"""Multi-process GOP distribution.

The decoder's cross-process axis is the closed GOP: reference chains never
cross an IDR, so processes need no communication while they decode.
Each process takes a deterministic, contiguous share of the stream's
GOPs (contiguous, not round-robin, so that every process parses one run
of the bitstream), decodes it with the lockstep driver over its local
devices (parallel/batch.py), and the caller concatenates the processes'
outputs in rank order.  Port of `parallel/distributed.py`.

The process group is the launcher's business, as `jax.distributed
.initialize` is in the JAX package: initialise `torch.distributed` (gloo
or NCCL, `init_method="tcp://127.0.0.1:<port>"` with rank and world size
on one machine) before calling decode_stream_multihost; without it the
process decodes the whole stream as rank 0 of 1.

A process's local devices, the counterpart of `jax.local_devices()`, are
its own cards, never another process's: with `LOCAL_RANK` and
`LOCAL_WORLD_SIZE` set (torchrun sets both) a process takes every
`LOCAL_WORLD_SIZE`-th visible card from `LOCAL_RANK` on (`local_cards`),
else every visible card.  A launcher that sets neither and starts more
than one process on a machine gives each its cards through
`CUDA_VISIBLE_DEVICES`.
"""

from __future__ import annotations

import os

import torch

from .batch import decode_gops_batched
from .gop import split_gops
from .mesh import make_decode_mesh


def my_gop_range(n_gops: int, rank: int, world: int) -> tuple[int, int]:
    """Contiguous [start, end) share of `n_gops` for `rank` of `world`
    (first `n_gops % world` ranks take one extra)."""
    base, extra = divmod(n_gops, world)
    start = rank * base + min(rank, extra)
    return start, start + base + (1 if rank < extra else 0)


def _rank_world():
    dist = torch.distributed
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def local_cards(n_visible: int, local_rank: int = 0,
                local_world: int = 1) -> list[int]:
    """Indices of the visible cards that are process `local_rank`'s own
    among `local_world` processes on a machine: all of them for one
    process; else every `local_world`-th card from `local_rank` on, or,
    with fewer cards than processes, card `local_rank % n_visible` (shared
    with the processes of the same remainder)."""
    if n_visible == 0:
        return []
    if local_world <= 1:
        return list(range(n_visible))
    if n_visible < local_world:
        return [local_rank % n_visible]
    return list(range(local_rank, n_visible, local_world))


def _local_devices():
    """This process's cards (see the module docstring)."""
    env = os.environ
    return [f"cuda:{i}" for i in local_cards(
        torch.cuda.device_count(), int(env.get("LOCAL_RANK", 0)),
        int(env.get("LOCAL_WORLD_SIZE", 1)))]


def decode_stream_multihost(stream: bytes, *, lanes: int = 4, device=None):
    """Decode this process's share of the stream's GOPs; returns an
    iterator of its Frames in stream order (empty when the share is).

    Rank and world size come from an initialised torch.distributed
    process group, else (0, 1).  device=None decodes on the process's
    local cards (module docstring): over a mesh of all of them when
    `lanes` is a multiple of their count, else on the first; it raises
    without a card.  Any device given (device="cpu" among them) decodes
    there with no mesh."""
    rank, world = _rank_world()
    gops = split_gops(stream)
    lo, hi = my_gop_range(len(gops), rank, world)
    share = b"".join(gops[lo:hi])
    if not share:
        return iter(())
    if device is None:
        local = _local_devices()
        if local and lanes % len(local) == 0:
            return decode_gops_batched(share, lanes=lanes,
                                       mesh=make_decode_mesh(local))
        device = local[0] if local else None
    return decode_gops_batched(share, lanes=lanes, device=device)
