"""Sharded decoding over a list of devices.

The decoder's embarrassingly parallel axis is the frame / GOP axis:
closed GOPs are independent, and intra frames always are.  A mesh here is
an ordered list of devices, one shard each, over which that axis is split
into contiguous blocks (what `NamedSharding(mesh, P("gop"))` does in the
JAX package); each shard runs the whole pixel path on its block, and no
shard reads another's data.  Port of `parallel/mesh.py`
(`make_decode_mesh`, `decode_batch_sharded`); the lockstep driver takes a
mesh too (parallel/batch.decode_gops_batched).

A list may name one device more than once: each entry is one shard.  The
CPU tests rehearse sharding with `["cpu"] * 8` (the counterpart of the
JAX tests' 8 virtual CPU devices), and one card with
`["cuda:0", "cuda:0"]`, whose shards run one after another on that card.
"""

from __future__ import annotations

import contextlib
from dataclasses import dataclass

import numpy as np
import torch

from ..api import pixel_device
from ..ops.frame import decode_frame


@dataclass(frozen=True)
class DecodeMesh:
    """An ordered tuple of torch devices, one per shard."""

    devices: tuple

    @property
    def size(self) -> int:
        return len(self.devices)


def make_decode_mesh(devices=None) -> DecodeMesh:
    """A mesh over `devices` (names or torch devices, repeats allowed), or
    over every visible CUDA device when None; raises when a CUDA device is
    asked for (or none is given) and no card is present.  Every shard must
    be of one device type, since the lanes share one packed upload."""
    if devices is None:
        pixel_device(None)
        devices = [f"cuda:{i}" for i in range(torch.cuda.device_count())]
    devs = tuple(pixel_device(d) for d in devices)
    if not devs:
        raise ValueError("a mesh needs at least one device")
    if len({d.type for d in devs}) != 1:
        raise ValueError(f"mixed device types in a mesh: {devs}")
    return DecodeMesh(devs)


def decode_batch_sharded(p_batch, sm4, sm8, mbW, mbH, mesh: DecodeMesh):
    """Decode a batch of intra frames with the frame axis split over the
    mesh: shard i takes the i-th contiguous block of N / mesh.size frames
    and runs ops/frame.decode_frame on its device.

    p_batch: {key: [N, ...]} syntax planes (numpy arrays or tensors; every
    key of convert.PLANE_KEYS), N a multiple of the mesh size; sm4 [6, 16]
    and sm8 [6, 64], shared by every frame (the JAX function's vmap shares
    them too).  Returns (y, cb, cr), each a list of per-shard uint8
    tensors [N / mesh.size, ...] on the shard's device; concatenating
    each list in shard order gives the JAX function's global array."""
    n = len(next(iter(p_batch.values())))
    if n % mesh.size:
        raise ValueError(f"{n} frames do not split over {mesh.size} shards")
    b = n // mesh.size
    outs = ([], [], [])
    for i, dev in enumerate(mesh.devices):
        with (torch.cuda.device(dev) if dev.type == "cuda"
              else contextlib.nullcontext()):
            p = {k: _int32(v[i * b:(i + 1) * b], dev)
                 for k, v in p_batch.items()}
            s4 = _int32(sm4, dev).expand(b, 6, 16)
            s8 = _int32(sm8, dev).expand(b, 6, 64)
            for out, t in zip(outs, decode_frame(p, s4, s8, mbW, mbH)):
                out.append(t)
    return outs


def _int32(a, dev):
    """A contiguous int32 tensor of `a` on `dev`; on a card always its own
    allocation, so the kernels find it 16-byte aligned."""
    if isinstance(a, np.ndarray):
        a = torch.from_numpy(np.ascontiguousarray(a))
    return a.to(device=dev, dtype=torch.int32,
                copy=dev.type == "cuda").contiguous()
