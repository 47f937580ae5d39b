"""Lockstep-batched pixel path: K independent frames (from K concurrent
GOPs) run every stage together, so each stage is one batched call (and
each kernel one launch) for all K.

Port of `ops/batched.py`'s `decode_batch_step` (the `_main_impl` stage
order) and `decode_batch_step_sharded`, the step's meta block
(`pack_meta`, `_meta_parts`), the reference rings (`alloc_ref_rings`,
`grow_ref_rings`) and the frame digests (`_digest3`,
`host_frame_digest`).  A step's input is one uploaded arena
(ops/arena.py) holding every lane's planes and its meta block.  The
per-lane reference store is a persistent device ring [K, S+1, ...] (slot
S is a write-off lane for non-reference frames), updated IN PLACE each
step where JAX donated it.
"""

from __future__ import annotations

import contextlib

import numpy as np
import torch

from .arena import unpack_planes
from .frame import _frame, _mode_flags
from .mc import make_ref_planes, mc_band_dims

I32 = torch.int32
U8 = torch.uint8


# ---------------------------------------------------------------------------
# frame digests: a 64-bit (2x uint32) position-weighted checksum computed on
# the device, so a consumer can check every frame while the pixels stay
# there.  host_frame_digest is the exact numpy twin.

DIG_MULS = (2654435761, 2246822519)          # Knuth / xxhash odd primes
_M32 = 0xFFFFFFFF


def _mulmod32(a, b):
    """a * b mod 2^32 for int64 tensors holding values < 2^32 (the product
    itself would overflow int64): split b into 16-bit halves."""
    return (a * (b & 0xFFFF) + (((a * (b >> 16)) & 0xFFFF) << 16)) & _M32


def _digest3(y8, cb8, cr8, crop):
    """Digest of ONE frame over its CROPPED planes (uint8 2-D each):
    int64 tensor [2] holding the two uint32 words."""
    ct, cr_, cb_, cl = crop
    H, W = y8.shape
    planes = (y8[ct:H - cb_, cl:W - cr_],
              cb8[ct // 2:(H - cb_) // 2, cl // 2:(W - cr_) // 2],
              cr8[ct // 2:(H - cb_) // 2, cl // 2:(W - cr_) // 2])
    outs = []
    for k, mul in enumerate(DIG_MULS):
        acc = torch.zeros((), dtype=torch.int64, device=y8.device)
        base = 1
        for p in planes:
            n = p.numel()
            i = ((torch.arange(n, dtype=torch.int64, device=y8.device)
                  + base) * mul) & _M32
            if k == 1:
                # quadratic weights: word 1 would otherwise be word 0
                # times a constant
                i = _mulmod32(i, i)
            s = ((p.reshape(-1).to(torch.int64) + 1) * i).sum()
            acc = (acc + s) & _M32
            base += n
        outs.append(acc)
    return torch.stack(outs)


def host_frame_digest(y, cb, cr):
    """numpy twin of _digest3 over an ALREADY-CROPPED frame; returns a
    (d0, d1) int tuple."""
    outs = []
    for k, mul in enumerate(DIG_MULS):
        acc = 0
        base = 1
        for p in (y, cb, cr):
            n = p.size
            with np.errstate(over="ignore"):
                i = ((np.arange(n, dtype=np.uint32) + np.uint32(base))
                     * np.uint32(mul))
                if k == 1:
                    i = i * i
                s = ((np.ascontiguousarray(p).reshape(-1)
                      .astype(np.uint32) + 1) * i).sum(dtype=np.uint32)
            acc = (acc + int(s)) & _M32
            base += n
        outs.append(acc)
    return tuple(outs)


def _emit_aux(y8, cb8, cr8, emit, crop):
    if emit == "flat":
        K = y8.shape[0]
        return torch.cat([y8.reshape(K, -1), cb8.reshape(K, -1),
                          cr8.reshape(K, -1)], 1)
    if emit == "digest":
        return torch.stack([_digest3(a, b, c, crop)
                            for a, b, c in zip(y8, cb8, cr8)])
    raise ValueError(f"emit={emit!r}")


# ---------------------------------------------------------------------------
# the step's meta block rides the arena upload: scaling matrices, the
# DPB-slot -> ring map and the destination ring slot, ~2 KB a lane of
# int32 appended to the packed planes (pack_planes_batch's `extra`)

META_WORDS = 96 + 384 + 32 + 1          # sm4 | sm8 | slot_map | ring


def scaling8(sm8):
    """The six 8x8 scaling lists [6, 64] int32 of the meta block and the
    oracle from the front end's two ([2, 64]: intra and inter Y); the
    chroma lists, unused in 4:2:0, stay flat (16)."""
    ws8 = np.full((6, 64), 16, np.int32)
    ws8[:2] = np.asarray(sm8)[:2]
    return ws8


def pack_meta(sm4s, sm8s, slot_maps, ring_slots):
    """Host side: [K, META_WORDS] int32 -> [K, 4*META_WORDS] uint8 rows
    for pack_planes_batch(extra=...)."""
    K = len(sm4s)
    m = np.empty((K, META_WORDS), np.int32)
    m[:, :96] = np.asarray(sm4s, np.int32).reshape(K, 96)
    m[:, 96:480] = np.asarray(sm8s, np.int32).reshape(K, 384)
    m[:, 480:512] = np.asarray(slot_maps, np.int32).reshape(K, 32)
    m[:, 512] = np.asarray(ring_slots, np.int32)
    return m.view(np.uint8)


def _meta_parts(arenas, meta_off):
    """Device side: the meta block as int32 views of the arena: sm4
    [K,6,16], sm8 [K,6,64], slot_map [K,32], ring_slot [K]."""
    K = arenas.shape[0]
    m = arenas[:, meta_off:meta_off + 4 * META_WORDS].view(I32)
    return (m[:, :96].reshape(K, 6, 16), m[:, 96:480].reshape(K, 6, 64),
            m[:, 480:512], m[:, 512])


# ---------------------------------------------------------------------------
# the step

def decode_batch_step(arenas, refs, *, layout, meta_off, mbW, mbH,
                      intra_mode, mc, emit="flat", crop=(0, 0, 0, 0)):
    """One lockstep step over K frames.

    arenas     [K, L] uint8 on the device: every lane's packed syntax
               planes (the shared `layout`, arena.pack_planes_batch) and
               at meta_off the meta block (pack_meta: sm4 | sm8 |
               slot_map, DPB slot -> ring index | ring slot, the
               destination; S = the write-off slot)
    refs       (refL [K,S1,4,ph,pw_b] u8, refC [K,S1,phc,2*pwc_pad] u8),
               updated IN PLACE and returned
    intra_mode "skip" (no intra or PCM mb in any lane) | "rounds{R}"
               (every lane intra-sparse, depths <= R: the level rounds on
               the CPU, intra.cu on a card) | "sheared" (the wavefront:
               intra_batch); see frame._intra_dispatch
    mc         False for steps without inter prediction (step 0); else
               mc.mc_predict: the MC kernels (their plain versions on the
               CPU) at every geometry and ring size
    emit       "flat" ([K, Y+C+C] u8) | "digest" ([K, 2] int64 uint32
               words)
    crop       (top, right, bottom, left) for the digest

    The layout's left-out planes skip their work (8x8 transform, PCM).
    Returns (y8, cb8, cr8, aux, refL, refC)."""
    refL, refC = refs
    K = arenas.shape[0]
    has_t8, has_pcm = _mode_flags(layout)
    p = unpack_planes(arenas, layout)
    sm4, sm8, slot_maps, ring_slots = _meta_parts(arenas, meta_off)
    # both lists: any lane's frame may be a B frame
    mc_in = (refL, refC, slot_maps, True) if mc else None
    y8, cb8, cr8 = _frame(p, sm4, sm8, mbW, mbH, mc_in, has_t8, has_pcm,
                          False, intra_mode)
    aux = _emit_aux(y8, cb8, cr8, emit, crop)
    newL, newC = make_ref_planes(y8, cb8, cr8)
    lanes = torch.arange(K, device=refL.device)
    ring = ring_slots.long()
    refL[lanes, ring] = newL
    refC[lanes, ring] = newC
    return y8, cb8, cr8, aux, refL, refC


def decode_batch_step_sharded(arenas, refs, *, layout, meta_off, mbW, mbH,
                              intra_mode, mc, emit, crop, mesh):
    """The lockstep step with the lane axis split over `mesh`'s shards
    (parallel.mesh.DecodeMesh): shard i holds a contiguous block of K/n
    lanes.  arenas: per shard a [K/n, L] uint8 arena on its device (rows
    of the step's one packed buffer, so `layout` and `meta_off` are
    shared); refs: per shard its (refL, refC) rings.  Each shard runs
    decode_batch_step under its device, on that device's current stream;
    every shard's work is issued before any is waited on (nothing here
    synchronises).  GOP lanes are reference-closed, so the shards exchange
    nothing.  intra_mode and the other arguments are step-wide, as in the
    JAX package (one program a step).  Shards that name the same device
    run one after another on its stream, so two persistent wavefront
    launches, each sized to fill the card, never share it at once.
    Returns per shard the tuple decode_batch_step returns."""
    outs = []
    for dev, arena, ring in zip(mesh.devices, arenas, refs):
        with (torch.cuda.device(dev) if dev.type == "cuda"
              else contextlib.nullcontext()):
            outs.append(decode_batch_step(
                arena, ring, layout=layout, meta_off=meta_off, mbW=mbW,
                mbH=mbH, intra_mode=intra_mode, mc=mc, emit=emit, crop=crop))
    return outs


def alloc_ref_rings(K, S, mbW, mbH, device):
    """Device ring buffers for K lanes x (S + 1 write-off) slots of MC
    half-pel planes (uint8; see mc.make_ref_planes for the layout)."""
    ph, pw_b, phc, pwc_pad = mc_band_dims(mbW, mbH)
    refL = torch.zeros((K, S + 1, 4, ph, pw_b), dtype=U8, device=device)
    refC = torch.zeros((K, S + 1, phc, 2 * pwc_pad), dtype=U8,
                       device=device)
    return refL, refC


def grow_ref_rings(refL, refC, S_old, S_new):
    """Grow each lane's ring to S_new slots, keeping slots [0, S_old).  The
    old write-off slot S_old holds only non-reference frames (no slot map
    points at it), so it becomes a regular slot; the write-off moves to
    S_new."""
    K = refL.shape[0]
    newL = torch.zeros((K, S_new + 1) + refL.shape[2:], dtype=refL.dtype,
                       device=refL.device)
    newC = torch.zeros((K, S_new + 1) + refC.shape[2:], dtype=refC.dtype,
                       device=refC.device)
    newL[:, :S_old] = refL[:, :S_old]
    newC[:, :S_old] = refC[:, :S_old]
    return newL, newC
