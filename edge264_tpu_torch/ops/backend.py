"""The single-frame pixel backend: one frame per call through every stage.

Port of `jaxdec.JaxBackend` for `core.DecoderCore`.  The DPB's reference
phase planes (mc.make_ref_planes) live in a persistent device ring
[1, S, ...] keyed by DPB slot, written in place and grown by doubling;
only reference frames enter it.  `reconstruct` runs the whole-frame
routine (ops/frame.py: residual -> MC when the ring holds a reference ->
intra -> deblock -> concealment blend) on the frame's arena, with the
same kernels as the lockstep step (K = 1), and returns device tensors so
the host parses the next slice while the device works.  On the card every
frame goes through the intra and deblock kernels, and every frame with a
reference through the MC route that mc.mc_predict picks for the geometry
and the ring (the two MC kernels where their load words reach).  Intra
follows `JaxBackend`'s rule: it builds level tables
(intra.intra_level_tables) only where it has no wavefront kernel (its
`use_pallas()` false, off the TPU), so on the CPU an intra-sparse frame
whose levels hold at most 128 mbs takes the level-gather scan
(intra.intra_scan) and every other frame the sheared scan; on the card
every frame takes the intra kernel.  A
frame's planes and meta block go up as one arena (ops/arena.py) in one
copy: dense, int16 levels, no gathering, the conditional planes sticky
for the stream, as `JaxBackend` packs them.
"""

from __future__ import annotations

import numpy as np
import torch

from ..api import pixel_device
from . import arena as A
from .batched import _meta_parts, pack_meta, scaling8
from .frame import decode_frame_arena, decode_frame_inter_arena
from .intra import intra_level_tables
from .mc import make_ref_planes, mc_band_dims
from .tables import MBF_IPCM, MBF_T8x8

U8 = torch.uint8


class TorchBackend:
    """Device pixel backend.  device: None -> "cuda" (raises without a
    card); "cpu" runs the plain versions."""

    RING_START = 8            # ring slots; grows by doubling

    def __init__(self, device=None):
        self.device = pixel_device(device)
        self.ringL = None         # [1, S, 4, ph, pw_b] uint8 (G,B,H,J)
        self.ringC = None         # [1, S, phc, 2*pwc_pad] uint8
        self.ring_map = {}        # DPB slot -> ring index
        self.ring_free = []
        self._keep = set()        # sticky conditional planes
        self._geom = None

    def _ring_reserve(self, slot, mbW, mbH):
        if self._geom != (mbW, mbH):
            self._geom = (mbW, mbH)
            self.ring_map.clear()
            ph, pw_b, phc, pwc_pad = mc_band_dims(mbW, mbH)
            S = self.RING_START
            self.ringL = torch.zeros((1, S, 4, ph, pw_b), dtype=U8,
                                     device=self.device)
            self.ringC = torch.zeros((1, S, phc, 2 * pwc_pad), dtype=U8,
                                     device=self.device)
            self.ring_free = list(range(S))
        if not self.ring_free:
            S = self.ringL.shape[1]
            self.ringL = torch.cat([self.ringL, torch.zeros_like(self.ringL)],
                                   1)
            self.ringC = torch.cat([self.ringC, torch.zeros_like(self.ringC)],
                                   1)
            self.ring_free = list(range(S, 2 * S))
        i = self.ring_free.pop()
        self.ring_map[slot] = i
        return i

    def reconstruct(self, planes, slot, store, is_ref=True):
        """One frame's pixels from its syntax planes: (y, cb, cr) uint8
        device tensors, mb-aligned.  `store` is unused: references come
        from the ring."""
        mbW, mbH = planes.mb_w, planes.mb_h
        flags = np.asarray(planes.mb_flags)
        if (flags & MBF_T8x8).any():
            self._keep |= {"coef_y8", "i8_modes"}
        if (flags & MBF_IPCM).any():
            self._keep |= {"pcm_y", "pcm_c"}
        if np.asarray(planes.wp).any() or np.asarray(planes.wp8).any():
            self._keep |= {"wp", "wp8"}
        smap = np.zeros(32, np.int32)
        for s, i in self.ring_map.items():
            smap[s] = i
        # the concealment planes go up only for a frame that blends
        # (plan_layout); the meta block's ring slot is unused here
        buf, layout, meta_off = A.pack_planes_batch(
            [planes], planes, keep=self._keep, coef8=False,
            extra=pack_meta([planes.sm4], [scaling8(planes.sm8)], [smap],
                            [0]),
            gat_state=None, device=self.device)
        arena = A.upload(buf, self.device)
        sm4, sm8, slot_maps, _ = _meta_parts(arena, meta_off)
        itab = None
        if self.device.type == "cpu":
            itab = intra_level_tables(flags, mbW, mbH)
            if itab is not None and itab[0].shape[1] > 128:
                itab = None
            if itab is not None:
                itab = tuple(torch.as_tensor(t)[None] for t in itab)
        if self.ring_map:
            y8, cb8, cr8 = decode_frame_inter_arena(
                arena, sm4, sm8, self.ringL, self.ringC, slot_maps, itab,
                layout=layout, mbW=mbW, mbH=mbH)
        else:
            y8, cb8, cr8 = decode_frame_arena(arena, sm4, sm8, itab,
                                              layout=layout, mbW=mbW, mbH=mbH)
        if is_ref:
            i = self._ring_reserve(slot, mbW, mbH)
            newL, newC = make_ref_planes(y8, cb8, cr8)
            self.ringL[0, i] = newL[0]
            self.ringC[0, i] = newC[0]
        return y8[0], cb8[0], cr8[0]

    def unpin(self, slot):
        i = self.ring_map.pop(slot, None)
        if i is not None:
            self.ring_free.append(i)
