"""The whole-frame pixel path: K frames (K = 1 for the single-frame
backend) from their syntax planes through every stage in one call.

Ports of `jaxdec._decode_frame_impl` with `decode_frame_jit` and
`decode_frame_inter_jit`, and of the arena forms `decode_frame_arena` and
`decode_frame_inter_arena`.  The JAX package splits the arena forms into
jitted programs (`_dense_arena_impl`, `_intra_arena_impl`, `_recon_arena`,
`_deblock_arena`) for its TPU compiler; here every form, and the lockstep
step (batched.decode_batch_step), runs the one routine `_frame`:

    residual_frame -> [mc_predict] -> intra (_intra_dispatch) -> deblock_bs
        -> deblock_batch -> [blend_recovered] -> uint8

Every function takes planes, scaling matrices and rings with a leading
lane dimension K, as the rest of the port does.  The card runs no plain
version of a kernel: deblocking, MC (`mc.mc_predict`, pack -> kernels ->
combine at every geometry and ring) and intra run their CUDA kernels on
the card and their plain versions on the CPU.  Intra by route
(`_intra_dispatch`) and device:

    route        planes on the CPU               planes on a card
    "skip"       identity                        identity, no launch
    "sheared"    intra_scan_sheared (plain)      intra.cu (intra_batch)
    "rounds{R}"  intra_rounds, the level rounds  intra.cu (intra_batch)
    "levels"     intra_scan over `itab`          raises ValueError

The lockstep driver names "rounds{R}" for intra-sparse P/B steps on the
CPU, where the level rounds hold the port to the JAX package's own
route; on a card it names only "skip" or "sheared".  `itab` (level
tables from `intra.intra_level_tables`) selects "levels", as in the JAX
functions, which build it only where they have no wavefront kernel (off
the TPU); the port keeps that rule by device, so `itab` with planes on a
card raises instead of running the plain level-gather scan there.
"""

from __future__ import annotations

import torch

from .arena import unpack_planes
from .deblock import blend_recovered, deblock_batch, deblock_bs
from .intra import intra_batch, intra_rounds, intra_scan
from .mc import mc_predict
from .residual import residual_frame

I32 = torch.int32
U8 = torch.uint8


def _mode_flags(layout):
    """(has_t8, has_pcm): whether the layout carries the 8x8-transform
    and PCM planes (left out, the frame skips that work)."""
    present = {k for k, _, _, off, _m in layout if off != -1}
    return "coef_y8" in present, "pcm_y" in present


def _intra_dispatch(y, cb, cr, res_y, res_cb, res_cr, p, intra_mode, mbW,
                    mbH, has_t8, has_pcm, itab=None):
    """The intra route (the module's table): "skip" is the identity;
    "rounds{R}" the level rounds with the depth plane recomputed from
    mb_flags, on the CPU only; "levels" the level-gather scan over `itab`,
    on the CPU only (`ValueError` for planes elsewhere); "sheared", and
    "rounds{R}" off the CPU, `intra_batch` (intra.cu on a card, the plain
    sheared scan on the CPU)."""
    if intra_mode == "skip":
        return y, cb, cr
    if intra_mode == "levels":
        if y.device.type != "cpu":
            raise ValueError(f"itab on {y.device}: the level-gather scan "
                             "runs on the CPU only; on a card pass "
                             "itab=None (intra.cu)")
        return intra_scan(y, cb, cr, res_y, res_cb, res_cr, p, itab)
    if intra_mode.startswith("rounds") and y.device.type == "cpu":
        return intra_rounds(y, cb, cr, res_y, res_cb, res_cr, p, None, mbW,
                            mbH, int(intra_mode[len("rounds"):]), has_t8,
                            has_pcm)
    if intra_mode == "sheared" or intra_mode.startswith("rounds"):
        return intra_batch(y, cb, cr, res_y, res_cb, res_cr, p, mbW, mbH,
                           has_t8, has_pcm)
    raise ValueError(f"intra_mode={intra_mode!r}")


def _frame(p, sm4, sm8, mbW, mbH, mc_in, has_t8, has_pcm, blend,
           intra_mode="sheared", itab=None):
    """mc_in: None, or (stackL, stackC, slot_map, has_b) for frames with
    inter macroblocks; intra_mode: see _intra_dispatch (itab: the tables
    of "levels")."""
    res_y, res_cb, res_cr = residual_frame(p, sm4, sm8, has_t8)
    if mc_in is not None:
        stackL, stackC, slot_map, has_b = mc_in
        pred_y, pred_cb, pred_cr, mask_y, mask_c = mc_predict(
            p, slot_map, stackL, stackC, has_b, mbW, mbH)
        y = torch.where(mask_y, (pred_y + res_y).clamp(0, 255), 0)
        cb = torch.where(mask_c, (pred_cb + res_cb).clamp(0, 255), 0)
        cr = torch.where(mask_c, (pred_cr + res_cr).clamp(0, 255), 0)
    else:
        K, dev = res_y.shape[0], res_y.device
        y = torch.zeros((K, 16 * mbH, 16 * mbW), dtype=I32, device=dev)
        cb = torch.zeros((K, 8 * mbH, 8 * mbW), dtype=I32, device=dev)
        cr = torch.zeros_like(cb)
    y, cb, cr = _intra_dispatch(y, cb, cr, res_y, res_cb, res_cr, p,
                                intra_mode, mbW, mbH, has_t8, has_pcm, itab)
    bs_v, bs_h = deblock_bs(p)
    y, cb, cr = deblock_batch(y, cb, cr, p, bs_v, bs_h, mbW, mbH)
    if blend:
        y, cb, cr = blend_recovered(y, cb, cr, p)
    return y.to(U8), cb.to(U8), cr.to(U8)


def _route(itab):
    return "sheared" if itab is None else "levels"


def decode_frame(p, sm4, sm8, mbW, mbH, itab=None):
    """Residuals -> intra -> deblocking for K frames without inter
    prediction (decode_frame_jit).  p: {key: [K, ...]} int32 planes (every
    key of convert.PLANE_KEYS), sm4 [K,6,16], sm8 [K,6,64]; itab None (the
    wavefront) or level tables (mxs, mys, valid), each [K, Lb, Nb], for
    intra.intra_scan.  Returns (y, cb, cr) uint8, mb-aligned."""
    return _frame(p, sm4, sm8, mbW, mbH, None, True, True, False,
                  _route(itab), itab)


def decode_frame_inter(p, sm4, sm8, stackL, stackC, slot_map, mbW, mbH,
                       itab=None, has_b=True):
    """The same with motion compensation first (decode_frame_inter_jit):
    stackL [K,S,4,ph,pw_b] / stackC [K,S,phc,2*pwc_pad] uint8 reference
    rings (mc.make_ref_planes), slot_map [K,32] DPB slot -> ring index;
    has_b False predicts from list 0 only."""
    return _frame(p, sm4, sm8, mbW, mbH, (stackL, stackC, slot_map, has_b),
                  True, True, False, _route(itab), itab)


def _arena_frame(arenas, sm4, sm8, mc_in, itab, layout, mbW, mbH):
    has_t8, has_pcm = _mode_flags(layout)
    blend = any(k == "mb_errors" and off != -1
                for k, _, _, off, _m in layout)
    return _frame(unpack_planes(arenas, layout), sm4, sm8, mbW, mbH, mc_in,
                  has_t8, has_pcm, blend, _route(itab), itab)


def decode_frame_arena(arenas, sm4, sm8, itab=None, *, layout, mbW, mbH):
    """decode_frame on an uploaded arena ([K, L] uint8, arena.pack_planes
    or pack_planes_batch): the layout's left-out planes skip their work,
    and a layout that carries `mb_errors` blends the recovered mbs after
    deblocking (jaxdec.decode_frame_arena)."""
    return _arena_frame(arenas, sm4, sm8, None, itab, layout, mbW, mbH)


def decode_frame_inter_arena(arenas, sm4, sm8, stackL, stackC, slot_map,
                             itab=None, *, layout, mbW, mbH, has_b=True):
    """decode_frame_inter on an uploaded arena
    (jaxdec.decode_frame_inter_arena)."""
    return _arena_frame(arenas, sm4, sm8, (stackL, stackC, slot_map, has_b),
                        itab, layout, mbW, mbH)
