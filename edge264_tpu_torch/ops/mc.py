"""Motion-compensated inter prediction (§8.4.2), batched over K frames.

Ports of `jaxdec.mc_band_dims`, `make_ref_planes`, `_mc_meta`,
`_mc_combine`, `mc_frame` (with `_mc_luma_list`, `_mc_chroma_list`) and
of `pallas_mc.pack_mc_params`, `run_mc_kernels` and `combine_mc`.
`mc_predict`, the decode paths' inter prediction, always runs

    pack_mc_params -> run_mc_kernels (mc_luma + mc_chroma) -> combine_mc

Each runs a hand-written kernel on CUDA tensors and its plain version
(the same arithmetic in tensor ops) on CPU tensors: `pack_mc_params`
`kernels/csrc/mcpack.cu` (plain: `pack_mc_params_plain`), `mc_luma` /
`mc_chroma` `kernels/csrc/mc.cu` (`mc_luma_plain` / `mc_chroma_plain`),
`combine_mc` `kernels/csrc/combine.cu` (`combine_mc_plain`).  Each load
(per block, list and quadrant) is a pair of int32 words:

    position word  y << 15 | x            x, y below 2^15
    ring word      ring index << 8 | sel  sel: the luma pair's half-pel
                   planes and B's offset from A, pA << 6 | pB << 4 |
                   (dyB + 1) << 2 | (dxB + 1), or the chroma phase
                   dy << 3 | dx
    both -1 where the quadrant's list is unused

so they reach every frame the front end accepts (1023 x 1056 mbs) and
rings of up to 2^23 slots in the bytes of the JAX package's pairs, whose
words each hold `plane << 24 | y << 12 | x` for one sample (luma: A and
B; chroma: the position, then the phase) and reach 253 mbs and 31 ring
slots.  The two carry the same fields where both reach.  The JAX package
sends a frame past its words to `jaxdec.mc_frame`; here `mc_frame`, its
port (plain gathers, no packing shared with the kernels), is the
reference that the kernels' route is held to, and no decode path calls
it.

Reference ring layout (shared with the JAX package): luma [4, ph, pw_b]
uint8 half-pel planes {0:G, 1:B, 2:H, 3:J}; chroma INTERLEAVED
[phc, 2*pwc_pad] uint8 with Cb at even and Cr at odd columns.  Widths
are rounded up to multiples of 128 (at least 256) with edge-replicated
columns, so position clamps against the padded width stay bit-exact.
"""

from __future__ import annotations

import ctypes

import torch

from .residual import _rep
from .tables import MBF_INTER, _MC_TAB_FLAT

I32 = torch.int32
U8 = torch.uint8

PADL, PADC = 20, 12     # replicate padding (>= max window + block reach)

# flags bits per 8x8 block (pallas_mc._F_*)
_F_USED0, _F_USED1, _F_UNIFORM = 1, 2, 4
_F_PAIR = 8              # this EVEN block and its right neighbour form one
#                          uniform 16x8 region sampled by the even block
_F_PAIRODD = 16          # odd half of a pair: luma skips (chroma keeps its
#                          own per-quad path off the used bits)


def mc_band_dims(mbW, mbH):
    """(ph, pw_b, phc, pwc_pad) of the MC ring planes for a geometry
    (pwc_pad is the per-component chroma width; interleaved 2*pwc_pad)."""
    ph = 16 * mbH + 2 * PADL
    pw = 16 * mbW + 2 * PADL
    phc = 8 * mbH + 2 * PADC
    pwc = 8 * mbW + 2 * PADC
    pw_b = max(-(-pw // 128) * 128, 256)
    pwc_pad = max(-(-(2 * pwc) // 128) * 128, 256) // 2
    return ph, pw_b, phc, pwc_pad


def _edge_pad(a, top, bottom, left, right):
    """Edge-replicating pad of the last two dims (index clamping)."""
    H, W = a.shape[-2:]
    rows = (torch.arange(-top, H + bottom, device=a.device)).clamp(0, H - 1)
    cols = (torch.arange(-left, W + right, device=a.device)).clamp(0, W - 1)
    return a.index_select(-2, rows).index_select(-1, cols)


def _six_j(a, dim):
    """6-tap (1,-5,20,20,-5,1) along `dim` (valid positions)."""
    n = a.shape[dim]

    def s(i):
        return a.narrow(dim, i, n - 5)

    return s(0) - 5 * s(1) + 20 * s(2) + 20 * s(3) - 5 * s(4) + s(5)


def make_ref_planes(y, cb, cr):
    """uint8 frames [K,H,W] / [K,H/2,W/2] -> (luma4 [K,4,ph,pw_b] uint8
    half-pel planes {G,B,H,J}, chroma interleaved [K,phc,2*pwc_pad]
    uint8).  Any quarter-pel sample is the rounded average of two samples
    of the luma planes (per _MC_TAB)."""
    K, H, W = y.shape
    mbW, mbH = W // 16, H // 16
    ph, pw_b, phc, pwc_pad = mc_band_dims(mbW, mbH)
    pw = W + 2 * PADL
    g = _edge_pad(y.to(I32), PADL, PADL, PADL, PADL)
    braw = _six_j(_edge_pad(g, 0, 0, 2, 3), 2)          # [K, ph, pw]
    b = ((braw + 16) >> 5).clamp(0, 255)
    h = ((_six_j(_edge_pad(g, 2, 3, 0, 0), 1) + 16) >> 5).clamp(0, 255)
    j = ((_six_j(_edge_pad(braw, 2, 3, 0, 0), 1) + 512) >> 10).clamp(0, 255)
    luma4 = _edge_pad(torch.stack([g, b, h, j], 1), 0, 0, 0, pw_b - pw)
    cpads = [_edge_pad(c, PADC, PADC, PADC,
                       PADC + pwc_pad - (W // 2) - 2 * PADC)
             for c in (cb, cr)]
    ci = torch.stack(cpads, -1).reshape(K, phc, 2 * pwc_pad)
    return luma4.to(U8), ci


def _mc_meta(p, slot_maps, l):
    """(used, sidx, mvx, mvy) per 4x4 cell for list `l` ([K,BH,BW] each);
    slot_maps [K,32] maps DPB slots to ring indices."""
    rs = p["refslot"][..., l]                            # [K,BH,BW]
    K = rs.shape[0]
    used = rs >= 0
    sidx = slot_maps.gather(1, rs.clamp(0, 31).reshape(K, -1).long()) \
        .reshape(rs.shape)
    return used, sidx, p["mvs"][..., l, 0], p["mvs"][..., l, 1]


def _mc_combine(p, preds, has_b=True):
    """Weighted-prediction combine (§8.4.2.3) of the per-list prediction
    planes.  preds: [(used [K,BH,BW] bool, y [K,H,W] i32, cb, cr i32)].
    Returns (pred_y, pred_cb, pred_cr, mask_y, mask_c)."""
    if not has_b:
        f = torch.zeros_like(preds[0][0])
        preds = [preds[0], (f, preds[0][1], preds[0][2], preds[0][3])]
    wp = p["wp"]                                         # [K,H,W,24]
    mode = _rep(wp[..., 0], 4)
    lwd = _rep(wp[..., 1], 4)
    cwd = _rep(wp[..., 2], 4)
    w8c = _rep(p["wp8"], 2)                              # [K,BH,BW,2,3,2]

    u0, y0_, cb0, cr0 = preds[0]
    u1, y1_, cb1, cr1 = preds[1]

    def weight_single(pred, w, o, logwd):
        num = pred * w + torch.where(
            logwd >= 1, 1 << (logwd - 1).clamp(min=0), 0)
        v = torch.where(logwd >= 1, num >> logwd.clamp(min=0), pred * w) + o
        return v.clamp(0, 255)

    def weight_bi(p0, p1, w0, w1, o0, o1, logwd):
        v = ((p0 * w0 + p1 * w1 + (1 << logwd)) >> (logwd + 1)) \
            + ((o0 + o1 + 1) >> 1)
        return v.clamp(0, 255)

    def combine(pix0, pix1, u0x, u1x, modex, wdx, wsel, n):
        w_0 = _rep(w8c[..., 0, wsel, 0], n)
        o_0 = _rep(w8c[..., 0, wsel, 1], n)
        w_1 = _rep(w8c[..., 1, wsel, 0], n)
        o_1 = _rep(w8c[..., 1, wsel, 1], n)
        bi = u0x & u1x
        single = u0x ^ u1x
        ps = torch.where(u0x, pix0, pix1)
        ws = torch.where(u0x, w_0, w_1)
        os_ = torch.where(u0x, o_0, o_1)
        s_w = torch.where(modex == 1, weight_single(ps, ws, os_, wdx), ps)
        b_d = (pix0 + pix1 + 1) >> 1
        b_w = weight_bi(pix0, pix1, w_0, w_1, o_0, o_1, wdx)
        b = torch.where(modex == 0, b_d, b_w)
        return torch.where(bi, b, torch.where(single, s_w, 0)), u0x | u1x

    u0y, u1y, u0c, u1c = _rep(u0, 4), _rep(u1, 4), _rep(u0, 2), _rep(u1, 2)
    modey, modec = _rep(mode, 4), _rep(mode, 2)
    pred_y, mask_y = combine(y0_, y1_, u0y, u1y, modey, _rep(lwd, 4), 0, 4)
    pred_cb, _ = combine(cb0, cb1, u0c, u1c, modec, _rep(cwd, 2), 1, 2)
    pred_cr, mask_c = combine(cr0, cr1, u0c, u1c, modec, _rep(cwd, 2), 2, 2)
    # cells of an INTER mb with no valid reference on either list
    # (corrupt stream): predict mid-gray, the concealment default
    inter = _rep((p["mb_flags"] & MBF_INTER) > 0, 4)
    orph_y = _rep(inter, 4) & ~mask_y
    orph_c = _rep(inter, 2) & ~mask_c
    return (torch.where(orph_y, 128, pred_y),
            torch.where(orph_c, 128, pred_cb),
            torch.where(orph_c, 128, pred_cr),
            mask_y | orph_y, mask_c | orph_c)


# ---------------------------------------------------------------------------
# Kernel parameter packing (pallas_mc.pack_mc_params)

def _quads(a):
    """[K, 2R, 2C] -> [K, R, C, 4] quadrant-last (q = qy*2 + qx)."""
    K, H2, W2 = a.shape
    return (a.reshape(K, H2 // 2, 2, W2 // 2, 2)
            .permute(0, 1, 3, 2, 4).reshape(K, H2 // 2, W2 // 2, 4))


def _pad_blocks(a, BR, BC, fill=-1):
    """Pad block-grid dims [K, br, bc, n] -> [K, BR, BC, n]."""
    K, br, bc, n = a.shape
    out = torch.full((K, BR, BC, n), fill, dtype=a.dtype, device=a.device)
    out[:, :br, :bc] = a
    return out


def _sel_phase6(phase):
    """The 6 _MC_TAB columns (p1, ox1, oy1, p2, ox2, oy2) of each phase."""
    tab = torch.as_tensor(_MC_TAB_FLAT, device=phase.device)
    return tab[phase.long()].unbind(-1)


# load words (the module's docstring)
_XY_SHIFT, _XY_MASK, _RING_SHIFT = 15, 0x7FFF, 8


def load_fields(pos, ring, luma):
    """The ring reads of load word pairs (position and ring words, int
    tensors of one shape): luma [(plane, y, x) of sample A, of sample B],
    plane = 4 * ring index + half-pel plane; chroma [(ring index, y, x)]
    of the 2x2 footprint's top-left byte."""
    y, x = pos >> _XY_SHIFT, pos & _XY_MASK
    slot = ring >> _RING_SHIFT
    if not luma:
        return [(slot, y, x)]
    return [(4 * slot + ((ring >> 6) & 3), y, x),
            (4 * slot + ((ring >> 4) & 3), y + ((ring >> 2) & 3) - 1,
             x + (ring & 3) - 1)]


def _words(sidx, y, x, sel, used):
    """The (position, ring) word pair of loads at (y, x) from ring index
    sidx, -1 where unused."""
    return (torch.where(used, (y << _XY_SHIFT) | x, -1),
            torch.where(used, (sidx << _RING_SHIFT) | sel, -1))


def _luma_words(sidx, y, x, s, used):
    """The word pair of luma loads at clamped (y, x) with their phases'
    _MC_TAB columns s = (p1, ox1, oy1, p2, ox2, oy2): sample A at the +1
    offsets (ox1, oy1) of plane p1, B at (ox2, oy2) of plane p2."""
    p1, ox1, oy1, p2, ox2, oy2 = s
    sel = (p1 << 6) | (p2 << 4) | ((oy2 - oy1 + 1) << 2) | (ox2 - ox1 + 1)
    return _words(sidx, y + oy1, x + ox1, sel, used)


def pack_mc_params(p, slot_maps, has_b, mbW, mbH):
    """The MC kernels' parameters (the contract of pack_mc_params_plain):
    pack_mc_params_plain on CPU tensors, pack_mc_params_cuda (mcpack.cu)
    on CUDA tensors."""
    if p["refslot"].device.type == "cpu":
        return pack_mc_params_plain(p, slot_maps, has_b, mbW, mbH)
    return pack_mc_params_cuda(p, slot_maps, has_b, mbW, mbH)


def _pack_dims(mbW):
    """(W_b, BC): the luma row padded to a multiple of 128 samples (at
    least 128) and its 8x8 block columns."""
    W_b = max(-(-16 * mbW // 128) * 128, 128)
    return W_b, W_b // 8


def pack_mc_params_plain(p, slot_maps, has_b, mbW, mbH):
    """Build (flags [K,BR,1,BC], pk_luma [K,BR,1,BC*16],
    pk_chroma [K,BR//2,1,2*BC*16]), all int32: the kernels' input
    contract, pallas_mc.pack_mc_params' with the port's load words (the
    module's docstring): the same flags, and the same fields in every
    word pair.

    BR = 2*mbH 8x8-block rows, BC = padded block columns (W_b/8).
    Per block: 2 lists x 4 quadrants x 2 words; uniform blocks carry
    their joint 8x8 (4x4 chroma) load words in the q0 slots, and the even
    block of a 16x8 pair its joint 16x8 luma words."""
    ph, pw_b, phc, pwc_pad = mc_band_dims(mbW, mbH)
    BR, bc = 2 * mbH, 2 * mbW
    BC = _pack_dims(mbW)[1]
    K = p["refslot"].shape[0]
    dev = p["refslot"].device
    BH, BW = 4 * mbH, 4 * mbW
    gx4 = (torch.arange(BW, dtype=I32, device=dev) * 4)[None, :] \
        .expand(BH, BW)
    gy4 = (torch.arange(BH, dtype=I32, device=dev) * 4)[:, None] \
        .expand(BH, BW)

    flags = torch.zeros((K, BR, bc), dtype=I32, device=dev)
    pk_l, pk_c = [], []
    metas = [_mc_meta(p, slot_maps, l) for l in ((0, 1) if has_b else (0,))]
    # per-block uniformity over every list: all 4 quadrants share
    # (used, sidx, mvx, mvy)
    uni_all = None
    for meta in metas:
        for a in meta:
            q = _quads(a.to(I32))
            u = (q == q[..., :1]).all(-1)
            uni_all = u if uni_all is None else uni_all & u
    # pair (16x8) uniformity: even+odd 8x8 blocks identical in every list
    pair_eq = None
    for meta in metas:
        for a in meta:
            a8 = a.to(I32)[:, ::2, ::2]
            e = a8[:, :, 0::2] == a8[:, :, 1::2]
            pair_eq = e if pair_eq is None else pair_eq & e
    pairU = uni_all[:, :, 0::2] & uni_all[:, :, 1::2] & pair_eq

    for l, (used, sidx, mvx, mvy) in enumerate(metas):
        # ---- luma per-cell (4x4 quadrant path)
        px = (gx4 + (mvx >> 2) + PADL).clamp(0, pw_b - 6)
        py = (gy4 + (mvy >> 2) + PADL).clamp(0, ph - 6)
        s = _sel_phase6((mvy & 3) * 4 + (mvx & 3))
        qA, qB = (_quads(w) for w in _luma_words(sidx, py, px, s, used))
        # ---- luma joint 8x8 (uniform arm; quadrant-0 cell params)
        u0, s0 = used[:, ::2, ::2], sidx[:, ::2, ::2]
        mx0, my0 = mvx[:, ::2, ::2], mvy[:, ::2, ::2]
        px8 = (gx4[::2, ::2] + (mx0 >> 2) + PADL).clamp(0, pw_b - 10)
        py8 = (gy4[::2, ::2] + (my0 >> 2) + PADL).clamp(0, ph - 10)
        s8 = _sel_phase6((my0 & 3) * 4 + (mx0 & 3))
        pk8A, pk8B = _luma_words(s0, py8, px8, s8, u0)
        qA[..., 0] = torch.where(uni_all, pk8A, qA[..., 0])
        qB[..., 0] = torch.where(uni_all, pk8B, qB[..., 0])
        # ---- luma joint 16x8 (pair arm; even-block q0 slots, wider x
        # clip for the 16-sample row)
        u16, s16 = u0[:, :, 0::2], s0[:, :, 0::2]
        mx16, my16 = mx0[:, :, 0::2], my0[:, :, 0::2]
        px16 = (gx4[::2, ::4] + (mx16 >> 2) + PADL).clamp(0, pw_b - 18)
        py16 = (gy4[::2, ::4] + (my16 >> 2) + PADL).clamp(0, ph - 10)
        s16t = _sel_phase6((my16 & 3) * 4 + (mx16 & 3))
        pk16A, pk16B = _luma_words(s16, py16, px16, s16t, u16)
        qA[:, :, 0::2, 0] = torch.where(pairU, pk16A, qA[:, :, 0::2, 0])
        qB[:, :, 0::2, 0] = torch.where(pairU, pk16B, qB[:, :, 0::2, 0])
        pk_l.append(torch.stack([qA, qB], -1).reshape(K, BR, bc, 8))

        # ---- chroma per-cell (2x2)
        pxc = ((gx4 >> 1) + (mvx >> 3) + PADC).clamp(0, pwc_pad - 4)
        pyc = ((gy4 >> 1) + (mvy >> 3) + PADC).clamp(0, phc - 4)
        cqA, cqB = (_quads(w) for w in _words(
            sidx, pyc, 2 * pxc, ((mvy & 7) << 3) | (mvx & 7), used))
        # ---- chroma joint 4x4 (uniform arm)
        pxc8 = ((gx4[::2, ::2] >> 1) + (mx0 >> 3) + PADC) \
            .clamp(0, pwc_pad - 8)
        pyc8 = ((gy4[::2, ::2] >> 1) + (my0 >> 3) + PADC).clamp(0, phc - 8)
        c8A = _words(s0, pyc8, 2 * pxc8, 0, u0)[0]
        cqA[..., 0] = torch.where(uni_all, c8A, cqA[..., 0])
        pk_c.append(torch.stack([cqA, cqB], -1).reshape(K, BR, bc, 8))

        flags = flags | (_quads(used).any(-1).to(I32) << l)

    flags = flags | uni_all.to(I32) * _F_UNIFORM
    fE, fO = flags[:, :, 0::2], flags[:, :, 1::2]
    flags = torch.stack([torch.where(pairU, fE | _F_PAIR, fE),
                         torch.where(pairU, fO | _F_PAIRODD, fO)],
                        -1).reshape(flags.shape)
    if not has_b:
        pk_l.append(torch.full_like(pk_l[0], -1))
        pk_c.append(torch.full_like(pk_c[0], -1))
    pkl = _pad_blocks(torch.cat(pk_l, -1), BR, BC)
    pkc = _pad_blocks(torch.cat(pk_c, -1), BR, BC)
    flg = _pad_blocks(flags[..., None], BR, BC, fill=0)[..., 0]
    return (flg.reshape(K, BR, 1, BC), pkl.reshape(K, BR, 1, BC * 16),
            pkc.reshape(K, BR // 2, 1, 2 * BC * 16))


def pack_args(p, slot_maps, mbW, mbH):
    """mcpack.cu's inputs after the checks: (refslot, mvs, slot_maps,
    slot_maps' lane stride).  Raises ValueError on a wrong shape, type,
    device, layout or alignment."""
    from ..kernels import build
    rs, mvs = p["refslot"], p["mvs"]
    K, dev = rs.shape[0], rs.device
    BH, BW = 4 * mbH, 4 * mbW
    build.check_tensors([(rs, (K, BH, BW, 2)), (mvs, (K, BH, BW, 2, 2))],
                        I32, dev)
    return rs, mvs, slot_maps, build.lane_stride(slot_maps, (K, 32), I32,
                                                 dev)


def pack_mc_params_cuda(p, slot_maps, has_b, mbW, mbH):
    """pack_mc_params on CUDA tensors: one launch of
    `kernels/csrc/mcpack.cu`, adding one to
    `pack_mc_params_cuda.launches`."""
    from ..kernels import build
    dev = p["refslot"].device
    build.require_cuda(dev)
    rs, mvs, smap, stride = pack_args(p, slot_maps, mbW, mbH)
    K, BR, BC = rs.shape[0], 2 * mbH, _pack_dims(mbW)[1]
    flg = torch.empty((K, BR, 1, BC), dtype=I32, device=dev)
    pkl = torch.empty((K, BR, 1, BC * 16), dtype=I32, device=dev)
    pkc = torch.empty((K, BR // 2, 1, 2 * BC * 16), dtype=I32, device=dev)
    build.launch("mcpack", "e264t_mcpack", dev,
                 (rs, mvs, smap, flg, pkl, pkc), K, mbW, mbH, BC,
                 *mc_band_dims(mbW, mbH), 2 if has_b else 1, stride)
    pack_mc_params_cuda.launches += 1
    return flg, pkl, pkc


pack_mc_params_cuda.launches = 0


# ---------------------------------------------------------------------------
# The kernels' plain versions: per output sample, the arm its block's flags
# select, as tensor ops over every sample at once.

def _block_coords(rows_per_blk, H, Wb, dev):
    yy = torch.arange(H, device=dev)[:, None]
    xx = torch.arange(Wb, device=dev)[None, :]
    return yy // rows_per_blk, yy % rows_per_blk, xx >> 3, xx & 7


def mc_luma_plain(flg, pk, band, n_lists):
    """flg [K,BR,BC], pk [K,BR,BC*16] int32, band
    [K,S1*4,ph,pw_b] uint8 -> n_lists x [K, 8*BR, 8*BC] uint8
    (quarter-pel luma per list)."""
    K, BR, BC = flg.shape
    _, nplanes, ph, pwb = band.shape
    dev = flg.device
    r, i, b, c = _block_coords(8, 8 * BR, 8 * BC, dev)
    kk = torch.arange(K, device=dev)[:, None, None]
    f = flg[kk, r, b]                                    # [K, H, Wb]
    odd = (f & _F_PAIRODD) != 0
    b = torch.where(odd, b - 1, b)
    c = torch.where(odd, c + 8, c)
    f = flg[kk, r, b]
    joint = (f & (_F_PAIR | _F_UNIFORM)) != 0
    q = torch.where(joint, 0, ((i >> 2) << 1) | (c >> 2))
    ri = torch.where(joint, i, i & 3)
    ci = torch.where(joint, c, c & 3)
    words = pk.reshape(K, BR, BC, 16)
    flat = band.reshape(-1)

    def sample(plane, wy, wx, on):
        off = ((kk * nplanes + plane) * ph + wy + ri) * pwb + wx + ci
        return flat[torch.where(on, off, 0)].to(I32)

    outs = []
    for l in range(n_lists):
        pka = words[kk, r, b, l * 8 + 2 * q].long()
        pkb = words[kk, r, b, l * 8 + 2 * q + 1].long()
        on = (((f >> l) & 1) == 1) & (pka >= 0)
        sa, sb = (sample(*ld, on) for ld in load_fields(pka, pkb, True))
        v = (sa + sb + 1) >> 1
        outs.append(torch.where(on, v, 0).to(U8))
    return outs


def mc_chroma_plain(flg, pk, band, n_lists):
    """flg [K,BR,BC], pk [K,BR,BC*16] int32 (chroma words),
    band [K,S1,phc,pwc2] uint8 -> n_lists x [K, 4*BR, 8*BC] uint8
    (eighth-pel bilinear, Cb/Cr interleaved)."""
    K, BR, BC = flg.shape
    _, S1, phc, pwc2 = band.shape
    dev = flg.device
    br, i, b, c = _block_coords(4, 4 * BR, 8 * BC, dev)
    kk = torch.arange(K, device=dev)[:, None, None]
    f = flg[kk, br, b]
    uni = (f & _F_UNIFORM) != 0
    q = torch.where(uni, 0, ((i >> 1) << 1) | (c >> 2))
    ri = torch.where(uni, i, i & 1)
    ci = torch.where(uni, c, c & 3)
    words = pk.reshape(K, BR, BC, 16)
    flat = band.reshape(-1)
    outs = []
    for l in range(n_lists):
        pka = words[kk, br, b, l * 8 + 2 * q].long()
        pkb = words[kk, br, b, l * 8 + 2 * q + 1].long()
        on = (((f >> l) & 1) == 1) & (pka >= 0)
        (slot, wy, wx), = load_fields(pka, pkb, False)
        off = ((kk * S1 + slot) * phc + wy + ri) * pwc2 + wx + ci
        off = torch.where(on, off, 0)

        def at(d):
            return flat[off + d].to(I32)

        dx, dy = pkb & 7, (pkb >> 3) & 7
        v = ((8 - dx) * (8 - dy) * at(0) + dx * (8 - dy) * at(2)
             + (8 - dx) * dy * at(pwc2) + dx * dy * at(pwc2 + 2) + 32) >> 6
        outs.append(torch.where(on, v, 0).to(U8))
    return outs


# ---------------------------------------------------------------------------
# Kernel wrappers

def _launch(entry, flg, pk, band, n_lists, out_shape, dims):
    from ..kernels import build
    dev = flg.device
    build.check_args([(flg, flg.shape), (pk, pk.shape)], I32, dev)
    build.check_args([(band, band.shape)], U8, dev)
    outs = [torch.empty(out_shape, dtype=U8, device=dev)
            for _ in range(n_lists)]
    ptr = [ctypes.c_void_p(t.data_ptr()) for t in (flg, pk, band, *outs)]
    if n_lists == 1:
        ptr.append(ctypes.c_void_p(None))
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = getattr(build.lib("mc"), entry)(*ptr, *dims, n_lists,
                                             ctypes.c_void_p(stream))
    build.raise_on(rc, entry)
    return outs


def _check_pk(flg, pk, band):
    K, BR, BC = flg.shape
    if pk.shape != (K, BR, BC * 16) or band.shape[0] != K:
        raise ValueError(f"shapes flg {tuple(flg.shape)} pk "
                         f"{tuple(pk.shape)} band {tuple(band.shape)}")
    return K, BR, BC


def mc_luma(flg, pk, band, n_lists):
    """Quarter-pel luma MC (the contract of mc_luma_plain).  CUDA tensors
    launch `mc.cu:mc_luma`, adding one to `mc_luma.launches`."""
    K, BR, BC = _check_pk(flg, pk, band)
    if flg.device.type == "cpu":
        return mc_luma_plain(flg, pk, band, n_lists)
    _, nplanes, ph, pwb = band.shape
    outs = _launch("e264t_mc_luma", flg, pk, band, n_lists,
                   (K, 8 * BR, 8 * BC), (K, BR, BC, nplanes, ph, pwb))
    mc_luma.launches += 1
    return outs


def mc_chroma(flg, pk, band, n_lists):
    """Eighth-pel chroma MC (the contract of mc_chroma_plain).  CUDA
    tensors launch `mc.cu:mc_chroma`, adding one to
    `mc_chroma.launches`."""
    K, BR, BC = _check_pk(flg, pk, band)
    if flg.device.type == "cpu":
        return mc_chroma_plain(flg, pk, band, n_lists)
    _, S1, phc, pwc2 = band.shape
    outs = _launch("e264t_mc_chroma", flg, pk, band, n_lists,
                   (K, 4 * BR, 8 * BC), (K, BR, BC, S1, phc, pwc2))
    mc_chroma.launches += 1
    return outs


mc_luma.launches = 0
mc_chroma.launches = 0


def run_mc_kernels(flg, pkl, pkc, refL, refC, has_b, mbW, mbH):
    """The luma + chroma MC kernels for all K lanes (params from
    pack_mc_params).  Returns the flat per-list tuple of
    pallas_mc.run_mc_kernels: (y [K,H,W] i32, c [K,H/2,W/2,2] i32) per
    list."""
    K, S1 = refL.shape[:2]
    ph, pw_b = refL.shape[-2:]
    H, W = 16 * mbH, 16 * mbW
    BR, BC = flg.shape[1], flg.shape[3]
    n = 2 if has_b else 1
    flg3 = flg.reshape(K, BR, BC)
    ys = mc_luma(flg3, pkl.reshape(K, BR, BC * 16),
                 refL.reshape(K, S1 * 4, ph, pw_b), n)
    cs = mc_chroma(flg3, pkc.reshape(K, BR, BC * 16), refC, n)
    flat = []
    for yl, cl in zip(ys, cs):
        flat += [yl[:, :, :W].to(I32),
                 cl[:, :, :W].reshape(K, H // 2, W // 2, 2).to(I32)]
    return tuple(flat)


def combine_mc(p, slot_maps, flat, has_b):
    """Weighted-prediction combine of the kernels' per-list planes
    (pallas_mc.combine_mc): combine_mc_plain on CPU tensors,
    combine_mc_cuda (combine.cu) on CUDA tensors."""
    if p["refslot"].device.type == "cpu":
        return combine_mc_plain(p, slot_maps, flat, has_b)
    return combine_mc_cuda(p, flat, has_b)


def combine_args(p, flat, has_b):
    """combine.cu's inputs after the checks, in the C entry's order:
    (mb_flags, refslot, wp, wp8, y0, c0, y1, c1), list 1's None without
    it.  Raises ValueError on a wrong shape, type, device, layout,
    alignment or list count."""
    from ..kernels import build
    flags = p["mb_flags"]
    K, H, W = flags.shape
    if len(flat) != (4 if has_b else 2):
        raise ValueError(f"{len(flat)} per-list planes for has_b={has_b}")
    args = [(flags, (K, H, W)), (p["refslot"], (K, 4 * H, 4 * W, 2)),
            (p["wp"], (K, H, W, 24)), (p["wp8"], (K, 2 * H, 2 * W, 2, 3, 2))]
    for l in range(len(flat) // 2):
        args += [(flat[2 * l], (K, 16 * H, 16 * W)),
                 (flat[2 * l + 1], (K, 8 * H, 8 * W, 2))]
    build.check_tensors(args, I32, flags.device)
    return [t for t, _ in args] + ([] if has_b else [None, None])


def combine_mc_cuda(p, flat, has_b):
    """combine_mc on CUDA tensors: one launch of `kernels/csrc/combine.cu`,
    adding one to `combine_mc_cuda.launches`.  Returns (pred_y, pred_cb,
    pred_cr, mask_y, mask_c) as combine_mc_plain does."""
    from ..kernels import build
    flags = p["mb_flags"]
    dev = flags.device
    build.require_cuda(dev)
    ins = combine_args(p, flat, has_b)
    K, H, W = flags.shape
    pred_y = torch.empty((K, 16 * H, 16 * W), dtype=I32, device=dev)
    pred_cb = torch.empty((K, 8 * H, 8 * W), dtype=I32, device=dev)
    pred_cr = torch.empty_like(pred_cb)
    mask_y = torch.empty(pred_y.shape, dtype=torch.bool, device=dev)
    mask_c = torch.empty(pred_cb.shape, dtype=torch.bool, device=dev)
    outs = [pred_y, pred_cb, pred_cr, mask_y, mask_c]
    build.launch("combine", "e264t_combine", dev, ins + outs, K, W, H)
    combine_mc_cuda.launches += 1
    return tuple(outs)


combine_mc_cuda.launches = 0


def combine_mc_plain(p, slot_maps, flat, has_b):
    """combine_mc in tensor ops."""
    preds = []
    for l in (0, 1) if has_b else (0,):
        used = _mc_meta(p, slot_maps, l)[0]
        yl, ci = flat[2 * l], flat[2 * l + 1]
        preds.append((used, yl, ci[..., 0], ci[..., 1]))
    return _mc_combine(p, preds, has_b)


# ---------------------------------------------------------------------------
# The reference by plain gathers (jaxdec.mc_frame): per 4x4 cell and list,
# two 4x4 window gathers from the luma ring and one 3x3 (both components)
# gather from the chroma ring.  Start indices are clamped as lax.gather's
# CLIP mode clamps them (each window inside the ring).

def _mc_luma_list(refL, sidx, mvx, mvy, gx4, gy4):
    """Luma MC for one list over all 4x4 cells of K frames.  refL
    [K,S1,4,ph,pw_b] uint8 half-pel planes; sidx/mvx/mvy [K,BH,BW] int32;
    gx4/gy4 [BH,BW] cell top-left full-pel coords.  Returns [K,16H,16W]
    int32."""
    K, S1, _, ph, pw_b = refL.shape
    BH, BW = sidx.shape[1:]
    dev = refL.device
    flat = refL.reshape(-1)
    px = (gx4 + (mvx >> 2) + PADL).clamp(0, pw_b - 6)
    py = (gy4 + (mvy >> 2) + PADL).clamp(0, ph - 6)
    sel = _sel_phase6((mvy & 3) * 4 + (mvx & 3))
    lane = torch.arange(K, device=dev).reshape(K, 1, 1) * (S1 * 4)
    r4 = torch.arange(4, device=dev)
    win = (r4[:, None] * pw_b + r4[None, :]).reshape(1, 1, 1, 4, 4)
    acc = None
    for pc, oxc, oyc in ((0, 1, 2), (3, 4, 5)):
        plane = (sidx * 4 + sel[pc]).clamp(0, S1 * 4 - 1)
        y0 = (py + sel[oyc]).clamp(0, ph - 4)
        x0 = (px + sel[oxc]).clamp(0, pw_b - 4)
        base = ((lane + plane).long() * ph + y0) * pw_b + x0
        v = flat[base[..., None, None] + win].to(I32)
        acc = v if acc is None else acc + v + 1
    return (acc >> 1).permute(0, 1, 3, 2, 4).reshape(K, 4 * BH, 4 * BW)


def _mc_chroma_list(refC, sidx, mvx, mvy, gx2, gy2):
    """Chroma MC (bilinear eighth-pel) for one list over all 2x2 chroma
    cells of K frames.  refC [K,S1,phc,2*pwc_pad] uint8 Cb/Cr-interleaved.
    Returns ([K,8H,8W] cb, [K,8H,8W] cr) int32."""
    K, S1, phc, pwc2 = refC.shape
    BH, BW = sidx.shape[1:]
    dev = refC.device
    flat = refC.reshape(-1)
    px = (gx2 + (mvx >> 3) + PADC).clamp(0, pwc2 // 2 - 4)
    py = (gy2 + (mvy >> 3) + PADC).clamp(0, phc - 4)
    slot = (torch.arange(K, device=dev).reshape(K, 1, 1) * S1
            + sidx.clamp(0, S1 - 1))
    base = ((slot.long() * phc + py.clamp(0, phc - 3)) * pwc2
            + (2 * px).clamp(0, pwc2 - 6))
    r3, c6 = torch.arange(3, device=dev), torch.arange(6, device=dev)
    win = (r3[:, None] * pwc2 + c6[None, :]).reshape(1, 1, 1, 3, 6)
    w = flat[base[..., None, None] + win].to(I32)        # [K,BH,BW,3,6]
    w = w.reshape(K, BH, BW, 3, 3, 2).permute(0, 1, 2, 5, 3, 4)
    dx = (mvx & 7)[..., None, None, None]
    dy = (mvy & 7)[..., None, None, None]
    v = ((8 - dx) * (8 - dy) * w[..., 0:2, 0:2]
         + dx * (8 - dy) * w[..., 0:2, 1:3]
         + (8 - dx) * dy * w[..., 1:3, 0:2]
         + dx * dy * w[..., 1:3, 1:3] + 32) >> 6       # [K,BH,BW,2,2,2]
    return [v[:, :, :, comp].permute(0, 1, 3, 2, 4)
            .reshape(K, 2 * BH, 2 * BW) for comp in (0, 1)]


def mc_frame(p, refL, refC, slot_maps, has_b=True):
    """Motion-compensated prediction of K frames by plain gathers:
    jaxdec.mc_frame batched over the lanes.  refL [K,S1,4,ph,pw_b], refC
    [K,S1,phc,2*pwc_pad] uint8 rings; slot_maps [K,32] int32 DPB slot ->
    ring index; has_b False skips list 1.  Returns (pred_y, pred_cb,
    pred_cr, mask_y, mask_c), as combine_mc does: the independent
    reference (no packing, no kernel arms) that the kernels' route is
    held to; no decode path calls it."""
    BH, BW = p["refslot"].shape[1:3]
    dev = refL.device
    gx4 = (torch.arange(BW, dtype=I32, device=dev) * 4)[None, :] \
        .expand(BH, BW)
    gy4 = (torch.arange(BH, dtype=I32, device=dev) * 4)[:, None] \
        .expand(BH, BW)
    preds = []
    for l in (0, 1) if has_b else (0,):
        used, sidx, mvx, mvy = _mc_meta(p, slot_maps, l)
        y = _mc_luma_list(refL, sidx, mvx, mvy, gx4, gy4)
        cb, cr = _mc_chroma_list(refC, sidx, mvx, mvy, gx4 >> 1, gy4 >> 1)
        preds.append((used, y, cb, cr))
    return _mc_combine(p, preds, has_b)


def mc_predict(p, slot_maps, refL, refC, has_b, mbW, mbH):
    """Inter prediction of K frames from their rings ([K,S1,...]): the
    kernels' route (mc.cu on a card, the plain versions on the CPU) at
    every geometry and ring size.  Returns (pred_y, pred_cb, pred_cr,
    mask_y, mask_c)."""
    flg, pkl, pkc = pack_mc_params(p, slot_maps, has_b, mbW, mbH)
    flat = run_mc_kernels(flg, pkl, pkc, refL, refC, has_b, mbW, mbH)
    return combine_mc(p, slot_maps, flat, has_b)
