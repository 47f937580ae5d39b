"""In-loop deblocking (§8.7), batched over K frames: boundary strengths, the
plain wavefront scan, the wrapper that launches the CUDA kernel, and the
post-deblock concealment blend.

Ports of `jaxdec.deblock_bs` (`deblock_bs` runs the plain
`deblock_bs_plain` on CPU tensors and `kernels/csrc/bs.cu` on CUDA
tensors), `jaxdec.deblock_scan` (with `_filter_luma_lines` /
`_filter_chroma_lines`), of `pallas_deblock.deblock_pallas_batch`'s role
(`deblock_batch` runs `kernels/csrc/deblock.cu` on CUDA tensors and the
plain `deblock_scan` on CPU tensors) and of `jaxdec.blend_recovered`
(plain PyTorch on every device, as it is XLA in the JAX package).
"""

from __future__ import annotations

import ctypes

import torch

from .intra import _shear_plane, _shear_tiles, _shift_my, _unshear_tiles, \
    _wave_index
from .residual import _rep
from .tables import ALPHA, BETA, DBF_INNER, DBF_LEFT, DBF_TOP, MBF_BLEND, \
    MBF_INTRA, MBF_T8x8, TC0

I32 = torch.int32


def deblock_bs(p):
    """Boundary strengths of every 4x4 block's left edge (bs_v) and top
    edge (bs_h), [K, 4mbH, 4mbW] int32 each (§8.7.2.1):
    deblock_bs_plain on CPU tensors, deblock_bs_cuda (bs.cu) on CUDA
    tensors."""
    if p["mb_flags"].device.type == "cpu":
        return deblock_bs_plain(p)
    return deblock_bs_cuda(p)


def bs_args(p):
    """bs.cu's planes after the checks (flags, nz_y, refslot, mvs), in the
    C entry's order.  Raises ValueError on a wrong shape, type, device,
    layout or alignment."""
    from ..kernels import build
    flags = p["mb_flags"]
    K, H, W = flags.shape
    args = [(flags, (K, H, W)), (p["nz_y"], (K, 4 * H, 4 * W)),
            (p["refslot"], (K, 4 * H, 4 * W, 2)),
            (p["mvs"], (K, 4 * H, 4 * W, 2, 2))]
    build.check_tensors(args, I32, flags.device)
    return [t for t, _ in args]


def deblock_bs_cuda(p):
    """deblock_bs on CUDA tensors: one launch of `kernels/csrc/bs.cu`,
    adding one to `deblock_bs_cuda.launches`."""
    from ..kernels import build
    flags = p["mb_flags"]
    dev = flags.device
    build.require_cuda(dev)
    planes = bs_args(p)
    K, H, W = flags.shape
    bs_v = torch.empty((K, 4 * H, 4 * W), dtype=I32, device=dev)
    bs_h = torch.empty_like(bs_v)
    build.launch("bs", "e264t_bs", dev, planes + [bs_v, bs_h], K, W, H)
    deblock_bs_cuda.launches += 1
    return bs_v, bs_h


deblock_bs_cuda.launches = 0


def deblock_bs_plain(p):
    """deblock_bs in tensor ops (the neighbours by torch.roll, so column
    and row 0 compare with the last)."""
    flags = p["mb_flags"]
    intra_blk = _rep((flags & MBF_INTRA) > 0, 4)
    nz = p["nz_y"] > 0
    # transform_size_8x8 mbs: the 8x8 block's flag covers all 4 cells
    K, BH, BW = nz.shape
    nz8 = nz.reshape(K, BH // 2, 2, BW // 2, 2).any(4).any(2)
    nz = torch.where(_rep((flags & MBF_T8x8) > 0, 4), _rep(nz8, 2), nz)
    rs0, rs1 = p["refslot"][..., 0], p["refslot"][..., 1]
    m0x, m0y = p["mvs"][..., 0, 0], p["mvs"][..., 0, 1]
    m1x, m1y = p["mvs"][..., 1, 0], p["mvs"][..., 1, 1]
    u0, u1 = rs0 >= 0, rs1 >= 0
    cnt = u0.to(I32) + u1.to(I32)
    r0 = torch.where(u0, rs0, 99)
    r1 = torch.where(u1, rs1, 99)
    lo, hi = torch.minimum(r0, r1), torch.maximum(r0, r1)
    sx = torch.where(u0, m0x, m1x)
    sy = torch.where(u0, m0y, m1y)
    gbx = torch.arange(BW, device=nz.device)[None, None, :]
    gby = torch.arange(BH, device=nz.device)[None, :, None]

    def far(ax, ay, bx, by):
        return ((ax - bx).abs() >= 4) | ((ay - by).abs() >= 4)

    def one_dir(dim):
        def sh(a):
            return torch.roll(a, 1, dim)
        mb_edge = (gbx % 4 == 0) if dim == 2 else (gby % 4 == 0)
        intra_e = intra_blk | sh(intra_blk)
        nz_e = nz | sh(nz)
        refs_diff = (sh(cnt) != cnt) | (sh(lo) != lo) | (sh(hi) != hi)
        p0x, p0y, p1x, p1y = sh(m0x), sh(m0y), sh(m1x), sh(m1y)
        f_single = far(sh(sx), sh(sy), sx, sy)
        c0 = sh(rs0) == rs0
        q0x = torch.where(c0, m0x, m1x)
        q0y = torch.where(c0, m0y, m1y)
        q1x = torch.where(c0, m1x, m0x)
        q1y = torch.where(c0, m1y, m0y)
        f_bi_distinct = far(p0x, p0y, q0x, q0y) | far(p1x, p1y, q1x, q1y)
        pair_a = ~far(p0x, p0y, m0x, m0y) & ~far(p1x, p1y, m1x, m1y)
        pair_b = ~far(p0x, p0y, m1x, m1y) & ~far(p1x, p1y, m0x, m0y)
        f_bi = torch.where(sh(rs0) != sh(rs1), f_bi_distinct,
                           ~(pair_a | pair_b))
        f_mv = torch.where(sh(cnt) == 1, f_single, f_bi)
        bs_mv = (refs_diff | f_mv).to(I32)
        return torch.where(intra_e, torch.where(mb_edge, 4, 3),
                           torch.where(nz_e, 2, bs_mv)).to(I32)

    return one_dir(2), one_dir(1)


def _clip(v, lo, hi):
    return torch.minimum(torch.maximum(v, lo), hi)


def _filter_luma_lines(S, alpha, beta, bs, tc0, active, axis=-1):
    """§8.7.2.3/.4 on S = [p3..p0, q0..q3] per line, sample index along
    `axis` (-1: [..., n, 8], -2: [..., 8, n]).  alpha/beta [...],
    bs/tc0/active [..., n].  Returns the 6 middle samples' new values
    (p2 p1 p0 q0 q1 q2) along the same axis."""
    p3, p2, p1, p0, q0, q1, q2, q3 = S.unbind(axis)
    al, be = alpha[..., None], beta[..., None]
    filt = active & (bs > 0) & ((p0 - q0).abs() < al) & \
        ((p1 - p0).abs() < be) & ((q1 - q0).abs() < be)
    ap = (p2 - p0).abs() < be
    aq = (q2 - q0).abs() < be
    # strong (bS=4)
    lim = (al >> 2) + 2
    sp = ap & ((p0 - q0).abs() < lim)
    sq = aq & ((p0 - q0).abs() < lim)
    sp0 = torch.where(sp, (p2 + 2 * p1 + 2 * p0 + 2 * q0 + q1 + 4) >> 3,
                      (2 * p1 + p0 + q1 + 2) >> 2)
    sp1 = torch.where(sp, (p2 + p1 + p0 + q0 + 2) >> 2, p1)
    sp2 = torch.where(sp, (2 * p3 + 3 * p2 + p1 + p0 + q0 + 4) >> 3, p2)
    sq0 = torch.where(sq, (q2 + 2 * q1 + 2 * q0 + 2 * p0 + p1 + 4) >> 3,
                      (2 * q1 + q0 + p1 + 2) >> 2)
    sq1 = torch.where(sq, (q2 + q1 + q0 + p0 + 2) >> 2, q1)
    sq2 = torch.where(sq, (2 * q3 + 3 * q2 + q1 + q0 + p0 + 4) >> 3, q2)
    # soft (bS<4)
    tc = tc0 + ap.to(I32) + aq.to(I32)
    delta = _clip((((q0 - p0) << 2) + (p1 - q1) + 4) >> 3, -tc, tc)
    wp0 = (p0 + delta).clamp(0, 255)
    wq0 = (q0 - delta).clamp(0, 255)
    avg = (p0 + q0 + 1) >> 1
    wp1 = torch.where(ap, p1 + _clip((p2 + avg - 2 * p1) >> 1, -tc0, tc0),
                      p1)
    wq1 = torch.where(aq, q1 + _clip((q2 + avg - 2 * q1) >> 1, -tc0, tc0),
                      q1)
    s4 = bs == 4
    out = torch.stack([torch.where(s4, sp2, p2), torch.where(s4, sp1, wp1),
                       torch.where(s4, sp0, wp0), torch.where(s4, sq0, wq0),
                       torch.where(s4, sq1, wq1), torch.where(s4, sq2, q2)],
                      axis)
    mid = S.narrow(axis, 1, 6)
    return torch.where(filt.unsqueeze(axis), out, mid)


def _filter_chroma_lines(S, alpha, beta, bs, tc0, active, axis=-1):
    """Chroma: S = [p1 p0 q0 q1] along `axis`; returns the 2 middle
    samples."""
    p1, p0, q0, q1 = S.unbind(axis)
    al, be = alpha[..., None], beta[..., None]
    filt = active & (bs > 0) & ((p0 - q0).abs() < al) & \
        ((p1 - p0).abs() < be) & ((q1 - q0).abs() < be)
    sp0 = (2 * p1 + p0 + q1 + 2) >> 2
    sq0 = (2 * q1 + q0 + p1 + 2) >> 2
    tc = tc0 + 1
    delta = _clip((((q0 - p0) << 2) + (p1 - q1) + 4) >> 3, -tc, tc)
    wp0 = (p0 + delta).clamp(0, 255)
    wq0 = (q0 - delta).clamp(0, 255)
    s4 = bs == 4
    out = torch.stack([torch.where(s4, sp0, wp0),
                       torch.where(s4, sq0, wq0)], axis)
    return torch.where(filt.unsqueeze(axis), out, S.narrow(axis, 1, 2))


def deblock_scan(y, cb, cr, p, bs_v, bs_h, mbW, mbH):
    """The plain version: the deblocking filter in wavefront order over
    sheared tiles (per mb V edges then H edges, §8.7).  y [K,16mbH,16mbW],
    cb/cr [K,8mbH,8mbW] int32; returns new (y, cb, cr).

    The step at wave w filters the tiles X of wave w against a rolling
    carry A (wave w-1, left neighbours) and B (wave w-2, top neighbours);
    V-edge 0 writes into A's last 3 columns and H-edge 0 into B's last 3
    rows, and B leaves the loop final (its last writer is this step)."""
    dev = y.device
    K = y.shape[0]
    alpha_t = torch.as_tensor(ALPHA, device=dev)
    beta_t = torch.as_tensor(BETA, device=dev)
    tc0_t = torch.as_tensor(TC0, device=dev)
    T = mbW + 2 * mbH
    _, _, val_t = _wave_index(T, mbW, mbH, dev)          # [T, mbH]

    Xy_t = _shear_tiles(y, mbW, mbH, 16)
    Xcb_t = _shear_tiles(cb, mbW, mbH, 8)
    Xcr_t = _shear_tiles(cr, mbW, mbH, 8)
    bsv_t = _shear_tiles(bs_v, mbW, mbH, 4)              # [T,K,mbH,seg,e]
    bsh_t = _shear_tiles(bs_h, mbW, mbH, 4)              # [T,K,mbH,e,seg]
    qp_t = _shear_plane(p["qp"], mbW, mbH)               # [T,K,mbH,4]
    qpl_t = torch.cat([torch.zeros_like(qp_t[:1]), qp_t[:-1]], 0)
    qpt_t = torch.cat([torch.zeros_like(qp_t[:2]), qp_t[:-2]], 0)
    qpt_t = torch.cat([torch.zeros_like(qpt_t[:, :, :1]),
                       qpt_t[:, :, :-1]], 2)
    db_t = _shear_plane(p["deblock"], mbW, mbH)
    ab_t = _shear_plane(p["deblock_ab"], mbW, mbH)
    t8_t = _shear_plane((p["mb_flags"] & MBF_T8x8) > 0, mbW, mbH)

    def tc0_sel(bs, ia):
        t3 = tc0_t[:, ia][..., None]                     # [3, K, mbH, 1]
        return torch.where(bs == 0, 0, torch.where(
            bs == 1, t3[0], torch.where(bs == 2, t3[1], t3[2])))

    z_y = torch.zeros((K, mbH, 16, 16), dtype=I32, device=dev)
    z_c = torch.zeros((K, mbH, 8, 8), dtype=I32, device=dev)
    A_y, A_cb, A_cr, B_y, B_cb, B_cr = z_y, z_c, z_c, z_y, z_c, z_c
    ey, ecb, ecr = [], [], []
    for w in range(T):
        Xy, Xcb, Xcr = Xy_t[w], Xcb_t[w], Xcr_t[w]
        bsv, bsh = bsv_t[w], bsh_t[w]
        qpo, qpl, qpt = qp_t[w], qpl_t[w], qpt_t[w]
        db, ab, t8 = db_t[w], ab_t[w], t8_t[w]
        val = val_t[w][None, :]
        offA, offB = ab[..., 0], ab[..., 1]
        Bts_y, Bts_cb, Bts_cr = _shift_my(B_y), _shift_my(B_cb), \
            _shift_my(B_cr)

        def edge_params(qpp, qpq, comp_bs, act, nseg):
            avg = (qpp + qpq + 1) >> 1
            ia = (avg + offA).clamp(0, 51).long()
            ib = (avg + offB).clamp(0, 51).long()
            bs = comp_bs.repeat_interleave(nseg // 4, -1)
            actm = act[..., None].expand(act.shape + (nseg,))
            return alpha_t[ia], beta_t[ib], bs, tc0_sel(bs, ia), actm

        def act_of(e, edge_bit):
            if e == 0:
                return val & ((db & edge_bit) > 0)
            act = val & ((db & DBF_INNER) > 0)
            return act & ~t8 if e % 2 else act

        # ---- luma V edges ----------------------------------------------
        W = torch.cat([A_y[..., 12:16], Xy], -1)
        for e in range(4):
            qpp = qpl[..., 0] if e == 0 else qpo[..., 0]
            alpha, beta, bs, tc0, actm = edge_params(
                qpp, qpo[..., 0], bsv[..., e], act_of(e, DBF_LEFT), 16)
            W[..., 4 * e + 1:4 * e + 7] = _filter_luma_lines(
                W[..., 4 * e:4 * e + 8], alpha, beta, bs, tc0, actm)
        A_y = A_y.clone()
        A_y[..., 13:16] = W[..., 1:4]
        Xy = W[..., 4:20]

        # ---- chroma V edges --------------------------------------------
        new_c = []
        for comp, (A_c, X_c) in enumerate(((A_cb, Xcb), (A_cr, Xcr)), 1):
            Wc = torch.cat([A_c[..., 6:8], X_c], -1)
            for e in (0, 2):
                qpp = qpl[..., comp] if e == 0 else qpo[..., comp]
                alpha, beta, bs, tc0, actm = edge_params(
                    qpp, qpo[..., comp], bsv[..., e],
                    act_of(0 if e == 0 else 2, DBF_LEFT), 8)
                Wc[..., 2 * e + 1:2 * e + 3] = _filter_chroma_lines(
                    Wc[..., 2 * e:2 * e + 4], alpha, beta, bs, tc0, actm)
            A_c = A_c.clone()
            A_c[..., 6:8] = Wc[..., 0:2]
            new_c.append((A_c, Wc[..., 2:10]))
        (A_cb, Xcb), (A_cr, Xcr) = new_c

        # ---- luma H edges ----------------------------------------------
        V = torch.cat([Bts_y[..., 12:16, :], Xy], -2)
        for e in range(4):
            qpp = qpt[..., 0] if e == 0 else qpo[..., 0]
            alpha, beta, bs, tc0, actm = edge_params(
                qpp, qpo[..., 0], bsh[..., e, :], act_of(e, DBF_TOP), 16)
            V[..., 4 * e + 1:4 * e + 7, :] = _filter_luma_lines(
                V[..., 4 * e:4 * e + 8, :], alpha, beta, bs, tc0, actm,
                axis=-2)
        Bts_y = Bts_y.clone()
        Bts_y[..., 13:16, :] = V[..., 1:4, :]
        Xy = V[..., 4:20, :]

        # ---- chroma H edges --------------------------------------------
        new_c = []
        for comp, (Bts_c, X_c) in enumerate(((Bts_cb, Xcb),
                                             (Bts_cr, Xcr)), 1):
            Vc = torch.cat([Bts_c[..., 6:8, :], X_c], -2)
            for e in (0, 2):
                qpp = qpt[..., comp] if e == 0 else qpo[..., comp]
                alpha, beta, bs, tc0, actm = edge_params(
                    qpp, qpo[..., comp], bsh[..., e, :],
                    act_of(0 if e == 0 else 2, DBF_TOP), 8)
                Vc[..., 2 * e + 1:2 * e + 3, :] = _filter_chroma_lines(
                    Vc[..., 2 * e:2 * e + 4, :], alpha, beta, bs, tc0, actm,
                    axis=-2)
            Bts_c = Bts_c.clone()
            Bts_c[..., 6:8, :] = Vc[..., 0:2, :]
            new_c.append((Bts_c, Vc[..., 2:10, :]))
        (Bts_cb, Xcb), (Bts_cr, Xcr) = new_c

        ey.append(torch.cat([Bts_y[:, 1:], B_y[:, -1:]], 1))
        ecb.append(torch.cat([Bts_cb[:, 1:], B_cb[:, -1:]], 1))
        ecr.append(torch.cat([Bts_cr[:, 1:], B_cr[:, -1:]], 1))
        A_y, A_cb, A_cr, B_y, B_cb, B_cr = Xy, Xcb, Xcr, A_y, A_cb, A_cr
    return (_unshear_tiles(torch.stack(ey), mbW, mbH, 16),
            _unshear_tiles(torch.stack(ecb), mbW, mbH, 8),
            _unshear_tiles(torch.stack(ecr), mbW, mbH, 8))


def deblock_batch(y, cb, cr, p, bs_v, bs_h, mbW, mbH):
    """Deblock K frames.  CPU tensors: the plain `deblock_scan`.  CUDA
    tensors: `kernels/csrc/deblock.cu`, which filters y, cb and cr IN
    PLACE (the frames are the step's own intermediates, as JAX donated
    them) and returns them.  Every launch adds one to
    `deblock_batch.launches`."""
    if y.device.type == "cpu":
        return deblock_scan(y, cb, cr, p, bs_v, bs_h, mbW, mbH)
    from ..kernels import build
    K = y.shape[0]
    H, W = 16 * mbH, 16 * mbW
    args = [(y, (K, H, W)), (cb, (K, H // 2, W // 2)),
            (cr, (K, H // 2, W // 2)), (p["qp"], (K, mbH, mbW, 4)),
            (p["deblock"], (K, mbH, mbW)),
            (p["deblock_ab"], (K, mbH, mbW, 2)),
            (p["mb_flags"], (K, mbH, mbW)), (bs_v, (K, 4 * mbH, 4 * mbW)),
            (bs_h, (K, 4 * mbH, 4 * mbW))]
    build.check_args(args, torch.int32, y.device)
    # progress[K*mbH] row counters, then the row ticket: zeroed per call
    scratch = torch.zeros(K * mbH + 1, dtype=torch.int32, device=y.device)
    with torch.cuda.device(y.device):
        stream = torch.cuda.current_stream(y.device).cuda_stream
        rc = build.lib("deblock").e264t_deblock(
            *[ctypes.c_void_p(t.data_ptr()) for t, _ in args],
            ctypes.c_void_p(scratch.data_ptr()), K, mbW, mbH,
            ctypes.c_void_p(stream))
    build.raise_on(rc, "deblock")
    deblock_batch.launches += 1
    return y, cb, cr


deblock_batch.launches = 0


def blend_recovered(y, cb, cr, p):
    """Post-deblock blend of erroneous I mbs toward their neighbour-edge DC,
    weighted by the graded error probability (recover_slice's I path,
    edge264_headers.c:316-396), for K frames: y [K,16mbH,16mbW], cb/cr
    [K,8mbH,8mbW] int32, p stacked.  As in the JAX package, neighbour
    samples are read PRE-blend so all mbs blend in one pass (the reference
    blends in raster order, reading already-blended neighbours)."""
    bl = (p["mb_flags"] & MBF_BLEND) > 0          # [K, mbH, mbW]
    sid = p["slice_id"]
    w = (p["mb_errors"] * 128 // 100).clamp(0, 128)

    def shl(a, fill):
        return torch.cat([torch.full_like(a[..., :1], fill), a[..., :-1]], -1)

    def shu(a, fill):
        return torch.cat([torch.full_like(a[..., :1, :], fill),
                          a[..., :-1, :]], -2)

    # a neighbour supplies DC only if it was recovered by the same slice
    # (reference: i==0 / i<pic_width exclusions, :326-329)
    availA = bl & shl(bl, False) & (sid == shl(sid, -1))
    availB = bl & shu(bl, False) & (sid == shu(sid, -1))

    def one(img, ts):
        K, H, W = img.shape
        mh, mw = H // ts, W // ts
        dev = img.device
        cols = (torch.arange(mw, device=dev) * ts - 1).clamp(0, W - 1)
        lsum = img[:, :, cols].reshape(K, mh, ts, mw).sum(2, dtype=I32)
        rows = (torch.arange(mh, device=dev) * ts - 1).clamp(0, H - 1)
        tsum = img[:, rows].reshape(K, mh, mw, ts).sum(3, dtype=I32)
        none_sum = torch.full_like(lsum, ts * 128)
        l = torch.where(availA, lsum, torch.where(availB, tsum, none_sum))
        t = torch.where(availB, tsum, torch.where(availA, lsum, none_sum))
        # rounded mean of the 2*ts edge samples
        dc = (l + t + ts) >> ts.bit_length()

        def rep(a):
            return a.repeat_interleave(ts, 1).repeat_interleave(ts, 2)
        wm, dcm = rep(w), rep(dc)
        mixed = torch.where(wm >= 128, dcm,
                            (img * (128 - wm) + dcm * wm) >> 7)
        return torch.where(rep(bl), mixed, img)

    return one(y, 16), one(cb, 8), one(cr, 8)
