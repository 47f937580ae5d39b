"""Residual decode: inverse quantisation, 4x4/8x8 inverse transforms and the
DC Hadamards (§8.5), batched over K frames.

Port of `jaxdec.residual_frame` and its helpers.  Every value is int32
and every step is exact integer arithmetic, as in the JAX version; the
lane axis K that JAX added with `vmap` is the leading dimension here.
`residual_frame` runs the plain version (`residual_frame_plain`,
coefficients in plane-major layout [K, 16, BH, BW]) on CPU tensors and
`kernels/csrc/residual.cu` (`residual_cuda`) on CUDA tensors.
"""

from __future__ import annotations

import torch

from .tables import MBF_I16x16, MBF_INTRA, MBF_T8x8, NORM_ADJUST_4x4, \
    NORM_ADJUST_8x8

I32 = torch.int32


def _rep(a, n, dims=(1, 2)):
    """Repeat each element n times along `dims` (default: the two grid
    dims of [K, H, W, ...], per-mb -> per-block or per-cell -> pixels)."""
    for d in dims:
        a = a.repeat_interleave(n, dim=d)
    return a


def _sel_norm(qpm6, table):
    """Row select table[qpm6]: qpm6 [K,H,W] in 0..5, table [6,N] ->
    [K,H,W,N] (JAX used a one-hot matmul to avoid a TPU gather)."""
    return table[qpm6.long()]


def _dequant_planes(coef, ls_mb, s_mb, rep, shift_base):
    """§8.5.12.1 / §8.5.13.1 over stacked planes: coef [K,N,BH,BW],
    ls_mb [K,H,W,N] per-mb scales, s_mb [K,H,W] qp//6; rep is the
    mb -> block expansion.  Returns the N dequantised planes."""
    s = _rep(s_mb, rep)[:, None]
    ls = _rep(ls_mb.permute(0, 3, 1, 2), rep, dims=(2, 3))
    t = coef * ls
    hi = t << (s - shift_base).clamp(min=0)
    lo = (t + (1 << (shift_base - 1 - s).clamp(min=0))) \
        >> (shift_base - s).clamp(min=0)
    d = torch.where(s >= shift_base, hi, lo)
    return list(d.unbind(1))


def _had4(c):
    """H4 @ c @ H4 over [..., 4, 4] (H4 is symmetric, entries +-1)."""
    def rows(x, dim):
        x0, x1, x2, x3 = x.unbind(dim)
        return torch.stack([x0 + x1 + x2 + x3, x0 + x1 - x2 - x3,
                            x0 - x1 - x2 + x3, x0 - x1 + x2 - x3], dim)
    return rows(rows(c, -2), -1)


def _idct4_planes(d):
    """§8.5.12.2 on a list of 16 coefficient planes."""
    rows = []
    for r in range(4):
        d0, d1, d2, d3 = d[4 * r:4 * r + 4]
        e0, e1 = d0 + d2, d0 - d2
        e2, e3 = (d1 >> 1) - d3, d1 + (d3 >> 1)
        rows += [e0 + e3, e1 + e2, e1 - e2, e0 - e3]
    out = []
    for c in range(4):
        f0, f1, f2, f3 = rows[c], rows[4 + c], rows[8 + c], rows[12 + c]
        g0, g1 = f0 + f2, f0 - f2
        g2, g3 = (f1 >> 1) - f3, f1 + (f3 >> 1)
        col = [g0 + g3, g1 + g2, g1 - g2, g0 - g3]
        out.append([(v + 32) >> 6 for v in col])
    return [out[c][r] for r in range(4) for c in range(4)]


def _idct8_planes(d):
    """§8.5.13.2 on 64 coefficient planes."""
    def pass1(x):
        e = [x[0] + x[4],
             -x[3] + x[5] - x[7] - (x[7] >> 1),
             x[0] - x[4],
             x[1] + x[7] - x[3] - (x[3] >> 1),
             (x[2] >> 1) - x[6],
             -x[1] + x[7] + x[5] + (x[5] >> 1),
             x[2] + (x[6] >> 1),
             x[3] + x[5] + x[1] + (x[1] >> 1)]
        f = [e[0] + e[6], e[1] + (e[7] >> 2), e[2] + e[4],
             e[3] + (e[5] >> 2), e[2] - e[4], (e[3] >> 2) - e[5],
             e[0] - e[6], e[7] - (e[1] >> 2)]
        return [f[0] + f[7], f[2] + f[5], f[4] + f[3], f[6] + f[1],
                f[6] - f[1], f[4] - f[3], f[2] - f[5], f[0] - f[7]]

    rows = []
    for r in range(8):
        rows += pass1(d[8 * r:8 * r + 8])
    cols = [pass1([rows[8 * r + c] for r in range(8)]) for c in range(8)]
    return [(cols[c][r] + 32) >> 6 for r in range(8) for c in range(8)]


def _planes_to_pixels(pl, n):
    """n*n coefficient planes [K,BH,BW] -> pixels [K, n*BH, n*BW]."""
    K, BH, BW = pl[0].shape
    a = torch.stack(pl, 1).reshape(K, n, n, BH, BW)
    return a.permute(0, 3, 1, 4, 2).reshape(K, BH * n, BW * n)


def residual_frame(p, sm4, sm8, has_t8=True):
    """All luma + chroma residuals for K frames (the contract of
    residual_frame_plain): residual_frame_plain on CPU tensors,
    residual_cuda (residual.cu) on CUDA tensors."""
    if p["mb_flags"].device.type == "cpu":
        return residual_frame_plain(p, sm4, sm8, has_t8)
    return residual_cuda(p, sm4, sm8, has_t8)


def residual_frame_plain(p, sm4, sm8, has_t8=True):
    """All luma + chroma residuals for K frames, in tensor ops.

    p: stacked int32 plane dict ([K, ...] each); sm4 [K,6,16] / sm8
    [K,6,64] weight-scale matrices.  Returns res_y [K,16H,16W] and
    res_cb, res_cr [K,8H,8W], all int32.  has_t8=False skips the 8x8
    transform (no Transform8x8 macroblock in the batch)."""
    dev = sm4.device
    norm4 = torch.as_tensor(NORM_ADJUST_4x4.reshape(6, 16), device=dev)
    norm8 = torch.as_tensor(NORM_ADJUST_8x8.reshape(6, 64), device=dev)
    flags = p["mb_flags"]
    K, H, W = flags.shape
    intra = (flags & MBF_INTRA) > 0
    i16 = (flags & MBF_I16x16) > 0
    t8 = (flags & MBF_T8x8) > 0

    qpy = p["qp"][..., 0]
    s_mb = qpy // 6

    # ---- luma 4x4 ---------------------------------------------------
    ls4_mb = torch.where(intra[..., None], sm4[:, None, None, 0],
                         sm4[:, None, None, 3]) * _sel_norm(qpy % 6, norm4)
    Cy = p["coef_y"].permute(0, 3, 1, 2)               # [K,16,4H,4W]
    d4 = _dequant_planes(Cy, ls4_mb, s_mb, 4, 4)

    # Intra16x16 DC hadamard (§8.5.10)
    f = _had4(p["coef_y_dc"].reshape(K, H, W, 4, 4))
    ls00 = sm4[:, None, None, 0, 0] * norm4[:, 0][(qpy % 6).long()]
    tdc = f * ls00[..., None, None]
    s = s_mb[..., None, None]
    dchi = tdc << (s - 6).clamp(min=0)
    dclo = (tdc + (1 << (5 - s).clamp(min=0))) >> (6 - s).clamp(min=0)
    dcy = torch.where(s >= 6, dchi, dclo)              # [K,H,W,4,4]
    dcy_blk = dcy.permute(0, 1, 3, 2, 4).reshape(K, 4 * H, 4 * W)
    d4[0] = torch.where(_rep(i16, 4), dcy_blk, d4[0])
    res4 = _planes_to_pixels(_idct4_planes(d4), 4)

    # ---- luma 8x8 (skipped when no mb uses it) ----------------------
    if not has_t8:
        res_y = res4
    else:
        ls8_mb = torch.where(intra[..., None], sm8[:, None, None, 0],
                             sm8[:, None, None, 1]) \
            * _sel_norm(qpy % 6, norm8)
        C8 = p["coef_y8"].permute(0, 3, 1, 2)          # [K,64,2H,2W]
        d8 = _dequant_planes(C8, ls8_mb, s_mb, 2, 6)
        res8 = _planes_to_pixels(_idct8_planes(d8), 8)
        res_y = torch.where(_rep(t8, 16), res8, res4)

    # ---- chroma (4:2:0): 2x2 DC hadamard (§8.5.11) + AC -------------
    res_c = []
    for comp, coef in ((1, p["coef_cb"]), (2, p["coef_cr"])):
        qpc = p["qp"][..., comp]
        lsc_mb = torch.where(intra[..., None], sm4[:, None, None, comp],
                             sm4[:, None, None, comp + 3]) \
            * _sel_norm(qpc % 6, norm4)
        Cc = coef.permute(0, 3, 1, 2)                  # [K,16,2H,2W]
        dc4 = _dequant_planes(Cc, lsc_mb, qpc // 6, 2, 4)
        c00, c01, c10, c11 = p["coef_c_dc"][:, :, :, comp - 1].unbind(-1)
        fdc = torch.stack([
            torch.stack([c00 + c01 + c10 + c11, c00 - c01 + c10 - c11], -1),
            torch.stack([c00 + c01 - c10 - c11, c00 - c01 - c10 + c11], -1),
        ], -2)                                         # [K,H,W,2,2]
        ls00c = sm4[:, None, None, comp, 0] * norm4[:, 0][(qpc % 6).long()]
        dcc = ((fdc * ls00c[..., None, None])
               << (qpc // 6)[..., None, None]) >> 5
        dc4[0] = dcc.permute(0, 1, 3, 2, 4).reshape(K, 2 * H, 2 * W)
        res_c.append(_planes_to_pixels(_idct4_planes(dc4), 4))
    return res_y, res_c[0], res_c[1]


def residual_args(p, sm4, sm8, has_t8):
    """residual.cu's arguments after the checks: ([planes], sm4's and
    sm8's lane strides), the planes in the C entry's order, coef_y8 None
    without the 8x8 transform.  Raises ValueError on a wrong shape, type,
    device, layout or alignment."""
    from ..kernels import build
    K, H, W = p["mb_flags"].shape
    dev = p["mb_flags"].device
    shapes = {"mb_flags": (K, H, W), "qp": (K, H, W, 4),
              "coef_y": (K, 4 * H, 4 * W, 16),
              "coef_y8": (K, 2 * H, 2 * W, 64),
              "coef_y_dc": (K, H, W, 16), "coef_c_dc": (K, H, W, 2, 4),
              "coef_cb": (K, 2 * H, 2 * W, 16),
              "coef_cr": (K, 2 * H, 2 * W, 16)}
    planes = [None if k == "coef_y8" and not has_t8 else p[k]
              for k in shapes]
    build.check_tensors([(t, shapes[k]) for k, t in zip(shapes, planes)
                         if t is not None], I32, dev)
    s4 = build.lane_stride(sm4, (K, 6, 16), I32, dev)
    s8 = build.lane_stride(sm8, (K, 6, 64), I32, dev) if has_t8 else 0
    return planes, s4, s8


def residual_cuda(p, sm4, sm8, has_t8=True):
    """residual_frame on CUDA tensors: one launch of
    `kernels/csrc/residual.cu`, adding one to `residual_cuda.launches`."""
    from ..kernels import build
    K, H, W = p["mb_flags"].shape
    dev = p["mb_flags"].device
    build.require_cuda(dev)
    planes, s4, s8 = residual_args(p, sm4, sm8, has_t8)
    res_y = torch.empty((K, 16 * H, 16 * W), dtype=I32, device=dev)
    res_cb = torch.empty((K, 8 * H, 8 * W), dtype=I32, device=dev)
    res_cr = torch.empty_like(res_cb)
    build.launch("residual", "e264t_residual", dev,
                 planes + [sm4, sm8 if has_t8 else None, res_y, res_cb,
                           res_cr], K, W, H, s4, s8, int(bool(has_t8)))
    residual_cuda.launches += 1
    return res_y, res_cb, res_cr


residual_cuda.launches = 0
