"""Intra reconstruction of K frames: the plain wavefront scan, the
sparse-intra level rounds, the level-gather scan, and the wrapper that
launches the CUDA kernel.

Ports of `jaxdec.intra_scan_sheared` with its weight matrices
(`_mk_dir_w`, `_dir_matmul`) and the sheared-layout helpers
(`_shear_tiles`, `_unshear_tiles`, `_shear_plane`, shared with the
deblocking scan), of `jaxdec.intra_round_plane` / `jaxdec.intra_rounds`,
of `jaxdec.intra_level_tables` / `jaxdec.intra_scan` (the CPU
single-frame path's route for intra-sparse frames, an algorithm of its
own: gathers and masked scatters of each level's mbs), and of
`pallas_intra.intra_pallas_batch`'s role: `intra_batch` runs
`kernels/csrc/intra.cu` on CUDA tensors and the plain
`intra_scan_sheared` on CPU tensors.

Which runs where (ops/frame._intra_dispatch): on a card every frame or
step with intra work takes `intra.cu`, whatever its route's name; the
plain versions below run on the CPU only, where `intra_rounds` (the
lockstep's intra-sparse P/B steps) and `intra_scan` (the single-frame
path's intra-sparse frames) follow the JAX package's own CPU routes.

Both plain versions reconstruct batches of macroblock tiles whose causal
neighbours (left, top-left, top, top-right) are already final, through
one shared routine (`_recon`):
- `intra_scan_sheared`: macroblock (mx, my) sits on wave w = mx + 2*my;
  the macroblocks of one wave are independent, so each wave is one batch
  of [K, mbH] tiles and the Python loop over waves takes the place of
  `lax.scan`.  The loop carries the tiles of waves w-1 (left and
  top-right neighbours), w-2 (top) and w-3 (top-left).
- `intra_rounds`: for intra-sparse frames, round r reconstructs every
  intra macroblock of dependency depth r at once over the whole frame
  (an intra macroblock waits only on intra neighbours; inter ones are
  final before intra starts).

Directional prediction for all modes is one matmul against the probed
weight matrices.  It runs in float64: every product and sum is an
integer below 2^24, so the result is exact whatever the TF32 settings.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from .tables import BLK4_X, BLK4_Y, CH_DIR_IDX, I4_IDX, I8_FILT_IDX, \
    I8_IDX, I16_DIR_IDX, MBF_I16x16, MBF_INTRA, MBF_IPCM, MBF_T8x8

I32 = torch.int32

# I16 plane-mode index vectors into nb33 (l[i]=15-i, tl=16, t[j]=17+j);
# the t[-1]/l[-1] -> tl substitutions fall out of the arithmetic.
_I16_HP = np.arange(25, 33)          # t[8+x]
_I16_HM = 23 - np.arange(8)          # t[6-x] (x=7 -> tl)
_I16_VP = 7 - np.arange(8)           # l[8+y]
_I16_VM = 9 + np.arange(8)           # l[6-y] (y=7 -> tl)
_CH_HP = 13 + np.arange(4)           # t[4+x]
_CH_HM = 11 - np.arange(4)           # t[2-x] (x=3 -> tl)
_CH_VP = 3 - np.arange(4)            # l[4+y]
_CH_VM = 5 + np.arange(4)            # l[2-y] (y=3 -> tl)


def _mk_dir_w(idx, ntap):
    """Directional-mode tap triples -> dense weight matrix [nm*npx, ntap+1]
    (last column = rounding bias) so prediction for every mode is ONE
    matmul: pred = (nb1 @ W.T) >> 2."""
    nm, npx, _ = idx.shape
    W = np.zeros((nm * npx, ntap + 1), np.float32)
    for m in range(nm):
        for pp in range(npx):
            i0, i1, i2 = idx[m, pp]
            W[m * npx + pp, i0] += 1
            W[m * npx + pp, i1] += 2
            W[m * npx + pp, i2] += 1
            W[m * npx + pp, ntap] += 2
    return W


_W4 = _mk_dir_w(I4_IDX, 13)            # [144, 14]
_W8 = _mk_dir_w(I8_IDX, 25)            # [576, 26]
_W16 = _mk_dir_w(I16_DIR_IDX, 33)      # [512, 34]
_WCH = _mk_dir_w(CH_DIR_IDX, 17)       # [128, 18]
_WF8 = _mk_dir_w(I8_FILT_IDX[None], 25)  # [25, 26] §8.3.2.2.1 lowpass


def _dense(nb, Wt):
    """(nb | 1) @ Wt in float64 -> int32; nb [..., ntap] int32,
    Wt [ntap+1, n] float64."""
    one = torch.ones_like(nb[..., :1])
    nb1 = torch.cat([nb, one], -1).to(torch.float64)
    return (nb1 @ Wt).to(I32)


def _dir_matmul(nb, Wt, mode, nm, npx):
    """nb [..., ntap] int32, mode [...] -> directional prediction
    [..., npx]: one matmul, then the mode's row of predictions (0 for a
    mode outside 0..nm-1, as JAX's one-hot contraction gives)."""
    preds = _dense(nb, Wt).reshape(nb.shape[:-1] + (nm, npx))
    idx = mode.clamp(0, nm - 1).long()[..., None, None] \
        .expand(mode.shape + (1, npx))
    sel = preds.gather(-2, idx)[..., 0, :]
    return torch.where(((mode >= 0) & (mode < nm))[..., None], sel, 0) >> 2


def _plane_sums(nb, idx_p, idx_m, n):
    w = torch.arange(1, n + 1, dtype=I32, device=nb.device)
    return ((nb[..., idx_p] - nb[..., idx_m]) * w).sum(-1, dtype=I32)


# ---------------------------------------------------------------------------
# Sheared layout: the tile of macroblock (mx, my) lands at wave mx + 2*my.

def _wave_index(T, mbW, mbH, device):
    w = torch.arange(T, device=device)[:, None]
    my = torch.arange(mbH, device=device)[None, :]
    mx = w - 2 * my
    valid = (mx >= 0) & (mx < mbW)
    return my.expand(T, mbH), mx.clamp(0, mbW - 1), valid


def _shear_tiles(img, mbW, mbH, ts, extra=2):
    """Dense [K, ts*mbH, ts*mbW] -> sheared [NW+extra, K, mbH, ts, ts]
    (zeros where no macroblock sits)."""
    K = img.shape[0]
    T = mbW + 2 * mbH - 2 + extra
    tiles = img.reshape(K, mbH, ts, mbW, ts).permute(0, 1, 3, 2, 4)
    my, mx, valid = _wave_index(T, mbW, mbH, img.device)
    out = tiles[:, my, mx] * valid[None, :, :, None, None]
    return out.transpose(0, 1).contiguous()


def _unshear_tiles(t, mbW, mbH, ts, shift=2):
    """Inverse of _shear_tiles for tiles emitted with a wave delay:
    [T, K, mbH, ts, ts] -> [K, mbH*ts, mbW*ts]."""
    K = t.shape[1]
    my = torch.arange(mbH, device=t.device)[:, None]
    mx = torch.arange(mbW, device=t.device)[None, :]
    d = t.transpose(0, 1)[:, mx + 2 * my + shift, my]  # [K,mbH,mbW,ts,ts]
    return d.permute(0, 1, 3, 2, 4).reshape(K, mbH * ts, mbW * ts)


def _shear_plane(pl, mbW, mbH, extra=2):
    """[K, mbH, mbW, ...] per-mb data -> [NW+extra, K, mbH, ...]."""
    T = mbW + 2 * mbH - 2 + extra
    my, mx, valid = _wave_index(T, mbW, mbH, pl.device)
    out = pl[:, my, mx]                                  # [K, T, mbH, ...]
    valid = valid.reshape((1, T, mbH) + (1,) * (out.ndim - 3))
    out = torch.where(valid, out, torch.zeros_like(out))
    return out.transpose(0, 1).contiguous()


def _shift_my(t):
    """Lane my takes lane my-1's tile (zeros for my = 0): [K, mbH, ...]."""
    return torch.cat([torch.zeros_like(t[:, :1]), t[:, :-1]], 1)


def _sel3(c1, a, c2, b, c):
    """where(c1, a, where(c2, b, c)): the DC rules' selection chains."""
    return torch.where(c1, a, torch.where(c2, b, c))


def _dc3(aA, aB, sboth, sl, st, shift):
    """DC with availability: both / left only / top only / 128."""
    both = (aA & aB) > 0
    return torch.where(both, (sboth + (1 << (shift - 1))) >> shift,
                       torch.where(aA > 0, (sl + (1 << (shift - 2)))
                                   >> (shift - 1),
                                   torch.where(aB > 0,
                                               (st + (1 << (shift - 2)))
                                               >> (shift - 1),
                                               torch.full_like(sl, 128))))


def _i8_edges(nb, nbf, aA, aB, aD):
    """Intra_8x8's reference filter (§8.3.2.2.1) finished: nbf, the
    3-tap lowpass of the neighbours nb [..., 25] (l[7..0], tl, t[0..15]),
    gets its corner and edge-end patches in place, then the unfiltered
    samples back on a side whose edge is unavailable."""
    l0, t0, t1, l1 = nb[..., 7], nb[..., 9], nb[..., 10], nb[..., 6]
    tl0 = nb[..., 8]
    nbf[..., 9] = torch.where(aD > 0, (tl0 + 2 * t0 + t1 + 2) >> 2,
                              (3 * t0 + t1 + 2) >> 2)
    nbf[..., 7] = torch.where(aD > 0, (tl0 + 2 * l0 + l1 + 2) >> 2,
                              (3 * l0 + l1 + 2) >> 2)
    nbf[..., 8] = torch.where(
        aD == 0, tl0,
        _sel3((aA & aB) > 0, (t0 + 2 * tl0 + l0 + 2) >> 2,
              aB > 0, (3 * tl0 + t0 + 2) >> 2,
              torch.where(aA > 0, (3 * tl0 + l0 + 2) >> 2, tl0)))
    nbf = torch.where((aB > 0)[..., None], nbf,
                      torch.cat([nbf[..., :9], nb[..., 9:]], -1))
    return torch.where((aA > 0)[..., None], nbf,
                       torch.cat([nb[..., :8], nbf[..., 8:]], -1))


def _chroma_dc(t, l, aA, aB, xx8, yy8):
    """Chroma DC prediction [..., 64] (raster 8x8, sample x = xx8, y =
    yy8) from the top / left neighbours t, l [..., 8] (zeros where
    unavailable): each 4x4 quadrant's own rule."""
    both, onlyA, onlyB = (aA & aB) > 0, aA > 0, aB > 0
    ts0, ts1 = t[..., :4].sum(-1, dtype=I32), t[..., 4:].sum(-1, dtype=I32)
    ls0, ls1 = l[..., :4].sum(-1, dtype=I32), l[..., 4:].sum(-1, dtype=I32)
    g128 = torch.full_like(ts0, 128)
    q00 = _sel3(both, (ts0 + ls0 + 4) >> 3, onlyA, (ls0 + 2) >> 2,
                torch.where(onlyB, (ts0 + 2) >> 2, g128))
    q01 = _sel3(onlyB, (ts1 + 2) >> 2, onlyA, (ls0 + 2) >> 2, g128)
    q10 = _sel3(onlyA, (ls1 + 2) >> 2, onlyB, (ts0 + 2) >> 2, g128)
    q11 = _sel3(both, (ts1 + ls1 + 4) >> 3, onlyA, (ls1 + 2) >> 2,
                torch.where(onlyB, (ts1 + 2) >> 2, g128))
    right, bottom = xx8 >= 4, yy8 >= 4
    return torch.where(
        bottom, torch.where(right, q11[..., None], q10[..., None]),
        torch.where(right, q01[..., None], q00[..., None]))


def _weights(dev):
    return {k: torch.as_tensor(v.T, dtype=torch.float64, device=dev)
            for k, v in (("4", _W4), ("8", _W8), ("16", _W16),
                         ("ch", _WCH), ("f8", _WF8))}


def _recon(X, Xc, nbr, nbr_c, ry, rc, m, act, pcm, has_t8, has_pcm, Wt):
    """Reconstruct the active macroblocks of a batch of tiles.

    X [K, M, 16, 16] the luma tiles as they stand, Xc their (cb, cr) tiles
    [K, M, 8, 8], ry / rc the residual tiles alike.  nbr = (T, L, TR, TL):
    the final samples of each tile's top neighbour's bottom row, left
    neighbour's right column, top-right neighbour's bottom row ([K, M, 16]
    each) and top-left neighbour's corner ([K, M]), zeros outside the
    frame; nbr_c = ((T, L, TL), (T, L, TL)) the same per chroma plane.  m:
    the tiles' "i4" [K,M,4,4], "i8" [K,M,2,2] (when has_t8), "i16", "ch"
    and "flags" [K,M] planes; act [K|1, M] the tiles to reconstruct; pcm
    the (y, cb, cr) PCM tiles when has_pcm.  Returns (X, (Xcb, Xcr))."""
    X = X.clone()
    K, M = X.shape[:2]
    dev = X.device
    T, L, TR, TL = nbr
    flags = m["flags"]
    is_pcm = (flags & MBF_IPCM) > 0
    is_i16 = (flags & MBF_I16x16) > 0
    is_t8 = (flags & MBF_T8x8) > 0
    is_intra = (flags & MBF_INTRA) > 0
    is_i4 = is_intra & ~is_i16 & ~is_pcm & ~is_t8
    is_i8 = is_intra & is_t8 & ~is_pcm

    # ---- I4x4: 16 quad-order substeps ----------------------------------
    act4 = (act & is_i4)[..., None, None]
    for k in range(16):
        bx, by = int(BLK4_X[k]), int(BLK4_Y[k])
        r0, c0 = by * 4, bx * 4
        mm = m["i4"][:, :, by, bx]
        mode = mm & 15
        aA, aB, aC = (mm >> 4) & 1, (mm >> 5) & 1, (mm >> 6) & 1
        if by == 0:
            t4 = T[..., c0:c0 + 4]
            tr = TR[..., 0:4] if bx == 3 else T[..., c0 + 4:c0 + 8]
        else:
            t4 = X[..., r0 - 1, c0:c0 + 4]
            tr = t4[..., 3:4].expand(t4.shape) if bx == 3 else \
                X[..., r0 - 1, c0 + 4:c0 + 8]
        t = torch.cat([t4, torch.where((aC > 0)[..., None], tr,
                                       t4[..., 3:4])], -1)
        l = L[..., r0:r0 + 4] if bx == 0 else X[..., r0:r0 + 4, c0 - 1]
        if bx == 0 and by == 0:
            tl = TL
        elif by == 0:
            tl = T[..., c0 - 1]
        elif bx == 0:
            tl = L[..., r0 - 1]
        else:
            tl = X[..., r0 - 1, c0 - 1]
        nb = torch.cat([l.flip(-1), tl[..., None], t], -1)
        dirp = _dir_matmul(nb, Wt["4"], mode, 9, 16)
        sA, sB = l.sum(-1, dtype=I32), t[..., :4].sum(-1, dtype=I32)
        dc = _dc3(aA, aB, sA + sB, sA, sB, 3)
        pred = torch.where((mode == 2)[..., None], dc[..., None], dirp)
        res = ry[..., r0:r0 + 4, c0:c0 + 4].reshape(K, M, 16)
        recon = (pred + res).clamp(0, 255).reshape(K, M, 4, 4)
        X[..., r0:r0 + 4, c0:c0 + 4] = torch.where(
            act4, recon, X[..., r0:r0 + 4, c0:c0 + 4])

    # ---- Intra_8x8: 4 quad-order substeps ------------------------------
    act8 = (act & is_i8)[..., None, None]
    for b in range(4) if has_t8 else ():
        bx8, by8 = b & 1, b >> 1
        r0, c0 = by8 * 8, bx8 * 8
        mm = m["i8"][:, :, by8, bx8]
        mode = mm & 15
        aA, aB = (mm >> 4) & 1, (mm >> 5) & 1
        aC, aD = (mm >> 6) & 1, (mm >> 7) & 1
        if by8 == 0:
            t8v = T[..., c0:c0 + 8]
            tr = TR[..., 0:8] if bx8 == 1 else T[..., 8:16]
        else:
            t8v = X[..., 7, c0:c0 + 8]
            tr = t8v[..., 7:8].expand(t8v.shape) if bx8 == 1 else \
                X[..., 7, 8:16]
        t = torch.cat([t8v, torch.where((aC > 0)[..., None], tr,
                                        t8v[..., 7:8])], -1)
        l = L[..., r0:r0 + 8] if bx8 == 0 else X[..., r0:r0 + 8, 7]
        if bx8 == 0 and by8 == 0:
            tl = TL
        elif by8 == 0:
            tl = T[..., 7]
        elif bx8 == 0:
            tl = L[..., 7]
        else:
            tl = X[..., 7, 7]
        nb = torch.cat([l.flip(-1), tl[..., None], t], -1)
        # §8.3.2.2.1 reference lowpass via matmul + boundary patches
        nbf = _i8_edges(nb, _dense(nb, Wt["f8"]) >> 2, aA, aB, aD)
        dirp = _dir_matmul(nbf, Wt["8"], mode, 9, 64)
        zero = torch.zeros_like(mode)
        st = torch.where(aB > 0, nbf[..., 9:17].sum(-1, dtype=I32), zero)
        sl = torch.where(aA > 0, nbf[..., :8].sum(-1, dtype=I32), zero)
        dc = _dc3(aA, aB, st + sl, sl, st, 4)
        pred = torch.where((mode == 2)[..., None], dc[..., None], dirp)
        res = ry[..., r0:r0 + 8, c0:c0 + 8].reshape(K, M, 64)
        recon = (pred + res).clamp(0, 255).reshape(K, M, 8, 8)
        X[..., r0:r0 + 8, c0:c0 + 8] = torch.where(
            act8, recon, X[..., r0:r0 + 8, c0:c0 + 8])

    # ---- I16x16 --------------------------------------------------------
    ar16 = torch.arange(16, dtype=I32, device=dev)
    mm = m["i16"]
    mode = mm & 3
    aA, aB = (mm >> 4) & 1, (mm >> 5) & 1
    t = torch.where((aB > 0)[..., None], T, 0)
    l = torch.where((aA > 0)[..., None], L, 0)
    nb = torch.cat([l.flip(-1), TL[..., None], t], -1)
    dirp = _dir_matmul(nb, Wt["16"], mode.clamp(0, 1), 2, 256)
    st, sl = t.sum(-1, dtype=I32), l.sum(-1, dtype=I32)
    dc = _dc3(aA, aB, st + sl, sl, st, 5)
    hs = _plane_sums(nb, _I16_HP, _I16_HM, 8)
    vs = _plane_sums(nb, _I16_VP, _I16_VM, 8)
    a = 16 * (nb[..., 0] + nb[..., 32])
    b_ = (5 * hs + 32) >> 6
    c_ = (5 * vs + 32) >> 6
    plane = ((a[..., None] + b_[..., None] * (ar16.repeat(16) - 7)
              + c_[..., None] * (ar16.repeat_interleave(16) - 7) + 16)
             >> 5).clamp(0, 255)
    pred = torch.where((mode == 2)[..., None], dc[..., None],
                       torch.where((mode == 3)[..., None], plane, dirp))
    recon = (pred + ry.reshape(K, M, 256)).clamp(0, 255) \
        .reshape(K, M, 16, 16)
    X = torch.where((act & is_i16)[..., None, None], recon, X)
    if has_pcm:
        X = torch.where((act & is_pcm)[..., None, None], pcm[0], X)

    # ---- chroma --------------------------------------------------------
    ar8 = torch.arange(8, dtype=I32, device=dev)
    xx8, yy8 = ar8.repeat(8), ar8.repeat_interleave(8)
    mm = m["ch"]
    mode = mm & 3
    aA, aB = (mm >> 4) & 1, (mm >> 5) & 1
    out_c = []
    for ci, (img, (Tc, Lc, TLc), res_c) in enumerate(zip(Xc, nbr_c, rc)):
        t = torch.where((aB > 0)[..., None], Tc, 0)
        l = torch.where((aA > 0)[..., None], Lc, 0)
        nb = torch.cat([l.flip(-1), TLc[..., None], t], -1)
        dirp = _dir_matmul(nb, Wt["ch"], (mode - 1).clamp(0, 1), 2, 64)
        dcmap = _chroma_dc(t, l, aA, aB, xx8, yy8)
        hs = _plane_sums(nb, _CH_HP, _CH_HM, 4)
        vs = _plane_sums(nb, _CH_VP, _CH_VM, 4)
        a = 16 * (nb[..., 0] + nb[..., 16])
        b_ = (34 * hs + 32) >> 6
        c_ = (34 * vs + 32) >> 6
        plane = ((a[..., None] + b_[..., None] * (xx8 - 3)
                  + c_[..., None] * (yy8 - 3) + 16) >> 5).clamp(0, 255)
        pred = torch.where((mode == 0)[..., None], dcmap,
                           torch.where((mode == 3)[..., None], plane, dirp))
        recon = (pred + res_c.reshape(K, M, 64)).clamp(0, 255) \
            .reshape(K, M, 8, 8)
        img = torch.where((act & is_intra & ~is_pcm)[..., None, None],
                          recon, img)
        if has_pcm:
            img = torch.where((act & is_pcm)[..., None, None],
                              pcm[1 + ci], img)
        out_c.append(img)
    return X, tuple(out_c)


def intra_scan_sheared(y, cb, cr, res_y, res_cb, res_cr, p, mbW, mbH,
                       has_t8=True, has_pcm=True):
    """Intra reconstruction over K inter-predicted frames.

    y [K,16mbH,16mbW], cb/cr [K,8mbH,8mbW] int32 (inter-predicted
    samples, zeros elsewhere); res_* the residuals; p the stacked plane
    dict.  Returns the reconstructed (y, cb, cr).  has_t8 / has_pcm =
    False skip the Intra_8x8 and PCM work (no such mb in the batch)."""
    K = y.shape[0]
    dev = y.device
    NW = mbW + 2 * mbH - 2
    _, _, val_t = _wave_index(NW, mbW, mbH, dev)        # [NW, mbH]

    def sh(img, ts):
        return _shear_tiles(img, mbW, mbH, ts, extra=0)

    Xy_t, Xcb_t, Xcr_t = sh(y, 16), sh(cb, 8), sh(cr, 8)
    ry_t, rcb_t, rcr_t = sh(res_y, 16), sh(res_cb, 8), sh(res_cr, 8)
    if has_pcm:
        pcm_t = (sh(p["pcm_y"], 16), sh(p["pcm_c"][:, 0], 8),
                 sh(p["pcm_c"][:, 1], 8))
    m_t = {"i4": sh(p["i4_modes"], 4)}
    if has_t8:
        m_t["i8"] = sh(p["i8_modes"], 2)
    for k, pk in (("i16", "i16_modes"), ("ch", "ch_modes"),
                  ("flags", "mb_flags")):
        m_t[k] = _shear_plane(p[pk], mbW, mbH, extra=0)
    Wt = _weights(dev)

    z_y = torch.zeros((K, mbH, 16, 16), dtype=I32, device=dev)
    z_c = torch.zeros((K, mbH, 8, 8), dtype=I32, device=dev)
    A = B = C = z_y
    Ab = Bb = Cb_ = Ar = Br = Cr_ = z_c
    ey, ecb, ecr = [], [], []
    for w in range(NW):
        Bs, Cs, As = _shift_my(B), _shift_my(C), _shift_my(A)
        nbr = (Bs[..., 15, :], A[..., :, 15], As[..., 15, :],
               Cs[..., 15, 15])
        nbr_c = tuple((_shift_my(Bc)[..., 7, :], Ac[..., :, 7],
                       _shift_my(Cc)[..., 7, 7])
                      for Ac, Bc, Cc in ((Ab, Bb, Cb_), (Ar, Br, Cr_)))
        X, (Xcb, Xcr) = _recon(
            Xy_t[w], (Xcb_t[w], Xcr_t[w]), nbr, nbr_c, ry_t[w],
            (rcb_t[w], rcr_t[w]), {k: v[w] for k, v in m_t.items()},
            val_t[w][None, :], tuple(a[w] for a in pcm_t) if has_pcm
            else None, has_t8, has_pcm, Wt)
        A, B, C = X, A, B
        Ab, Bb, Cb_ = Xcb, Ab, Bb
        Ar, Br, Cr_ = Xcr, Ar, Br
        ey.append(X)
        ecb.append(Xcb)
        ecr.append(Xcr)
    return (_unshear_tiles(torch.stack(ey), mbW, mbH, 16, shift=0),
            _unshear_tiles(torch.stack(ecb), mbW, mbH, 8, shift=0),
            _unshear_tiles(torch.stack(ecr), mbW, mbH, 8, shift=0))


# ---------------------------------------------------------------------------
# Sparse intra: dependency-depth level rounds

_ROUND_BUCKETS = (2, 4, 8)


def _intra_depth(flags, passes):
    """Host-side dependency depth of every mb: 0 for inter, 1 for an intra
    mb with no intra causal neighbour (left, top, top-left, top-right),
    else 1 + the deepest intra neighbour's depth; found by fixpoint
    relaxation.  None when more than 40% of the mbs are intra, or when
    `passes` passes do not converge (a chain deeper than `passes`)."""
    M = (flags & MBF_INTRA) > 0
    if M.mean() > 0.4:
        return None
    lvl = M.astype(np.int32)
    for _ in range(passes):
        left = np.pad(lvl, ((0, 0), (1, 0)))[:, :-1]
        top = np.pad(lvl, ((1, 0), (0, 0)))[:-1, :]
        tl = np.pad(lvl, ((1, 0), (1, 0)))[:-1, :-1]
        tr = np.pad(lvl, ((1, 0), (0, 1)))[:-1, 1:]
        new = np.where(M, 1 + np.maximum.reduce([left, top, tl, tr]), 0)
        if np.array_equal(new, lvl):
            return lvl
        lvl = new
    return None


def intra_round_plane(flags, mbW, mbH):
    """Host-side dependency-depth plane for intra_rounds().

    An intra macroblock only waits on *intra* causal neighbours (left,
    top, top-left, top-right); inter neighbours are reconstructed by the
    dense MC+residual pass before any intra work.  Depth 1 = no intra
    neighbour; depth d = 1 + max(depth of intra neighbours).

    Returns (lvl int32 [mbH, mbW], R) with R the smallest of
    _ROUND_BUCKETS covering the max depth, or None when the frame is too
    intra-dense (more than 40% intra, or a chain deeper than the last
    bucket): the caller then uses the wavefront instead."""
    lvl = _intra_depth(flags, _ROUND_BUCKETS[-1] + 1)
    if lvl is None:
        return None
    R = next((b for b in _ROUND_BUCKETS if int(lvl.max()) <= b), None)
    if R is None:
        return None
    return lvl.astype(np.int32), R


def _tiles(img, mbW, mbH, ts):
    """[K, mbH*ts, mbW*ts] -> [K, mbH*mbW, ts, ts] (raster mb order)."""
    K = img.shape[0]
    return img.reshape(K, mbH, ts, mbW, ts).transpose(2, 3) \
        .reshape(K, mbH * mbW, ts, ts)


def _untile(X, mbW, mbH, ts):
    K = X.shape[0]
    return X.reshape(K, mbH, mbW, ts, ts).transpose(2, 3) \
        .reshape(K, mbH * ts, mbW * ts)


def _shift(a, dy, dx):
    """out[:, my, mx] = a[:, my - dy, mx - dx], zeros where that falls
    outside the [mbH, mbW] grid (dims 1 and 2)."""
    out = torch.zeros_like(a)
    H, W = a.shape[1], a.shape[2]
    out[:, dy:, max(dx, 0):W + min(dx, 0)] = \
        a[:, :H - dy, max(-dx, 0):W - max(dx, 0)]
    return out


def _edges(X, mbW, mbH, ts):
    """The (T, L, TR, TL) neighbour samples of every tile of X
    [K, N, ts, ts] (see _recon), read from the tiles themselves."""
    K = X.shape[0]
    g = X.reshape(K, mbH, mbW, ts, ts)
    bot = g[..., ts - 1, :]
    out = (_shift(bot, 1, 0), _shift(g[..., :, ts - 1], 0, 1),
           _shift(bot, 1, -1), _shift(g[..., ts - 1, ts - 1], 1, 1))
    return tuple(a.reshape((K, mbH * mbW) + a.shape[3:]) for a in out)


def intra_rounds(y, cb, cr, res_y, res_cb, res_cr, p, lvl, mbW, mbH,
                 rounds, has_t8=True, has_pcm=True):
    """Level-rounds intra reconstruction of K intra-SPARSE frames.

    Round r reconstructs every intra macroblock of dependency depth r
    (intra_round_plane) at once as full-frame tensor work, reading its
    neighbours from the frame as it stood at the round's start; the
    arithmetic is `_recon`'s, as in the wavefront.  lvl [K, mbH, mbW]
    int32, or None to recompute it here from mb_flags (`rounds` fixpoint
    steps; the caller has checked that every depth is <= rounds).  Plain
    PyTorch (XLA, not Pallas, in the JAX package), which the decode paths
    run on the CPU only; each call adds one to `intra_rounds.launches`,
    so a run shows which steps took this route (none on a card)."""
    K = y.shape[0]
    N = mbH * mbW
    if lvl is None:
        intra = (p["mb_flags"] & MBF_INTRA) > 0
        lvl = intra.to(I32)
        for _ in range(rounds):
            nbmax = torch.maximum(
                torch.maximum(_shift(lvl, 0, 1), _shift(lvl, 1, 0)),
                torch.maximum(_shift(lvl, 1, 1), _shift(lvl, 1, -1)))
            lvl = torch.where(intra, 1 + nbmax, 0)
    lvl = torch.as_tensor(lvl, device=y.device).reshape(K, N)

    X = _tiles(y, mbW, mbH, 16)
    Xc = (_tiles(cb, mbW, mbH, 8), _tiles(cr, mbW, mbH, 8))
    ry = _tiles(res_y, mbW, mbH, 16)
    rc = (_tiles(res_cb, mbW, mbH, 8), _tiles(res_cr, mbW, mbH, 8))
    m = {"i4": _tiles(p["i4_modes"], mbW, mbH, 4),
         "i16": p["i16_modes"].reshape(K, N),
         "ch": p["ch_modes"].reshape(K, N),
         "flags": p["mb_flags"].reshape(K, N)}
    if has_t8:
        m["i8"] = _tiles(p["i8_modes"], mbW, mbH, 2)
    pcm = (_tiles(p["pcm_y"], mbW, mbH, 16),
           _tiles(p["pcm_c"][:, 0], mbW, mbH, 8),
           _tiles(p["pcm_c"][:, 1], mbW, mbH, 8)) if has_pcm else None
    Wt = _weights(y.device)
    for r in range(1, rounds + 1):
        nbr = _edges(X, mbW, mbH, 16)
        nbr_c = tuple((T, L, TL) for T, L, _, TL in
                      (_edges(c, mbW, mbH, 8) for c in Xc))
        X, Xc = _recon(X, Xc, nbr, nbr_c, ry, rc, m, lvl == r, pcm,
                       has_t8, has_pcm, Wt)
    intra_rounds.launches += 1
    return (_untile(X, mbW, mbH, 16), _untile(Xc[0], mbW, mbH, 8),
            _untile(Xc[1], mbW, mbH, 8))


intra_rounds.launches = 0


# ---------------------------------------------------------------------------
# Sparse intra: the level-gather scan (the JAX package's CPU single-frame
# route)

_LEVEL_BUCKETS = (2, 4, 8, 16)
_ENTRY_BUCKETS = (128, 512, 2048, 8160)


def intra_level_tables(flags, mbW, mbH):
    """Host-side level compression of the intra wavefront for intra_scan.

    The dependency depths of intra_round_plane become per-level lists of
    the intra mbs' coordinates, padded to a fixed menu of (levels,
    entries) buckets: (mxs, mys, valid) int32 / int32 / bool [Lb, Nb],
    padded entries at mb (0, 0) with valid False.  None when more than 40%
    of the mbs are intra, or the chains are deeper than 16, or a level
    holds more than 8160 mbs.  An exact copy of jaxdec.intra_level_tables,
    with the same buckets."""
    lvl = _intra_depth(flags, 17)
    if lvl is None:
        return None
    lmax = int(lvl.max())
    if lmax == 0:
        mxs = np.zeros((1, 1), np.int32)
        return mxs, mxs.copy(), np.zeros((1, 1), bool)
    per = [np.nonzero(lvl == lv) for lv in range(1, lmax + 1)]
    nmax = max(len(ys) for ys, xs in per)
    Lb = next((b for b in _LEVEL_BUCKETS if lmax <= b), None)
    Nb = next((b for b in _ENTRY_BUCKETS if nmax <= b), None)
    if Lb is None or Nb is None:
        return None
    mxs = np.zeros((Lb, Nb), np.int32)
    mys = np.zeros((Lb, Nb), np.int32)
    valid = np.zeros((Lb, Nb), bool)
    for i, (ys, xs) in enumerate(per):
        mxs[i, :len(xs)] = xs
        mys[i, :len(ys)] = ys
        valid[i, :len(ys)] = True
    return mxs, mys, valid


def _gather2(img, rows, cols):
    """img[k, rows, cols] for img [K, H, W], with rows / cols [K, ...]
    broadcast together and clipped to the image (values at clipped
    indices are masked by the callers)."""
    K, H, W = img.shape
    k = torch.arange(K, device=img.device).view((K,) + (1,) * (rows.ndim - 1))
    return img[k, rows.clamp(0, H - 1), cols.clamp(0, W - 1)]


def _scatter2(img, rows, cols, vals, active):
    """img[k, rows, cols] = vals in place where active [K, N] (rows, cols
    and vals [K, N, P]).  JAX sends inactive entries out of bounds and
    drops them; here they are masked out before the scatter, so a padded
    entry (at mb (0, 0)) never overwrites a real mb there."""
    rows, cols = torch.broadcast_tensors(rows, cols)
    act = active[..., None].expand_as(rows)
    k = torch.arange(img.shape[0], device=img.device)[:, None, None] \
        .expand_as(rows)
    img[k[act], rows[act], cols[act]] = vals.expand_as(rows)[act]


def _tap3(nb, idx):
    """(a + 2b + c + 2) >> 2 through per-entry index triples: nb [K, N, T],
    idx [K, N, P, 3] -> [K, N, P]."""
    a, b, c = (torch.gather(nb, 2, idx[..., j]) for j in range(3))
    return (a + 2 * b + c + 2) >> 2


def intra_scan(y, cb, cr, res_y, res_cb, res_cr, p, tables):
    """Reconstruct the intra mbs of K frames level by level from
    level-compressed tables (intra_level_tables): a plain port of
    jaxdec.intra_scan, gathers and masked scatters of each level's mbs,
    with a leading lane dimension K.

    y [K,16mbH,16mbW], cb / cr [K,8mbH,8mbW] int32 hold the inter
    prediction (zeros elsewhere); res_* the residuals; p the [K, ...]
    plane dict; tables (mxs, mys, valid), each [K, Lb, Nb].  Returns new
    (y, cb, cr).  Integer arithmetic throughout, so exact; the
    whole-frame functions run it on CPU planes only (ops/frame.py: on a
    card intra takes intra.cu).  Modes outside a table are clipped into it, as JAX's gathers clip."""
    dev = y.device
    y, cb, cr = y.clone(), cb.clone(), cr.clone()
    K = y.shape[0]
    kk = torch.arange(K, device=dev)[:, None]
    mxs_t, mys_t, valid_t = (torch.as_tensor(t, device=dev) for t in tables)
    i4idx, i8idx, i16idx, chidx, fidx = (
        torch.as_tensor(t, dtype=torch.long, device=dev)
        for t in (I4_IDX, I8_IDX, I16_DIR_IDX, CH_DIR_IDX, I8_FILT_IDX))
    r4, r8, r16 = (torch.arange(n, dtype=I32, device=dev) for n in (4, 8, 16))
    ar16 = torch.arange(16 * 16, dtype=I32, device=dev)
    xx16, yy16 = ar16 % 16, ar16 // 16          # raster order of a 16x16
    xx8, yy8 = (ar16[:64] % 8, ar16[:64] // 8)
    blk_y, blk_x = ar16[:16] // 4, ar16[:16] % 4

    def pl(name, r, c):
        return p[name][kk, r, c]

    for lv in range(mxs_t.shape[1]):
        mxs, mys = mxs_t[:, lv].long(), mys_t[:, lv].long()
        val = valid_t[:, lv].bool()
        flags = pl("mb_flags", mys, mxs)
        is_pcm = (flags & MBF_IPCM) > 0
        is_i16 = (flags & MBF_I16x16) > 0
        is_t8 = (flags & MBF_T8x8) > 0
        is_intra = (flags & MBF_INTRA) > 0
        is_i4 = is_intra & ~is_i16 & ~is_pcm & ~is_t8
        is_i8 = is_intra & is_t8 & ~is_pcm

        # ---- I4x4 luma: 16 quad-order substeps -------------------------
        for b in range(16):
            bx, by = int(BLK4_X[b]), int(BLK4_Y[b])
            px0, py0 = mxs * 16 + bx * 4, mys * 16 + by * 4
            m = pl("i4_modes", mys * 4 + by, mxs * 4 + bx)
            mode = m & 15
            aA, aB, aC = (m >> 4) & 1, (m >> 5) & 1, (m >> 6) & 1
            t = _gather2(y, (py0 - 1)[..., None], px0[..., None] + r8)
            t = torch.cat([t[..., :4], torch.where(
                (aC > 0)[..., None], t[..., 4:], t[..., 3:4])], -1)
            l = _gather2(y, py0[..., None] + r4, (px0 - 1)[..., None])
            tl = _gather2(y, py0 - 1, px0 - 1)
            nb = torch.cat([l.flip(-1), tl[..., None], t], -1)
            dirp = _tap3(nb, i4idx[mode.clamp(0, 8).long()])
            sA, sB = l.sum(-1, dtype=I32), t[..., :4].sum(-1, dtype=I32)
            dc = _dc3(aA, aB, sA + sB, sA, sB, 3)
            pred = torch.where((mode == 2)[..., None], dc[..., None], dirp)
            rows = py0[..., None] + blk_y
            cols = px0[..., None] + blk_x
            recon = (pred + _gather2(res_y, rows, cols)).clamp(0, 255)
            _scatter2(y, rows, cols, recon, val & is_i4)

        # ---- Intra_8x8 luma: 4 quad-order substeps ---------------------
        for b in range(4):
            bx8, by8 = b & 1, b >> 1
            px0, py0 = mxs * 16 + bx8 * 8, mys * 16 + by8 * 8
            mm = pl("i8_modes", mys * 2 + by8, mxs * 2 + bx8)
            mode = mm & 15
            aA, aB = (mm >> 4) & 1, (mm >> 5) & 1
            aC, aD = (mm >> 6) & 1, (mm >> 7) & 1
            t = _gather2(y, (py0 - 1)[..., None], px0[..., None] + r16)
            t = torch.cat([t[..., :8], torch.where(
                (aC > 0)[..., None], t[..., 8:], t[..., 7:8])], -1)
            l = _gather2(y, py0[..., None] + r8, (px0 - 1)[..., None])
            tl = _gather2(y, py0 - 1, px0 - 1)
            nb = torch.cat([l.flip(-1), tl[..., None], t], -1)
            # §8.3.2.2.1 reference lowpass: 3-tap gather + boundary patches
            nbf = _i8_edges(nb, (nb[..., fidx[:, 0]] + 2 * nb[..., fidx[:, 1]]
                                 + nb[..., fidx[:, 2]] + 2) >> 2, aA, aB, aD)
            dirp = _tap3(nbf, i8idx[mode.clamp(0, 8).long()])
            zero = torch.zeros_like(mode)
            st = torch.where(aB > 0, nbf[..., 9:17].sum(-1, dtype=I32), zero)
            sl = torch.where(aA > 0, nbf[..., :8].sum(-1, dtype=I32), zero)
            dc = _dc3(aA, aB, st + sl, sl, st, 4)
            pred = torch.where((mode == 2)[..., None], dc[..., None], dirp)
            rows = py0[..., None] + yy8
            cols = px0[..., None] + xx8
            recon = (pred + _gather2(res_y, rows, cols)).clamp(0, 255)
            _scatter2(y, rows, cols, recon, val & is_i8)

        # ---- I16x16 luma -----------------------------------------------
        px0, py0 = mxs * 16, mys * 16
        m = pl("i16_modes", mys, mxs)
        mode = m & 3
        aA, aB = (m >> 4) & 1, (m >> 5) & 1
        t = _gather2(y, (py0 - 1)[..., None], px0[..., None] + r16)
        l = _gather2(y, py0[..., None] + r16, (px0 - 1)[..., None])
        tl = _gather2(y, py0 - 1, px0 - 1)
        t = torch.where((aB > 0)[..., None], t, 0)
        l = torch.where((aA > 0)[..., None], l, 0)
        nb = torch.cat([l.flip(-1), tl[..., None], t], -1)
        dirp = _tap3(nb, i16idx[mode.clamp(0, 1).long()])
        st, sl = t.sum(-1, dtype=I32), l.sum(-1, dtype=I32)
        dc = _dc3(aA, aB, st + sl, sl, st, 5)
        hs = _plane_sums(nb, _I16_HP, _I16_HM, 8)
        vs = _plane_sums(nb, _I16_VP, _I16_VM, 8)
        a = 16 * (nb[..., 0] + nb[..., 32])
        b_ = (5 * hs + 32) >> 6
        c_ = (5 * vs + 32) >> 6
        plane = ((a[..., None] + b_[..., None] * (xx16 - 7)
                  + c_[..., None] * (yy16 - 7) + 16) >> 5).clamp(0, 255)
        pred = torch.where((mode == 2)[..., None], dc[..., None],
                           torch.where((mode == 3)[..., None], plane, dirp))
        rows = py0[..., None] + yy16
        cols = px0[..., None] + xx16
        recon = (pred + _gather2(res_y, rows, cols)).clamp(0, 255)
        _scatter2(y, rows, cols, recon, val & is_i16)

        # ---- I_PCM -----------------------------------------------------
        _scatter2(y, rows, cols, _gather2(p["pcm_y"], rows, cols),
                  val & is_pcm)

        # ---- chroma (all intra mbs; PCM overwrites) --------------------
        cx0, cy0 = mxs * 8, mys * 8
        crows = cy0[..., None] + yy8
        ccols = cx0[..., None] + xx8
        m = pl("ch_modes", mys, mxs)
        mode = m & 3
        aA, aB = (m >> 4) & 1, (m >> 5) & 1
        for ci, (img, res_c) in enumerate(((cb, res_cb), (cr, res_cr))):
            t = _gather2(img, (cy0 - 1)[..., None], cx0[..., None] + r8)
            l = _gather2(img, cy0[..., None] + r8, (cx0 - 1)[..., None])
            tl = _gather2(img, cy0 - 1, cx0 - 1)
            t = torch.where((aB > 0)[..., None], t, 0)
            l = torch.where((aA > 0)[..., None], l, 0)
            nb = torch.cat([l.flip(-1), tl[..., None], t], -1)
            dirp = _tap3(nb, chidx[(mode - 1).clamp(0, 1).long()])
            dcmap = _chroma_dc(t, l, aA, aB, xx8, yy8)
            hs = _plane_sums(nb, _CH_HP, _CH_HM, 4)
            vs = _plane_sums(nb, _CH_VP, _CH_VM, 4)
            a = 16 * (nb[..., 0] + nb[..., 16])
            b_ = (34 * hs + 32) >> 6
            c_ = (34 * vs + 32) >> 6
            plane = ((a[..., None] + b_[..., None] * (xx8 - 3)
                      + c_[..., None] * (yy8 - 3) + 16) >> 5).clamp(0, 255)
            pred = torch.where((mode == 0)[..., None], dcmap,
                               torch.where((mode == 3)[..., None], plane,
                                           dirp))
            recon = (pred + _gather2(res_c, crows, ccols)).clamp(0, 255)
            _scatter2(img, crows, ccols, recon, val & is_intra & ~is_pcm)
            _scatter2(img, crows, ccols,
                      _gather2(p["pcm_c"][:, ci], crows, ccols),
                      val & is_pcm)
    return y, cb, cr


# ---------------------------------------------------------------------------
# The kernel

# kernels/csrc/intra.cu's __constant__ tap tables, in its upload order
_TAP_TABLES = np.concatenate([
    a.astype(np.uint8).ravel()
    for a in (I4_IDX, I8_IDX, I16_DIR_IDX, CH_DIR_IDX, I8_FILT_IDX)])


def intra_batch(y, cb, cr, res_y, res_cb, res_cr, p, mbW, mbH,
                has_t8=True, has_pcm=True):
    """Intra reconstruction of K frames (the contract of
    intra_scan_sheared).  CPU tensors: the plain `intra_scan_sheared`.
    CUDA tensors: `kernels/csrc/intra.cu`, which reconstructs y, cb and cr
    IN PLACE (the frames are the step's own intermediates) and returns
    them.  Every launch adds one to `intra_batch.launches`."""
    if y.device.type == "cpu":
        return intra_scan_sheared(y, cb, cr, res_y, res_cb, res_cr, p,
                                  mbW, mbH, has_t8, has_pcm)
    from ..kernels import build
    K = y.shape[0]
    H, W = 16 * mbH, 16 * mbW
    luma, chroma = (K, H, W), (K, H // 2, W // 2)
    args = [(y, luma), (cb, chroma), (cr, chroma), (res_y, luma),
            (res_cb, chroma), (res_cr, chroma),
            (p["i4_modes"], (K, 4 * mbH, 4 * mbW)),
            (p["i8_modes"], (K, 2 * mbH, 2 * mbW)),
            (p["i16_modes"], (K, mbH, mbW)), (p["ch_modes"], (K, mbH, mbW)),
            (p["mb_flags"], (K, mbH, mbW)), (p["pcm_y"], luma),
            (p["pcm_c"], (K, 2, H // 2, W // 2))]
    build.check_args(args, torch.int32, y.device)
    # progress[K*mbH] row counters, then the row ticket: zeroed per call
    scratch = torch.zeros(K * mbH + 1, dtype=torch.int32, device=y.device)
    with torch.cuda.device(y.device):
        stream = torch.cuda.current_stream(y.device).cuda_stream
        rc = build.lib("intra").e264t_intra(
            *[ctypes.c_void_p(t.data_ptr()) for t, _ in args],
            _TAP_TABLES.ctypes.data_as(ctypes.c_void_p),
            ctypes.c_void_p(scratch.data_ptr()), K, mbW, mbH,
            int(has_t8), int(has_pcm), ctypes.c_void_p(stream))
    build.raise_on(rc, "intra")
    intra_batch.launches += 1
    return y, cb, cr


intra_batch.launches = 0
