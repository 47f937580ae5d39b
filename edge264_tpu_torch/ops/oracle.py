"""Numpy golden model of the H.264 pixel path (exact integer math): the
port's own copy of the JAX package's `ops/oracle.py`, unchanged but for
this docstring.

Inverse quantization, 4x4/8x8 inverse transforms, DC hadamards, intra
prediction, motion compensation and deblocking, straight from ISO/IEC
14496-10 with no shortcuts, in scalar numpy loops.  It shares no code
with the port's tensor code (ops/residual.py, intra.py, mc.py,
deblock.py and the CUDA kernels), so it is an independent golden for
them: `core.NumpyBackend` (backend="numpy") decodes with it, on the host
only.

Everything operates on the syntax planes emitted by the native front end
(edge264_tpu_torch/native): coefficients already un-zigzagged to raster
order, intra modes pre-resolved with availability bits.

Scalar loops are fine here: this model is the *oracle*, not the product.
"""

from __future__ import annotations

import numpy as np

# ---------------------------------------------------------------------------
# Inverse quantization tables (§8.5.9)

# normAdjust4x4: v[m][k], position class k: 0 for (0,0),(0,2),(2,0),(2,2);
# 1 for (1,1),(1,3),(3,1),(3,3); 2 otherwise
_V4 = np.array([[10, 16, 13], [11, 18, 14], [13, 20, 16],
                [14, 23, 18], [16, 25, 20], [18, 29, 23]], np.int32)
_POS4 = np.array([[0, 2, 0, 2], [2, 1, 2, 1],
                  [0, 2, 0, 2], [2, 1, 2, 1]], np.int32)
NORM_ADJUST_4x4 = _V4[:, _POS4]              # [6][4][4]

# normAdjust8x8 (§8.5.9): m[m][k], class by (i%4, j%4)
_V8 = np.array([
    [20, 18, 32, 19, 25, 24], [22, 19, 35, 21, 28, 26],
    [26, 23, 42, 24, 33, 31], [28, 25, 45, 26, 35, 33],
    [32, 28, 51, 30, 40, 38], [36, 32, 58, 34, 46, 43]], np.int32)
_POS8 = np.zeros((8, 8), np.int32)
for _i in range(8):
    for _j in range(8):
        a, b = _i % 4, _j % 4
        if a == 0 and b == 0:
            _POS8[_i, _j] = 0
        elif _i % 2 == 1 and _j % 2 == 1:
            _POS8[_i, _j] = 1
        elif a == 2 and b == 2:
            _POS8[_i, _j] = 2
        elif (a == 0 and _j % 2 == 1) or (_i % 2 == 1 and b == 0):
            _POS8[_i, _j] = 3
        elif (a == 0 and b == 2) or (a == 2 and b == 0):
            _POS8[_i, _j] = 4
        else:
            _POS8[_i, _j] = 5
NORM_ADJUST_8x8 = _V8[:, _POS8]              # [6][8][8]

FLAT16_4 = np.full((4, 4), 16, np.int32)
FLAT16_8 = np.full((8, 8), 16, np.int32)


def clip1(x):
    return np.clip(x, 0, 255)


# ---------------------------------------------------------------------------
# Scaling (inverse quantization)

def scale_block4(c, qp, ws=FLAT16_4, skip_dc=False):
    """§8.5.12.1: scale a 4x4 coefficient block (raster int32 [4,4]).
    skip_dc leaves d[0,0] at 0 (Intra16x16 / chroma AC: DC comes from the
    hadamard path)."""
    m, s = qp % 6, qp // 6
    ls = ws.astype(np.int64) * NORM_ADJUST_4x4[m]
    c = c.astype(np.int64)
    if qp >= 24:
        d = (c * ls) << (s - 4)
    else:
        d = (c * ls + (1 << (3 - s))) >> (4 - s)
    d = d.astype(np.int32)
    if skip_dc:
        d[0, 0] = 0
    return d


def scale_block8(c, qp, ws=FLAT16_8):
    """§8.5.13.1: scale an 8x8 coefficient block."""
    m, s = qp % 6, qp // 6
    ls = ws.astype(np.int64) * NORM_ADJUST_8x8[m]
    c = c.astype(np.int64)
    if qp >= 36:
        d = (c * ls) << (s - 6)
    else:
        d = (c * ls + (1 << (5 - s))) >> (6 - s)
    return d.astype(np.int32)


def luma_dc_dequant(c, qp, ws00=16):
    """§8.5.10: 4x4 hadamard of Intra16x16 luma DC + scaling."""
    H = np.array([[1, 1, 1, 1], [1, 1, -1, -1],
                  [1, -1, -1, 1], [1, -1, 1, -1]], np.int64)
    f = H @ c.astype(np.int64) @ H
    ls = int(ws00) * int(NORM_ADJUST_4x4[qp % 6][0][0])
    s = qp // 6
    if qp >= 36:
        d = (f * ls) << (s - 6)
    else:
        d = (f * ls + (1 << (5 - s))) >> (6 - s)
    return d.astype(np.int32)


def chroma_dc_dequant(c, qp, ws00=16):
    """§8.5.11: 2x2 hadamard of chroma DC + scaling (4:2:0)."""
    H = np.array([[1, 1], [1, -1]], np.int64)
    f = H @ c.astype(np.int64) @ H
    ls = int(ws00) * int(NORM_ADJUST_4x4[qp % 6][0][0])
    d = ((f * ls) << (qp // 6)) >> 5
    return d.astype(np.int32)


# ---------------------------------------------------------------------------
# Inverse transforms

def idct4(d):
    """§8.5.12.2: 4x4 integer inverse transform; returns residual [4,4]
    (already rounded: (x+32)>>6)."""
    d = d.astype(np.int64)
    # horizontal (rows)
    e0 = d[:, 0] + d[:, 2]
    e1 = d[:, 0] - d[:, 2]
    e2 = (d[:, 1] >> 1) - d[:, 3]
    e3 = d[:, 1] + (d[:, 3] >> 1)
    f = np.stack([e0 + e3, e1 + e2, e1 - e2, e0 - e3], axis=1)
    # vertical (columns)
    g0 = f[0] + f[2]
    g1 = f[0] - f[2]
    g2 = (f[1] >> 1) - f[3]
    g3 = f[1] + (f[3] >> 1)
    h = np.stack([g0 + g3, g1 + g2, g1 - g2, g0 - g3], axis=0)
    return ((h + 32) >> 6).astype(np.int32)


def idct8(d):
    """§8.5.13.2: 8x8 integer inverse transform."""
    d = d.astype(np.int64)

    def pass1(a):         # operates on last axis of [.., 8]
        e = np.empty_like(a)
        e[..., 0] = a[..., 0] + a[..., 4]
        e[..., 1] = -a[..., 3] + a[..., 5] - a[..., 7] - (a[..., 7] >> 1)
        e[..., 2] = a[..., 0] - a[..., 4]
        e[..., 3] = a[..., 1] + a[..., 7] - a[..., 3] - (a[..., 3] >> 1)
        e[..., 4] = (a[..., 2] >> 1) - a[..., 6]
        e[..., 5] = -a[..., 1] + a[..., 7] + a[..., 5] + (a[..., 5] >> 1)
        e[..., 6] = a[..., 2] + (a[..., 6] >> 1)
        e[..., 7] = a[..., 3] + a[..., 5] + a[..., 1] + (a[..., 1] >> 1)
        f = np.empty_like(a)
        f[..., 0] = e[..., 0] + e[..., 6]
        f[..., 1] = e[..., 1] + (e[..., 7] >> 2)
        f[..., 2] = e[..., 2] + e[..., 4]
        f[..., 3] = e[..., 3] + (e[..., 5] >> 2)
        f[..., 4] = e[..., 2] - e[..., 4]
        f[..., 5] = (e[..., 3] >> 2) - e[..., 5]
        f[..., 6] = e[..., 0] - e[..., 6]
        f[..., 7] = e[..., 7] - (e[..., 1] >> 2)
        g = np.empty_like(a)
        g[..., 0] = f[..., 0] + f[..., 7]
        g[..., 1] = f[..., 2] + f[..., 5]
        g[..., 2] = f[..., 4] + f[..., 3]
        g[..., 3] = f[..., 6] + f[..., 1]
        g[..., 4] = f[..., 6] - f[..., 1]
        g[..., 5] = f[..., 4] - f[..., 3]
        g[..., 6] = f[..., 2] - f[..., 5]
        g[..., 7] = f[..., 0] - f[..., 7]
        return g

    h = pass1(d)                      # horizontal on rows
    k = pass1(h.T).T                  # vertical on columns
    return ((k + 32) >> 6).astype(np.int32)


# ---------------------------------------------------------------------------
# Intra prediction (§8.3).  Availability bit layout matches the native
# front end: bit4=A(left), bit5=B(top), bit6=C(top-right)|D, bit7=D.

def intra4x4_pred(mode, t, l, tl, aA, aB):
    """§8.3.1.2.  t = p[0..7,-1] (C-substitution already applied),
    l = p[-1,0..3], tl = p[-1,-1].  Returns uint8-range [4,4] int32."""
    t = t.astype(np.int32)
    l = l.astype(np.int32)
    tl = int(tl)
    p = np.zeros((4, 4), np.int32)
    if mode == 0:          # Vertical
        p[:] = t[:4][None, :]
    elif mode == 1:        # Horizontal
        p[:] = l[:, None]
    elif mode == 2:        # DC
        if aA and aB:
            p[:] = (t[:4].sum() + l.sum() + 4) >> 3
        elif aA:
            p[:] = (l.sum() + 2) >> 2
        elif aB:
            p[:] = (t[:4].sum() + 2) >> 2
        else:
            p[:] = 128
    elif mode == 3:        # Diagonal-Down-Left
        for y in range(4):
            for x in range(4):
                if x == 3 and y == 3:
                    p[y, x] = (t[6] + 3 * t[7] + 2) >> 2
                else:
                    p[y, x] = (t[x + y] + 2 * t[x + y + 1] + t[x + y + 2] + 2) >> 2
    elif mode == 4:        # Diagonal-Down-Right
        tx = lambda i: tl if i < 0 else t[i]
        lx = lambda i: tl if i < 0 else l[i]
        for y in range(4):
            for x in range(4):
                if x > y:
                    p[y, x] = (tx(x - y - 2) + 2 * t[x - y - 1] + t[x - y] + 2) >> 2
                elif x < y:
                    p[y, x] = (lx(y - x - 2) + 2 * l[y - x - 1] + l[y - x] + 2) >> 2
                else:
                    p[y, x] = (t[0] + 2 * tl + l[0] + 2) >> 2
    elif mode == 5:        # Vertical-Right
        tx = lambda i: tl if i < 0 else t[i]
        lx = lambda i: tl if i < 0 else l[i]
        for y in range(4):
            for x in range(4):
                z = 2 * x - y
                if z >= 0 and z % 2 == 0:
                    p[y, x] = (tx(x - (y >> 1) - 1) + t[x - (y >> 1)] + 1) >> 1
                elif z >= 0:
                    p[y, x] = (tx(x - (y >> 1) - 2) + 2 * tx(x - (y >> 1) - 1)
                               + t[x - (y >> 1)] + 2) >> 2
                elif z == -1:
                    p[y, x] = (l[0] + 2 * tl + t[0] + 2) >> 2
                else:
                    p[y, x] = (lx(y - 1) + 2 * lx(y - 2) + lx(y - 3) + 2) >> 2
    elif mode == 6:        # Horizontal-Down
        tx = lambda i: tl if i < 0 else t[i]
        lx = lambda i: tl if i < 0 else l[i]
        for y in range(4):
            for x in range(4):
                z = 2 * y - x
                if z >= 0 and z % 2 == 0:
                    p[y, x] = (lx(y - (x >> 1) - 1) + l[y - (x >> 1)] + 1) >> 1
                elif z >= 0:
                    p[y, x] = (lx(y - (x >> 1) - 2) + 2 * lx(y - (x >> 1) - 1)
                               + l[y - (x >> 1)] + 2) >> 2
                elif z == -1:
                    p[y, x] = (l[0] + 2 * tl + t[0] + 2) >> 2
                else:
                    p[y, x] = (tx(x - 1) + 2 * tx(x - 2) + tx(x - 3) + 2) >> 2
    elif mode == 7:        # Vertical-Left
        for y in range(4):
            for x in range(4):
                if y % 2 == 0:
                    p[y, x] = (t[x + (y >> 1)] + t[x + (y >> 1) + 1] + 1) >> 1
                else:
                    p[y, x] = (t[x + (y >> 1)] + 2 * t[x + (y >> 1) + 1]
                               + t[x + (y >> 1) + 2] + 2) >> 2
    elif mode == 8:        # Horizontal-Up
        for y in range(4):
            for x in range(4):
                z = x + 2 * y
                if z % 2 == 0 and z <= 4:
                    p[y, x] = (l[y + (x >> 1)] + l[y + (x >> 1) + 1] + 1) >> 1
                elif z in (1, 3):
                    p[y, x] = (l[y + (x >> 1)] + 2 * l[y + (x >> 1) + 1]
                               + l[y + (x >> 1) + 2] + 2) >> 2
                elif z == 5:
                    p[y, x] = (l[2] + 3 * l[3] + 2) >> 2
                else:
                    p[y, x] = l[3]
    else:
        raise ValueError(f"bad intra4x4 mode {mode}")
    return p


def intra8x8_filter(t, l, tl, aA, aB, aC, aD):
    """§8.3.2.2.1 reference sample filtering for Intra_8x8.
    t = p[0..15,-1] (already C-substituted), l = p[-1,0..7], tl.
    Returns (t', l', tl')."""
    t = t.astype(np.int32)
    l = l.astype(np.int32)
    tl = int(tl)
    tf = t.copy()
    lf = l.copy()
    tlf = tl
    if aB:
        if aD:
            tf[0] = (tl + 2 * t[0] + t[1] + 2) >> 2
        else:
            tf[0] = (3 * t[0] + t[1] + 2) >> 2
        for x in range(1, 15):
            tf[x] = (t[x - 1] + 2 * t[x] + t[x + 1] + 2) >> 2
        tf[15] = (t[14] + 3 * t[15] + 2) >> 2
    if aD:
        if aA and aB:
            tlf = (t[0] + 2 * tl + l[0] + 2) >> 2
        elif aB:
            tlf = (3 * tl + t[0] + 2) >> 2
        elif aA:
            tlf = (3 * tl + l[0] + 2) >> 2
    if aA:
        if aD:
            lf[0] = (tl + 2 * l[0] + l[1] + 2) >> 2
        else:
            lf[0] = (3 * l[0] + l[1] + 2) >> 2
        for y in range(1, 7):
            lf[y] = (l[y - 1] + 2 * l[y] + l[y + 1] + 2) >> 2
        lf[7] = (l[6] + 3 * l[7] + 2) >> 2
    return tf, lf, tlf


def intra8x8_pred(mode, t, l, tl, aA, aB):
    """§8.3.2.2.2-10 on *filtered* samples.  t = p'[0..15,-1],
    l = p'[-1,0..7], tl = p'[-1,-1]."""
    t = t.astype(np.int32)
    l = l.astype(np.int32)
    tl = int(tl)
    p = np.zeros((8, 8), np.int32)
    if mode == 0:          # Vertical
        p[:] = t[:8][None, :]
    elif mode == 1:        # Horizontal
        p[:] = l[:, None]
    elif mode == 2:        # DC
        if aA and aB:
            p[:] = (t[:8].sum() + l.sum() + 8) >> 4
        elif aA:
            p[:] = (l.sum() + 4) >> 3
        elif aB:
            p[:] = (t[:8].sum() + 4) >> 3
        else:
            p[:] = 128
    elif mode == 3:        # Diagonal-Down-Left
        for y in range(8):
            for x in range(8):
                if x == 7 and y == 7:
                    p[y, x] = (t[14] + 3 * t[15] + 2) >> 2
                else:
                    p[y, x] = (t[x + y] + 2 * t[x + y + 1] + t[x + y + 2] + 2) >> 2
    elif mode == 4:        # Diagonal-Down-Right
        tx = lambda i: tl if i < 0 else t[i]
        lx = lambda i: tl if i < 0 else l[i]
        for y in range(8):
            for x in range(8):
                if x > y:
                    p[y, x] = (tx(x - y - 2) + 2 * t[x - y - 1] + t[x - y] + 2) >> 2
                elif x < y:
                    p[y, x] = (lx(y - x - 2) + 2 * l[y - x - 1] + l[y - x] + 2) >> 2
                else:
                    p[y, x] = (t[0] + 2 * tl + l[0] + 2) >> 2
    elif mode == 5:        # Vertical-Right
        tx = lambda i: tl if i < 0 else t[i]
        lx = lambda i: tl if i < 0 else l[i]
        for y in range(8):
            for x in range(8):
                z = 2 * x - y
                if z >= 0 and z % 2 == 0:
                    p[y, x] = (tx(x - (y >> 1) - 1) + t[x - (y >> 1)] + 1) >> 1
                elif z >= 0:
                    p[y, x] = (tx(x - (y >> 1) - 2) + 2 * tx(x - (y >> 1) - 1)
                               + t[x - (y >> 1)] + 2) >> 2
                elif z == -1:
                    p[y, x] = (l[0] + 2 * tl + t[0] + 2) >> 2
                else:
                    p[y, x] = (lx(y - 2 * x - 1) + 2 * lx(y - 2 * x - 2)
                               + lx(y - 2 * x - 3) + 2) >> 2
    elif mode == 6:        # Horizontal-Down
        tx = lambda i: tl if i < 0 else t[i]
        lx = lambda i: tl if i < 0 else l[i]
        for y in range(8):
            for x in range(8):
                z = 2 * y - x
                if z >= 0 and z % 2 == 0:
                    p[y, x] = (lx(y - (x >> 1) - 1) + l[y - (x >> 1)] + 1) >> 1
                elif z >= 0:
                    p[y, x] = (lx(y - (x >> 1) - 2) + 2 * lx(y - (x >> 1) - 1)
                               + l[y - (x >> 1)] + 2) >> 2
                elif z == -1:
                    p[y, x] = (l[0] + 2 * tl + t[0] + 2) >> 2
                else:
                    p[y, x] = (tx(x - 2 * y - 1) + 2 * tx(x - 2 * y - 2)
                               + tx(x - 2 * y - 3) + 2) >> 2
    elif mode == 7:        # Vertical-Left
        for y in range(8):
            for x in range(8):
                if y % 2 == 0:
                    p[y, x] = (t[x + (y >> 1)] + t[x + (y >> 1) + 1] + 1) >> 1
                else:
                    p[y, x] = (t[x + (y >> 1)] + 2 * t[x + (y >> 1) + 1]
                               + t[x + (y >> 1) + 2] + 2) >> 2
    elif mode == 8:        # Horizontal-Up
        for y in range(8):
            for x in range(8):
                z = x + 2 * y
                if z % 2 == 0 and z <= 12:
                    p[y, x] = (l[y + (x >> 1)] + l[y + (x >> 1) + 1] + 1) >> 1
                elif z < 13:
                    p[y, x] = (l[y + (x >> 1)] + 2 * l[y + (x >> 1) + 1]
                               + l[y + (x >> 1) + 2] + 2) >> 2
                elif z == 13:
                    p[y, x] = (l[6] + 3 * l[7] + 2) >> 2
                else:
                    p[y, x] = l[7]
    else:
        raise ValueError(f"bad intra8x8 mode {mode}")
    return p


def intra16x16_pred(mode, t, l, tl, aA, aB):
    """§8.3.3.  t = p[0..15,-1], l = p[-1,0..15], tl = p[-1,-1]."""
    t = t.astype(np.int32)
    l = l.astype(np.int32)
    tl = int(tl)
    p = np.zeros((16, 16), np.int32)
    if mode == 0:          # Vertical
        p[:] = t[None, :]
    elif mode == 1:        # Horizontal
        p[:] = l[:, None]
    elif mode == 2:        # DC
        if aA and aB:
            p[:] = (t.sum() + l.sum() + 16) >> 5
        elif aA:
            p[:] = (l.sum() + 8) >> 4
        elif aB:
            p[:] = (t.sum() + 8) >> 4
        else:
            p[:] = 128
    elif mode == 3:        # Plane
        H = sum((x + 1) * (int(t[8 + x]) - int(t[6 - x] if 6 - x >= 0 else tl))
                for x in range(8))
        V = sum((y + 1) * (int(l[8 + y]) - int(l[6 - y] if 6 - y >= 0 else tl))
                for y in range(8))
        a = 16 * (int(l[15]) + int(t[15]))
        b = (5 * H + 32) >> 6
        c = (5 * V + 32) >> 6
        for y in range(16):
            for x in range(16):
                p[y, x] = np.clip((a + b * (x - 7) + c * (y - 7) + 16) >> 5,
                                  0, 255)
    else:
        raise ValueError(f"bad intra16x16 mode {mode}")
    return p


def intra_chroma_pred(mode, t, l, tl, aA, aB):
    """§8.3.4 (4:2:0, 8x8).  Chroma mode numbering: 0 DC, 1 H, 2 V, 3 Plane.
    t = p[0..7,-1], l = p[-1,0..7], tl = p[-1,-1]."""
    t = t.astype(np.int32)
    l = l.astype(np.int32)
    tl = int(tl)
    p = np.zeros((8, 8), np.int32)
    if mode == 0:          # DC, per 4x4 sub-block
        for cy in (0, 4):
            for cx in (0, 4):
                ts = t[cx:cx + 4].sum()
                ls = l[cy:cy + 4].sum()
                if (cx == 0 and cy == 0) or (cx > 0 and cy > 0):
                    if aA and aB:
                        v = (ts + ls + 4) >> 3
                    elif aA:
                        v = (ls + 2) >> 2
                    elif aB:
                        v = (ts + 2) >> 2
                    else:
                        v = 128
                elif cx > 0:           # top-right block: prefer top
                    if aB:
                        v = (ts + 2) >> 2
                    elif aA:
                        v = (ls + 2) >> 2
                    else:
                        v = 128
                else:                  # bottom-left block: prefer left
                    if aA:
                        v = (ls + 2) >> 2
                    elif aB:
                        v = (ts + 2) >> 2
                    else:
                        v = 128
                p[cy:cy + 4, cx:cx + 4] = v
    elif mode == 1:        # Horizontal
        p[:] = l[:, None]
    elif mode == 2:        # Vertical
        p[:] = t[None, :]
    elif mode == 3:        # Plane
        H = sum((x + 1) * (int(t[4 + x]) - int(t[2 - x] if 2 - x >= 0 else tl))
                for x in range(4))
        V = sum((y + 1) * (int(l[4 + y]) - int(l[2 - y] if 2 - y >= 0 else tl))
                for y in range(4))
        a = 16 * (int(l[7]) + int(t[7]))
        b = (34 * H + 32) >> 6
        c = (34 * V + 32) >> 6
        for y in range(8):
            for x in range(8):
                p[y, x] = np.clip((a + b * (x - 3) + c * (y - 3) + 16) >> 5,
                                  0, 255)
    else:
        raise ValueError(f"bad chroma mode {mode}")
    return p


# ---------------------------------------------------------------------------
# Whole-frame intra reconstruction from syntax planes

# block scan order within a macroblock (quad order, §6.4.3)
BLK4_X = np.array([0, 1, 0, 1, 2, 3, 2, 3, 0, 1, 0, 1, 2, 3, 2, 3])
BLK4_Y = np.array([0, 0, 1, 1, 0, 0, 1, 1, 2, 2, 3, 3, 2, 2, 3, 3])
BLK8_X = np.array([0, 1, 0, 1])
BLK8_Y = np.array([0, 0, 1, 1])

MBF_INTRA, MBF_I16x16, MBF_IPCM, MBF_T8x8 = 1, 2, 4, 8
MBF_SKIP, MBF_PARSED, MBF_INTER = 16, 32, 64


class ScalingMatrices:
    """Per-frame weight-scale matrices (flat 16 unless High-profile scaling
    lists are active).  Index: [intraY, intraCb, intraCr, interY, interCb,
    interCr] for 4x4; [intraY, interY, intraCb, interCb, intraCr, interCr]
    for 8x8 (§7.4.2.1.1.1)."""

    def __init__(self, ws4=None, ws8=None):
        self.ws4 = (np.asarray(ws4, np.int32).reshape(6, 4, 4)
                    if ws4 is not None else np.tile(FLAT16_4, (6, 1, 1)))
        self.ws8 = (np.asarray(ws8, np.int32).reshape(6, 8, 8)
                    if ws8 is not None else np.tile(FLAT16_8, (6, 1, 1)))


def reconstruct_intra_mb(pl, y, cb, cr, mx, my, sm: ScalingMatrices):
    """Reconstruct one intra macroblock in place into images y/cb/cr
    (uint8 [16H,16W] / [8H,8W]).  `pl` is a SyntaxPlanes view."""
    flags = int(pl.mb_flags[my, mx])
    if flags & MBF_IPCM:
        y[my * 16:(my + 1) * 16, mx * 16:(mx + 1) * 16] = \
            pl.pcm_y[my * 16:(my + 1) * 16, mx * 16:(mx + 1) * 16]
        cb[my * 8:(my + 1) * 8, mx * 8:(mx + 1) * 8] = \
            pl.pcm_c[0, my * 8:(my + 1) * 8, mx * 8:(mx + 1) * 8]
        cr[my * 8:(my + 1) * 8, mx * 8:(mx + 1) * 8] = \
            pl.pcm_c[1, my * 8:(my + 1) * 8, mx * 8:(mx + 1) * 8]
        return

    qpy = int(pl.qp[my, mx, 0])
    x0, y0 = mx * 16, my * 16

    if flags & MBF_I16x16:
        mb = int(pl.i16_modes[my, mx])
        mode, aA, aB, aD = mb & 3, mb >> 4 & 1, mb >> 5 & 1, mb >> 6 & 1
        t = y[y0 - 1, x0:x0 + 16] if aB else np.zeros(16, np.uint8)
        l = y[y0:y0 + 16, x0 - 1] if aA else np.zeros(16, np.uint8)
        # PHYSICAL corner sample regardless of D availability: plane is
        # the only consumer, it only runs with A and B available, and
        # the reference reads the decoded pixel across slice boundaries
        # (its I16x16/chroma mode tables key on A/B only)
        tl = y[max(y0 - 1, 0), max(x0 - 1, 0)]
        pred = intra16x16_pred(mode, t, l, tl, aA, aB)
        dc = luma_dc_dequant(pl.coef_y_dc[my, mx].reshape(4, 4), qpy,
                             sm.ws4[0][0, 0])
        for i in range(16):
            bx, by = int(BLK4_X[i]), int(BLK4_Y[i])
            d = scale_block4(pl.coef_y[my * 4 + by, mx * 4 + bx].reshape(4, 4),
                             qpy, sm.ws4[0], skip_dc=True)
            d[0, 0] = dc[by, bx]
            r = idct4(d)
            ys, xs = y0 + by * 4, x0 + bx * 4
            y[ys:ys + 4, xs:xs + 4] = clip1(
                pred[by * 4:by * 4 + 4, bx * 4:bx * 4 + 4] + r)
    elif flags & MBF_T8x8:
        for i in range(4):
            bx, by = int(BLK8_X[i]), int(BLK8_Y[i])
            mb = int(pl.i8_modes[my * 2 + by, mx * 2 + bx])
            mode = mb & 15
            aA, aB = mb >> 4 & 1, mb >> 5 & 1
            aC, aD = mb >> 6 & 1, mb >> 7 & 1
            ys, xs = y0 + by * 8, x0 + bx * 8
            t = np.zeros(16, np.int32)
            if aB:
                t[:8] = y[ys - 1, xs:xs + 8]
                if aC:
                    t[8:] = y[ys - 1, xs + 8:xs + 16]
                else:
                    t[8:] = t[7]
            l = y[ys:ys + 8, xs - 1].astype(np.int32) if aA \
                else np.zeros(8, np.int32)
            tl = int(y[ys - 1, xs - 1]) if aD else 0
            tf, lf, tlf = intra8x8_filter(t, l, tl, aA, aB, aC, aD)
            pred = intra8x8_pred(mode, tf, lf, tlf, aA, aB)
            d = scale_block8(pl.coef_y8[my * 2 + by, mx * 2 + bx].reshape(8, 8),
                             qpy, sm.ws8[0])
            y[ys:ys + 8, xs:xs + 8] = clip1(pred + idct8(d))
    else:                  # Intra_4x4
        for i in range(16):
            bx, by = int(BLK4_X[i]), int(BLK4_Y[i])
            mb = int(pl.i4_modes[my * 4 + by, mx * 4 + bx])
            mode = mb & 15
            aA, aB = mb >> 4 & 1, mb >> 5 & 1
            aC, aD = mb >> 6 & 1, mb >> 7 & 1
            ys, xs = y0 + by * 4, x0 + bx * 4
            t = np.zeros(8, np.int32)
            if aB:
                t[:4] = y[ys - 1, xs:xs + 4]
                if aC:
                    t[4:] = y[ys - 1, xs + 4:xs + 8]
                else:
                    t[4:] = t[3]
            l = y[ys:ys + 4, xs - 1].astype(np.int32) if aA \
                else np.zeros(4, np.int32)
            tl = int(y[ys - 1, xs - 1]) if aD else 0
            pred = intra4x4_pred(mode, t, l, tl, aA, aB)
            d = scale_block4(pl.coef_y[my * 4 + by, mx * 4 + bx].reshape(4, 4),
                             qpy, sm.ws4[0])
            y[ys:ys + 4, xs:xs + 4] = clip1(pred + idct4(d))

    # ---- chroma ----------------------------------------------------------
    cm = int(pl.ch_modes[my, mx])
    mode, aA, aB, aD = cm & 3, cm >> 4 & 1, cm >> 5 & 1, cm >> 6 & 1
    cx0, cy0 = mx * 8, my * 8
    for comp, img, coefp, qpc in ((0, cb, pl.coef_cb, int(pl.qp[my, mx, 1])),
                                  (1, cr, pl.coef_cr, int(pl.qp[my, mx, 2]))):
        t = img[cy0 - 1, cx0:cx0 + 8] if aB else np.zeros(8, np.uint8)
        l = img[cy0:cy0 + 8, cx0 - 1] if aA else np.zeros(8, np.uint8)
        tl = img[max(cy0 - 1, 0), max(cx0 - 1, 0)]   # physical (see i16)
        pred = intra_chroma_pred(mode, t, l, tl, aA, aB)
        ws = sm.ws4[1 + comp]
        dc = chroma_dc_dequant(pl.coef_c_dc[my, mx, comp].reshape(2, 2), qpc,
                               ws[0, 0])
        for by in range(2):
            for bx in range(2):
                d = scale_block4(coefp[my * 2 + by, mx * 2 + bx].reshape(4, 4),
                                 qpc, ws, skip_dc=True)
                d[0, 0] = dc[by, bx]
                r = idct4(d)
                ys, xs = cy0 + by * 4, cx0 + bx * 4
                img[ys:ys + 4, xs:xs + 4] = clip1(
                    pred[by * 4:by * 4 + 4, bx * 4:bx * 4 + 4] + r)


def reconstruct_frame(pl, sm: ScalingMatrices | None = None, dpb=None):
    """Reconstruct a full frame from syntax planes; returns (y, cb, cr)
    uint8 images (uncropped, mb-aligned).  Intra-only for now; inter mbs
    (dpb = dict slot -> (y,cb,cr)) come with the MC milestone."""
    sm = sm or ScalingMatrices()
    H, W = pl.mb_h, pl.mb_w
    y = np.zeros((H * 16, W * 16), np.uint8)
    cb = np.zeros((H * 8, W * 8), np.uint8)
    cr = np.zeros((H * 8, W * 8), np.uint8)
    for my in range(H):
        for mx in range(W):
            flags = int(pl.mb_flags[my, mx])
            if not flags & MBF_PARSED:
                continue
            if flags & MBF_INTRA:
                reconstruct_intra_mb(pl, y, cb, cr, mx, my, sm)
            elif flags & MBF_INTER:
                reconstruct_inter_mb(pl, y, cb, cr, mx, my, sm, dpb)
    return y, cb, cr


# ---------------------------------------------------------------------------
# Motion compensation (§8.4.2.2): 6-tap quarter-pel luma, bilinear
# eighth-pel chroma, with edge replication via clamped indices (the oracle
# twin of the reference's clamped loads, edge264_inter.c:362-415).

def _six(a, axis):
    """6-tap (1,-5,20,20,-5,1) along `axis`, valid positions only."""
    n = a.shape[axis]

    def s(i):
        idx = [slice(None)] * a.ndim
        idx[axis] = slice(i, n - 5 + i)
        return a[tuple(idx)]

    return s(0) - 5 * s(1) + 20 * s(2) + 20 * s(3) - 5 * s(4) + s(5)


def mc_luma(ref, px, py, fx, fy, w, h):
    """Predict a w*h luma block whose top-left full-pel position is
    (px, py) with fractional offsets (fx, fy) in quarter pels."""
    H, W = ref.shape
    ys = np.clip(np.arange(py - 2, py + h + 3), 0, H - 1)
    xs = np.clip(np.arange(px - 2, px + w + 3), 0, W - 1)
    win = ref[np.ix_(ys, xs)].astype(np.int32)      # [(h+5), (w+5)]
    G = win[2:2 + h, 2:2 + w]
    if fx == 0 and fy == 0:
        return G
    Hn = win[2:2 + h, 3:3 + w]
    M = win[3:3 + h, 2:2 + w]
    braw = _six(win, 1)                             # [(h+5), w] horizontal
    b_all = clip1((braw + 16) >> 5)
    b = b_all[2:2 + h]
    s = b_all[3:3 + h]
    hraw = _six(win, 0)                             # [h, (w+5)] vertical
    h_all = clip1((hraw + 16) >> 5)
    hh = h_all[:, 2:2 + w]
    m = h_all[:, 3:3 + w]
    j = clip1((_six(braw, 0) + 512) >> 10)          # [h, w]
    table = {
        (1, 0): (G + b + 1) >> 1,
        (2, 0): b,
        (3, 0): (Hn + b + 1) >> 1,
        (0, 1): (G + hh + 1) >> 1,
        (1, 1): (b + hh + 1) >> 1,
        (2, 1): (b + j + 1) >> 1,
        (3, 1): (b + m + 1) >> 1,
        (0, 2): hh,
        (1, 2): (hh + j + 1) >> 1,
        (2, 2): j,
        (3, 2): (j + m + 1) >> 1,
        (0, 3): (M + hh + 1) >> 1,
        (1, 3): (hh + s + 1) >> 1,
        (2, 3): (j + s + 1) >> 1,
        (3, 3): (m + s + 1) >> 1,
    }
    return table[(fx, fy)]


def mc_chroma(ref, px, py, dx, dy, w, h):
    """Predict a w*h chroma block at full-pel (px, py) with eighth-pel
    fractional offsets (dx, dy)."""
    H, W = ref.shape
    ys = np.clip(np.arange(py, py + h + 1), 0, H - 1)
    xs = np.clip(np.arange(px, px + w + 1), 0, W - 1)
    win = ref[np.ix_(ys, xs)].astype(np.int32)
    A = win[0:h, 0:w]
    B = win[0:h, 1:w + 1]
    C = win[1:h + 1, 0:w]
    D = win[1:h + 1, 1:w + 1]
    return ((8 - dx) * (8 - dy) * A + dx * (8 - dy) * B
            + (8 - dx) * dy * C + dx * dy * D + 32) >> 6


def _weight_single(pred, w, o, logwd):
    """§8.4.2.3.2, single-list explicit weighting."""
    if logwd >= 1:
        v = ((pred * w + (1 << (logwd - 1))) >> logwd) + o
    else:
        v = pred * w + o
    return clip1(v)


def _weight_bi(p0, p1, w0, w1, o0, o1, logwd):
    v = ((p0 * w0 + p1 * w1 + (1 << logwd)) >> (logwd + 1)) \
        + ((o0 + o1 + 1) >> 1)
    return clip1(v)


def _ref_or_gray(dpb, slot, pl):
    """Reference pixels for a DPB slot; a slot with no decoded pixels
    (a NON-EXISTING frame from gaps-in-frame_num handling, §8.2.5.2, or
    an erroneous reference) supplies mid-gray -- the reference leaves
    such buffers allocated-but-unwritten (edge264_headers.c:1122-1145),
    i.e. undefined content, so any deterministic fill is conformant."""
    f = dpb.get(slot)
    if f is not None:
        return f
    h, w = pl.mb_h * 16, pl.mb_w * 16
    g = (np.full((h, w), 128, np.uint8),
         np.full((h // 2, w // 2), 128, np.uint8),
         np.full((h // 2, w // 2), 128, np.uint8))
    dpb[slot] = g
    return g


def inter_pred_mb(pl, mx, my, dpb):
    """Motion-compensated prediction for one inter mb at uniform 4x4
    granularity; returns (pred_y [16,16], pred_cb [8,8], pred_cr [8,8])."""
    py_out = np.zeros((16, 16), np.int32)
    pc_out = [np.zeros((8, 8), np.int32), np.zeros((8, 8), np.int32)]
    wp = pl.wp[my, mx]
    mode, lwd, cwd = int(wp[0]), int(wp[1]), int(wp[2])
    for cy in range(4):
        for cx in range(4):
            gx, gy = mx * 4 + cx, my * 4 + cy
            preds_y, preds_c = [], []
            lists = [l for l in range(2) if pl.refslot[gy, gx, l] >= 0]
            w8 = pl.wp8[my * 2 + (cy >> 1), mx * 2 + (cx >> 1)]
            for l in lists:
                slot = int(pl.refslot[gy, gx, l])
                ry, rcb, rcr = _ref_or_gray(dpb, slot, pl)
                mvx = int(pl.mvs[gy, gx, l, 0])
                mvy = int(pl.mvs[gy, gx, l, 1])
                preds_y.append(mc_luma(ry, gx * 4 + (mvx >> 2),
                                       gy * 4 + (mvy >> 2),
                                       mvx & 3, mvy & 3, 4, 4))
                preds_c.append([
                    mc_chroma(rc, gx * 2 + (mvx >> 3), gy * 2 + (mvy >> 3),
                              mvx & 7, mvy & 7, 2, 2)
                    for rc in (rcb, rcr)])
            if not lists:
                # no valid reference on either list (corrupt stream /
                # modification to a nonexistent pic): predict mid-gray,
                # the concealment default
                y4 = np.full((4, 4), 128, np.int32)
                c4 = [np.full((2, 2), 128, np.int32) for _ in range(2)]
            elif len(lists) == 1:
                l = lists[0]
                if mode == 1:
                    y4 = _weight_single(preds_y[0], int(w8[l, 0, 0]),
                                        int(w8[l, 0, 1]), lwd)
                    c4 = [_weight_single(preds_c[0][c],
                                         int(w8[l, 1 + c, 0]),
                                         int(w8[l, 1 + c, 1]), cwd)
                          for c in range(2)]
                else:
                    y4, c4 = preds_y[0], preds_c[0]
            else:
                if mode == 0:
                    y4 = (preds_y[0] + preds_y[1] + 1) >> 1
                    c4 = [(preds_c[0][c] + preds_c[1][c] + 1) >> 1
                          for c in range(2)]
                else:       # explicit / implicit bi
                    y4 = _weight_bi(preds_y[0], preds_y[1],
                                    int(w8[0, 0, 0]), int(w8[1, 0, 0]),
                                    int(w8[0, 0, 1]), int(w8[1, 0, 1]), lwd)
                    c4 = [_weight_bi(preds_c[0][c], preds_c[1][c],
                                     int(w8[0, 1 + c, 0]), int(w8[1, 1 + c, 0]),
                                     int(w8[0, 1 + c, 1]), int(w8[1, 1 + c, 1]),
                                     cwd)
                          for c in range(2)]
            py_out[cy * 4:cy * 4 + 4, cx * 4:cx * 4 + 4] = y4
            for c in range(2):
                pc_out[c][cy * 2:cy * 2 + 2, cx * 2:cx * 2 + 2] = c4[c]
    return py_out, pc_out[0], pc_out[1]


def reconstruct_inter_mb(pl, y, cb, cr, mx, my, sm: ScalingMatrices, dpb):
    """MC + residual for one inter macroblock."""
    pred_y, pred_cb, pred_cr = inter_pred_mb(pl, mx, my, dpb)
    qpy = int(pl.qp[my, mx, 0])
    x0, y0 = mx * 16, my * 16
    t8 = int(pl.mb_flags[my, mx]) & MBF_T8x8
    if t8:
        for by in range(2):
            for bx in range(2):
                d = scale_block8(pl.coef_y8[my * 2 + by, mx * 2 + bx]
                                 .reshape(8, 8), qpy, sm.ws8[1])
                r = idct8(d)
                ys, xs = by * 8, bx * 8
                y[y0 + ys:y0 + ys + 8, x0 + xs:x0 + xs + 8] = clip1(
                    pred_y[ys:ys + 8, xs:xs + 8] + r)
    else:
        for i in range(16):
            bx, by = int(BLK4_X[i]), int(BLK4_Y[i])
            d = scale_block4(pl.coef_y[my * 4 + by, mx * 4 + bx].reshape(4, 4),
                             qpy, sm.ws4[3])
            r = idct4(d)
            ys, xs = by * 4, bx * 4
            y[y0 + ys:y0 + ys + 4, x0 + xs:x0 + xs + 4] = clip1(
                pred_y[ys:ys + 4, xs:xs + 4] + r)
    cx0, cy0 = mx * 8, my * 8
    for comp, img, coefp, pred, qpc in (
            (0, cb, pl.coef_cb, pred_cb, int(pl.qp[my, mx, 1])),
            (1, cr, pl.coef_cr, pred_cr, int(pl.qp[my, mx, 2]))):
        ws = sm.ws4[4 + comp]
        dc = chroma_dc_dequant(pl.coef_c_dc[my, mx, comp].reshape(2, 2), qpc,
                               ws[0, 0])
        for by in range(2):
            for bx in range(2):
                d = scale_block4(coefp[my * 2 + by, mx * 2 + bx].reshape(4, 4),
                                 qpc, ws, skip_dc=True)
                d[0, 0] = dc[by, bx]
                r = idct4(d)
                ys, xs = cy0 + by * 4, cx0 + bx * 4
                img[ys:ys + 4, xs:xs + 4] = clip1(
                    pred[by * 4:by * 4 + 4, bx * 4:bx * 4 + 4] + r)
