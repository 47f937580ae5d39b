"""Numpy golden model of the in-loop deblocking filter (§8.7): the port's
own copy of the JAX package's `ops/deblock_oracle.py`, unchanged but for
its docstrings.

Spec-order sequential filtering: macroblocks in raster order, vertical
edges left-to-right then horizontal edges top-to-bottom, in place.  The
port's deblocking (ops/deblock.py and kernels/csrc/deblock.cu)
reformulates this as wavefront passes; this model shares no code with
them (the reference's vectorized bS logic is described at
edge264_deblock.c:899-926).

bS derivation covers the full rule set (intra/coeff/mv) so P/B frames use
the same model.
"""

from __future__ import annotations

import numpy as np

from .oracle import MBF_INTRA, MBF_PARSED, MBF_T8x8

# §8.7.2.2 Table 8-16 (alpha/beta) and Table 8-17 (tC0), indexA/B = 0..51
ALPHA = np.array([0] * 16 + [4, 4, 5, 6, 7, 8, 9, 10, 12, 13, 15, 17, 20, 22,
                             25, 28, 32, 36, 40, 45, 50, 56, 63, 71, 80, 90,
                             101, 113, 127, 144, 162, 182, 203, 226, 255, 255],
                 np.int32)
BETA = np.array([0] * 16 + [2, 2, 2, 3, 3, 3, 3, 4, 4, 4, 6, 6, 7, 7, 8, 8,
                            9, 9, 10, 10, 11, 11, 12, 12, 13, 13, 14, 14, 15,
                            15, 16, 16, 17, 17, 18, 18], np.int32)
TC0 = np.array([
    [0] * 16 + [0, 0, 0, 0, 0, 0, 0, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 2, 2, 2,
                2, 3, 3, 3, 4, 4, 4, 5, 6, 6, 7, 8, 9, 10, 11, 13],
    [0] * 16 + [0, 0, 0, 0, 0, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 2, 2, 2, 2, 3,
                3, 3, 4, 4, 5, 5, 6, 7, 8, 8, 10, 11, 12, 13, 15, 17],
    [0] * 16 + [0, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 2, 2, 2, 2, 3, 3, 3, 4, 4,
                4, 5, 6, 6, 7, 8, 9, 10, 11, 13, 14, 16, 18, 20, 23, 25],
], np.int32)

DBF_LEFT, DBF_TOP, DBF_INNER = 1, 2, 4


def _nz_eff(pl, x, y):
    """Non-zero-coefficient flag of the transform block covering cell (x,y):
    8x8 granularity for transform_size_8x8 macroblocks (§8.7.2.1)."""
    if int(pl.mb_flags[y >> 2, x >> 2]) & MBF_T8x8:
        x0, y0 = x & ~1, y & ~1
        return pl.nz_y[y0:y0 + 2, x0:x0 + 2].any()
    return pl.nz_y[y, x] > 0


def _block_bs_inter(pl, px, py, qx, qy):
    """bS for an edge between two inter 4x4 luma blocks (block coords in the
    global 4x4 grid): coefficient rule then the mv/ref rules (§8.7.2.1)."""
    if _nz_eff(pl, px, py) or _nz_eff(pl, qx, qy):
        return 2
    pr = [int(pl.refslot[py, px, l]) for l in range(2)]
    qr = [int(pl.refslot[qy, qx, l]) for l in range(2)]
    pm = [pl.mvs[py, px, l].astype(int) for l in range(2)]
    qm = [pl.mvs[qy, qx, l].astype(int) for l in range(2)]
    pused = [l for l in range(2) if pr[l] >= 0]
    qused = [l for l in range(2) if qr[l] >= 0]
    if len(pused) != len(qused):
        return 1
    if sorted(pr[l] for l in pused) != sorted(qr[l] for l in qused):
        return 1

    def far(a, b):
        return abs(a[0] - b[0]) >= 4 or abs(a[1] - b[1]) >= 4

    if len(pused) == 1:
        return 1 if far(pm[pused[0]], qm[qused[0]]) else 0
    # bidirectional: same two pictures on both sides
    p0r, p1r = pr[0], pr[1]
    q0r, q1r = qr[0], qr[1]
    if p0r != p1r:
        # distinct pictures: compare mvs of matching pictures
        qm_for = {q0r: qm[0], q1r: qm[1]}
        return 1 if (far(pm[0], qm_for[p0r]) or far(pm[1], qm_for[p1r])) else 0
    # same picture twice: bS=0 if either assignment has both pairs close
    a = not far(pm[0], qm[0]) and not far(pm[1], qm[1])
    b = not far(pm[0], qm[1]) and not far(pm[1], qm[0])
    return 0 if (a or b) else 1


def _edge_bs(pl, mx, my, edge, vertical):
    """bS values for the 4 segments of one luma edge of mb (mx,my).
    edge = 0..3 (position k*4 within the mb; 0 = mb boundary)."""
    bs = np.zeros(4, np.int32)
    qflags = int(pl.mb_flags[my, mx])
    if edge == 0:
        pmx, pmy = (mx - 1, my) if vertical else (mx, my - 1)
        pflags = int(pl.mb_flags[pmy, pmx])
        if (qflags | pflags) & MBF_INTRA:
            return bs + 4
    else:
        if qflags & MBF_INTRA:
            return bs + 3
    for seg in range(4):
        if vertical:
            qx, qy = mx * 4 + edge, my * 4 + seg
            px, py = qx - 1, qy
        else:
            qx, qy = mx * 4 + seg, my * 4 + edge
            px, py = qx, qy - 1
        bs[seg] = _block_bs_inter(pl, px, py, qx, qy)
    return bs


def _filter_luma_line(p, q, alpha, beta, bs, tc0):
    p0, p1, p2, p3 = p
    q0, q1, q2, q3 = q
    if abs(p0 - q0) >= alpha or abs(p1 - p0) >= beta or abs(q1 - q0) >= beta:
        return p, q
    ap = abs(p2 - p0) < beta
    aq = abs(q2 - q0) < beta
    if bs == 4:
        strong = abs(p0 - q0) < (alpha >> 2) + 2
        if ap and strong:
            np0 = (p2 + 2 * p1 + 2 * p0 + 2 * q0 + q1 + 4) >> 3
            np1 = (p2 + p1 + p0 + q0 + 2) >> 2
            np2 = (2 * p3 + 3 * p2 + p1 + p0 + q0 + 4) >> 3
        else:
            np0 = (2 * p1 + p0 + q1 + 2) >> 2
            np1, np2 = p1, p2
        if aq and strong:
            nq0 = (q2 + 2 * q1 + 2 * q0 + 2 * p0 + p1 + 4) >> 3
            nq1 = (q2 + q1 + q0 + p0 + 2) >> 2
            nq2 = (2 * q3 + 3 * q2 + q1 + q0 + p0 + 4) >> 3
        else:
            nq0 = (2 * q1 + q0 + p1 + 2) >> 2
            nq1, nq2 = q1, q2
        return [np0, np1, np2, p3], [nq0, nq1, nq2, q3]
    tc = tc0 + ap + aq
    delta = (((q0 - p0) << 2) + (p1 - q1) + 4) >> 3
    delta = max(-tc, min(tc, delta))
    np0 = max(0, min(255, p0 + delta))
    nq0 = max(0, min(255, q0 - delta))
    avg = (p0 + q0 + 1) >> 1
    np1 = p1 + max(-tc0, min(tc0, (p2 + avg - 2 * p1) >> 1)) if ap else p1
    nq1 = q1 + max(-tc0, min(tc0, (q2 + avg - 2 * q1) >> 1)) if aq else q1
    return [np0, np1, p2, p3], [nq0, nq1, q2, q3]


def _filter_chroma_line(p, q, alpha, beta, bs, tc0):
    """Chroma line (§8.7.2.3/.4): only p0/q0 are modified."""
    p0, p1 = p
    q0, q1 = q
    if abs(p0 - q0) >= alpha or abs(p1 - p0) >= beta or abs(q1 - q0) >= beta:
        return p0, q0
    if bs == 4:
        return (2 * p1 + p0 + q1 + 2) >> 2, (2 * q1 + q0 + p1 + 2) >> 2
    tc = tc0 + 1
    delta = (((q0 - p0) << 2) + (p1 - q1) + 4) >> 3
    delta = max(-tc, min(tc, delta))
    return max(0, min(255, p0 + delta)), max(0, min(255, q0 - delta))


def deblock_mb(pl, y, cb, cr, mx, my):
    """Filter all edges of one macroblock in place (spec order: vertical
    edges left to right, then horizontal top to bottom)."""
    db = int(pl.deblock[my, mx])
    if not db:
        return
    offA = int(pl.deblock_ab[my, mx, 0])
    offB = int(pl.deblock_ab[my, mx, 1])
    qpq = [int(pl.qp[my, mx, c]) for c in range(3)]
    t8 = int(pl.mb_flags[my, mx]) & MBF_T8x8

    for vertical in (True, False):
        edges = []
        if vertical and db & DBF_LEFT:
            edges.append(0)
        if not vertical and db & DBF_TOP:
            edges.append(0)
        if db & DBF_INNER:
            edges += [2] if t8 else [1, 2, 3]
        for edge in edges:
            if edge == 0:
                pmx, pmy = (mx - 1, my) if vertical else (mx, my - 1)
            else:
                pmx, pmy = mx, my
            qpp = [int(pl.qp[pmy, pmx, c]) for c in range(3)]
            bs = _edge_bs(pl, mx, my, edge, vertical)
            if not bs.any():
                continue
            # luma
            qpav = (qpp[0] + qpq[0] + 1) >> 1
            ia = max(0, min(51, qpav + offA))
            ib = max(0, min(51, qpav + offB))
            alpha, beta = int(ALPHA[ia]), int(BETA[ib])
            if alpha and beta:
                for seg in range(4):
                    if not bs[seg]:
                        continue
                    tc0 = int(TC0[bs[seg] - 1, ia]) if bs[seg] < 4 else 0
                    for k in range(4):
                        if vertical:
                            r, c = my * 16 + seg * 4 + k, mx * 16 + edge * 4
                            p = [int(y[r, c - 1 - i]) for i in range(4)]
                            q = [int(y[r, c + i]) for i in range(4)]
                            np_, nq = _filter_luma_line(
                                p, q, alpha, beta, int(bs[seg]), tc0)
                            for i in range(4):
                                y[r, c - 1 - i] = np_[i]
                                y[r, c + i] = nq[i]
                        else:
                            r, c = my * 16 + edge * 4, mx * 16 + seg * 4 + k
                            p = [int(y[r - 1 - i, c]) for i in range(4)]
                            q = [int(y[r + i, c]) for i in range(4)]
                            np_, nq = _filter_luma_line(
                                p, q, alpha, beta, int(bs[seg]), tc0)
                            for i in range(4):
                                y[r - 1 - i, c] = np_[i]
                                y[r + i, c] = nq[i]
            # chroma: edges 0 and 2 only (chroma cols/rows 0 and 4)
            if edge in (0, 2):
                ce = edge // 2      # 0 or 1 -> chroma offset 0 or 4
                for comp, img in ((1, cb), (2, cr)):
                    qpav = (qpp[comp] + qpq[comp] + 1) >> 1
                    ia = max(0, min(51, qpav + offA))
                    ib = max(0, min(51, qpav + offB))
                    alpha, beta = int(ALPHA[ia]), int(BETA[ib])
                    if not (alpha and beta):
                        continue
                    for k in range(8):
                        seg = k >> 1          # luma segment for this line
                        if not bs[seg]:
                            continue
                        tc0 = int(TC0[bs[seg] - 1, ia]) if bs[seg] < 4 else 0
                        if vertical:
                            r, c = my * 8 + k, mx * 8 + ce * 4
                            p = [int(img[r, c - 1]), int(img[r, c - 2])]
                            q = [int(img[r, c]), int(img[r, c + 1])]
                            np0, nq0 = _filter_chroma_line(
                                p, q, alpha, beta, int(bs[seg]), tc0)
                            img[r, c - 1] = np0
                            img[r, c] = nq0
                        else:
                            r, c = my * 8 + ce * 4, mx * 8 + k
                            p = [int(img[r - 1, c]), int(img[r - 2, c])]
                            q = [int(img[r, c]), int(img[r + 1, c])]
                            np0, nq0 = _filter_chroma_line(
                                p, q, alpha, beta, int(bs[seg]), tc0)
                            img[r - 1, c] = np0
                            img[r, c] = nq0


def deblock_frame(pl, y, cb, cr):
    """In-place deblocking of a reconstructed frame, spec macroblock order."""
    for my in range(pl.mb_h):
        for mx in range(pl.mb_w):
            if int(pl.mb_flags[my, mx]) & MBF_PARSED:
                deblock_mb(pl, y, cb, cr, mx, my)


def blend_recovered_frame(planes, y, cb, cr):
    """Numpy mirror of ops/deblock.blend_recovered (recover_slice I path,
    edge264_headers.c:316-396): erroneous I mbs blend toward neighbour-edge
    DC with weight mb_errors*128/100, neighbours read pre-blend."""
    MBF_BLEND = 256
    flags = np.asarray(planes.mb_flags)
    bl = (flags & MBF_BLEND) > 0
    if not bl.any():
        return
    sid = np.asarray(planes.slice_id).astype(np.int32)
    w = np.clip(np.asarray(planes.mb_errors).astype(np.int32) * 128 // 100,
                0, 128)
    shl = lambda a, fill: np.concatenate(
        [np.full_like(a[:, :1], fill), a[:, :-1]], 1)
    shu = lambda a, fill: np.concatenate(
        [np.full_like(a[:1], fill), a[:-1]], 0)
    availA = bl & shl(bl, False) & (sid == shl(sid, -1))
    availB = bl & shu(bl, False) & (sid == shu(sid, -1))

    def one(img, ts):
        im = img.astype(np.int32)
        H, W = im.shape
        mh, mw = H // ts, W // ts
        cols = np.clip(np.arange(mw) * ts - 1, 0, W - 1)
        lsum = im[:, cols].reshape(mh, ts, mw).sum(1)
        rows = np.clip(np.arange(mh) * ts - 1, 0, H - 1)
        tsum = im[rows].reshape(mh, mw, ts).sum(2)
        none_sum = np.full_like(lsum, ts * 128)
        l = np.where(availA, lsum, np.where(availB, tsum, none_sum))
        t = np.where(availB, tsum, np.where(availA, lsum, none_sum))
        dc = (l + t + ts) >> ts.bit_length()
        rep = lambda a: np.repeat(np.repeat(a, ts, 0), ts, 1)
        wm, dcm, blm = rep(w), rep(dc), rep(bl)
        mixed = np.where(wm >= 128, dcm, (im * (128 - wm) + dcm * wm) >> 7)
        img[...] = np.where(blm, mixed, im).astype(img.dtype)

    one(y, 16)
    one(cb, 8)
    one(cr, 8)
