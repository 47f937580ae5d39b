"""Named, seeded test streams: one for each stream class the JAX
package's tests decode, built by the repository's generator through
`streams.avcgen()` (no JAX).

    from edge264_tpu_torch import corpus
    data = corpus.build("high_intra_scaling_pcm")     # bytes, seeded
    for name in corpus.CPU_CLASSES + corpus.CARD_CLASSES: ...

`CPU_CLASSES` stay at or below 22x18 mbs, so the numpy oracle decodes
each in seconds; `CARD_CLASSES` are 1920x1088 (120x68 mbs), for the card,
with the port's CPU path as their golden.  The recipes of the JAX
conformance tests are rebuilt from the generator's `make_*` calls, the
calls those tests make, at 11x9 mbs.  What each class reaches:

  cavlc_intra_slices        CAVLC intra, 3 slices a frame, PCM: intra
                            availability and deblocking at slice edges
  cavlc_ipp_5refs           CAVLC IPP, 5 references, 2 slices a frame:
                            the ring's slot maps, multi-slice inter
  cavlc_ipb_implicit_temporal  CAVLC closed IPB, implicit bipred
                            weights, temporal direct
  cavlc_ipb_open_gop        CAVLC open IPB: the lockstep takes the stream
                            as one GOP
  cabac_ipb_slices_init2    CABAC closed IPB, 3 slices, cabac_init_idc 2,
                            implicit weights, temporal direct
  cabac_ipb_deblock_off     CABAC closed IPB, disable_deblocking_filter_idc
                            1: every edge off
  deblock_idc2_offsets      3 slices a frame, disable_deblocking_filter_idc
                            2 and alpha/beta offsets: edges off at slice
                            boundaries only
  high_intra_scaling_pcm    High intra i4/i8/i16/PCM, scaling matrices,
                            separate Cb/Cr QP offsets
  high_ipp_t8               High CAVLC IPP, 8x8 transforms in inter mbs
  high_cabac_i8_pcm         High CABAC intra i4/i8/i16/PCM
  mvc_stereo                MVC, two views: inter-view references
  explicit_wp_p, explicit_wp_b_cavlc, explicit_w_cabac
                            explicit weights and offsets for each refIdx,
                            P and B, CAVLC and CABAC
  long_term_mmco_rplm       IDR long-term, MMCO 3/2 and 6, list reordering
                            (duplicate and long-term): five GOPs
  extreme_levels            levels of +-2063 at 22x18 mbs, then a P frame:
                            past int8
  truncated_concealment     a P slice cut in half, then an intra frame's:
                            mb_errors, P re-prediction, the blend of
                            recovered intra mbs
  qp_extremes               intra at QP 0, then at QP 51
  high_ipp_t8_1080p         High CAVLC IPP at 1080p, 8x8 transforms, 3
                            references
  cabac_ipb_slices_1080p    CABAC closed IPB at 1080p, 4 slices, implicit
                            weights, temporal direct, cabac_init_idc 1
"""

from __future__ import annotations

import random

from . import streams

W, H = 11, 9                 # the small classes' frame, in mbs
FULL_W, FULL_H = 120, 68     # 1920x1088



def _specs_in_slice(g, rng, lo, hi, kind, **kw):
    """Random mb specs for mbs [lo, hi) of one slice, intra modes resolved
    against the slice's own availability (as the generator's multi-slice
    streams do)."""
    probe = g.IntraEncoder(W, H, 26)
    specs = []
    for addr in range(lo, hi):
        if kind == "i":
            spec = g.random_intra_mb(rng, ("i4", "i16", "pcm"), 8, 0.3)
        else:
            spec = g.random_p_mb(rng, kw["nrefs"], 8, 0.3, 16, 0.15, 0.2)
        if spec.kind in ("i4", "i16"):
            g.resolve_random_modes(rng, probe, addr % W, addr // W, spec)
        probe.parsed.add((addr % W, addr // W))
        specs.append(spec)
    return specs


def _deblock_idc2_offsets(g):
    """IDR, a non-IDR I and two P frames, each in 3 slices with
    disable_deblocking_filter_idc 2 (edges off at slice boundaries only);
    the I slices carry alpha/beta offsets from -6 to +6 and slice QPs
    that differ (the generator's P slices write zero offsets)."""
    rng = random.Random(40)
    out = g.make_sps(W, H, max_ref_frames=2) \
        + g.make_pps(deblock_control=True, nrefs=2)
    bounds = (0, 31, 64, W * H)
    offsets = ((-6, 4), (2, -2), (6, 6), (-4, -6), (4, 2), (-2, 0))
    for f in range(4):
        for s in range(3):
            lo, hi = bounds[s], bounds[s + 1]
            qp = (22, 30, 38)[(s + f) % 3]
            if f < 2:
                out += g.make_idr_slice(
                    W, H, _specs_in_slice(g, rng, lo, hi, "i"),
                    slice_qp=qp, frame_num=f, poc_lsb=2 * f, idr=f == 0,
                    first_mb=lo, deblock_idc=2,
                    deblock_ab=offsets[3 * f + s])
            else:
                nr = min(f, 2)
                out += g.make_p_slice(
                    W, H, _specs_in_slice(g, rng, lo, hi, "p", nrefs=nr),
                    slice_qp=qp, frame_num=f, poc_lsb=2 * f, first_mb=lo,
                    nrefs=nr, pps_nrefs=2, deblock_idc=2)
    return out


def _explicit_wp_p(g):
    """tests/test_conformance_cases.py::test_explicit_weighted_p at
    11x9 mbs."""
    rng = random.Random(31)
    out = g.make_sps(W, H, max_ref_frames=2) + g.make_pps(nrefs=2, wp=True)
    out += g.make_idr_slice(W, H, g.random_frame_specs(rng, W, H, "i"))
    wts = {"luma_denom": 5, "chroma_denom": 4,
           "l0": [(40, 3, (20, -2, 12, 5)), (24, -8, None)]}
    for f in (1, 2):
        nr = min(f, 2)
        out += g.make_p_slice(
            W, H, g.random_frame_specs(rng, W, H, "p", nrefs=nr),
            frame_num=f, poc_lsb=2 * f, nrefs=nr, pps_nrefs=2,
            weights={**wts, "l0": wts["l0"][:nr]})
    return out


def _explicit_wp_b_cavlc(g):
    """tests/test_conformance_cases.py::test_explicit_weighted_b_cavlc at
    11x9 mbs."""
    rng = random.Random(32)
    out = g.make_sps(W, H, max_ref_frames=3, log2_max_poc_lsb=6) \
        + g.make_pps(nrefs=2, nrefs1=1, wbi=1)
    out += g.make_idr_slice(W, H, g.random_frame_specs(rng, W, H, "i"),
                            log2_max_poc_lsb=6)
    out += g.make_p_slice(W, H, g.random_frame_specs(rng, W, H, "p",
                                                     nrefs=1),
                          frame_num=1, poc_lsb=8, nrefs=1, pps_nrefs=2,
                          log2_max_poc_lsb=6)
    wts = {"luma_denom": 6, "chroma_denom": 5,
           "l0": [(70, -4, (30, 2, 36, -1)), None],
           "l1": [(58, 6, None)]}
    out += g.make_b_slice(W, H, g.random_frame_specs(rng, W, H, "b",
                                                     b_nrefs=(2, 1)),
                          frame_num=2, poc_lsb=4, nrefs=(2, 1),
                          pps_nrefs=(2, 1), log2_max_poc_lsb=6, weights=wts)
    return out


def _explicit_w_cabac(g):
    """tests/test_conformance_cases.py::test_explicit_weighted_cabac at
    11x9 mbs."""
    rng = random.Random(33)
    out = g.make_sps(W, H, max_ref_frames=3, log2_max_poc_lsb=6) \
        + g.make_pps(cabac=True, nrefs=2, nrefs1=1, wp=True, wbi=1)
    out += g.make_cabac_slice(W, H, g.random_frame_specs(rng, W, H, "i"), 2,
                              idr=True)
    pw = {"luma_denom": 5, "chroma_denom": 3,
          "l0": [(38, 2, (14, 0, 9, 3))]}
    out += g.make_cabac_slice(W, H, g.random_frame_specs(rng, W, H, "p",
                                                         nrefs=1), 0,
                              frame_num=1, poc_lsb=8, nrefs=(1, 1),
                              pps_nrefs=(2, 1), weights=pw)
    bw = {"luma_denom": 6, "chroma_denom": 5,
          "l0": [(70, -4, (30, 2, 36, -1)), (60, 1, None)],
          "l1": [(58, 6, (25, 0, 25, 0))]}
    out += g.make_cabac_slice(W, H, g.random_frame_specs(rng, W, H, "b",
                                                         b_nrefs=(2, 1)), 1,
                              frame_num=2, nal_ref_idc=0, poc_lsb=4,
                              nrefs=(2, 1), pps_nrefs=(2, 1), weights=bw)
    return out


def _ip(g, rng, n_p, idr_kw=None, p_kw=()):
    """SPS + PPS (2 references) + an IDR + n_p P frames; p_kw maps a P
    frame's number to extra make_p_slice arguments."""
    out = g.make_sps(W, H, max_ref_frames=2) + g.make_pps(nrefs=2)
    out += g.make_idr_slice(W, H, g.random_frame_specs(rng, W, H, "i"),
                            **(idr_kw or {}))
    p_kw = dict(p_kw)
    for f in range(1, n_p + 1):
        nr = min(f, 2)
        out += g.make_p_slice(W, H, g.random_frame_specs(rng, W, H, "p",
                                                         nrefs=nr),
                              frame_num=f, poc_lsb=2 * f, nrefs=nr,
                              pps_nrefs=2, **p_kw.get(f, {}))
    return out


def _long_term_mmco_rplm(g):
    """Five GOPs, the recipes of tests/test_conformance_cases.py at 11x9
    mbs: test_idr_long_term, test_mmco3_then_mmco2,
    test_mmco6_current_to_long_term, test_rplm_duplicate_ref and
    test_rplm_long_term."""
    out = _ip(g, random.Random(9), 2, {"long_term": True})
    out += _ip(g, random.Random(11), 4, p_kw={1: {"mmco": [(3, 0, 0)]},
                                             3: {"mmco": [(2, 0)]}})
    out += _ip(g, random.Random(14), 2,
               p_kw={1: {"mmco": [(4, 1), (6, 0)]}})
    out += _ip(g, random.Random(15), 2,
               p_kw={2: {"reorder": [(0, 0), (1, 0)]}})
    out += _ip(g, random.Random(16), 2, {"long_term": True},
               p_kw={2: {"reorder": [(2, 0)]}})
    return out


def _extreme_levels(g):
    """tests/test_conformance_cases.py::test_extreme_residual_levels at
    22x18 mbs (+-2063 in two 4x4 blocks of one I4 mb), then a P frame."""
    rng = random.Random(30)
    w, h = 22, 18
    specs = g.random_frame_specs(rng, w, h, "i")
    i4 = next(s for s in specs if s.kind == "i4")
    i4.luma_coeffs[0] = [2063] + [0] * 15
    i4.luma_coeffs[1] = [-2063] + [0] * 15
    i4.cbp |= 1
    out = g.make_sps(w, h) + g.make_pps() + g.make_idr_slice(w, h, specs)
    out += g.make_p_slice(w, h, g.random_frame_specs(rng, w, h, "p"),
                          frame_num=1, poc_lsb=2)
    return out


RECIPES = {
    "cavlc_intra_slices": lambda g: g.gen_random_intra_stream(
        W, H, n_frames=3, seed=101, slices_per_frame=3),
    "cavlc_ipp_5refs": lambda g: g.gen_random_ipp_stream(
        W, H, n_frames=10, seed=102, nrefs=5, slices_per_frame=2),
    "cavlc_ipb_implicit_temporal": lambda g: g.gen_random_ipb_stream(
        W, H, n_gops=3, seed=103, closed=True, wbi=2, direct_spatial=False),
    "cavlc_ipb_open_gop": lambda g: g.gen_random_ipb_stream(
        W, H, n_gops=3, seed=104, closed=False),
    "cabac_ipb_slices_init2": lambda g: g.gen_random_cabac_ipb_stream(
        W, H, n_gops=3, seed=105, closed=True, slices_per_frame=3,
        cabac_init_idc=2, wbi=2, direct_spatial=False, intra_prob=0.05),
    "cabac_ipb_deblock_off": lambda g: g.gen_random_cabac_ipb_stream(
        W, H, n_gops=2, seed=106, closed=True, deblock=False),
    "deblock_idc2_offsets": _deblock_idc2_offsets,
    "high_intra_scaling_pcm": lambda g: g.gen_random_high_stream(
        W, H, n_frames=2, seed=107, kinds=("i4", "i8", "i16", "pcm"),
        scaling=True, second_chroma_qp_off=-4),
    "high_ipp_t8": lambda g: g.gen_random_high_ipp_stream(
        W, H, n_frames=4, seed=108, nrefs=2, t8_prob=0.5),
    "high_cabac_i8_pcm": lambda g: g.gen_random_high_cabac_stream(
        W, H, n_frames=3, seed=109, kinds=("i4", "i8", "i16", "pcm")),
    "mvc_stereo": lambda g: g.gen_random_mvc_stream(8, 6, n_aus=5,
                                                    seed=110),
    "explicit_wp_p": _explicit_wp_p,
    "explicit_wp_b_cavlc": _explicit_wp_b_cavlc,
    "explicit_w_cabac": _explicit_w_cabac,
    "long_term_mmco_rplm": _long_term_mmco_rplm,
    "extreme_levels": _extreme_levels,
    "truncated_concealment": lambda g: streams.truncate_slice(
        g.gen_random_ipp_stream(W, H, n_frames=3, seed=111), 1, frac=0.5)
    + streams.truncate_slice(g.gen_random_intra_stream(
        W, H, n_frames=2, seed=111, density=0.3), 1, frac=0.5),
    "qp_extremes": lambda g: b"".join(
        g.gen_random_intra_stream(W, H, n_frames=2, seed=112 + q, qp=q)
        for q in (0, 51)),
    "high_ipp_t8_1080p": lambda g: g.gen_random_high_ipp_stream(
        FULL_W, FULL_H, n_frames=4, seed=120, nrefs=3, t8_prob=0.5,
        density=0.1),
    "cabac_ipb_slices_1080p": lambda g: g.gen_random_cabac_ipb_stream(
        FULL_W, FULL_H, n_gops=1, seed=121, closed=True, gop_pb=2,
        slices_per_frame=4, wbi=2, direct_spatial=False, cabac_init_idc=1,
        density=0.1, intra_prob=0.05),
}

CARD_CLASSES = ("high_ipp_t8_1080p", "cabac_ipb_slices_1080p")
CPU_CLASSES = tuple(n for n in RECIPES if n not in CARD_CLASSES)


def build(name: str) -> bytes:
    """The named class's stream (the same bytes on every call)."""
    return RECIPES[name](streams.avcgen())

