"""The hand-written CUDA kernels against their plain PyTorch versions, and
the lockstep and single-frame decodes on the card against the CPU path.  These need a CUDA
device (the kernels have no CPU mode) and skip without one.  The file
imports nothing of JAX, so on a machine with a card and no JAX:

    python -m pytest --noconftest -p no:cacheprovider -m cuda \
        tests/test_torch_kernels_cuda.py
"""

import json
import os
import subprocess
import sys
import threading

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from chip_smoke import IntraModes, RouteLog, check_no_plain, \
    check_views, combine_case, deblock_inputs, decoded_planes, intra_case, \
    intra_inputs, lane_views, mc_case, mc_inputs, read_counts, \
    reset_counts, stage_calls  # noqa: E402
from edge264_tpu_torch import corpus, streams  # noqa: E402
from edge264_tpu_torch.api import decode_annexb, find_start_code  # noqa
from edge264_tpu_torch.convert import CONDITIONAL, planes_to_torch  # noqa
from edge264_tpu_torch.native import EV_FRAME_DONE, NativeDecoder  # noqa
from edge264_tpu_torch.ops import arena as A  # noqa: E402
from edge264_tpu_torch.ops import deblock as D  # noqa: E402
from edge264_tpu_torch.ops import frame as F  # noqa: E402
from edge264_tpu_torch.ops import intra as I  # noqa: E402
from edge264_tpu_torch.ops import mc as M  # noqa: E402
from edge264_tpu_torch.ops import residual as R  # noqa: E402
from edge264_tpu_torch.ops.batched import host_frame_digest  # noqa: E402
from edge264_tpu_torch.parallel import make_decode_mesh  # noqa: E402
from edge264_tpu_torch.parallel.batch import \
    decode_gops_batched  # noqa: E402
from edge264_tpu_torch.parallel.gop import \
    decode_annexb_parallel  # noqa: E402

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    return torch.device("cuda")


def _deblock_pair(dev, seed, K, mbW, mbH, random_flags=False):
    """(plain result, kernel result) on one random deblock input."""
    y, cb, cr, p, bs_v, bs_h = deblock_inputs(dev, seed, K, mbW, mbH,
                                              random_flags)
    want = D.deblock_scan(y, cb, cr, p, bs_v, bs_h, mbW, mbH)
    got = D.deblock_batch(y.clone(), cb.clone(), cr.clone(), p, bs_v, bs_h,
                          mbW, mbH)
    return want, got


def _intra_pair(dev, seed, K, mbW, mbH, intra_share=1.0):
    p, frames = intra_case(dev, seed, intra_share, K, mbW, mbH)
    want = I.intra_scan_sheared(*frames, p, mbW, mbH)
    got = I.intra_batch(*[f.clone() for f in frames[:3]], *frames[3:], p,
                        mbW, mbH)
    return want, got


def _assert_equal(want, got):
    torch.cuda.synchronize()
    for a, b in zip(want, got):
        assert torch.equal(a, b)


def test_deblock_kernel_matches_plain(dev):
    """Every edge on; then at 1080p, K=2, random edge bits (edges off
    inside the frame) and random transform-8x8 bits."""
    n = D.deblock_batch.launches
    _assert_equal(*_deblock_pair(dev, 3, 2, 120, 6))
    assert D.deblock_batch.launches == n + 1
    _assert_equal(*_deblock_pair(dev, 4, 2, 120, 68, random_flags=True))


def _mc_cases(dev, seed, K, S, mbW, mbH, has_b, arm=None, mvmax=300):
    """(kernel, plain, args) for mc_luma and mc_chroma on one random input
    (chip_smoke.mc_inputs): per-8x8 mvs up to +-mvmax quarter-pels past
    every edge, unused cells, and with arm=None some 16x8 pairs and split
    cells; `arm` forces one kernel arm on every block (mc_planes)."""
    case = mc_inputs(dev, seed, K, mbW, mbH, S, has_b, arm=arm,
                     mvmax=mvmax)
    return [(M.mc_luma, M.mc_luma_plain, case["mc_luma"]),
            (M.mc_chroma, M.mc_chroma_plain, case["mc_chroma"])]


def _mc_check(cases):
    for kern, plain, args in cases:
        n = kern.launches
        got, want = kern(*args), plain(*args)
        assert kern.launches == n + 1
        assert len(got) == len(want) == args[-1]
        _assert_equal(want, got)


@pytest.mark.parametrize("has_b", [True, False])
def test_mc_kernels_match_plain(dev, has_b):
    _mc_check(_mc_cases(dev, 5, 2, 3, 120, 4, has_b))


# the flag bits every real block of an input carries (all) or lacks (none)
# when one arm is forced
_ARM_BITS = {"uniform": (M._F_UNIFORM, M._F_PAIR | M._F_PAIRODD),
             "pair": (M._F_UNIFORM, 0), "quad": (0, M._F_UNIFORM),
             "unused": (0, 3)}


@pytest.mark.parametrize("arm", ["uniform", "pair", "quad", "unused"])
def test_mc_kernel_arms(dev, arm):
    """Every block on one arm: 8x8 uniform, 16x8 pairs, per-4x4 quadrants
    (with unused cells), no list used."""
    mbW, mbH = 40, 6
    cases = _mc_cases(dev, 40, 2, 4, mbW, mbH, True, arm=arm)
    f = cases[0][2][0][:, :, :2 * mbW]
    have, lack = _ARM_BITS[arm]
    assert ((f & have) == have).all() and not (f & lack).any()
    if arm == "pair":
        assert ((f[:, :, 0::2] & M._F_PAIR) != 0).all()
        assert ((f[:, :, 1::2] & M._F_PAIRODD) != 0).all()
    _mc_check(cases)


@pytest.mark.parametrize("has_b", [True, False])
def test_mc_kernel_clamps(dev, has_b):
    """mvs to +-2000 quarter-pels: nearly every load word sits at its
    arm's clamp, where the kernels' aligned word reads meet the right and
    bottom window limits."""
    _mc_check(_mc_cases(dev, 41 + has_b, 2, 3, 20, 6, has_b, mvmax=2000))


# (K, mbW, mbH): padded block columns past 2*mbW (5 and 11 mbs wide), 4K
# in one lane, bench.py's 8 lanes at 1080p
MC_GEOMETRIES = [(2, 5, 3), (3, 11, 9), (1, 240, 135), (8, 120, 68)]


@pytest.mark.parametrize("K,mbW,mbH", MC_GEOMETRIES)
def test_mc_kernel_geometries(dev, K, mbW, mbH):
    _mc_check(_mc_cases(dev, 50 + mbW, K, 3, mbW, mbH, True))


def test_mc_kernels_back_to_back(dev):
    """20 calls of each kernel with fresh inputs, launched without a sync
    between them."""
    cases = [_mc_cases(dev, 200 + s, 2, 3, 24, 5, s % 2 == 0)
             for s in range(20)]
    wants = [[plain(*args) for _, plain, args in c] for c in cases]
    torch.cuda.synchronize()
    gots = [[kern(*args) for kern, _, args in c] for c in cases]
    for want, got in zip(wants, gots):
        for w, g in zip(want, got):
            _assert_equal(w, g)


@pytest.mark.parametrize("has_t8,has_pcm", [(True, True), (False, False)])
def test_intra_kernel_matches_plain(dev, has_t8, has_pcm):
    K, mbW, mbH = 2, 120, 3
    p, frames = intra_inputs(np.random.RandomState(8 + has_t8), K, mbW, mbH,
                             has_t8, has_pcm)
    p = {k: torch.as_tensor(v, dtype=torch.int32, device=dev)
         for k, v in p.items()}
    frames = [torch.as_tensor(f, dtype=torch.int32, device=dev)
              for f in frames]
    want = I.intra_scan_sheared(*frames, p, mbW, mbH, has_t8, has_pcm)
    n = I.intra_batch.launches
    got = I.intra_batch(*[f.clone() for f in frames], p, mbW, mbH, has_t8,
                        has_pcm)
    torch.cuda.synchronize()
    assert I.intra_batch.launches == n + 1
    for a, b in zip(want, got):
        assert torch.equal(a, b)


def test_lockstep_on_card_matches_cpu(dev):
    data = b"".join(streams.avcgen().gen_random_cabac_ipb_stream(
        8, 6, n_gops=1, seed=s, closed=True, gop_pb=1 + s, density=0.1,
        max_level=4, intra_prob=0.1) for s in (0, 1))
    want = list(decode_gops_batched(data, lanes=2, device="cpu"))
    got = list(decode_gops_batched(data, lanes=2))
    assert len(got) == len(want) > 0
    for a, b in zip(want, got):
        for n in ("y", "cb", "cr"):
            assert np.array_equal(getattr(a, n), getattr(b, n))


def test_decode_annexb_on_card_matches_cpu(dev):
    data = streams.avcgen().gen_random_cabac_ipb_stream(
        8, 6, n_gops=1, seed=4, closed=True, gop_pb=2, density=0.1,
        max_level=4, intra_prob=0.1)
    want = list(decode_annexb(data, device="cpu"))
    n = (I.intra_batch.launches, D.deblock_batch.launches,
         M.mc_luma.launches, M.mc_chroma.launches)
    got = list(decode_annexb(data))
    assert len(got) == len(want) == 5
    for a, b in zip(want, got):
        assert a.frame_id == b.frame_id
        for c in ("y", "cb", "cr"):
            assert np.array_equal(getattr(a, c), getattr(b, c))
    # intra + deblock on every frame, MC on the four with a reference
    assert (I.intra_batch.launches - n[0], D.deblock_batch.launches - n[1],
            M.mc_luma.launches - n[2], M.mc_chroma.launches - n[3]) == \
        (5, 5, 4, 4)


# the four stage kernels, their wrappers and their plain versions
STAGES = {"residual": (R, "residual_frame_plain", R.residual_cuda),
          "bs": (D, "deblock_bs_plain", D.deblock_bs_cuda),
          "mcpack": (M, "pack_mc_params_plain", M.pack_mc_params_cuda),
          "combine": (M, "combine_mc_plain", M.combine_mc_cuda)}


@pytest.mark.parametrize("K", [1, 8])
def test_stage_kernels_match_plain(dev, K):
    """residual.cu, bs.cu, mcpack.cu and combine.cu against their plain
    versions at 1080p on random inputs with their extremes: levels at
    +-2063, QP 0 and 51, every mb kind with the 8x8 transform on and off,
    scaling matrices and slot maps as lane views of longer rows, every
    weighted-prediction mode and orphan inter cells; one launch a call."""
    for name, (kern, plain, _bytes, _ops) in stage_calls(dev, 60 + K,
                                                         K).items():
        wrapper = STAGES[name.split("_")[0]][2]
        n = wrapper.launches
        got = kern()
        assert wrapper.launches == n + 1, name
        _assert_equal(plain(), got)


@pytest.mark.parametrize("has_b", [True, False])
@pytest.mark.parametrize("arm", [None, "uniform", "pair", "quad", "unused"])
def test_stage_kernels_on_mc_arms(dev, arm, has_b):
    """mcpack.cu and combine.cu on every MC arm (16x8 pairs, uniform 8x8,
    per-4x4 quadrants, no list used), at the clamps (mvs to +-2000) and
    with one list or two; combine also with random weights."""
    for kw in (dict(arm=arm), dict(arm=arm, mvmax=2000)):
        p, smap, L, C = mc_case(dev, 70, K=2, mbW=40, mbH=6, **kw)
        smap = lane_views(smap.cpu().numpy(), dev)
        got = M.pack_mc_params_cuda(p, smap, has_b, 40, 6)
        _assert_equal(M.pack_mc_params_plain(p, smap, has_b, 40, 6), got)
        flat = M.run_mc_kernels(*got, L, C, has_b, 40, 6)
        _assert_equal(M.combine_mc_plain(p, smap, flat, has_b),
                      M.combine_mc_cuda(p, flat, has_b))
        p, smap, flat = combine_case(dev, 71, 2, has_b, mbW=40, mbH=6, **kw)
        _assert_equal(M.combine_mc_plain(p, smap, flat, has_b),
                      M.combine_mc_cuda(p, flat, has_b))


# padded block columns past 2*mbW, an odd lane count, the front end's
# widest row and tallest column
STAGE_GEOMETRIES = [(3, 5, 3), (2, 11, 9), (1, 1023, 2), (1, 2, 1056)]


@pytest.mark.parametrize("K,mbW,mbH", STAGE_GEOMETRIES)
def test_stage_kernels_geometries(dev, K, mbW, mbH):
    for name, (kern, plain, _b, _o) in stage_calls(dev, 80, K, mbW,
                                                   mbH).items():
        _assert_equal(plain(), kern())


def test_decode_paths_run_no_plain_stage(dev, monkeypatch):
    """Both decode paths on the card never call a stage's plain version:
    each is replaced by a function that raises, and the frames stay
    byte-identical to the CPU path's, with each stage kernel launched once
    a step or frame (the MC ones on every inter step)."""
    data = streams.avcgen().gen_random_cabac_ipb_stream(
        8, 6, n_gops=2, seed=5, closed=True, gop_pb=2, density=0.1,
        max_level=4, intra_prob=0.1)
    runs = (("decode_annexb", decode_annexb),
            ("lockstep", lambda d, **kw: decode_gops_batched(d, lanes=2,
                                                             **kw)))
    want = {name: list(run(data, device="cpu")) for name, run in runs}

    def plain_on_card(*a, **kw):
        raise AssertionError("a stage's plain version ran on the card")

    for mod, plain, _wrapper in STAGES.values():
        monkeypatch.setattr(mod, plain, plain_on_card)
    for name, run in runs:
        reset_counts()
        with RouteLog() as rl:
            got = list(run(data))
        launches = read_counts()
        check_no_plain(name, launches, rl)
        assert launches["residual"] and launches["mcpack"], launches
        check_views(name, want[name], got)


@pytest.mark.parametrize("name", corpus.CPU_CLASSES + corpus.CARD_CLASSES)
def test_corpus_class_on_card_matches_cpu(dev, name):
    """Each class of the port's stream corpus through decode_annexb and
    the lockstep driver (lanes=2) on the card: frames, ids, crop,
    mb_errors and both MVC views byte-identical to the same path on the
    CPU, with no plain version of a kernel (no level rounds, no mc_frame)
    on the card."""
    data = corpus.build(name)
    for path, run in (("decode_annexb", decode_annexb),
                      ("lockstep", lambda d, **kw: decode_gops_batched(
                          d, lanes=2, **kw))):
        want = list(run(data, device="cpu"))
        reset_counts()
        with RouteLog() as rl, IntraModes() as im:
            got = list(run(data))
        launches = read_counts()
        check_no_plain(f"{name} {path}", launches, rl,
                       im.non_skip if path == "lockstep" else None)
        assert launches["intra"] and launches["deblock"], launches
        check_views(f"{name} {path}", want, got)


@pytest.mark.parametrize("mbW,mbH", [(5, 3), (11, 9)])
def test_decode_paths_on_card_odd_mb_count(dev, mbW, mbH):
    """15 and 99 mbs, not a multiple of 4: the syntax planes share one
    device buffer, and each must still start 16-byte aligned for the
    kernels' cp.async.  decode_annexb (K=1) and the lockstep path (lanes=2)
    are byte-identical to the CPU path."""
    data = b"".join(streams.avcgen().gen_random_cabac_ipb_stream(
        mbW, mbH, n_gops=1, seed=s, closed=True, gop_pb=1, density=0.1,
        max_level=4, intra_prob=0.1) for s in (0, 1))
    for run in (decode_annexb,
                lambda d, **kw: decode_gops_batched(d, lanes=2, **kw)):
        want = list(run(data, device="cpu"))
        got = list(run(data))
        assert len(got) == len(want) == 6
        for a, b in zip(want, got):
            for c in ("y", "cb", "cr"):
                assert np.array_equal(getattr(a, c), getattr(b, c))


def test_kernel_wrappers_reject_misaligned_planes(dev):
    """A plane that starts off a 16-byte boundary raises before launch."""
    y, cb, cr, p, bs_v, bs_h = deblock_inputs(dev, 3, 1, 3, 5)
    buf = torch.zeros(p["qp"].numel() + 1, dtype=torch.int32, device=dev)
    qp = buf[1:].view(p["qp"].shape)
    n = D.deblock_batch.launches
    with pytest.raises(ValueError, match="16-byte"):
        D.deblock_batch(y, cb, cr, dict(p, qp=qp), bs_v, bs_h, 3, 5)
    pi, frames = intra_case(dev, 3, 1.0, 1, 3, 5)
    ry = torch.zeros(frames[3].numel() + 1, dtype=torch.int32, device=dev)
    frames[3] = ry[1:].view(frames[3].shape)
    with pytest.raises(ValueError, match="16-byte"):
        I.intra_batch(*frames, pi, 3, 5)
    assert D.deblock_batch.launches == n


# ---------------------------------------------------------------------------
# The row-synchronised launches: odd geometries, more rows than fit on the
# card at once, back-to-back calls, sparse intra, a second card.

# (K, mbW, mbH): one mb, one column, one row, odd sizes, 4K in one lane
GEOMETRIES = [(1, 1, 1), (2, 1, 4), (2, 4, 1), (2, 3, 5), (3, 5, 3),
              (1, 240, 135)]


@pytest.mark.parametrize("K,mbW,mbH", GEOMETRIES)
def test_deblock_kernel_geometries(dev, K, mbW, mbH):
    _assert_equal(*_deblock_pair(dev, 20 + mbW, K, mbW, mbH))


@pytest.mark.parametrize("K,mbW,mbH", GEOMETRIES)
def test_intra_kernel_geometries(dev, K, mbW, mbH):
    _assert_equal(*_intra_pair(dev, 30 + mbW, K, mbW, mbH))


@pytest.mark.parametrize("K,mbW,mbH", [(1, 1023, 2), (1, 600, 3)])
def test_intra_kernel_wide_rows(dev, K, mbW, mbH):
    """Rows past the former 512-mb work mask, up to the front end's
    widest (1023 mbs): one launch, exact."""
    n = I.intra_batch.launches
    _assert_equal(*_intra_pair(dev, 40, K, mbW, mbH))
    assert I.intra_batch.launches == n + 1


def test_intra_kernel_refuses_rows_past_its_mask(dev):
    p, frames = intra_case(dev, 41, 1.0, 1, 1025, 1)
    n = I.intra_batch.launches
    with pytest.raises(RuntimeError, match="intra kernel launch failed"):
        I.intra_batch(*frames, p, 1025, 1)
    assert I.intra_batch.launches == n


def test_wide_stream_on_card_matches_cpu(dev):
    """256 mbs across (DCI 4K's width), past the JAX package's MC load
    words: both paths run the MC kernels on every inter step (mc_frame
    never) and the deblock kernel on every step, byte-identical to the
    CPU."""
    data = streams.avcgen().gen_random_cabac_ipb_stream(
        256, 2, n_gops=1, seed=44, closed=True, gop_pb=1, density=0.05,
        max_level=4, intra_prob=0.05)
    for run in (decode_annexb,
                lambda d, **kw: decode_gops_batched(d, lanes=1, **kw)):
        want = list(run(data, device="cpu"))
        n = D.deblock_batch.launches, I.intra_rounds.launches
        with RouteLog() as rl:
            got = list(run(data))
        assert rl.routes == ["kernels", "kernels"]
        assert rl.launches == {"mc_luma": 2, "mc_chroma": 2}
        assert D.deblock_batch.launches == n[0] + 3
        assert I.intra_rounds.launches == n[1]
        assert len(got) == len(want) == 3
        for a, b in zip(want, got):
            for c in ("y", "cb", "cr"):
                assert np.array_equal(getattr(a, c), getattr(b, c))


def test_ring_of_33_slots_on_card_matches_cpu(dev, monkeypatch):
    """A lockstep ring of 32 + 1 slots, past the JAX package's load
    words' plane field: its inter steps run the MC kernels on the card
    too (mc_frame never), byte-identical to the CPU."""
    from edge264_tpu_torch.parallel import batch as TB
    monkeypatch.setattr(TB, "RING_SLOTS", 32)
    data = b"".join(streams.avcgen().gen_random_cabac_ipb_stream(
        8, 6, n_gops=1, seed=50 + s, closed=True, gop_pb=1, density=0.1,
        max_level=4, intra_prob=0.1) for s in (0, 1))
    want = list(decode_gops_batched(data, lanes=2, device="cpu"))
    with RouteLog() as rl:
        got = list(decode_gops_batched(data, lanes=2))
    assert rl.routes == ["kernels", "kernels"]
    assert rl.launches == {"mc_luma": 2, "mc_chroma": 2}
    assert len(got) == len(want) == 6
    for a, b in zip(want, got):
        for c in ("y", "cb", "cr"):
            assert np.array_equal(getattr(a, c), getattr(b, c))


def test_lockstep_on_card_runs_no_level_rounds(dev, monkeypatch):
    """The lockstep driver on the card: intra-sparse P/B steps, which take
    the level rounds on the CPU, run intra.cu (one launch a step with an
    intra mb) and never intra_rounds; the frames equal the CPU's."""
    from edge264_tpu_torch.parallel import batch as TB
    data = b"".join(streams.avcgen().gen_random_cabac_ipb_stream(
        12, 8, n_gops=1, seed=60 + s, closed=True, gop_pb=2, density=0.1,
        max_level=4, intra_prob=0.03) for s in (0, 1))
    cpu_modes, card_modes = [], []
    real = TB._intra_mode

    def rec(flags_list, mbW, mbH, on_cpu):
        mode = real(flags_list, mbW, mbH, on_cpu)
        (cpu_modes if on_cpu else card_modes).append(mode)
        return mode

    monkeypatch.setattr(TB, "_intra_mode", rec)
    want = list(decode_gops_batched(data, lanes=2, device="cpu"))
    assert any(m.startswith("rounds") for m in cpu_modes)
    n = I.intra_rounds.launches, I.intra_batch.launches
    got = list(decode_gops_batched(data, lanes=2))
    assert I.intra_rounds.launches == n[0]
    assert I.intra_batch.launches - n[1] == \
        sum(m != "skip" for m in card_modes)
    assert [m == "skip" for m in card_modes] == \
        [m == "skip" for m in cpu_modes]
    assert len(got) == len(want) == 10
    for a, b in zip(want, got):
        for c in ("y", "cb", "cr"):
            assert np.array_equal(getattr(a, c), getattr(b, c))


# (K, mbW, mbH, S): DCI 4K in a short frame, a 33-slot ring, the front
# end's widest row and tallest column
MC_REACH = [(1, 256, 4, 8), (2, 24, 5, 32), (1, 1023, 2, 8), (1, 2, 1056, 8)]


@pytest.mark.parametrize("K,mbW,mbH,S", MC_REACH)
def test_mc_route_matches_mc_frame_past_the_jax_words(dev, K, mbW, mbH, S):
    """Where the JAX package's int32 words do not reach, the MC kernels'
    route (mc_predict: pack -> mc.cu -> combine) equals mc_frame, the
    plain gathers that share no packing with it, and each kernel equals
    its plain version."""
    p, smap, L, C = mc_case(dev, 70 + mbW, K, mbW, mbH, S)
    n = M.mc_luma.launches, M.mc_chroma.launches
    got = M.mc_predict(p, smap, L, C, True, mbW, mbH)
    assert (M.mc_luma.launches, M.mc_chroma.launches) == (n[0] + 1,
                                                          n[1] + 1)
    _assert_equal(M.mc_frame(p, L, C, smap, True), got)
    _mc_check(_mc_cases(dev, 80 + mbW, K, S, mbW, mbH, True))


@pytest.mark.parametrize("K", [16, 24])
@pytest.mark.parametrize("kernel", ["deblock", "intra"])
def test_kernel_more_rows_than_resident(dev, kernel, K):
    """1080p at K=16 (1088 rows) and K=24 (1632 rows, more than an H100
    holds at once for either kernel: its shared memory caps intra at 11
    blocks an SM): blocks take further tickets after their first row, and
    the ticket order must let every worker finish."""
    pair = _deblock_pair if kernel == "deblock" else _intra_pair
    _assert_equal(*pair(dev, 5, K, 120, 68))


@pytest.mark.parametrize("kernel", ["deblock", "intra"])
def test_kernel_back_to_back(dev, kernel):
    """20 calls with fresh inputs, launched without a sync between them:
    a stale progress counter or a memory-ordering race would show as a
    mismatch (repetition is the check; no race detector runs here)."""
    K, mbW, mbH = 2, 20, 8
    wants, calls = [], []
    for seed in range(20):
        if kernel == "deblock":
            y, cb, cr, p, bs_v, bs_h = deblock_inputs(dev, 100 + seed, K,
                                                      mbW, mbH)
            wants.append(D.deblock_scan(y, cb, cr, p, bs_v, bs_h, mbW, mbH))
            calls.append(((y.clone(), cb.clone(), cr.clone(), p, bs_v,
                           bs_h, mbW, mbH), D.deblock_batch))
        else:
            p, frames = intra_case(dev, 100 + seed, 1.0, K, mbW, mbH)
            wants.append(I.intra_scan_sheared(*frames, p, mbW, mbH))
            calls.append(((*[f.clone() for f in frames[:3]], *frames[3:],
                           p, mbW, mbH), I.intra_batch))
    torch.cuda.synchronize()
    gots = [fn(*args) for args, fn in calls]
    for want, got in zip(wants, gots):
        _assert_equal(want, got)


def test_intra_kernel_sparse(dev):
    """5% intra mbs at 1080p: the inter mbs are published without a wait;
    the kernel equals the sheared scan and the level rounds."""
    p, frames = intra_case(dev, 17, 0.05, 2, 120, 68)
    tabs = [I.intra_round_plane(f, 120, 68)
            for f in p["mb_flags"].cpu().numpy()]
    assert all(t is not None for t in tabs)
    R = max(t[1] for t in tabs)
    rounds = I.intra_rounds(*frames, p, None, 120, 68, R)
    want = I.intra_scan_sheared(*frames, p, 120, 68)
    got = I.intra_batch(*[f.clone() for f in frames[:3]], *frames[3:], p,
                        120, 68)
    _assert_equal(want, got)
    _assert_equal(rounds, got)


# ---------------------------------------------------------------------------
# The host arena: unpacked on the card, pinned staging, two threads.

def _arena_steps(data):
    """Every frame of `data` packed as the lockstep driver packs on the
    card (int8 levels, a carried gat_state, a dead second lane): (CPU
    buffer copy, layout) per frame."""
    nd = NativeDecoder()
    out, st = [], {}
    pos = find_start_code(data, 0)
    while pos < len(data):
        end = find_start_code(data, pos + 3)
        _, events = nd.decode_nal(data[pos + 3:end])
        for e in events:
            if e[0] == EV_FRAME_DONE:
                pl = nd.planes(e[1])
                buf, layout, _ = A.pack_planes_batch(
                    [pl, None], pl, coef8=True, gat_state=st, device="cpu")
                out.append((buf.clone(), layout))
        while (info := nd.get_frame()) is not None:
            nd.return_frame(info["slot"])
        pos = end
    nd.close()
    return out


def test_unpack_on_card_matches_cpu(dev):
    """unpack_planes on cuda == on the CPU for the same arenas (dense,
    gathered and base+exception entries, int8 levels); every plane is a
    contiguous int32 tensor starting on a 16-byte boundary."""
    data = streams.avcgen().gen_random_cabac_ipb_stream(
        24, 16, n_gops=1, seed=5, closed=True, gop_pb=2, density=0.1,
        intra_prob=0.05)
    steps = _arena_steps(data)
    kinds = set()
    for buf, layout in steps:
        want = A.unpack_planes(buf, layout)
        got = A.unpack_planes(buf.to(dev), layout)
        for k, t in got.items():
            assert t.is_cuda and t.dtype == torch.int32, k
            assert t.is_contiguous() and t.data_ptr() % 16 == 0, k
            assert torch.equal(t.cpu(), want[k]), k
        kinds |= {off if off < 0 else 0 for *_, off, _m in layout}
    assert {0, -1, -2, -3} <= kinds


def test_arena_upload_is_pinned(dev):
    """On cuda the packer fills pinned staging, taken in turns; upload
    refuses a pageable buffer."""
    data = streams.avcgen().gen_random_cabac_ipb_stream(
        6, 4, n_gops=1, seed=2, closed=True, gop_pb=1)
    buf, layout = _arena_steps(data)[0]
    a = A._arena_buf(buf.shape[1], 2, dev)
    b = A._arena_buf(buf.shape[1], 2, dev)
    assert a.is_pinned() and b.is_pinned()
    assert a.data_ptr() != b.data_ptr()
    a.copy_(buf)
    assert torch.equal(A.upload(a, dev).cpu(), buf)
    with pytest.raises(ValueError, match="pinned"):
        A.upload(buf, dev)


def test_two_threads_share_no_staging(dev):
    """The lockstep path (21 steps, its staging refilled at every step)
    and decode_annexb_parallel (two worker threads) decode at once on the
    card, and each gives the CPU's frames."""
    data = b"".join(streams.avcgen().gen_random_cabac_ipb_stream(
        8, 6, n_gops=1, seed=s, closed=True, gop_pb=10, density=0.1,
        max_level=4, intra_prob=0.1) for s in (0, 1))
    want = list(decode_gops_batched(data, lanes=2, device="cpu"))
    got = {}

    def run(name, fn):
        got[name] = list(fn())

    ts = [threading.Thread(target=run, args=(
              "lockstep", lambda: decode_gops_batched(data, lanes=1))),
          threading.Thread(target=run, args=(
              "parallel", lambda: decode_annexb_parallel(data,
                                                         n_workers=2)))]
    for t in ts:
        t.start()
    for t in ts:
        t.join(timeout=600)
        assert not t.is_alive()
    assert set(got) == {"lockstep", "parallel"}
    for frames in got.values():
        assert len(frames) == len(want) == 42
        for a, b in zip(want, frames):
            for c in ("y", "cb", "cr"):
                assert np.array_equal(getattr(a, c), getattr(b, c))


def test_pool_packs_1080p_k8_steps_into_pinned_staging(dev):
    """Every step of 8 lanes at 1080p (two closed GOPs, four decoders
    each, gat_state carried, int8 levels as on the card), packed by the
    lane pool into pinned staging: the bytes, layout and meta offset of
    the packer one lane after another."""
    from test_torch_pack_pool import _steps, serial_pack
    gops = [streams.avcgen().gen_random_cabac_ipb_stream(
        120, 68, n_gops=1, seed=s, closed=True, gop_pb=1, density=0.05,
        max_level=4, intra_prob=0.05) for s in (42, 43)]
    st_pool, st_ser, n = {}, {}, 0
    for n, pls in enumerate(_steps(gops * 4), 1):
        extra = np.random.RandomState(n).randint(0, 256, (8, 64), np.uint8)
        buf, layout, off = A.pack_planes_batch(
            pls, pls[0], coef8=True, extra=extra, gat_state=st_pool,
            device=dev)
        assert buf.is_pinned() and buf.shape[0] == 8
        want, wlayout, woff = serial_pack(pls, pls[0], coef8=True,
                                          extra=extra, gat_state=st_ser)
        assert layout == wlayout and off == woff and st_pool == st_ser, n
        assert np.array_equal(buf.numpy(), want), n
    assert n == 3


def test_staging_uploads_rows_to_two_shards(dev):
    """At every step one pinned staging buffer's two rows go to two shards
    (two cards where there are, else cuda:0 twice), the two buffers taken
    in turn over 5 steps: each buffer keeps both copies' events, its
    refill waits on both, and every shard's row arrives intact."""
    data = streams.avcgen().gen_random_cabac_ipb_stream(
        6, 4, n_gops=1, seed=6, closed=True, gop_pb=2, density=0.1,
        intra_prob=0.1)
    steps = _arena_steps(data)
    devs = [torch.device("cuda:0"),
            torch.device(f"cuda:{min(1, torch.cuda.device_count() - 1)}")]
    st = A._staging()
    got = []
    for buf, _ in steps:
        host = A._arena_buf(buf.shape[1], 2, dev)
        host.copy_(buf)
        got.append([A.upload(host[i:i + 1], d) for i, d in enumerate(devs)])
        i = [b.data_ptr() if b is not None else None
             for b in st.bufs].index(host.data_ptr())
        assert len(st.done[i]) == 2
    assert len(got) == 5
    for (buf, _), parts in zip(steps, got):
        for i, t in enumerate(parts):
            assert t.device == devs[i]
            assert torch.equal(t.cpu(), buf[i:i + 1])


def test_mesh_lockstep_on_card_matches_cpu(dev):
    """decode_gops_batched over a mesh of two shards on cuda:0, both
    sinks, == device="cpu"; every kernel launches."""
    data = b"".join(streams.avcgen().gen_random_cabac_ipb_stream(
        8, 6, n_gops=1, seed=s, closed=True, gop_pb=1 + s, density=0.1,
        max_level=4, intra_prob=0.1) for s in (0, 1))
    want = list(decode_gops_batched(data, lanes=2, device="cpu"))
    mesh = make_decode_mesh(["cuda:0", "cuda:0"])
    n = [f.launches for f in (I.intra_batch, D.deblock_batch, M.mc_luma,
                              M.mc_chroma)]
    got = list(decode_gops_batched(data, lanes=2, mesh=mesh))
    digests = list(decode_gops_batched(data, lanes=2, mesh=mesh,
                                       sink="digest"))
    assert all(f.launches > k for f, k in zip(
        (I.intra_batch, D.deblock_batch, M.mc_luma, M.mc_chroma), n))
    assert len(got) == len(digests) == len(want) > 0
    for a, b, d in zip(want, got, digests):
        for c in ("y", "cb", "cr"):
            assert np.array_equal(getattr(a, c), getattr(b, c))
        assert d.digest == host_frame_digest(a.y, a.cb, a.cr)


def test_frame_with_itab_on_card_raises(dev):
    """Level tables with planes on the card raise instead of running the
    plain level-gather scan there; without them intra.cu runs."""
    data = streams.avcgen().gen_random_cabac_ipb_stream(
        6, 4, n_gops=1, seed=12, closed=True, gop_pb=1, density=0.1,
        max_level=4, intra_prob=0.25)
    (pl, sm4, sm8, *_), = decoded_planes(data, 1)
    p = planes_to_torch([pl], CONDITIONAL, dev)
    s4 = torch.as_tensor(sm4, device=dev)[None]
    s8 = torch.as_tensor(sm8, device=dev)[None]
    tabs = tuple(torch.zeros((1, 2, 2), dtype=torch.int32, device=dev)
                 for _ in range(3))
    with pytest.raises(ValueError, match="CPU only"):
        F.decode_frame(p, s4, s8, 6, 4, itab=tabs)
    n = I.intra_batch.launches
    F.decode_frame(p, s4, s8, 6, 4)
    assert I.intra_batch.launches == n + 1


def test_kernels_launch_on_their_tensors_device(dev):
    """Frames on cuda:1 while cuda:0 is current: every wrapper launches on
    its tensors' card."""
    if torch.cuda.device_count() < 2:
        pytest.skip("needs two CUDA devices")
    d1 = torch.device("cuda:1")
    assert torch.cuda.current_device() == 0
    _assert_equal(*_deblock_pair(d1, 3, 2, 7, 5))
    _assert_equal(*_intra_pair(d1, 3, 2, 7, 5))
    for kern, plain, args in _mc_cases(d1, 9, 2, 2, 6, 4, True):
        _assert_equal(plain(*args), kern(*args))


def test_bench_torch_cell_on_card(dev):
    """bench_torch.py's lockstep cell on the card at 2 timed runs: exit 0,
    every frame equal to the committed seed-42 goldens, all four kernels
    launched, each roofline share under 1."""
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    cell = "lockstep_k8_1080p_cabac_ipb"
    r = subprocess.run([sys.executable, "bench_torch.py", "--cell", cell,
                        "--runs", "2", "--passes", "1"], cwd=repo,
                       capture_output=True, text=True, timeout=1200)
    res = json.loads(r.stdout.strip().splitlines()[-1])
    assert r.returncode == 0 and res["ok"] and res["correct"], \
        r.stdout[-3000:] + r.stderr[-3000:]
    got = res["cells"][cell]
    assert got["frames"] == 72 and len(got["runs"]) == 2
    assert got["frames_per_s"] > 0
    for k, row in got["layers"]["kernels"].items():
        assert row["launches"] > 0 and 0 < row["roofline_share"] < 1, (k, row)
    stage = got["layers"]["stage_device_ms_per_step"]
    assert stage["deblock_batch"] > 0 and stage["residual_frame"] > 0, stage
