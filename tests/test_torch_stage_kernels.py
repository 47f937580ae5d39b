"""The four stage functions that run a hand-written kernel on the card
(residual_frame: residual.cu, deblock_bs: bs.cu, pack_mc_params:
mcpack.cu, combine_mc: combine.cu), on the CPU: CPU tensors take the plain
version and never load a kernel library, and each wrapper's argument
checks refuse a wrong input with ValueError before any native call.  Then
the kernels' sources built for the host (tests/host_cuda.py: g++, one
thread at a time) run through the same wrappers on CPU tensors and are
held to the plain versions bit for bit, on random planes with their
extremes, on every MC arm and through both decode paths on corpus
classes.  Only the card shows that nvcc compiles them and that they run
in parallel (tests/test_torch_kernels_cuda.py, chip_smoke.py); the plain
versions are held to the JAX package by tests/test_torch_residual.py,
test_torch_deblock.py and test_torch_mc.py.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from chip_smoke import combine_case, stage_calls  # noqa: E402
from edge264_tpu_torch.kernels import build  # noqa: E402
from edge264_tpu_torch.ops import deblock as D  # noqa: E402
from edge264_tpu_torch.ops import mc as M  # noqa: E402
from edge264_tpu_torch.ops import residual as R  # noqa: E402

I32 = torch.int32
MBW, MBH, K = 5, 3, 2
cpu = torch.device("cpu")


def _planes(seed=0, K=K, mbW=MBW, mbH=MBH):
    """Random int32 planes of every key the four functions read, with
    scaling matrices and slot maps as lane views of longer rows (as the
    step's arena gives them)."""
    rng = np.random.RandomState(seed)
    H, W = mbH, mbW
    shapes = {"mb_flags": (K, H, W), "qp": (K, H, W, 4),
              "coef_y": (K, 4 * H, 4 * W, 16),
              "coef_y8": (K, 2 * H, 2 * W, 64), "coef_y_dc": (K, H, W, 16),
              "coef_c_dc": (K, H, W, 2, 4), "coef_cb": (K, 2 * H, 2 * W, 16),
              "coef_cr": (K, 2 * H, 2 * W, 16), "nz_y": (K, 4 * H, 4 * W),
              "refslot": (K, 4 * H, 4 * W, 2),
              "mvs": (K, 4 * H, 4 * W, 2, 2), "wp": (K, H, W, 24),
              "wp8": (K, 2 * H, 2 * W, 2, 3, 2)}
    p = {k: torch.as_tensor(rng.randint(-20, 21, s), dtype=I32)
         for k, s in shapes.items()}
    p["mb_flags"] = torch.as_tensor(
        rng.choice([1 | 32, 1 | 2 | 32, 1 | 8 | 32, 64 | 32, 64 | 8 | 32],
                   shapes["mb_flags"]), dtype=I32)
    p["qp"] = torch.as_tensor(rng.randint(0, 52, shapes["qp"]), dtype=I32)
    p["refslot"] = torch.as_tensor(rng.randint(-1, 3, shapes["refslot"]),
                                   dtype=I32)
    p["wp"][..., 0] = torch.as_tensor(rng.randint(0, 3, (K, H, W)))
    p["wp"][..., 1:3] = torch.as_tensor(rng.randint(0, 8, (K, H, W, 2)))
    meta = torch.as_tensor(rng.randint(1, 64, (K, 3 + 96 + 384 + 32)),
                           dtype=I32)
    sm4 = meta[:, 3:99].reshape(K, 6, 16)
    sm8 = meta[:, 99:483].reshape(K, 6, 64)
    smap = meta[:, 483:515] % 4
    flat = []
    for _ in range(2):
        flat += [torch.as_tensor(rng.randint(0, 256, (K, 16 * H, 16 * W)),
                                 dtype=I32),
                 torch.as_tensor(rng.randint(0, 256, (K, 8 * H, 8 * W, 2)),
                                 dtype=I32)]
    return p, sm4, sm8, smap, tuple(flat)


def _no_native(monkeypatch):
    def refuse(*a, **kw):
        raise AssertionError("a kernel library was loaded")

    monkeypatch.setattr(build, "lib", refuse)
    monkeypatch.setattr(build, "build_all", refuse)


# (stage function, its plain version, arguments)
def _stage_calls(p, sm4, sm8, smap, flat):
    return {
        "residual_frame": (R.residual_frame, R.residual_frame_plain,
                           (p, sm4, sm8, True)),
        "residual_frame_no_t8": (R.residual_frame, R.residual_frame_plain,
                                 (p, sm4, sm8, False)),
        "deblock_bs": (D.deblock_bs, D.deblock_bs_plain, (p,)),
        "pack_mc_params": (M.pack_mc_params, M.pack_mc_params_plain,
                           (p, smap, True, MBW, MBH)),
        "pack_mc_params_one_list": (M.pack_mc_params,
                                    M.pack_mc_params_plain,
                                    (p, smap, False, MBW, MBH)),
        "combine_mc": (M.combine_mc, M.combine_mc_plain,
                       (p, smap, flat, True)),
        "combine_mc_one_list": (M.combine_mc, M.combine_mc_plain,
                                (p, smap, flat[:2], False)),
    }


STAGE_NAMES = list(_stage_calls(*_planes()))


@pytest.mark.parametrize("name", STAGE_NAMES)
def test_cpu_tensors_take_the_plain_version(monkeypatch, name):
    """On CPU tensors each stage function returns its plain version's
    result and neither builds nor loads a kernel library, nor counts a
    launch."""
    fn, plain, args = _stage_calls(*_planes(1))[name]
    want = plain(*args)
    counts = [w.launches for w in (R.residual_cuda, D.deblock_bs_cuda,
                                   M.pack_mc_params_cuda, M.combine_mc_cuda)]
    _no_native(monkeypatch)
    got = fn(*args)
    assert len(got) == len(want)
    for a, b in zip(got, want):
        assert a.dtype == b.dtype and torch.equal(a, b)
    assert counts == [w.launches for w in (
        R.residual_cuda, D.deblock_bs_cuda, M.pack_mc_params_cuda,
        M.combine_mc_cuda)]


@pytest.mark.parametrize("wrapper", ["residual", "bs", "mcpack", "combine"])
def test_cuda_wrappers_refuse_cpu_tensors(monkeypatch, wrapper):
    """The kernel wrappers themselves refuse CPU tensors before any native
    call: only the stage functions choose the plain version."""
    p, sm4, sm8, smap, flat = _planes(2)
    _no_native(monkeypatch)
    call = {"residual": lambda: R.residual_cuda(p, sm4, sm8, True),
            "bs": lambda: D.deblock_bs_cuda(p),
            "mcpack": lambda: M.pack_mc_params_cuda(p, smap, True, MBW, MBH),
            "combine": lambda: M.combine_mc_cuda(p, flat, True)}[wrapper]
    with pytest.raises(ValueError, match="CUDA tensors"):
        call()


def _prepare(wrapper, p, sm4, sm8, smap, flat, has=True):
    """The wrapper's argument preparation, which runs on any device."""
    if wrapper == "residual":
        return R.residual_args(p, sm4, sm8, has)
    if wrapper == "bs":
        return D.bs_args(p)
    if wrapper == "mcpack":
        return M.pack_args(p, smap, MBW, MBH)
    return M.combine_args(p, flat if has else flat[:2], has)


# the planes each wrapper reads (a defect in any must be refused)
READS = {"residual": ["mb_flags", "qp", "coef_y", "coef_y8", "coef_y_dc",
                      "coef_c_dc", "coef_cb", "coef_cr"],
         "bs": ["mb_flags", "nz_y", "refslot", "mvs"],
         "mcpack": ["refslot", "mvs"],
         "combine": ["mb_flags", "refslot", "wp", "wp8"]}


def _misaligned(t):
    """t's values in a view that starts 4 bytes past a 16-byte boundary."""
    buf = torch.zeros(t.numel() + 1, dtype=t.dtype)
    out = buf[1:].view(t.shape)
    out.copy_(t)
    return out


DEFECTS = {
    "shape": lambda t: t[:, :-1].contiguous(),
    "dtype": lambda t: t.to(torch.int64),
    "layout": lambda t: t.transpose(1, 2).contiguous().transpose(1, 2),
    "alignment": _misaligned,
}


@pytest.mark.parametrize("defect", list(DEFECTS))
@pytest.mark.parametrize("wrapper", list(READS))
def test_argument_checks_refuse_bad_planes(monkeypatch, wrapper, defect):
    """Each plane a wrapper reads, with the wrong shape, type, layout or
    alignment, is refused with ValueError before any native call; the
    right planes pass."""
    p, sm4, sm8, smap, flat = _planes(3)
    _no_native(monkeypatch)
    _prepare(wrapper, p, sm4, sm8, smap, flat)
    for key in READS[wrapper]:
        bad = dict(p, **{key: DEFECTS[defect](p[key])})
        with pytest.raises(ValueError):
            _prepare(wrapper, bad, sm4, sm8, smap, flat)


@pytest.mark.parametrize("defect", list(DEFECTS))
def test_argument_checks_refuse_bad_list_planes(monkeypatch, defect):
    """combine.cu's per-list prediction planes are checked like the
    syntax planes."""
    p, sm4, sm8, smap, flat = _planes(4)
    _no_native(monkeypatch)
    for i in range(4):
        bad = list(flat)
        bad[i] = DEFECTS[defect](flat[i])
        with pytest.raises(ValueError):
            M.combine_args(p, tuple(bad), True)


def test_argument_checks_follow_the_optional_arms(monkeypatch):
    """has_t8=False reads no coef_y8 and no sm8, so neither is checked,
    and passes null for both; has_b decides how many per-list planes
    combine.cu takes, null for list 1 without it."""
    p, sm4, sm8, smap, flat = _planes(5)
    _no_native(monkeypatch)
    bad = dict(p, coef_y8=p["coef_y8"][:, :1].contiguous())
    with pytest.raises(ValueError):
        R.residual_args(bad, sm4, sm8, True)
    planes, s4, s8 = R.residual_args(bad, sm4, sm8[:, :1], False)
    assert planes[3] is None and s8 == 0 and s4 == sm4.stride(0)
    assert len(M.combine_args(p, flat, True)) == 8
    ins = M.combine_args(p, flat[:2], False)
    assert len(ins) == 8 and ins[6] is None and ins[7] is None
    for got, has_b in ((flat, False), (flat[:2], True)):
        with pytest.raises(ValueError, match="per-list"):
            M.combine_args(p, got, has_b)


def test_lane_views_pass_with_their_stride(monkeypatch):
    """Scaling matrices and slot maps are lane views of the arena's rows:
    each lane contiguous, the lanes a row apart.  The stride is passed on;
    a lane that is not contiguous, or the wrong shape or type, is
    refused."""
    p, sm4, sm8, smap, flat = _planes(6)
    _no_native(monkeypatch)
    assert not sm4.is_contiguous()
    _, s4, s8 = R.residual_args(p, sm4, sm8, True)
    assert (s4, s8) == (sm4.stride(0), sm8.stride(0))
    assert M.pack_args(p, smap, MBW, MBH)[3] == smap.stride(0)
    for bad in (sm4.transpose(1, 2), sm4[:, :5], sm4.to(torch.int64)):
        with pytest.raises(ValueError):
            R.residual_args(p, bad, sm8, True)
    for bad in (smap[:, ::2], smap.to(torch.int16), smap[:1]):
        with pytest.raises(ValueError):
            M.pack_args(p, bad, MBW, MBH)


def test_first_library_builds_every_stale_library(monkeypatch, tmp_path):
    """The first lib() call builds every stale library of ENTRIES through
    one build_all (all nvcc processes at once); a failed build raises."""
    calls = []

    def failing(names=tuple(build.ENTRIES), force=False):
        calls.append(tuple(names))
        raise RuntimeError("nvcc failed")

    monkeypatch.setattr(build, "_libs", {})
    monkeypatch.setattr(build, "build_all", failing)
    with pytest.raises(RuntimeError, match="nvcc failed"):
        build.lib("bs")
    assert calls == [tuple(build.ENTRIES)]
    assert {"residual", "mcpack", "combine", "bs"} <= set(build.ENTRIES)


# ---------------------------------------------------------------------------
# The kernels' sources built for the host (tests/host_cuda.py) and run
# through the port's own wrappers on CPU tensors

@pytest.fixture(scope="module")
def host_libs(tmp_path_factory):
    import host_cuda
    out = str(tmp_path_factory.mktemp("host_kernels"))
    return {n: host_cuda.build(n, out, build.ENTRIES[n])
            for n in ("residual", "bs", "mcpack", "combine")}


@pytest.fixture
def host_kernels(monkeypatch, host_libs):
    """The CUDA wrappers, on CPU tensors, launch the host builds."""
    import contextlib
    import types
    monkeypatch.setattr(build, "lib", host_libs.__getitem__)
    monkeypatch.setattr(build, "require_cuda", lambda device: None)
    monkeypatch.setattr(torch.cuda, "device",
                        lambda device: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda device=None: types.SimpleNamespace(
                            cuda_stream=0))


# (K, mbW, mbH): an odd lane count and padded block columns (5 and 7 mbs
# wide: 10 and 14 of 16 block columns)
HOST_GEOMETRIES = [(1, 5, 3), (2, 7, 4), (3, 5, 3)]


@pytest.mark.parametrize("K,mbW,mbH", HOST_GEOMETRIES)
def test_host_built_kernels_match_plain(host_kernels, K, mbW, mbH):
    """Each stage kernel's source, run thread by thread on the host, gives
    its plain version's planes bit for bit, with one launch a call, on
    chip_smoke.py's random inputs (levels at +-2063, QP 0 and 51, the 8x8
    transform on and off, every weighted-prediction mode, orphan inter
    cells, scaling matrices and slot maps as lane views)."""
    wrappers = {"residual": R.residual_cuda, "bs": D.deblock_bs_cuda,
                "mcpack": M.pack_mc_params_cuda, "combine": M.combine_mc_cuda}
    for name, (kern, plain, _b, _o) in stage_calls(cpu, 90 + K, K, mbW,
                                                   mbH).items():
        wrapper = wrappers[name.split("_")[0]]
        n = wrapper.launches
        got = kern()
        assert wrapper.launches == n + 1, name
        for a, b in zip(got, plain()):
            assert a.dtype == b.dtype and torch.equal(a, b), name


@pytest.mark.parametrize("mvmax", [300, 2000])
@pytest.mark.parametrize("arm", ["uniform", "pair", "quad", "unused"])
def test_host_built_mc_kernels_on_every_arm(host_kernels, arm, mvmax):
    """mcpack.cu and combine.cu on one forced MC arm (chip_smoke.mc_planes:
    uniform 8x8 blocks, 16x8 pairs, split quadrants, no list used), inside
    the frame and at the clamps (mvs to +-2000), with one list and two."""
    for has_b in (True, False):
        p, smap, flat = combine_case(cpu, 95, 2, has_b, mbW=9, mbH=4,
                                     arm=arm, mvmax=mvmax)
        for a, b in zip(M.pack_mc_params_cuda(p, smap, has_b, 9, 4),
                        M.pack_mc_params_plain(p, smap, has_b, 9, 4)):
            assert torch.equal(a, b)
        for a, b in zip(M.combine_mc_cuda(p, flat, has_b),
                        M.combine_mc_plain(p, smap, flat, has_b)):
            assert torch.equal(a, b)


# corpus classes that reach the kernels' edges: levels past int8, QP 0 and
# 51, scaling matrices with PCM, explicit and implicit weights, temporal
# direct, concealment
HOST_CLASSES = ["extreme_levels", "qp_extremes", "high_intra_scaling_pcm",
                "explicit_wp_b_cavlc", "cavlc_ipb_implicit_temporal",
                "truncated_concealment"]


@pytest.mark.parametrize("name", HOST_CLASSES)
def test_host_built_kernels_decode_corpus_classes(host_kernels, monkeypatch,
                                                  name):
    """Both decode paths on the CPU with the four stages sent to the
    host-built kernels (scaling matrices and slot maps as the arena's lane
    views) decode every frame byte-identical to the plain stages."""
    from edge264_tpu_torch import corpus
    from edge264_tpu_torch.api import decode_annexb
    from edge264_tpu_torch.ops import frame as F
    from edge264_tpu_torch.parallel.batch import decode_gops_batched
    torch.set_num_threads(1)
    data = corpus.build(name)
    runs = (lambda: decode_annexb(data, device="cpu"),
            lambda: decode_gops_batched(data, lanes=2, device="cpu"))
    want = [[(f.y.copy(), f.cb.copy(), f.cr.copy()) for f in run()]
            for run in runs]
    monkeypatch.setattr(F, "residual_frame", R.residual_cuda)
    monkeypatch.setattr(F, "deblock_bs", D.deblock_bs_cuda)
    monkeypatch.setattr(M, "pack_mc_params", M.pack_mc_params_cuda)
    monkeypatch.setattr(M, "combine_mc", lambda p, slot_maps, flat, has_b:
                        M.combine_mc_cuda(p, flat, has_b))
    for run, frames in zip(runs, want):
        n = R.residual_cuda.launches
        got = list(run())
        assert R.residual_cuda.launches > n
        assert len(got) == len(frames) > 0
        for a, b in zip(frames, got):
            for plane, c in zip(a, ("y", "cb", "cr")):
                assert np.array_equal(plane, getattr(b, c))
