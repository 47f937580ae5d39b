"""The level-gather intra route == the JAX package's: intra_level_tables,
intra_scan, the whole-frame functions with `itab`, and the CPU
single-frame backend, which takes the route on the frames where
JaxBackend on the CPU builds tables."""

import functools
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

import edge264_tpu.ops.jaxdec as J  # noqa: E402
from chip_smoke import decoded_planes  # noqa: E402
from edge264_tpu.api import decode_annexb as jax_decode_annexb  # noqa
from edge264_tpu_torch import streams  # noqa: E402
from edge264_tpu_torch.api import decode_annexb  # noqa: E402
from edge264_tpu_torch.convert import CONDITIONAL, \
    planes_to_torch  # noqa: E402
from edge264_tpu_torch.ops import backend as BK  # noqa: E402
from edge264_tpu_torch.ops import frame as F  # noqa: E402
from edge264_tpu_torch.ops import intra as I  # noqa: E402
from edge264_tpu_torch.ops.tables import MBF_INTRA  # noqa: E402

INTER = 64 | 32          # an inter mb's flags in the synthetic planes


# ---------------------------------------------------------------------------
# intra_level_tables

def _isolated(w, h):
    """Intra at every (even x, even y): no intra causal neighbour, so all
    of them sit on level 1 (25% intra)."""
    f = np.full((h, w), INTER, np.int32)
    f[::2, ::2] = 1
    return f


def _chain(n, w=40, h=4):
    """One row of n consecutive intra mbs: depths 1..n."""
    f = np.full((h, w), INTER, np.int32)
    f[1, 3:3 + n] = 1
    return f


def _random(w, h, share, seed):
    rng = np.random.RandomState(seed)
    return np.where(rng.rand(h, w) < share, 1 | 32, INTER).astype(np.int32)


TABLE_CASES = {
    "empty": np.full((4, 6), INTER, np.int32),
    "1080p": _random(120, 68, 0.05, 1),
    "chain2": _chain(2), "chain4": _chain(4), "chain8": _chain(8),
    "chain16": _chain(16),
    "entries512": _isolated(30, 20), "entries2048": _isolated(80, 60),
    "entries8160": _isolated(180, 100),
    # None: too dense; chains deeper than 16 (17: converged but past the
    # last bucket, 18: not converged); a level past 8160 entries
    "dense": _random(20, 10, 0.5, 2), "chain17": _chain(17),
    "chain18": _chain(18), "entries_past": _isolated(240, 160),
}


@pytest.mark.parametrize("case", list(TABLE_CASES))
def test_level_tables_match_jax(case):
    flags = TABLE_CASES[case]
    h, w = flags.shape
    want = J.intra_level_tables(flags, w, h)
    got = I.intra_level_tables(flags, w, h)
    assert (want is None) == (got is None)
    if case in ("dense", "chain17", "chain18", "entries_past"):
        assert got is None
        return
    for a, b in zip(want, got):
        assert a.dtype == b.dtype and np.array_equal(a, b)
    Lb, Nb = got[0].shape
    if case.startswith("chain"):
        assert Lb == int(case[5:])
    if case.startswith("entries"):
        assert Nb == int(case[7:])


# ---------------------------------------------------------------------------
# intra_scan on real planes

@functools.lru_cache(maxsize=None)
def _frames(kind):
    """Intra-sparse frames of a stream: (planes snapshot, sm4, sm8, slot,
    is_ref) as chip_smoke.decoded_planes gives them, for the frames that
    have level tables."""
    g = streams.avcgen()
    if kind == "ipb":              # CABAC P/B frames with I4 / I16 mbs
        data = g.gen_random_cabac_ipb_stream(
            6, 4, n_gops=1, seed=12, closed=True, gop_pb=3, density=0.1,
            max_level=4, intra_prob=0.25)
        return tuple(f for f in decoded_planes(data)
                     if I.intra_level_tables(f[0].mb_flags, 6, 4)
                     is not None)
    assert kind == "i8_pcm"
    # The generators put only I4 and I16 mbs into P/B frames, so Intra_8x8
    # and PCM come from High IDR frames with two mbs in three turned
    # inter (their planes otherwise as decoded); mb (0, 0) stays intra,
    # so the later levels' padded entries, all at (0, 0), must not
    # overwrite it.
    data = g.gen_random_high_stream(6, 4, n_frames=2, seed=3,
                                    kinds=("i4", "i8", "i16", "pcm"))
    out = []
    for snap, *rest in decoded_planes(data):
        pl = types.SimpleNamespace(**vars(snap))
        yy, xx = np.mgrid[:4, :6]
        pl.mb_flags = np.where((xx + yy) % 3 == 0, snap.mb_flags, INTER) \
            .astype(snap.mb_flags.dtype)
        out.append((pl, *rest))
    return tuple(out)


def _scan_inputs(pl, seed):
    rng = np.random.RandomState(seed)
    H, W = 16 * pl.mb_h, 16 * pl.mb_w
    return [rng.randint(0, 256, (H, W)), rng.randint(0, 256, (H // 2, W // 2)),
            rng.randint(0, 256, (H // 2, W // 2)),
            rng.randint(-40, 40, (H, W)),
            rng.randint(-40, 40, (H // 2, W // 2)),
            rng.randint(-40, 40, (H // 2, W // 2))]


def _jax_planes(pl):
    return {k: v.astype(jnp.int32) for k, v in J.planes_to_jax(pl).items()}


def _pad(tabs):
    """Per-frame tables padded to the largest (Lb, Nb) and stacked
    [K, Lb, Nb] (padding: mb (0, 0), not valid)."""
    Lb = max(t[0].shape[0] for t in tabs)
    Nb = max(t[0].shape[1] for t in tabs)
    out = []
    for j, dt in enumerate((np.int32, np.int32, bool)):
        a = np.zeros((len(tabs), Lb, Nb), dt)
        for k, t in enumerate(tabs):
            a[k, :t[j].shape[0], :t[j].shape[1]] = t[j]
        out.append(torch.from_numpy(a))
    return tuple(out)


@pytest.mark.parametrize("kind", ["ipb", "i8_pcm"])
@pytest.mark.parametrize("K", [1, 2])
def test_intra_scan_matches_jax(kind, K):
    frames = _frames(kind)
    assert len(frames) >= 2
    flags = [np.asarray(f[0].mb_flags) for f in frames]
    if kind == "i8_pcm":
        both = np.stack(flags)
        assert (both & MBF_INTRA)[:, 0, 0].all()
        assert (both & 8).any() and (both & 4).any()      # I8x8, PCM mbs
    groups = [frames[i:i + K] for i in range(0, len(frames) - K + 1, K)]
    for gi, group in enumerate(groups):
        ins = [_scan_inputs(f[0], 10 * gi + k) for k, f in enumerate(group)]
        tabs = [I.intra_level_tables(np.asarray(f[0].mb_flags), 6, 4)
                for f in group]
        assert all(t[2].sum() < t[2].size for t in tabs)   # padded entries
        want = [J.intra_scan(*[jnp.asarray(a, jnp.int32) for a in x],
                             _jax_planes(f[0]),
                             tuple(jnp.asarray(t) for t in tab))
                for x, f, tab in zip(ins, group, tabs)]
        p = planes_to_torch([f[0] for f in group], CONDITIONAL, "cpu")
        got = I.intra_scan(*[torch.as_tensor(np.stack(a), dtype=torch.int32)
                             for a in zip(*ins)], p, _pad(tabs))
        for k in range(K):
            for c in range(3):
                assert np.array_equal(np.asarray(want[k][c]),
                                      got[c][k].numpy()), (gi, k, c)


# ---------------------------------------------------------------------------
# the whole-frame functions and the backend

def _itabs(pl):
    t = I.intra_level_tables(np.asarray(pl.mb_flags), pl.mb_w, pl.mb_h)
    return (tuple(jnp.asarray(a) for a in t),
            tuple(torch.from_numpy(a)[None] for a in t))


def test_decode_frame_with_itab_matches_jax():
    """decode_frame (the i8_pcm frames) and decode_frame_inter (the ipb
    P/B frames, from a one-slot ring holding a random reference) with
    level tables == decode_frame_jit / decode_frame_inter_jit with the
    same tables."""
    for pl, sm4, sm8, _, _ in _frames("i8_pcm"):
        jt, tt = _itabs(pl)
        want = J.decode_frame_jit(_jax_planes(pl), jnp.asarray(sm4),
                                  jnp.asarray(sm8), 6, 4, jt)
        got = F.decode_frame(planes_to_torch([pl], CONDITIONAL, "cpu"),
                             torch.as_tensor(sm4)[None],
                             torch.as_tensor(sm8)[None], 6, 4, itab=tt)
        for a, b in zip(want, got):
            assert np.array_equal(np.asarray(a), b[0].numpy())
    rng = np.random.RandomState(5)
    ref = [rng.randint(0, 256, s).astype(np.uint8)
           for s in ((64, 96), (32, 48), (32, 48))]
    l4, ch = (np.array(a) for a in J.make_ref_planes(*map(jnp.asarray,
                                                          ref)))
    smap = np.zeros(32, np.int32)      # every DPB slot -> ring slot 0
    for pl, sm4, sm8, _, _ in _frames("ipb"):
        jt, tt = _itabs(pl)
        want = J.decode_frame_inter_jit(
            _jax_planes(pl), jnp.asarray(sm4), jnp.asarray(sm8),
            jnp.asarray(l4[None]), jnp.asarray(ch[None]),
            jnp.asarray(smap), 6, 4, jt)
        got = F.decode_frame_inter(
            planes_to_torch([pl], CONDITIONAL, "cpu"),
            torch.as_tensor(sm4)[None], torch.as_tensor(sm8)[None],
            torch.from_numpy(l4)[None, None], torch.from_numpy(ch)[None, None],
            torch.as_tensor(smap)[None], 6, 4, itab=tt)
        for a, b in zip(want, got):
            assert np.array_equal(np.asarray(a), b[0].numpy())


def test_levels_route_refuses_planes_off_the_cpu():
    """The level-gather scan is plain PyTorch: with planes on another
    device (here "meta", standing in for a card) the levels route raises
    before it computes anything, so a card never runs it."""
    y = torch.zeros((1, 64, 96), dtype=torch.int32, device="meta")
    c = torch.zeros((1, 32, 48), dtype=torch.int32, device="meta")
    tabs = tuple(torch.zeros((1, 2, 2), dtype=torch.int32) for _ in range(3))
    with pytest.raises(ValueError, match="CPU only"):
        F._intra_dispatch(y, c, c, y, c, c, {}, "levels", 6, 4, True, True,
                          tabs)


@pytest.mark.parametrize("device", ["cpu", "meta"])
@pytest.mark.parametrize("route", ["skip", "sheared", "rounds2", "rounds8"])
def test_intra_route_by_device(device, route, monkeypatch):
    """_intra_dispatch on planes on the CPU and off it ("meta", standing
    in for a card): "rounds{R}" takes the plain level rounds on the CPU
    only and intra_batch (intra.cu on a card) elsewhere; "sheared" always
    intra_batch; "skip" neither."""
    calls = []

    def rec(name):
        def fn(y, cb, cr, *a):
            calls.append((name, a[-5:] if name == "intra_rounds" else a[-4:]))
            return y, cb, cr
        return fn

    monkeypatch.setattr(F, "intra_batch", rec("intra_batch"))
    monkeypatch.setattr(F, "intra_rounds", rec("intra_rounds"))
    y = torch.zeros((1, 64, 96), dtype=torch.int32, device=device)
    c = torch.zeros((1, 32, 48), dtype=torch.int32, device=device)
    out = F._intra_dispatch(y, c, c, y, c, c, {}, route, 6, 4, True, False)
    assert out[0] is y
    if route == "skip":
        assert calls == []
    elif route.startswith("rounds") and device == "cpu":
        assert calls == [("intra_rounds", (6, 4, int(route[6:]), True,
                                           False))]
    else:
        assert calls == [("intra_batch", (6, 4, True, False))]


def _route_log(module, names, routes):
    """Wrap module's arena frame functions: append, per call, whether the
    call carried level tables (itab, positional as JaxBackend and
    TorchBackend pass it)."""
    saved = {n: getattr(module, n) for n in names}

    def wrap(fn, at):
        def rec(*a, **kw):
            routes.append(a[at] is not None)
            return fn(*a, **kw)
        return rec
    return {n: wrap(fn, 3 if n == "decode_frame_arena" else 6)
            for n, fn in saved.items()}


def test_cpu_backend_takes_the_levels_route_where_jax_does(monkeypatch):
    """decode_annexb(device="cpu") == the JAX package's backend="jax" on
    the CPU, frame for frame, and each frame takes the level-gather scan
    exactly where JaxBackend builds tables (the P/B frames here)."""
    data = streams.avcgen().gen_random_cabac_ipb_stream(
        6, 4, n_gops=1, seed=12, closed=True, gop_pb=3, density=0.1,
        max_level=4, intra_prob=0.25)
    names = ("decode_frame_arena", "decode_frame_inter_arena")
    jroutes, troutes, scans = [], [], []
    for n, fn in _route_log(J, names, jroutes).items():
        monkeypatch.setattr(J, n, fn)
    for n, fn in _route_log(BK, names, troutes).items():
        monkeypatch.setattr(BK, n, fn)
    scan = F.intra_scan
    monkeypatch.setattr(F, "intra_scan",
                        lambda *a: scans.append(1) or scan(*a))
    want = list(jax_decode_annexb(data, backend="jax"))
    got = list(decode_annexb(data, device="cpu"))
    assert len(got) == len(want) == 7
    for a, b in zip(want, got):
        for c in ("y", "cb", "cr"):
            assert np.array_equal(np.asarray(getattr(a, c)), getattr(b, c))
    assert troutes == jroutes and len(troutes) == 7
    assert troutes[0] is False and sum(troutes) == len(scans) == 6
