"""The lockstep packer's lane pool (ops/arena.pack_planes_batch) against
the packer one lane after another: the same native probes, layout and
pack_row calls made on this thread, kept here as the reference.  Every
step's buffer, layout, meta offset and carried gat_state must be equal
byte for byte, over K of 2, 3, 8 and 4 lanes with dead lanes, a lane
without a reliable dirty list (concealment), a lane whose levels leave
int8, and gat_state carried over every step of the lanes' GOPs."""

import copy
import functools
import os
import sys
import threading
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from edge264_tpu_torch import corpus, streams  # noqa: E402
from edge264_tpu_torch.convert import PLANE_KEYS  # noqa: E402
from edge264_tpu_torch.native import SyntaxPlanes  # noqa: E402
from edge264_tpu_torch.ops import arena as A  # noqa: E402
from edge264_tpu_torch.parallel.batch import _Lane  # noqa: E402


def serial_pack(planes_list, ref_planes, keep=frozenset(), coef8=False,
                extra=None, gat_state=None):
    """The packer of native planes one lane after another, as it was
    before the pool: (uint8 [K, L] array, layout, extra_off)."""
    live = [pl for pl in planes_list if pl is not None]
    gat = None
    if gat_state is not None:
        counts = dict.fromkeys((*A.GAT_TAGS, *A.BASE_EXC), 0)
        ok = True
        for pl in live:
            pr = pl.pack_probe(True)
            if coef8 and not pr.coef8_ok:
                coef8 = False
                gat_state["coef8_off"] = True
            if pr.dirty_all:
                ok = False
                continue
            for k, (tag, _re) in A.GAT_TAGS.items():
                counts[k] = max(counts[k], pr.gat_counts[tag])
            counts["mvs"] = max(counts["mvs"], pr.exc_counts[0])
            counts["refslot"] = max(counts["refslot"], pr.exc_counts[1])
        if ok:
            gat = {}
            isz8 = 1 if coef8 else 2
            for k, (_tag, re_) in A.GAT_TAGS.items():
                U = getattr(ref_planes, k).size // re_
                b = max(gat_state.get(k, 0), 128)
                while b < counts[k]:
                    b *= 2
                sparse = (U + 7) // 8 + b * re_ * isz8 <= U * re_ * isz8 // 2
                gat[k] = b if sparse else None
                if sparse:
                    gat_state[k] = b
            for k, be in A.BASE_EXC.items():
                a = getattr(ref_planes, k)
                isz, U = a.dtype.itemsize, a.size // (16 * be)
                b = max(gat_state.get(k, 0), 128)
                while b < counts[k]:
                    b *= 2
                sparse = (U * be * isz + (U + 7) // 8 + b * 16 * be * isz
                          <= U * 16 * be * isz // 2)
                gat[k] = b if sparse else None
                if sparse:
                    gat_state[k] = b
            gat_state["_bx_on"] = any(gat[k] is not None for k in A.BASE_EXC)
    elif coef8:
        for pl in live:
            if not pl.pack_probe(False).coef8_ok:
                coef8 = False
                break
    layout, size = A.plan_layout(ref_planes, keep=keep, coef8=coef8,
                                 gat=gat)
    extra_off = size + (-size) % 8
    buf = np.zeros((len(planes_list), extra_off + extra.shape[1]), np.uint8)
    ents, n = A._native_entries(layout, size)
    for pl, row in zip(planes_list, buf):
        if pl is not None:
            assert pl.pack_row(ents, n, row, size) == 0
    buf[:, extra_off:] = extra
    return buf, layout, extra_off


@functools.cache
def _gop(w, h, seed, gop_pb=2, max_level=8):
    """One closed CABAC IPB GOP (1 + 2 * gop_pb frames)."""
    return streams.avcgen().gen_random_cabac_ipb_stream(
        w, h, n_gops=1, seed=seed, closed=True, gop_pb=gop_pb,
        density=0.1, max_level=max_level, intra_prob=0.05)


def _lanes(case):
    """The lanes' streams of a case (None: a dead lane)."""
    g = functools.partial(_gop, 24, 16)    # base+exception entries occur
    if case == "k2":
        return [g(1), g(2)]
    if case == "k3_dead":
        return [g(3), None, g(4, gop_pb=1)]
    if case == "k8_dead":
        return [g(5), g(6, gop_pb=1), None, g(7), g(8, gop_pb=3), None,
                g(9, gop_pb=1), g(10)]
    if case == "int8":
        # the second lane's levels leave int8 at its second GOP's IDR
        return [g(11, gop_pb=3), g(12) + g(13, max_level=200), None, g(14)]
    if case == "dirty_all":
        # frames 1 and 4 of the concealment class have no reliable dirty
        # list (a recovery); the class is 11x9 mbs
        return [_gop(11, 9, 15), corpus.build("truncated_concealment"),
                _gop(11, 9, 16, gop_pb=1)]
    raise KeyError(case)


def _steps(lane_streams):
    """Each lockstep step's planes list, parsed as the lockstep parses: a
    lane's frame per step, None once its stream has ended.  The frames
    stay pinned (borrowed) while the lanes live."""
    lanes = [None if s is None else _Lane(s, 8) for s in lane_streams]
    try:
        step = 0
        while True:
            for ln in lanes:
                if ln is not None and len(ln.done_slots) <= step:
                    ln.parse_next_frame()
            pls = [ln.nd.planes(ln.done_slots[step][0])
                   if ln is not None and len(ln.done_slots) > step else None
                   for ln in lanes]
            if all(pl is None for pl in pls):
                return
            yield pls
            step += 1
    finally:
        for ln in lanes:
            if ln is not None:
                ln.nd.close()


def _meta(K, step):
    return np.random.RandomState(step).randint(0, 256, (K, 40), np.uint8)


def _pack_both(pls, coef8, gat, st_pool, st_ser, step):
    extra = _meta(len(pls), step)
    ref = next(pl for pl in pls if pl is not None)
    got = A.pack_planes_batch(pls, ref, coef8=coef8, extra=extra,
                              gat_state=st_pool if gat else None,
                              device="cpu")
    want = serial_pack(pls, ref, coef8=coef8, extra=extra,
                       gat_state=st_ser if gat else None)
    return got, want


def _assert_same(got, want, step):
    (buf, layout, off), (wbuf, wlayout, woff) = got, want
    assert layout == wlayout and off == woff, step
    assert buf.dtype == torch.uint8 and buf.shape == wbuf.shape, step
    assert np.array_equal(buf.numpy(), wbuf), step


@pytest.mark.parametrize("gat", ["carried", "dense"])
@pytest.mark.parametrize("case", ["k2", "k3_dead", "k8_dead", "int8",
                                  "dirty_all"])
def test_pool_matches_serial_packer(case, gat, monkeypatch):
    """Every step of the case's lanes: the pooled buffer, layout and
    extra_off equal the serial packer's, and so does the carried
    gat_state (coef8_off included) after every step.  The buffer is
    handed over filled with 0xAB (as reused staging holds an older
    step's bytes), so every byte must be written."""
    monkeypatch.setattr(A, "_arena_buf", lambda n, rows, device: torch.full(
        (rows, n), 0xAB, dtype=torch.uint8))
    lane_streams = _lanes(case)
    st_pool, st_ser = {}, {}
    coef8 = True                    # as on the card
    seen = set()
    step = -1
    for step, pls in enumerate(_steps(lane_streams)):
        if coef8 and st_pool.get("coef8_off"):
            coef8 = False           # as _decode_group does
        got, want = _pack_both(pls, coef8, gat == "carried", st_pool,
                               st_ser, step)
        _assert_same(got, want, step)
        assert st_pool == st_ser, step
        seen |= {off for *_x, off, _m in got[1] if off < 0}
        seen |= {"dead"} if any(pl is None for pl in pls) else set()
        seen |= {"dirty_all"} if any(pl is not None and pl.dirty_all
                                     for pl in pls) else set()
        seen |= {"int16"} if any(dt == "int16" and k in A.COEF_PLANES
                                 for k, dt, *_x in got[1]) else set()
    assert step >= 2
    if gat == "carried":
        assert {-2, -3} <= seen or case == "dirty_all", seen
        assert -2 in seen, seen
    if case != "k2":
        assert "dead" in seen
    if case == "int8":
        assert "int16" in seen
        assert st_pool.get("coef8_off") is (True if gat == "carried"
                                            else None)
    if case == "dirty_all":
        assert "dirty_all" in seen


def _record_threads(monkeypatch):
    names = []
    for meth in ("pack_probe", "pack_row"):
        fn = getattr(SyntaxPlanes, meth)

        def rec(self, *a, _fn=fn, **kw):
            names.append(threading.current_thread().name)
            return _fn(self, *a, **kw)
        monkeypatch.setattr(SyntaxPlanes, meth, rec)
    return names


def test_lanes_pack_on_the_pool(monkeypatch):
    """Two or more live lanes: every probe and row on the pool's threads;
    one live lane (the single-frame path's K=1): on the calling thread."""
    names = _record_threads(monkeypatch)
    for pls in _steps(_lanes("k3_dead")):
        live = [pl for pl in pls if pl is not None]
        names.clear()
        A.pack_planes_batch(pls, live[0], coef8=True, extra=_meta(3, 0),
                            gat_state={})
        if len(live) >= 2:
            assert len(names) == 2 * len(live)
            assert all(n.startswith("arena-pack") for n in names), names
        names.clear()
        A.pack_planes_batch([live[0]], live[0], coef8=True, gat_state={})
        assert names == [threading.current_thread().name] * 2


def _plain(pl):
    """A plain copy of a planes object: no pack_probe, so it packs with
    the numpy packer."""
    ns = types.SimpleNamespace(mb_w=pl.mb_w, mb_h=pl.mb_h,
                               dirty=pl.dirty.copy(), dirty_all=pl.dirty_all)
    for k in PLANE_KEYS:
        setattr(ns, k, np.array(getattr(pl, k)))
    return ns


def test_numpy_and_single_lane_paths_stay_inline(monkeypatch):
    """The numpy packer (any K) and a native step with one live lane never
    reach the pool."""

    def refuse():
        raise AssertionError("the pool was used")

    monkeypatch.setattr(A, "_pool", refuse)
    st = {}
    for pls in _steps(_lanes("k3_dead")):
        live = [pl for pl in pls if pl is not None]
        plain = [None if pl is None else _plain(pl) for pl in pls]
        A.pack_planes_batch(plain, plain[0], coef8=True, gat_state=st)
        A.pack_planes_batch(plain, plain[0], coef8=True)
        A.pack_planes_batch([live[0], None], live[0], coef8=True,
                            gat_state={})


@pytest.mark.parametrize("stage", ["probe", "row"])
def test_a_bad_slot_names_its_lane(stage):
    """A native failure on lane 2 raises RuntimeError naming lane 2 (the
    probe fails with gathering on, pack_row with it off), after every
    other lane's task has ended; the next call packs normally."""
    steps = _steps(_lanes("k8_dead"))
    pls = next(steps)           # the lanes' decoders live until close()
    bad = copy.copy(pls[3])
    bad._slot = 99
    lanes = [pls[0], pls[1], bad, pls[3]]
    with pytest.raises(RuntimeError,
                       match=f"lane 2: e264t_pack_{stage}"):
        A.pack_planes_batch(lanes, pls[0], extra=_meta(4, 0),
                            gat_state={} if stage == "probe" else None)
    good = [pls[0], pls[1], None, pls[3]]
    _assert_same(A.pack_planes_batch(good, pls[0], extra=_meta(4, 0)),
                 serial_pack(good, pls[0], extra=_meta(4, 0)), 0)
    steps.close()


def test_threads_packing_at_once_each_get_their_own_buffer():
    """More callers than cores pack their own lanes at once through the
    one pool (as decode_annexb_parallel and the mesh path may), with a
    short switch interval: each caller's every step equals the serial
    packer's on the same streams."""
    lane_streams = _lanes("k3_dead")
    want, st = [], {}
    for step, pls in enumerate(_steps(lane_streams)):
        extra = _meta(3, step)
        want.append(serial_pack(pls, pls[0], coef8=True, extra=extra,
                                gat_state=st))
    errors, done = [], []

    def caller(i):
        try:
            st = {}
            for step, pls in enumerate(_steps(lane_streams)):
                got = A.pack_planes_batch(pls, pls[0], coef8=True,
                                          extra=_meta(3, step),
                                          gat_state=st)
                _assert_same(got, want[step], step)
            done.append(i)
        except Exception as e:       # reported by the main thread
            errors.append((i, e))

    n = (os.cpu_count() or 1) + 2
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        threads = [threading.Thread(target=caller, args=(i,))
                   for i in range(n)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
    finally:
        sys.setswitchinterval(old)
    assert not any(t.is_alive() for t in threads)
    assert not errors, errors
    assert sorted(done) == list(range(n))
