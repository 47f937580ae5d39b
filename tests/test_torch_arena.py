"""ops/arena.py == the JAX package's arena (jaxdec.pack_planes_batch,
_unpack_planes) on the same frames: the port's planes come from its
native front end, the JAX package's from its own, over the same bytes.

The streams are 24x16 mbs: below ~300 mbs a base+exception entry is
never under half its dense size, so smaller frames would leave that
entry kind (and the 8x8 coefficient gather) untested."""

import functools
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import edge264_tpu.ops.jaxdec as J  # noqa: E402
from edge264_tpu.native import NativeDecoder as JNativeDecoder  # noqa: E402
from edge264_tpu_torch import streams  # noqa: E402
from edge264_tpu_torch.api import find_start_code  # noqa: E402
from edge264_tpu_torch.convert import CONDITIONAL, PLANE_KEYS  # noqa: E402
from edge264_tpu_torch.native import EV_FRAME_DONE, NativeDecoder  # noqa
from edge264_tpu_torch.ops import arena as A  # noqa: E402
from edge264_tpu_torch.ops.batched import pack_meta  # noqa: E402

CPU = torch.device("cpu")


@functools.lru_cache(maxsize=None)
def _stream(kind):
    g = streams.avcgen()
    if kind == "ipb":          # CABAC IDR P B P B, two closed GOPs
        return g.gen_random_cabac_ipb_stream(
            24, 16, n_gops=2, seed=5, closed=True, gop_pb=2, density=0.1,
            intra_prob=0.05)
    assert kind == "high"      # High IPP, 8x8 transforms in P frames
    return g.gen_random_high_ipp_stream(24, 16, n_frames=3, seed=6,
                                        density=0.1)


def _frames(data):
    """Decode `data` with both front ends in step; at each completed
    frame yield (JAX planes, port planes) of the same slot, valid until
    the next iteration."""
    jd, td = JNativeDecoder(), NativeDecoder()
    pos = find_start_code(data, 0)
    while pos < len(data):
        end = find_start_code(data, pos + 3)
        _, jev = jd.decode_nal(data[pos + 3:end])
        _, tev = td.decode_nal(data[pos + 3:end])
        assert jev == tev
        for e in tev:
            if e[0] == EV_FRAME_DONE:
                yield jd.planes(e[1]), td.planes(e[1])
        for nd in (jd, td):
            while (info := nd.get_frame()) is not None:
                nd.return_frame(info["slot"])
        pos = end
    jd.close()
    td.close()


def _plain(pl):
    """A plain copy of a planes object: no pack_probe, so it packs with
    the numpy packer."""
    ns = types.SimpleNamespace(mb_w=pl.mb_w, mb_h=pl.mb_h,
                               dirty=pl.dirty.copy(),
                               dirty_all=pl.dirty_all)
    for k in PLANE_KEYS:
        setattr(ns, k, np.array(getattr(pl, k)))
    return ns


def _meta(seed):
    rng = np.random.RandomState(seed)
    return pack_meta(rng.randint(0, 99, (2, 6, 16)),
                     rng.randint(0, 99, (2, 6, 64)),
                     rng.randint(0, 9, (2, 32)), [3, 8])


@pytest.mark.parametrize("gat", ["none", "fresh", "carried"])
@pytest.mark.parametrize("keep", ["empty", "full"])
@pytest.mark.parametrize("coef8", [False, True])
@pytest.mark.parametrize("path", ["native", "numpy"])
@pytest.mark.parametrize("kind", ["ipb", "high"])
def test_pack_matches_jax(kind, path, coef8, keep, gat, monkeypatch):
    """Layout, bytes and meta offset of every frame, packed with a dead
    second lane and a meta block, equal the JAX package's; a carried
    gat_state grows and ends the same."""
    if path == "numpy":
        monkeypatch.setenv("E264T_NO_NATIVE_PACK", "1")
    keep = set(CONDITIONAL) if keep == "full" else set()
    jst = tst = None
    if gat == "carried":
        jst, tst = {}, {}
    seen = set()
    for i, (jp, tp) in enumerate(_frames(_stream(kind))):
        if gat == "fresh":
            jst, tst = {}, {}
        if path == "numpy":
            tp = _plain(tp)
        extra = _meta(i)
        jb, jl, jo = J.pack_planes_batch([jp, None], jp, keep=keep,
                                         coef8=coef8, extra=extra,
                                         gat_state=jst)
        tb, tl, to = A.pack_planes_batch([tp, None], tp, keep=keep,
                                         coef8=coef8, extra=extra,
                                         gat_state=tst, device=CPU)
        assert tl == jl and to == jo, i
        assert tb.dtype == torch.uint8 and np.array_equal(tb.numpy(), jb), i
        seen |= {off for *_, off, _m in tl if off < 0}
    assert i >= 2
    if gat != "none":
        assert {-2, -3} <= seen, seen
    if gat == "carried":
        assert tst == jst
        assert max(v for k, v in tst.items() if k in A.GAT_TAGS) > 128


def test_pack_planes_matches_jax():
    """The one-frame numpy packer: JAX's pack_planes bytes and layout."""
    for i, (jp, tp) in enumerate(_frames(_stream("high"))):
        keep = {"wp", "wp8"} if i else set()
        ja, jl = J.pack_planes(jp, keep=keep)
        ta, tl = A.pack_planes(_plain(tp), keep=keep)
        assert tl == jl and np.array_equal(ta, np.asarray(ja)), i


def test_dirty_lists_match_jax():
    n = 0
    for kind in ("ipb", "high"):
        for jp, tp in _frames(_stream(kind)):
            assert tp.dirty_all == jp.dirty_all
            assert tp.dirty.dtype == np.uint64
            assert np.array_equal(tp.dirty, jp.dirty)
            n += len(tp.dirty)
    assert n > 0


@pytest.fixture(scope="module")
def arenas():
    """Arenas of the ipb stream's first two frames (an IDR: dense
    coefficients, base+exception mvs; a P frame: gathered coefficients),
    packed with int8 and int16 levels, a carried gat_state and a meta
    block, beside each frame's dense planes."""
    out = []
    states = {False: {}, True: {}}
    for i, (jp, _tp) in enumerate(_frames(_stream("ipb"))):
        if i == 2:
            break
        dense = {k: np.array(getattr(jp, k)) for k in PLANE_KEYS}
        for coef8 in (False, True):
            buf, layout, off = J.pack_planes_batch(
                [jp, None], jp, coef8=coef8, extra=_meta(i),
                gat_state=states[coef8])
            out.append((np.array(buf), layout, dense))
    return out


@pytest.mark.parametrize("case", range(4))
def test_unpack_matches_jax(arenas, case):
    """unpack_planes on the CPU == jax.vmap(_unpack_planes) on the same
    arena, key by key; the live lane equals the frame's planes where the
    layout carries them, the dead lane is zeros; every plane is a
    contiguous int32 tensor of its own, 16-byte aligned."""
    buf, layout, dense = arenas[case]
    got = A.unpack_planes(torch.from_numpy(buf), layout)
    want = jax.vmap(lambda a: J._unpack_planes(a, layout))(jnp.asarray(buf))
    assert set(got) == set(PLANE_KEYS)
    ptrs = set()
    for k, dt, shape, off, _m in layout:
        g = got[k]
        assert g.dtype == torch.int32 and g.is_contiguous(), k
        assert tuple(g.shape) == (2,) + tuple(shape), k
        assert g.data_ptr() % 16 == 0 and g.data_ptr() not in ptrs, k
        ptrs.add(g.data_ptr())
        assert np.array_equal(g.numpy(), np.asarray(want[k])), k
        if off != -1:
            assert np.array_equal(g[0].numpy(), dense[k].reshape(shape)), k
        assert not g[1].any(), k
    kinds = {off if off < 0 else 0 for *_, off, _m in layout}
    assert kinds & {-2, -3}
    assert (got["refslot"][0] < 0).any()       # int8 sign extension


def test_int8_range_always_checked():
    """coef8 with gathering off (gat_state=None) and a level of 200: the
    port packs int16 and the level comes back.  The JAX packer skips its
    range check on this path and packs int8, which wraps 200 to -56."""
    frames = _frames(_stream("ipb"))     # alive: it owns the decoders
    next(frames)
    _jp, tp = next(frames)                  # a P frame
    # the numpy packer: any position
    ns = _plain(tp)
    ns.coef_cb[3, 5, 2] = 200
    # the native packer checks the coded rows of the dirty list: put the
    # level in one of them
    d = tp.dirty
    row = int((d[(d >> np.uint64(48)) == 0][0] & np.uint64((1 << 48) - 1))
              // 16)
    tp.coef_y.reshape(-1, 16)[row, 7] = 200
    for pl, k, at in ((ns, "coef_cb", (3, 5, 2)),
                      (tp, "coef_y", np.unravel_index(
                          row * 16 + 7, tp.coef_y.shape))):
        buf, layout, _ = A.pack_planes_batch([pl], pl, coef8=True,
                                             device=CPU)
        assert {e[0]: e[1] for e in layout}[k] == "int16"
        assert int(A.unpack_planes(buf, layout)[k][0][at]) == 200
    # with the levels in range, coef8 does pack int8
    tp.coef_y.reshape(-1, 16)[row, 7] = 5
    _, layout, _ = A.pack_planes_batch([tp], tp, coef8=True, device=CPU)
    assert {e[0]: e[1] for e in layout}["coef_y"] == "int8"


def test_pack_row_bounds_guard():
    """The C packer checks an entry's end only after writing it: a short
    output row and an entry past the arena's size raise before the
    call."""
    for _jp, tp in _frames(_stream("ipb")):
        layout, size = A.plan_layout(tp)
        ents, n = A._native_entries(layout, size)
        with pytest.raises(ValueError, match="cannot hold"):
            tp.pack_row(ents, n, np.zeros(size - 1, np.uint8), size)
        with pytest.raises(ValueError, match="ends past"):
            A._native_entries(layout, size - 1)
        out = np.zeros(size, np.uint8)
        assert tp.pack_row(ents, n, out, size) == 0
        assert out.any()
        break


def test_cpu_arena_buffers_are_fresh():
    """On the CPU every call packs into a new buffer, and upload hands it
    back as the arena."""
    for _jp, tp in _frames(_stream("ipb")):
        a, _, _ = A.pack_planes_batch([tp], tp, device=CPU)
        b, _, _ = A.pack_planes_batch([tp], tp, device=CPU)
        assert not np.shares_memory(a.numpy(), b.numpy())
        assert np.array_equal(a.numpy(), b.numpy())
        assert A.upload(a, CPU) is a and not a.is_pinned()
        break
