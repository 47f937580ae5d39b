"""The port's lockstep decode on the CPU == the JAX package's
decode_gops_batched, frame for frame and byte for byte, taking the same
intra route at every step; the port's native front end == the JAX
package's; device digests == host_frame_digest."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import __graft_entry__  # noqa: E402
import edge264_tpu.ops.batched as JB  # noqa: E402
import edge264_tpu.ops.jaxdec as J  # noqa: E402
from edge264_tpu.native import NativeDecoder as JNativeDecoder  # noqa: E402
from edge264_tpu.parallel.batch import \
    decode_gops_batched as jax_decode  # noqa: E402
from edge264_tpu_torch import streams  # noqa: E402
from edge264_tpu_torch.api import find_start_code  # noqa: E402
from edge264_tpu_torch.convert import PLANE_KEYS  # noqa: E402
from edge264_tpu_torch.ops import arena as A  # noqa: E402
from edge264_tpu_torch.ops import batched as B  # noqa: E402
from edge264_tpu_torch.native import EV_FRAME_DONE, NativeDecoder  # noqa
from edge264_tpu_torch.ops.batched import host_frame_digest  # noqa: E402
from edge264_tpu_torch.parallel import batch as TB  # noqa: E402
from edge264_tpu_torch.parallel.batch import \
    decode_gops_batched  # noqa: E402

VIEWS = ("y", "cb", "cr", "y_mvc", "cb_mvc", "cr_mvc")


def _uneven_ipb():
    """Two closed CABAC IPB GOPs of different lengths (IDR+P+B and
    IDR+3x(P+B)): with lanes=2 one lane idles out mid-group."""
    g = streams.avcgen()
    return b"".join(g.gen_random_cabac_ipb_stream(
        6, 4, n_gops=1, seed=100 + i, closed=True, gop_pb=pb, density=0.1,
        max_level=4, intra_prob=0.1) for i, pb in enumerate((1, 3)))


def _assert_same_frames(want, got):
    assert len(got) == len(want) > 0
    for i, (a, b) in enumerate(zip(want, got)):
        for n in VIEWS:
            x, y = getattr(a, n), getattr(b, n)
            assert (x is None) == (y is None), (i, n)
            if x is not None:
                assert y.dtype == np.uint8
                assert np.array_equal(np.asarray(x), y), (i, n)


def _assert_digests(frames, digests):
    assert len(frames) == len(digests)
    for f, d in zip(frames, digests):
        assert d.digest == host_frame_digest(f.y, f.cb, f.cr)
        if f.y_mvc is not None:
            assert d.digest_mvc == host_frame_digest(f.y_mvc, f.cb_mvc,
                                                     f.cr_mvc)


def _recording(module, modes):
    """Wrap module.decode_batch_step to append each step's intra_mode."""
    step = module.decode_batch_step

    def rec(*a, **kw):
        modes.append(kw["intra_mode"])
        return step(*a, **kw)
    return rec


def _recording_pack(module, packs):
    """Wrap module.pack_planes_batch to append each step's (layout,
    bytes, meta offset)."""
    pack = module.pack_planes_batch

    def rec(*a, **kw):
        buf, layout, meta_off = pack(*a, **kw)
        packs.append((layout, np.array(buf), meta_off))
        return buf, layout, meta_off
    return rec


@pytest.fixture(scope="module")
def uneven():
    """The uneven IPB stream, JAX's frames, JAX's per-step intra routes
    and JAX's per-step arenas."""
    data = _uneven_ipb()
    modes, packs = [], []
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(JB, "decode_batch_step", _recording(JB, modes))
        mp.setattr(J, "pack_planes_batch", _recording_pack(J, packs))
        want = list(jax_decode(data, lanes=2))
    return data, want, modes, packs


def test_cabac_ipb_uneven_gops_matches_jax(uneven):
    data, want, _, _ = uneven
    got = list(decode_gops_batched(data, lanes=2, device="cpu"))
    _assert_same_frames(want, got)
    _assert_digests(got, list(decode_gops_batched(
        data, lanes=2, sink="digest", device="cpu")))


def test_step_arenas_match_jax(uneven, monkeypatch):
    """The port's driver packs, at every step, the JAX driver's layout and
    bytes (planes, dead-lane rows and meta block) with its carried
    gat_state."""
    data, _, _, want = uneven
    got = []
    monkeypatch.setattr(A, "pack_planes_batch", _recording_pack(A, got))
    list(decode_gops_batched(data, lanes=2, device="cpu"))
    assert len(got) == len(want) > 3
    for i, ((tl, tb, to), (jl, jb, jo)) in enumerate(zip(got, want)):
        assert tl == jl and to == jo, i
        assert np.array_equal(tb, jb), i


def test_intra_route_per_step_matches_jax(uneven, monkeypatch):
    """IDR steps take the wavefront, intra-sparse P/B steps the level
    rounds, exactly as the JAX package's lockstep loop chooses."""
    data, _, want, _ = uneven
    got = []
    monkeypatch.setattr(B, "decode_batch_step", _recording(B, got))
    list(decode_gops_batched(data, lanes=2, device="cpu"))
    assert got == want
    assert got[0] == "sheared" and any(m.startswith("rounds") for m in got)


@pytest.mark.parametrize("share", [0.0, 0.02, 0.2, 0.6])
def test_card_intra_route_needs_no_depth_plane(share, monkeypatch):
    """Off the CPU the step's intra route is "skip" (no lane has an intra
    mb) or "sheared" (intra.cu, whatever the CPU would name), from the
    flags alone: no depth plane is built.  On the CPU the same flags skip
    exactly when the card's route does."""
    rng = np.random.RandomState(int(share * 100))
    flags = [np.where(rng.rand(8, 12) < share, 1 | 32, 64 | 32)
             .astype(np.int32) for _ in range(2)]
    cpu = TB._intra_mode(flags, 12, 8, True)

    def no_plane(*a):
        raise AssertionError("a depth plane was built off the CPU")

    monkeypatch.setattr(TB, "intra_round_plane", no_plane)
    card = TB._intra_mode(flags, 12, 8, False)
    assert card == ("skip" if share == 0 else "sheared")
    assert (cpu == "skip") == (card == "skip")


def test_dryrun_stream_high_mvc_matches_jax():
    """__graft_entry__._dryrun_stream(3): CABAC IPB + High 8x8 + MVC
    Stereo GOPs in one lockstep group."""
    with streams.scoped_tools():
        data = __graft_entry__._dryrun_stream(3)
    want = list(jax_decode(data, lanes=3))
    got = list(decode_gops_batched(data, lanes=3, device="cpu"))
    _assert_same_frames(want, got)
    assert any(f.y_mvc is not None for f in got)
    _assert_digests(got, list(decode_gops_batched(
        data, lanes=3, sink="digest", device="cpu")))


def _slot_planes(nd_cls, data):
    """Every completed frame's syntax planes, copied, in decode order."""
    nd = nd_cls()
    out = []
    pos = find_start_code(data, 0)
    while pos < len(data):
        end = find_start_code(data, pos + 3)
        _, events = nd.decode_nal(data[pos + 3:end])
        for e in events:
            if e[0] == EV_FRAME_DONE:
                pl = nd.planes(e[1])
                out.append({k: np.array(getattr(pl, k))
                            for k in PLANE_KEYS + ["sm4", "sm8"]})
        while (info := nd.get_frame()) is not None:
            nd.return_frame(info["slot"])
        pos = end
    nd.close()
    return out


def test_native_planes_match_jax_front_end():
    g = streams.avcgen()
    data = g.gen_random_high_cabac_stream(5, 4, n_frames=2, seed=3,
                                          density=0.2) + _uneven_ipb()
    want = _slot_planes(JNativeDecoder, data)
    got = _slot_planes(NativeDecoder, data)
    assert len(got) == len(want) > 0
    for i, (a, b) in enumerate(zip(want, got)):
        for k in a:
            assert a[k].dtype == b[k].dtype, (i, k)
            assert np.array_equal(a[k], b[k]), (i, k)

