"""The port's single-frame decoder, decode_annexb(..., device="cpu") ==
the JAX package's decode_annexb(..., backend="jax"): frames, frame ids,
error planes, crop and the MVC views, on one stream of each class the
JAX stream tests use; the streaming interface and the native binding's
logging, frame-task and slot calls."""

import errno

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from edge264_tpu.api import decode_annexb as jax_decode_annexb  # noqa: E402
from edge264_tpu_torch import streams  # noqa: E402
from edge264_tpu_torch.native import EV_FRAME_DONE, EV_FRAME_START, \
    EV_OUTPUT, EV_SLICE_DONE, NativeDecoder  # noqa: E402
from edge264_tpu_torch.api import Decoder, decode_annexb, \
    find_start_code  # noqa: E402
from edge264_tpu_torch.ops import backend as BK  # noqa: E402

VIEWS = ("y", "cb", "cr", "y_mvc", "cb_mvc", "cr_mvc")
KINDS = ("cavlc_intra", "cabac_ipb", "high_pcm", "mvc", "truncated")


def _stream(kind):
    g = streams.avcgen()
    if kind == "cavlc_intra":
        return g.gen_random_intra_stream(6, 4, n_frames=2, seed=1)
    if kind == "cabac_ipb":
        return g.gen_random_cabac_ipb_stream(
            6, 4, n_gops=1, seed=2, closed=True, gop_pb=1, density=0.1,
            intra_prob=0.1)
    if kind == "high_pcm":
        return g.gen_random_high_stream(
            6, 4, n_frames=2, seed=3, kinds=("i4", "i8", "i16", "pcm"))
    if kind == "mvc":
        return g.gen_random_mvc_stream(4, 3, n_aus=2, seed=1)
    assert kind == "truncated"
    return streams.truncate_slice(
        g.gen_random_intra_stream(6, 5, n_frames=2, seed=7, density=0.3), 1,
        frac=0.5)


def _assert_same_frames(want, got):
    assert len(got) == len(want) > 0
    for i, (a, b) in enumerate(zip(want, got)):
        assert (a.frame_id, a.frame_id_mvc, a.crop_offsets) == \
            (b.frame_id, b.frame_id_mvc, b.crop_offsets), i
        for n in VIEWS:
            x, y = getattr(a, n), getattr(b, n)
            assert (x is None) == (y is None), (i, n)
            if x is not None:
                assert isinstance(y, np.ndarray) and y.dtype == np.uint8
                assert np.array_equal(np.asarray(x), y), (i, n)
        assert (a.mb_errors is None) == (b.mb_errors is None), i
        if a.mb_errors is not None:
            assert np.array_equal(a.mb_errors, b.mb_errors), i


@pytest.mark.parametrize("kind", KINDS)
def test_decode_annexb_matches_jax(kind):
    data = _stream(kind)
    got = list(decode_annexb(data, device="cpu"))
    _assert_same_frames(list(jax_decode_annexb(data, backend="jax")), got)
    if kind == "mvc":
        assert all(f.y_mvc is not None for f in got)
    if kind == "truncated":
        assert any(f.mb_errors is not None for f in got)


@pytest.mark.parametrize("kind", KINDS)
def test_numpy_backend_matches_jax_numpy_and_torch(kind):
    """backend="numpy" (the port's copy of the scalar oracle) == the JAX
    package's backend="numpy": frames, ids, error planes, crop and MVC
    views.  On these five classes JAX's two backends agree, and so the
    port's oracle also equals its torch path on the CPU."""
    data = _stream(kind)
    got = list(decode_annexb(data, backend="numpy"))
    _assert_same_frames(list(jax_decode_annexb(data, backend="numpy")), got)
    _assert_same_frames(got, list(decode_annexb(data, device="cpu")))


def test_numpy_backend_ignores_device(monkeypatch):
    """The oracle runs on the host: with no card it needs no
    device="cpu", and Decoder streams its frames as numpy arrays."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    data = _stream("cabac_ipb")
    want = list(decode_annexb(data, backend="numpy", device="cpu"))
    with Decoder(backend="numpy") as dec:
        pos, got = 3, []
        while True:
            end = find_start_code(data, pos)
            res = dec.decode_nal(data[pos:end] if pos < len(data) else None)
            pos = end + 3
            while (f := dec.get_frame()) is not None:
                got.append(f)
            if res == errno.ENODATA:
                break
    _assert_same_frames(want, got)


def test_decoder_streaming_interface():
    """The Decoder's streaming calls on the CPU: ENODATA after the drain,
    borrowed frames returned, the unported backend ("jax") refused."""
    data = _stream("cabac_ipb")
    with Decoder(device="cpu") as dec:
        pos, res, frames = 3, 0, []
        while res != errno.ENODATA:
            end = find_start_code(data, pos)
            res = dec.decode_nal(data[pos:end] if pos < len(data) else None)
            pos = end + 3
            while (f := dec.get_frame(borrow=True)) is not None:
                frames.append(f)
                dec.return_frame(f)
    assert sorted(f.frame_id for f in frames) == [0, 1, 2]
    with pytest.raises(ValueError, match="not ported"):
        Decoder(backend="jax", device="cpu")


def test_backend_ring_grows_by_doubling(monkeypatch):
    """With a one-slot ring the reference frames of an IPB stream force
    the ring to double, and the frames stay exact."""
    data = _stream("cabac_ipb")
    want = list(decode_annexb(data, device="cpu"))
    monkeypatch.setattr(BK.TorchBackend, "RING_START", 1)
    sizes = []
    grow = BK.TorchBackend._ring_reserve

    def spy(self, *a):
        i = grow(self, *a)
        sizes.append(self.ringL.shape[1])
        return i
    monkeypatch.setattr(BK.TorchBackend, "_ring_reserve", spy)
    got = list(decode_annexb(data, device="cpu"))
    assert max(sizes) > 1
    for a, b in zip(want, got):
        assert np.array_equal(a.y, b.y) and np.array_equal(a.cb, b.cb)


def _drive(nd, data):
    """Feed every NAL; returns (events, logs, slot_info of each completed
    slot, output infos)."""
    events, logs, infos, outs = [], [], [], []
    pos = find_start_code(data, 0)
    while pos < len(data):
        end = find_start_code(data, pos + 3)
        _, evs = nd.decode_nal(data[pos + 3:end])
        evs += nd.poll()
        events += evs
        # the log's timing lines (decoding_start_us, ...) differ per run
        logs.append("\n".join(ln for ln in nd.get_log().splitlines()
                               if "_us:" not in ln))
        infos += [nd.slot_info(e[1]) for e in evs if e[0] == EV_FRAME_DONE]
        while (info := nd.get_frame()) is not None:
            outs.append(info)
            nd.return_frame(info["slot"])
        pos = end
    nd.flush()
    nd.close()
    return events, logs, infos, outs


def test_native_interface_matches_jax():
    """The port's binding == the JAX package's on one stream: events (all
    kinds), the per-macroblock YAML log, slot_info and output order."""
    import edge264_tpu.native as JN
    assert (EV_FRAME_START, EV_SLICE_DONE, EV_FRAME_DONE, EV_OUTPUT) == \
        (JN.EV_FRAME_START, JN.EV_SLICE_DONE, JN.EV_FRAME_DONE, JN.EV_OUTPUT)
    data = _stream("cabac_ipb")
    want = _drive(JN.NativeDecoder(log=True, log_mbs=True), data)
    got = _drive(NativeDecoder(log=True, log_mbs=True), data)
    assert got == want
    kinds = {e[0] for e in got[0]}
    assert {EV_FRAME_START, EV_SLICE_DONE, EV_FRAME_DONE}.issubset(kinds)
    assert "mb_type" in "".join(got[1])


def test_decode_annexb_frame_tasks_and_log():
    """Frame-task parsing (n_tasks, wait_frame) gives the frames of the
    synchronous decode; a log callback receives the YAML log."""
    data = _stream("cabac_ipb")
    want = list(decode_annexb(data, device="cpu"))
    got = list(decode_annexb(data, device="cpu", n_tasks=2))
    logs = []
    logged = list(decode_annexb(data, device="cpu", log_cb=logs.append))
    for frames in (got, logged):
        assert [f.frame_id for f in frames] == [f.frame_id for f in want]
        for a, b in zip(want, frames):
            assert np.array_equal(a.y, b.y) and np.array_equal(a.cr, b.cr)
    assert logs and "frame_num" in "".join(logs)
