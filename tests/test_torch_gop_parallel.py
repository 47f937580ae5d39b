"""decode_annexb_parallel (whole decoders on worker threads, frames in
stream order) on the CPU == the port's serial decode_annexb == the JAX
package's serial decode_annexb(backend="jax"); also with backend="numpy",
and on a stream whose GOPs receive a PPS between their slices, where the
lockstep driver must match too."""

import random

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from edge264_tpu.api import decode_annexb as jax_decode_annexb  # noqa: E402
from edge264_tpu_torch import streams  # noqa: E402
from edge264_tpu_torch.api import decode_annexb  # noqa: E402
from edge264_tpu_torch.parallel.batch import \
    decode_gops_batched  # noqa: E402
from edge264_tpu_torch.parallel.gop import decode_annexb_parallel, \
    split_gops  # noqa: E402


@pytest.fixture(scope="module")
def three_gops():
    """Three closed CABAC GOPs of different lengths (IDR+P+B,
    IDR+2x(P+B), IDR+P+B), the JAX package's frames and the port's serial
    frames."""
    g = streams.avcgen()
    data = b"".join(g.gen_random_cabac_ipb_stream(
        6, 4, n_gops=1, seed=20 + i, closed=True, gop_pb=pb, density=0.1,
        max_level=4, intra_prob=0.1) for i, pb in enumerate((1, 2, 1)))
    assert len(split_gops(data)) == 3
    return (data, list(jax_decode_annexb(data, backend="jax")),
            list(decode_annexb(data, device="cpu")))


@pytest.mark.parametrize("n_workers", [1, 3])
def test_parallel_matches_serial_and_jax(three_gops, n_workers):
    data, jax_frames, serial = three_gops
    got = list(decode_annexb_parallel(data, n_workers=n_workers,
                                      device="cpu"))
    assert len(got) == len(serial) == len(jax_frames) == 11
    for i, (a, b, c) in enumerate(zip(jax_frames, serial, got)):
        for n in ("y", "cb", "cr"):
            assert np.array_equal(np.asarray(getattr(a, n)),
                                  getattr(c, n)), (i, n)
            assert np.array_equal(getattr(b, n), getattr(c, n)), (i, n)


def test_parallel_needs_a_card_unless_told_cpu(three_gops, monkeypatch):
    """Like decode_annexb, it raises at the call without a card."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        decode_annexb_parallel(three_gops[0])


def test_parallel_numpy_backend(three_gops, monkeypatch):
    """backend="numpy" through the worker threads: the oracle's frames,
    with no card and no device argument."""
    data, _, serial = three_gops
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    got = list(decode_annexb_parallel(data, n_workers=2, backend="numpy"))
    assert len(got) == len(serial)
    for a, b in zip(serial, got):
        for n in ("y", "cb", "cr"):
            assert isinstance(getattr(b, n), np.ndarray)
            assert np.array_equal(getattr(a, n), getattr(b, n))


def _mid_gop_pps_stream(mbW=6, mbH=4, seed=31):
    """Two closed CABAC GOPs, IDR + P + B + P, whose IDR uses PPS 0 and
    whose later slices use PPS 1, a PPS that arrives after the IDR: in
    the first GOP for the first time, in the second redefined (another
    init_qp and chroma_qp_off under the same id)."""
    g = streams.avcgen()
    rng = random.Random(seed)
    qp = 26
    out = g.make_sps(mbW, mbH, max_ref_frames=3, log2_max_poc_lsb=6) \
        + g.make_pps(cabac=True, nrefs=2, nrefs1=1)

    def specs(pick):
        probe = g.IntraEncoder(mbW, mbH, qp)
        sp = []
        for addr in range(mbW * mbH):
            spec = pick()
            if spec.kind in ("i4", "i16"):
                g.resolve_random_modes(rng, probe, addr % mbW, addr // mbW,
                                       spec)
            probe.parsed.add((addr % mbW, addr // mbW))
            sp.append(spec)
        return sp

    for gop, (init_qp, cqp) in enumerate(((30, 3), (22, -2))):
        out += g.make_cabac_slice(
            mbW, mbH, specs(lambda: g.random_intra_mb(
                rng, ("i4", "i16"), 4, 0.1)), 2, slice_qp=qp, idr=True,
            idr_pic_id=gop)
        out += g.make_pps(pps_id=1, cabac=True, nrefs=2, nrefs1=1,
                          init_qp=init_qp, chroma_qp_off=cqp)
        kw = dict(slice_qp=qp, init_qp=init_qp, pps_id=1, pps_nrefs=(2, 1))
        out += g.make_cabac_slice(
            mbW, mbH, specs(lambda: g.random_p_mb(rng, 1, 4, 0.1, 32, 0.1)),
            0, frame_num=1, poc_lsb=8, nrefs=(1, 1), **kw)
        out += g.make_cabac_slice(
            mbW, mbH, specs(lambda: g.random_b_mb(rng, (1, 1), 4, 0.1, 32,
                                                  0.1)),
            1, frame_num=2, poc_lsb=4, nrefs=(1, 1), nal_ref_idc=0, **kw)
        out += g.make_cabac_slice(
            mbW, mbH, specs(lambda: g.random_p_mb(rng, 2, 4, 0.1, 32, 0.1)),
            0, frame_num=2, poc_lsb=16, nrefs=(2, 1), **kw)
    return out


@pytest.fixture(scope="module")
def mid_gop_pps():
    """The mid-GOP PPS stream, the JAX package's serial frames and the
    port's serial frames."""
    data = _mid_gop_pps_stream()
    assert len(split_gops(data)) == 2
    want = list(jax_decode_annexb(data, backend="jax"))
    serial = list(decode_annexb(data, device="cpu"))
    assert len(want) == len(serial) == 8
    return data, want, serial


@pytest.mark.parametrize("path", ["parallel", "lockstep"])
def test_mid_gop_pps_parallel_paths(mid_gop_pps, path):
    """A PPS that arrives inside a GOP reaches that GOP's later slices on
    both parallel paths (split_gops puts it in the GOP at its place), so
    decode_annexb_parallel and the lockstep driver give the serial
    decoders' frames: the port's and the JAX package's."""
    data, want, serial = mid_gop_pps
    if path == "parallel":
        got = list(decode_annexb_parallel(data, n_workers=2, device="cpu"))
    else:
        got = list(decode_gops_batched(data, lanes=2, device="cpu"))
    assert len(got) == len(want)
    for i, (a, b, c) in enumerate(zip(want, serial, got)):
        for n in ("y", "cb", "cr"):
            assert np.array_equal(np.asarray(getattr(a, n)),
                                  getattr(b, n)), (i, n)
            assert np.array_equal(getattr(b, n), getattr(c, n)), (i, n)


def test_split_gops_places_mid_gop_parameter_sets(mid_gop_pps):
    """Each GOP holds the PPS that arrived inside it, after its IDR and
    before its next slice; the second GOP's prefix holds the first GOP's
    version, and no GOP ends in a parameter set."""
    data = mid_gop_pps[0]
    nals = [n for n in data.split(b"\x00\x00\x01") if n]
    pps1 = [n for n in nals if n[0] & 31 == 8][1:]
    assert len(pps1) == 2 and pps1[0] != pps1[1]
    for k, gop in enumerate(split_gops(data)):
        units = [n for n in gop.split(b"\x00\x00\x01") if n]
        kinds = [n[0] & 31 for n in units]
        idr = kinds.index(5)
        assert units[idr + 1] == pps1[k] and kinds[idr + 2] == 1
        assert units[:idr].count(pps1[0]) == k
        assert pps1[1] not in units[:idr]
        assert kinds[-1] in (1, 5)
