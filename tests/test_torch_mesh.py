"""The port's mesh paths on the CPU == the JAX package's over its 8
virtual CPU devices, byte for byte: the lockstep driver with its lanes
split over a mesh of CPU shards (uneven group, MVC, both sinks, ring
growth), each shard's uploaded rows, and the sharded frame batch."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from chip_smoke import decoded_planes  # noqa: E402
from edge264_tpu.parallel.batch import \
    decode_gops_batched as jax_decode  # noqa: E402
from edge264_tpu.parallel.mesh import \
    decode_batch_sharded as jax_batch_sharded  # noqa: E402
from edge264_tpu.parallel.mesh import \
    make_decode_mesh as jax_mesh  # noqa: E402
from edge264_tpu_torch import streams  # noqa: E402
from edge264_tpu_torch.convert import PLANE_KEYS  # noqa: E402
from edge264_tpu_torch.ops import arena as A  # noqa: E402
from edge264_tpu_torch.ops.batched import host_frame_digest  # noqa: E402
from edge264_tpu_torch.parallel import decode_batch_sharded, \
    make_decode_mesh  # noqa: E402
from edge264_tpu_torch.parallel.batch import \
    decode_gops_batched  # noqa: E402

VIEWS = ("y", "cb", "cr", "y_mvc", "cb_mvc", "cr_mvc")


def _stream(kind):
    g = streams.avcgen()
    if kind == "ipb5":           # 5 closed GOPs: 3 dead lanes of 8
        return g.gen_random_ipb_stream(5, 3, n_gops=5, seed=13, closed=True,
                                       gop_pb=1)
    if kind == "mvc3":           # 3 MVC GOPs: 5 dead lanes of 8
        return b"".join(g.gen_random_mvc_stream(4, 3, n_aus=2, seed=s)
                        for s in range(3))
    assert kind == "refs10"      # 10 references: every lane's ring grows
    return b"".join(g.gen_random_ipp_stream(5, 4, n_frames=10, seed=s,
                                            nrefs=10, density=0.2)
                    for s in (3, 4, 5, 6))


def _assert_same_frames(want, got):
    assert len(got) == len(want) > 0
    for i, (a, b) in enumerate(zip(want, got)):
        assert a.frame_id == b.frame_id, i
        for n in VIEWS:
            x, y = getattr(a, n), getattr(b, n)
            assert (x is None) == (y is None), (i, n)
            if x is not None:
                assert y.dtype == np.uint8
                assert np.array_equal(np.asarray(x), y), (i, n)


@pytest.fixture(scope="module", params=["ipb5", "mvc3"])
def jax_mesh_decode(request):
    """A stream and the JAX package's frames from its 8-device mesh."""
    assert len(jax.devices()) == 8
    data = _stream(request.param)
    return data, list(jax_decode(data, lanes=8, mesh=jax_mesh()))


def test_mesh_lockstep_matches_jax(jax_mesh_decode):
    data, want = jax_mesh_decode
    got = list(decode_gops_batched(data, lanes=8,
                                   mesh=make_decode_mesh(["cpu"] * 8)))
    _assert_same_frames(want, got)


def test_mesh_digest_sink_matches_single_device(jax_mesh_decode):
    data, want = jax_mesh_decode
    mesh = list(decode_gops_batched(data, lanes=8, sink="digest",
                                    mesh=make_decode_mesh(["cpu"] * 8)))
    one = list(decode_gops_batched(data, lanes=8, sink="digest",
                                   device="cpu"))
    assert len(mesh) == len(one) == len(want)
    for f, m, o in zip(want, mesh, one):
        assert m.frame_id == o.frame_id and m.digest == o.digest
        assert m.digest == host_frame_digest(np.asarray(f.y),
                                             np.asarray(f.cb),
                                             np.asarray(f.cr))
        assert m.digest_mvc == o.digest_mvc
        if f.y_mvc is not None:
            assert m.digest_mvc == host_frame_digest(
                np.asarray(f.y_mvc), np.asarray(f.cb_mvc),
                np.asarray(f.cr_mvc))


def test_mesh_of_two_with_ring_growth(monkeypatch):
    """lanes=4 over a mesh of 2 on 4 GOPs whose rings outgrow their 8
    slots: the single-device lockstep's frames (held to JAX by
    test_torch_lockstep.py), and at every step the two shards' uploaded
    rows are the single-device arena's rows, halved."""
    data = _stream("refs10")
    upload, rec = A.upload, []

    def recording(buf, device):
        rec.append((str(device), buf.clone()))
        return upload(buf, device)
    monkeypatch.setattr(A, "upload", recording)
    want = list(decode_gops_batched(data, lanes=4, device="cpu"))
    one_up, rec[:] = rec[:], []
    got = list(decode_gops_batched(data, lanes=4,
                                   mesh=make_decode_mesh(["cpu", "cpu"])))
    mesh_up = rec
    _assert_same_frames(want, got)
    assert len(want) == 40
    assert len(mesh_up) == 2 * len(one_up) == 20
    for s, (dev, buf) in enumerate(one_up):
        (d0, a), (d1, b) = mesh_up[2 * s:2 * s + 2]
        assert dev == d0 == d1 == "cpu"
        assert a.shape[0] == b.shape[0] == 2
        assert torch.equal(torch.cat([a, b]), buf), s


def test_decode_batch_sharded_matches_jax():
    """8 intra frames (two intra streams, one scaling matrix) split over
    8 CPU shards == the JAX package's decode_batch_sharded on its mesh."""
    g = streams.avcgen()
    frames = decoded_planes(
        g.gen_random_intra_stream(4, 3, n_frames=4, seed=8, density=0.3)
        + g.gen_random_intra_stream(4, 3, n_frames=4, seed=9, density=0.3))
    assert len(frames) == 8
    p = {}
    for k in PLANE_KEYS:
        p[k] = np.stack([np.asarray(getattr(f[0], k)) for f in frames])
    p["coef_c_dc"] = p["coef_c_dc"].reshape(8, 3, 4, 2, 4)
    sm4, sm8 = frames[0][1], frames[0][2]
    assert all(np.array_equal(f[1], sm4) and np.array_equal(f[2], sm8)
               for f in frames)
    want = jax_batch_sharded(p, sm4, sm8, 4, 3, jax_mesh())
    got = decode_batch_sharded(p, sm4, sm8, 4, 3,
                               make_decode_mesh(["cpu"] * 8))
    for w, parts in zip(want, got):
        assert len(parts) == 8 and all(t.shape[0] == 1 for t in parts)
        assert np.array_equal(np.asarray(w), torch.cat(parts).numpy())
    with pytest.raises(ValueError, match="split"):
        decode_batch_sharded(p, sm4, sm8, 4, 3, make_decode_mesh(["cpu"] * 3))


def test_mesh_argument_errors(monkeypatch):
    data = _stream("ipb5")
    mesh = make_decode_mesh(["cpu"] * 8)
    with pytest.raises(ValueError, match="multiple"):
        decode_gops_batched(data, lanes=4, mesh=mesh)
    with pytest.raises(ValueError, match="not both"):
        decode_gops_batched(data, lanes=8, mesh=mesh, device="cpu")
    with pytest.raises(ValueError, match="mixed"):
        make_decode_mesh(["cpu", "meta"])
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for devices in (None, ["cuda:0", "cuda:0"]):
        with pytest.raises(RuntimeError, match="CUDA"):
            make_decode_mesh(devices)
