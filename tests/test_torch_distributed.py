"""The port's multi-process GOP split == the JAX package's: the same GOP
shares, and processes whose frames, taken in rank order, are the serial
decode's, byte for byte."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from chip_smoke import run_multihost  # noqa: E402
from edge264_tpu.api import decode_annexb as jax_decode_annexb  # noqa: E402
from edge264_tpu.parallel.distributed import \
    my_gop_range as jax_my_gop_range  # noqa: E402
from edge264_tpu_torch import streams  # noqa: E402
from edge264_tpu_torch.api import decode_annexb  # noqa: E402
from edge264_tpu_torch.parallel import distributed as D  # noqa: E402
from edge264_tpu_torch.parallel.distributed import \
    decode_stream_multihost, local_cards, my_gop_range  # noqa: E402

WORKER_TIMEOUT = 120     # seconds a process may take before it is killed


def _stream():
    """4 closed CAVLC IPB GOPs at 5x3 mbs."""
    g = streams.avcgen()
    return b"".join(g.gen_random_ipb_stream(5, 3, n_gops=1, seed=s)
                    for s in range(4))


def _planes(frames):
    return [(np.asarray(f.y), np.asarray(f.cb), np.asarray(f.cr))
            for f in frames]


def _assert_same(want, got):
    assert len(got) == len(want) > 0
    for i, (a, b) in enumerate(zip(want, got)):
        for c, x, y in zip(("y", "cb", "cr"), a, b):
            assert np.array_equal(x, y), (i, c)


def test_my_gop_range_matches_jax():
    for n in range(21):
        for world in range(1, 6):
            shares = [my_gop_range(n, r, world) for r in range(world)]
            assert shares == [jax_my_gop_range(n, r, world)
                              for r in range(world)]
            # contiguous, in rank order, covering every GOP once
            assert shares[0][0] == 0 and shares[-1][1] == n
            assert all(a[1] == b[0] for a, b in zip(shares, shares[1:]))
            sizes = [hi - lo for lo, hi in shares]
            assert max(sizes) - min(sizes) <= 1


def test_single_process_decodes_the_whole_stream():
    """No process group: rank 0 of 1 decodes every GOP."""
    assert not torch.distributed.is_initialized()
    data = _stream()
    got = _planes(decode_stream_multihost(data, lanes=4, device="cpu"))
    _assert_same(_planes(decode_annexb(data, device="cpu")), got)


@pytest.mark.parametrize("lanes,mesh_size", [(4, 2), (3, None)])
def test_default_device_uses_the_local_cards(monkeypatch, lanes, mesh_size):
    """device=None: a mesh over the process's local devices when `lanes`
    divides by their count, else the first of them alone (two CPU devices
    stand in for two cards)."""
    calls = []
    run = D.decode_gops_batched

    def spy(share, **kw):
        calls.append(kw)
        return run(share, **kw)
    monkeypatch.setattr(D, "_local_devices", lambda: ["cpu", "cpu"])
    monkeypatch.setattr(D, "decode_gops_batched", spy)
    data = _stream()
    got = _planes(decode_stream_multihost(data, lanes=lanes))
    _assert_same(_planes(decode_annexb(data, device="cpu")), got)
    (kw,) = calls
    if mesh_size is None:
        assert kw == {"lanes": lanes, "device": "cpu"}
    else:
        assert kw["mesh"].size == mesh_size and "device" not in kw


def test_local_cards_never_share_a_card_they_need_not(monkeypatch):
    """Each of a machine's processes gets cards of its own while there are
    enough; with fewer cards than processes they share by remainder."""
    assert local_cards(0, 0, 1) == []
    assert local_cards(4) == [0, 1, 2, 3]
    assert [local_cards(4, r, 4) for r in range(4)] == [[0], [1], [2], [3]]
    assert [local_cards(8, r, 4) for r in range(4)] == [
        [0, 4], [1, 5], [2, 6], [3, 7]]
    assert [local_cards(1, r, 2) for r in range(2)] == [[0], [0]]
    assert [local_cards(2, r, 3) for r in range(3)] == [[0], [1], [0]]
    monkeypatch.setenv("LOCAL_RANK", "1")
    monkeypatch.setenv("LOCAL_WORLD_SIZE", "2")
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
    assert D._local_devices() == ["cuda:1", "cuda:3"]


def test_two_processes_on_gloo(tmp_path):
    """Two processes (gloo on 127.0.0.1, a free port), each decoding its
    two GOPs on the CPU; each is killed after WORKER_TIMEOUT s.  Their
    frames in rank order == the JAX package's numpy backend."""
    data = _stream()
    per_rank, counts = run_multihost(data, 2, 2, "cpu", str(tmp_path),
                                     WORKER_TIMEOUT)
    assert [len(f) for f in per_rank] == [6, 6]
    assert [c["mc_frame"] for c in counts] == [0, 0]
    _assert_same(_planes(jax_decode_annexb(data, backend="numpy")),
                 [f for frames in per_rank for f in frames])
