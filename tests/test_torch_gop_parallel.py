"""decode_annexb_parallel (whole decoders on worker threads, frames in
stream order) on the CPU == the port's serial decode_annexb == the JAX
package's serial decode_annexb(backend="jax")."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from edge264_tpu.api import decode_annexb as jax_decode_annexb  # noqa: E402
from edge264_tpu_torch import streams  # noqa: E402
from edge264_tpu_torch.api import decode_annexb  # noqa: E402
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
