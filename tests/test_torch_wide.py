"""Frames wider than the JAX package's MC load words reach: a 256x2-mb
CABAC IPB stream (4096 samples across, the width of DCI 4K) through the
port's decode_annexb and lockstep driver on the CPU == the JAX package's
decode_annexb(backend="jax") and decode_gops_batched, which take
jaxdec.mc_frame there.  The port's wider words keep every inter step on
the kernels' route (pack_mc_params -> the kernels' plain versions on the
CPU -> combine_mc); mc.mc_frame never runs."""

import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from chip_smoke import RouteLog  # noqa: E402
from edge264_tpu.api import decode_annexb as jax_decode_annexb  # noqa: E402
from edge264_tpu.parallel.batch import \
    decode_gops_batched as jax_decode  # noqa: E402
from edge264_tpu_torch import streams  # noqa: E402
from edge264_tpu_torch.api import decode_annexb  # noqa: E402
from edge264_tpu_torch.parallel.batch import \
    decode_gops_batched  # noqa: E402

MBW, MBH = 256, 2


@functools.lru_cache(maxsize=None)
def _wide():
    """One closed GOP, IDR + P + B, at bench.py's density, max_level and
    intra_prob."""
    return streams.avcgen().gen_random_cabac_ipb_stream(
        MBW, MBH, n_gops=1, seed=44, closed=True, gop_pb=1, density=0.05,
        max_level=4, intra_prob=0.05)


@pytest.mark.parametrize("path", ["decode_annexb", "lockstep"])
def test_wide_stream_matches_jax(path):
    data = _wide()
    if path == "decode_annexb":
        want = list(jax_decode_annexb(data, backend="jax"))
        with RouteLog() as rl:
            got = list(decode_annexb(data, device="cpu"))
    else:
        want = list(jax_decode(data, lanes=1))
        with RouteLog() as rl:
            got = list(decode_gops_batched(data, lanes=1, device="cpu"))
    assert len(got) == len(want) == 3
    for i, (a, b) in enumerate(zip(want, got)):
        assert b.y.shape == (16 * MBH, 16 * MBW)
        for n in ("y", "cb", "cr"):
            assert np.array_equal(np.asarray(getattr(a, n)),
                                  getattr(b, n)), (i, n)
    assert rl.routes == ["kernels", "kernels"]
