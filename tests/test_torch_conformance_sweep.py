"""The randomized all-axes sweep of tests/test_conformance_cases.py
(test_randomized_sweep: tools/conformance_sweep.build_stream, seeds
1000-1007, one random generator across them) held to the JAX package
instead of the reference binary: each stream through the port's
decode_annexb (device="cpu") and its lockstep driver (lanes=2), against
the JAX package's backend="numpy", both MVC views included.  The
lockstep decodes each closed GOP with a fresh decoder, so it is held to
the oracle GOP by GOP (jax_golden.numpy_frames_by_gop)."""

import functools
import random

import pytest

torch = pytest.importorskip("torch")

from edge264_tpu_torch import streams  # noqa: E402
from edge264_tpu_torch.api import decode_annexb  # noqa: E402
from edge264_tpu_torch.parallel.batch import \
    decode_gops_batched  # noqa: E402
from jax_golden import assert_same_frames, numpy_frames, \
    numpy_frames_by_gop, torch_threads  # noqa: E402

FIRST_SEED, N_SEEDS = 1000, 8      # test_randomized_sweep's run(n=8)


@functools.cache
def _sweep_streams():
    """The sweep's streams in seed order: its generator is shared across
    seeds, so every stream is built in one pass, as the sweep does."""
    with streams.scoped_tools():
        from tools.conformance_sweep import build_stream
        rng = random.Random(FIRST_SEED)
        return tuple(build_stream(s, rng)
                     for s in range(FIRST_SEED, FIRST_SEED + N_SEEDS))


@pytest.mark.parametrize("seed", range(FIRST_SEED, FIRST_SEED + N_SEEDS))
def test_sweep_seed_on_both_port_paths(seed):
    data = _sweep_streams()[seed - FIRST_SEED]
    want = numpy_frames(data)
    with torch_threads(1):
        assert_same_frames(want, list(decode_annexb(data, device="cpu")),
                           f"seed {seed}: decode_annexb")
        assert_same_frames(
            numpy_frames_by_gop(data, want),
            list(decode_gops_batched(data, lanes=2, device="cpu")),
            f"seed {seed}: lockstep")
