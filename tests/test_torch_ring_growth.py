"""Lockstep ring growth: a lane whose live references outnumber the
starting ring slots grows the ring by doubling, byte-identical to the JAX
package's decode_gops_batched (as tests/test_batch_lanes.py checks it
against the serial decoder); and a ring of 33 slots, past the JAX
package's MC load words (it decodes on jaxdec.mc_frame there), stays on
the port's kernels' route."""

import numpy as np
import pytest

pytest.importorskip("torch")

from chip_smoke import RouteLog  # noqa: E402
from edge264_tpu.parallel.batch import \
    decode_gops_batched as jax_decode  # noqa: E402
from edge264_tpu_torch import streams  # noqa: E402
from edge264_tpu_torch.parallel import batch as TB  # noqa: E402


def test_ring_growth_matches_jax(monkeypatch):
    """12-frame IPP GOP with up to 10 references alive (> 8 slots)."""
    data = streams.avcgen().gen_random_ipp_stream(
        5, 4, n_frames=12, seed=3, nrefs=10, density=0.2, mv_range=8)
    grown = []
    real_grow = TB.B.grow_ref_rings

    def grow(*a):
        grown.append(a[2:])
        return real_grow(*a)

    monkeypatch.setattr(TB.B, "grow_ref_rings", grow)
    got = list(TB.decode_gops_batched(data, lanes=1, device="cpu"))
    want = list(jax_decode(data, lanes=1))
    assert grown == [(8, 16)]
    assert len(got) == len(want) == 12
    for a, b in zip(want, got):
        for n in ("y", "cb", "cr"):
            assert np.array_equal(np.asarray(getattr(a, n)), getattr(b, n))


def test_ring_of_33_slots_takes_mc_frame(monkeypatch):
    """A lockstep ring of 32 + 1 slots is past the JAX package's load
    words (its driver, ring size from E264T_RING_S, takes jaxdec.mc_frame
    past fits_pallas); the port's words reach it, so every inter step
    takes the kernels' route and mc_frame never runs, and the frames stay
    byte-identical to the JAX package's."""
    data = b"".join(streams.avcgen().gen_random_cabac_ipb_stream(
        6, 4, n_gops=1, seed=50 + s, closed=True, gop_pb=1, density=0.1,
        max_level=4, intra_prob=0.1) for s in (0, 1))
    monkeypatch.setattr(TB, "RING_SLOTS", 32)
    monkeypatch.setenv("E264T_RING_S", "32")
    with RouteLog() as rl:
        got = list(TB.decode_gops_batched(data, lanes=2, device="cpu"))
    want = list(jax_decode(data, lanes=2))
    assert rl.routes == ["kernels", "kernels"]
    assert len(got) == len(want) == 6
    for a, b in zip(want, got):
        for n in ("y", "cb", "cr"):
            assert np.array_equal(np.asarray(getattr(a, n)), getattr(b, n))
