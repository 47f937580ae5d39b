"""Port sheared intra scan == jaxdec.intra_scan_sheared (exact), with the
Intra_8x8 and PCM paths on and off; the intra kernel wrapper's CPU route
== pallas_intra.intra_pallas_batch in interpret mode."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import edge264_tpu.ops.jaxdec as J  # noqa: E402
from __graft_entry__ import _example_planes  # noqa: E402
from edge264_tpu_torch.convert import planes_to_torch  # noqa: E402
from edge264_tpu_torch.ops.intra import intra_batch, \
    intra_scan_sheared  # noqa: E402


def _inputs(seed, mbW, mbH, K, t8):
    rng = np.random.RandomState(seed)
    planes, imgs = [], []
    for _ in range(K):
        pl = {k: np.asarray(v).astype(np.int32)
              for k, v in _example_planes(mbW, mbH).items()}
        # shuffle mb kinds per lane; some inter mbs keep their samples
        kinds = rng.randint(0, 5, (mbH, mbW))
        fl = np.choose(kinds, [1 | 32, 1 | 2 | 32, 1 | 4 | 32, 64 | 32,
                               1 | 8 | 32 if t8 else 1 | 32])
        pl["mb_flags"] = fl.astype(np.int32)
        # availability bits as random as the mode values
        pl["i4_modes"] = rng.randint(0, 256, (4 * mbH, 4 * mbW)) & 0x7F
        pl["i4_modes"] = np.where((pl["i4_modes"] & 15) > 8,
                                  pl["i4_modes"] & 0x77, pl["i4_modes"])
        pl["i8_modes"] = (rng.randint(0, 9, (2 * mbH, 2 * mbW))
                          | (rng.randint(0, 16, (2 * mbH, 2 * mbW)) << 4))
        pl["i16_modes"] = rng.randint(0, 4, (mbH, mbW)) \
            | (rng.randint(0, 4, (mbH, mbW)) << 4)
        pl["ch_modes"] = rng.randint(0, 4, (mbH, mbW)) \
            | (rng.randint(0, 4, (mbH, mbW)) << 4)
        planes.append(pl)
        H, W = 16 * mbH, 16 * mbW
        imgs.append([rng.randint(0, 256, (H, W)),
                     rng.randint(0, 256, (H // 2, W // 2)),
                     rng.randint(0, 256, (H // 2, W // 2)),
                     rng.randint(-40, 40, (H, W)),
                     rng.randint(-40, 40, (H // 2, W // 2)),
                     rng.randint(-40, 40, (H // 2, W // 2))])
    imgs = [np.stack([im[i] for im in imgs]).astype(np.int32)
            for i in range(6)]
    return planes, imgs


@pytest.mark.parametrize("has_t8,has_pcm", [(True, True), (False, False),
                                            (True, False), (False, True)])
def test_intra_scan_sheared_matches_jax(has_t8, has_pcm):
    mbW, mbH, K = 5, 3, 2
    planes, imgs = _inputs(int(has_t8) * 2 + int(has_pcm), mbW, mbH, K,
                           has_t8)
    if not has_pcm:
        for pl in planes:
            pl["mb_flags"] = np.where(pl["mb_flags"] & 4, 1 | 32,
                                      pl["mb_flags"]).astype(np.int32)
    p_np = {k: np.stack([pl[k] for pl in planes]) for k in planes[0]}
    want = jax.vmap(
        lambda yy, cc, rr, ry, rcb, rcr, pp: J.intra_scan_sheared(
            yy, cc, rr, ry, rcb, rcr, pp, mbW, mbH, has_t8, has_pcm)
    )(*[jnp.asarray(a) for a in imgs],
      {k: jnp.asarray(v) for k, v in p_np.items()})
    keep = ({"coef_y8", "i8_modes"} if has_t8 else set()) | \
        ({"pcm_y", "pcm_c"} if has_pcm else set())
    p = planes_to_torch(planes, keep, "cpu")
    got = intra_scan_sheared(*[torch.as_tensor(a) for a in imgs], p,
                             mbW, mbH, has_t8, has_pcm)
    for name, a, b in zip(("y", "cb", "cr"), want, got):
        assert b.dtype == torch.int32, name
        assert np.array_equal(np.asarray(a), b.numpy()), name


def test_intra_batch_matches_pallas_interpret():
    """The kernel wrapper's contract on the CPU (the plain scan) against the
    TPU kernel itself, run in interpret mode."""
    from edge264_tpu.ops.pallas_intra import intra_pallas_batch
    mbW, mbH, K = 5, 3, 2
    planes, imgs = _inputs(9, mbW, mbH, K, True)
    p_np = {k: np.stack([pl[k] for pl in planes]) for k in planes[0]}
    want = intra_pallas_batch(*[jnp.asarray(a) for a in imgs],
                              {k: jnp.asarray(v) for k, v in p_np.items()},
                              mbW, mbH, interpret=True)
    p = planes_to_torch(planes, {"coef_y8", "i8_modes", "pcm_y", "pcm_c"},
                        "cpu")
    n = intra_batch.launches
    got = intra_batch(*[torch.as_tensor(a) for a in imgs], p, mbW, mbH)
    assert intra_batch.launches == n          # no kernel on the CPU
    for name, a, b in zip(("y", "cb", "cr"), want, got):
        assert b.dtype == torch.int32, name
        assert np.array_equal(np.asarray(a), b.numpy()), name
