"""convert.planes_to_torch: every plane of the one shared buffer starts on
a 16-byte boundary (the CUDA kernels fetch planes with 16-byte cp.async
copies), and holds exactly the numpy planes it was given."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from edge264_tpu_torch.convert import PLANE_KEYS, planes_to_torch  # noqa: E402


def _planes(rng, mbW, mbH):
    """Random int32 planes of the shapes the native front end gives."""
    shapes = {"mb_flags": (mbH, mbW), "qp": (mbH, mbW, 4),
              "i4_modes": (4 * mbH, 4 * mbW), "i16_modes": (mbH, mbW),
              "i8_modes": (2 * mbH, 2 * mbW), "ch_modes": (mbH, mbW),
              "deblock_ab": (mbH, mbW, 2), "deblock": (mbH, mbW),
              "pcm_y": (16 * mbH, 16 * mbW),
              "pcm_c": (2, 8 * mbH, 8 * mbW)}
    return {k: rng.randint(-99, 99, s).astype(np.int32)
            for k, s in shapes.items()}


# (K, mbW, mbH): K * mbW * mbH = 15, 30, 297 -- none a multiple of 4
@pytest.mark.parametrize("K,mbW,mbH", [(1, 5, 3), (2, 5, 3), (3, 11, 9)])
def test_planes_start_16_byte_aligned(K, mbW, mbH):
    rng = np.random.RandomState(K)
    planes = [_planes(rng, mbW, mbH) for _ in range(K)]
    extra = {"sm4": rng.randint(0, 99, (K, 6, 16))}
    p = planes_to_torch(planes, {"i8_modes", "pcm_y", "pcm_c"}, "cpu",
                        extra=extra)
    assert set(p) == {k for k in PLANE_KEYS if k in planes[0]} | {"sm4"}
    base = p["mb_flags"].data_ptr()
    for k, t in p.items():
        assert (t.data_ptr() - base) % 16 == 0, k
        assert t.is_contiguous() and t.dtype == torch.int32
        want = extra[k] if k in extra else np.stack([pl[k] for pl in planes])
        assert np.array_equal(t.numpy(), want), k
