"""Port deblocking == the JAX package's: deblock_bs against
jaxdec.deblock_bs, the plain deblock_scan against jaxdec.deblock_scan and
against the Pallas kernel (interpret mode), on the random inputs of
tests/test_pallas_deblock.py; blend_recovered against
jaxdec.blend_recovered on random planes.  The CUDA kernel against the
plain version: tests/test_torch_kernels_cuda.py."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import edge264_tpu.ops.jaxdec as J  # noqa: E402
import edge264_tpu.ops.pallas_deblock as PD  # noqa: E402
from edge264_tpu_torch.ops import deblock as D  # noqa: E402


def _rand_frame(rng, mbW, mbH):
    """tests/test_pallas_deblock.py::_rand_frame."""
    H, W = mbH * 16, mbW * 16
    y = rng.randint(0, 255, (H, W)).astype(np.int32)
    cb = rng.randint(0, 255, (H // 2, W // 2)).astype(np.int32)
    cr = rng.randint(0, 255, (H // 2, W // 2)).astype(np.int32)
    db = np.full((mbH, mbW), 7)
    db[:, 0] &= ~1
    db[0, :] &= ~2
    p = {
        "qp": rng.randint(10, 45, (mbH, mbW, 4)).astype(np.int32),
        "deblock_ab": rng.randint(-2, 3, (mbH, mbW, 2)).astype(np.int32),
        "deblock": db.astype(np.int32),
        "mb_flags": (rng.randint(0, 2, (mbH, mbW))
                     * (J.MBF_INTRA | J.MBF_T8x8)).astype(np.int32),
    }
    bs_v = rng.randint(0, 5, (mbH * 4, mbW * 4)).astype(np.int32)
    bs_h = rng.randint(0, 5, (mbH * 4, mbW * 4)).astype(np.int32)
    return y, cb, cr, p, bs_v, bs_h


def _batch(frames):
    st = lambda i: np.stack([f[i] for f in frames])  # noqa: E731
    p = {k: np.stack([f[3][k] for f in frames]) for k in frames[0][3]}
    return st(0), st(1), st(2), p, st(4), st(5)


def _t(a):
    return torch.as_tensor(np.asarray(a))


@pytest.mark.parametrize("K,seed", [(1, 7), (2, 21)])
def test_deblock_scan_matches_jax_and_pallas(K, seed):
    rng = np.random.RandomState(seed)
    mbW, mbH = 6, 4
    y, cb, cr, p, bs_v, bs_h = _batch([_rand_frame(rng, mbW, mbH)
                                       for _ in range(K)])
    got = D.deblock_scan(_t(y), _t(cb), _t(cr),
                         {k: _t(v) for k, v in p.items()}, _t(bs_v),
                         _t(bs_h), mbW, mbH)
    jp = {k: jnp.asarray(v) for k, v in p.items()}
    ref = jax.vmap(lambda a, b, c, pp, bv, bh: J.deblock_scan(
        a, b, c, pp, bv, bh, mbW, mbH))(
        jnp.asarray(y), jnp.asarray(cb), jnp.asarray(cr), jp,
        jnp.asarray(bs_v), jnp.asarray(bs_h))
    pal = PD.deblock_pallas_batch(jnp.asarray(y), jnp.asarray(cb),
                                  jnp.asarray(cr), jp, jnp.asarray(bs_v),
                                  jnp.asarray(bs_h), mbW, mbH,
                                  interpret=True)
    for name, a, b, c in zip(("y", "cb", "cr"), ref, pal, got):
        assert np.array_equal(np.asarray(a), c.numpy()), (name, "jax")
        assert np.array_equal(np.asarray(b), c.numpy()), (name, "pallas")


def test_deblock_batch_on_cpu_is_the_plain_scan():
    rng = np.random.RandomState(5)
    mbW, mbH = 3, 2
    y, cb, cr, p, bs_v, bs_h = _batch([_rand_frame(rng, mbW, mbH)])
    args = (_t(y), _t(cb), _t(cr), {k: _t(v) for k, v in p.items()},
            _t(bs_v), _t(bs_h), mbW, mbH)
    before = D.deblock_batch.launches
    got = D.deblock_batch(*args)
    want = D.deblock_scan(*args)
    assert D.deblock_batch.launches == before
    for a, b in zip(got, want):
        assert torch.equal(a, b)


def _bs_planes(rng, mbW, mbH):
    BH, BW = 4 * mbH, 4 * mbW
    kinds = rng.randint(0, 4, (mbH, mbW))
    flags = np.choose(kinds, [1 | 32, 64 | 32, 64 | 8 | 32, 64 | 16 | 32])
    rs = rng.randint(-1, 3, (BH, BW, 2))
    # mostly per-mb uniform motion with some split cells
    mv = rng.randint(-6, 7, (mbH, mbW, 2, 2))
    mvs = np.repeat(np.repeat(mv, 4, 0), 4, 1)
    split = rng.rand(BH, BW) < 0.3
    mvs = np.where(split[..., None, None],
                   rng.randint(-6, 7, (BH, BW, 2, 2)), mvs)
    return {"mb_flags": flags.astype(np.int32),
            "nz_y": rng.randint(0, 3, (BH, BW)).astype(np.int32),
            "refslot": rs.astype(np.int32), "mvs": mvs.astype(np.int32)}


@pytest.mark.parametrize("seed", [3, 4])
def test_deblock_bs_matches_jax(seed):
    rng = np.random.RandomState(seed)
    mbW, mbH, K = 5, 3, 2
    planes = [_bs_planes(rng, mbW, mbH) for _ in range(K)]
    p = {k: np.stack([pl[k] for pl in planes]) for k in planes[0]}
    want = jax.vmap(J.deblock_bs)({k: jnp.asarray(v) for k, v in p.items()})
    got = D.deblock_bs({k: _t(v) for k, v in p.items()})
    for a, b in zip(want, got):
        assert b.dtype == torch.int32
        assert np.array_equal(np.asarray(a), b.numpy())



@pytest.mark.parametrize("seed", [0, 1])
def test_blend_recovered_matches_jax(seed):
    """Random frames, blend flags on about half the mbs (some runs of
    neighbours, some slice boundaries) and error percentages past both
    ends of the 0..100 range."""
    rng = np.random.RandomState(seed)
    K, mbW, mbH = 2, 6, 4
    frames = [_rand_frame(rng, mbW, mbH) for _ in range(K)]
    planes = []
    for _ in range(K):
        planes.append({
            "mb_flags": (rng.randint(0, 2, (mbH, mbW)) * (256 | 1)
                         | 32).astype(np.int32),
            "slice_id": np.sort(rng.randint(0, 3, mbH * mbW))
            .reshape(mbH, mbW).astype(np.int32),
            "mb_errors": rng.randint(0, 130, (mbH, mbW)).astype(np.int32)})
    want = [J.blend_recovered(*[jnp.asarray(a) for a in f[:3]],
                              {k: jnp.asarray(v) for k, v in pl.items()})
            for f, pl in zip(frames, planes)]
    p = {k: torch.as_tensor(np.stack([pl[k] for pl in planes]))
         for k in planes[0]}
    got = D.blend_recovered(*[torch.as_tensor(np.stack([f[i] for f in frames]))
                              for i in range(3)], p)
    changed = False
    for i, g in enumerate(got):
        assert g.dtype == torch.int32
        for k in range(K):
            assert np.array_equal(np.asarray(want[k][i]), g[k].numpy())
            changed |= not np.array_equal(frames[k][i], g[k].numpy())
    assert changed
