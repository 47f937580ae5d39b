"""Port inter prediction == the JAX package's: make_ref_planes, the kernels'
parameter packing (pallas_mc.pack_mc_params: the same flags, and the same
fields in every load word, mapped from JAX's int32 words to the port's
int64 ones), the plain luma/chroma MC against the Pallas kernels
(interpret mode) and the weighted combine against
pallas_mc.mc_frame_batch and jaxdec.mc_frame -- on _mk-style inputs
(tests/test_pallas_mc.py): mvs overshooting every frame edge, unused
cells, uniform and split blocks.  The reference by plain gathers,
mc_frame, against jaxdec.mc_frame, and the load words at the largest
frames and rings, where the plain versions equal mc_frame.  The CUDA
kernels against the plain versions: tests/test_torch_kernels_cuda.py."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import edge264_tpu.ops.jaxdec as J  # noqa: E402
import edge264_tpu.ops.pallas_mc as PM  # noqa: E402
from __graft_entry__ import _example_planes  # noqa: E402
from edge264_tpu_torch.convert import planes_to_torch, \
    rings_from_numpy  # noqa: E402
from edge264_tpu_torch.ops import mc as M  # noqa: E402


def _mk(mbW, mbH, K, S, seed, frac_unused=0.1, frac_subq=0.3, mvmax=300,
        pair_prob=0.3):
    """Random planes + rings: per-8x8 uniform mvs with a subset of cells
    re-randomized, unused cells, mvs overshooting every edge, and (beyond
    tests/test_pallas_mc.py::_mk) 16x8 pairs so every kernel arm runs.
    Returns numpy planes (list of dicts), frames (ys, cbs, crs) and slot
    maps."""
    rng = np.random.RandomState(seed)
    BH, BW = 4 * mbH, 4 * mbW
    p1 = {k: np.asarray(v).astype(np.int32)
          for k, v in _example_planes(mbW, mbH).items()}
    planes = []
    for _ in range(K):
        mv8 = rng.randint(-mvmax, mvmax + 1, (BH // 2, BW // 2, 2, 2))
        rs8 = rng.randint(0, S, (BH // 2, BW // 2, 2))
        rs8 = np.where(rng.rand(BH // 2, BW // 2, 2) < frac_unused, -1, rs8)
        pair = rng.rand(BH // 2, BW // 4) < pair_prob
        pair = np.repeat(pair, 2, 1)
        mv8 = np.where(pair[..., None, None], np.repeat(mv8[:, ::2], 2, 1),
                       mv8)
        rs8 = np.where(pair[..., None], np.repeat(rs8[:, ::2], 2, 1), rs8)
        mvs = np.repeat(np.repeat(mv8, 2, 0), 2, 1)
        sub = rng.rand(BH // 2, BW // 2) < frac_subq
        subm = np.repeat(np.repeat(sub, 2, 0), 2, 1)
        mvs = np.where(subm[..., None, None],
                       rng.randint(-mvmax, mvmax + 1, (BH, BW, 2, 2)), mvs)
        pp = dict(p1)
        pp["refslot"] = np.repeat(np.repeat(rs8, 2, 0), 2, 1).astype(np.int32)
        pp["mvs"] = mvs.astype(np.int32)
        pp["mb_flags"] = np.where(rng.rand(mbH, mbW) < 0.8, 64 | 32,
                                  1 | 32).astype(np.int32)
        planes.append(pp)
    H, W = 16 * mbH, 16 * mbW
    ys = rng.randint(0, 256, (K, S + 1, H, W)).astype(np.uint8)
    cbs = rng.randint(0, 256, (K, S + 1, H // 2, W // 2)).astype(np.uint8)
    crs = rng.randint(0, 256, (K, S + 1, H // 2, W // 2)).astype(np.uint8)
    smap = np.zeros((K, 32), np.int32)
    smap[:, :S] = np.arange(S)
    return planes, (ys, cbs, crs), smap


def _jax_rings(frames):
    ys, cbs, crs = frames
    K, S1 = ys.shape[:2]
    flat = lambda a: jnp.asarray(a.reshape((-1,) + a.shape[2:]))  # noqa
    L, C = jax.vmap(J.make_ref_planes)(flat(ys), flat(cbs), flat(crs))
    return (L.reshape((K, S1) + L.shape[1:]),
            C.reshape((K, S1) + C.shape[1:]))


def _torch_rings(frames):
    ys, cbs, crs = frames
    K, S1 = ys.shape[:2]
    flat = lambda a: torch.as_tensor(a.reshape((-1,) + a.shape[2:]))  # noqa
    L, C = M.make_ref_planes(flat(ys), flat(cbs), flat(crs))
    return (L.reshape((K, S1) + L.shape[1:]),
            C.reshape((K, S1) + C.shape[1:]))


def _jp(planes):
    return {k: jnp.asarray(np.stack([pl[k] for pl in planes]))
            for k in planes[0]}


def _port_words(jw, luma):
    """The JAX package's int32 load word pairs (each word plane << 24 |
    y << 12 | x for one sample, negative: unused; luma A and B, chroma the
    position and the eighth-pel phase) as the port's (position word
    y << 15 | x, ring word ring index << 8 | sel; -1, -1 unused)."""
    w = np.asarray(jw).astype(np.int64).reshape(-1, 2)
    a, b = w[:, 0], w[:, 1]
    ya, xa = (a >> 12) & 0xFFF, a & 0xFFF
    if luma:
        ring = ((a >> 26) << 8) | (((a >> 24) & 3) << 6) \
            | (((b >> 24) & 3) << 4) | ((((b >> 12) & 0xFFF) - ya + 1) << 2) \
            | ((b & 0xFFF) - xa + 1)
    else:
        ring = ((a >> 24) << 8) | b
    out = np.where((a >= 0)[:, None], np.stack([(ya << 15) | xa, ring], -1),
                   -1)
    return out.reshape(np.shape(jw))


@pytest.mark.parametrize("geom", [(10, 3), (4, 4)])
def test_make_ref_planes_matches_jax(geom):
    mbW, mbH = geom
    _, frames, _ = _mk(mbW, mbH, 2, 1, seed=mbW)
    for a, b in zip(_jax_rings(frames), _torch_rings(frames)):
        assert b.dtype == torch.uint8
        assert np.array_equal(np.asarray(a), b.numpy())


@pytest.mark.parametrize("has_b", [True, False])
@pytest.mark.parametrize("geom", [(10, 3, 300), (4, 4, 300), (6, 2, 2000)])
def test_pack_and_plain_mc_match_pallas(has_b, geom):
    """geom: (mbW, mbH, mvmax).  At mvmax=2000 quarter-pels nearly every
    load word sits at its arm's clamp: the plain versions, the card
    kernels' yardstick, agree with the Pallas kernels there too."""
    mbW, mbH, mvmax = geom
    K, S = 2, 3
    planes, frames, smap = _mk(mbW, mbH, K, S, seed=mbW * 10 + has_b,
                               mvmax=mvmax)
    jp = _jp(planes)
    jpk = PM.pack_mc_params(jp, jnp.asarray(smap), has_b, mbW, mbH)
    p = planes_to_torch(planes, {"wp", "wp8"}, "cpu")
    pk = M.pack_mc_params(p, torch.as_tensor(smap), has_b, mbW, mbH)
    for b in pk:
        assert b.dtype == torch.int32
    assert np.array_equal(np.asarray(jpk[0]), pk[0].numpy())
    for name, a, b in zip(("pk_luma", "pk_chroma"), jpk[1:], pk[1:]):
        assert b.shape == a.shape, name
        assert np.array_equal(_port_words(a, name == "pk_luma"),
                              b.numpy()), name
    flags = pk[0].numpy()
    for bit in (M._F_UNIFORM, M._F_PAIR, M._F_PAIRODD):
        assert (flags & bit).any(), bit            # every arm is exercised
    assert ((flags & 3) & ~(flags >> 2)).any()    # and the quad arm

    jL, jC = _jax_rings(frames)
    want = PM.run_mc_kernels(*jpk, jL, jC, has_b, mbW, mbH, interpret=True)
    tL, tC = rings_from_numpy(jL, jC, "cpu")        # the same ring state
    got = M.run_mc_kernels(*pk, tL, tC, has_b, mbW, mbH)
    assert len(want) == len(got)
    for i, (a, b) in enumerate(zip(want, got)):
        assert np.array_equal(np.asarray(a), b.numpy()), i

    # what pallas_mc.mc_frame_batch returns: its combine on its kernels
    ref = PM.combine_mc(jp, jnp.asarray(smap), want, has_b)
    comb = M.combine_mc(p, torch.as_tensor(smap), got, has_b)
    for n, a, b in zip(("pred_y", "pred_cb", "pred_cr", "mask_y", "mask_c"),
                       ref, comb):
        assert np.array_equal(np.asarray(a), b.numpy()), n


def test_weighted_combine_matches_jax():
    """Explicit (mode 1) and implicit-style (mode 2) weighted prediction
    through _mc_combine against jaxdec._mc_combine."""
    rng = np.random.RandomState(8)
    mbW, mbH, K = 3, 2, 2
    planes, frames, smap = _mk(mbW, mbH, K, 2, seed=3)
    for pl in planes:
        wp = np.zeros((mbH, mbW, 24), np.int32)
        wp[..., 0] = rng.randint(0, 3, (mbH, mbW))
        wp[..., 1] = rng.randint(0, 8, (mbH, mbW))
        wp[..., 2] = rng.randint(0, 8, (mbH, mbW))
        pl["wp"] = wp
        pl["wp8"] = rng.randint(-64, 128, (2 * mbH, 2 * mbW, 2, 3, 2)) \
            .astype(np.int32)
    jp = _jp(planes)
    jL, jC = _jax_rings(frames)
    ref = jax.vmap(lambda pp, rl, rc, sm: J.mc_frame(pp, rl, rc, sm, True))(
        jp, jL, jC, jnp.asarray(smap))
    p = planes_to_torch(planes, {"wp", "wp8"}, "cpu")
    tL, tC = _torch_rings(frames)
    sm = torch.as_tensor(smap)
    got = M.combine_mc(p, sm, M.run_mc_kernels(
        *M.pack_mc_params(p, sm, True, mbW, mbH), tL, tC, True, mbW, mbH),
        True)
    for a, b in zip(ref, got):
        assert np.array_equal(np.asarray(a), b.numpy())



@pytest.mark.parametrize("has_b", [True, False])
@pytest.mark.parametrize("geom", [(10, 3, 300), (6, 2, 2000), (256, 1, 300)])
def test_mc_frame_matches_jax(has_b, geom):
    """The reference by plain gathers, mc_frame, against jaxdec.mc_frame
    (vmapped over the lanes) with one and two lists, and the kernels'
    route (mc_predict) against it; 256 mbs across is past JAX's int32
    load words, where the JAX package takes jaxdec.mc_frame."""
    mbW, mbH, mvmax = geom
    K, S = 2, 3
    planes, frames, smap = _mk(mbW, mbH, K, S, seed=mbW + has_b,
                               mvmax=mvmax)
    jL, jC = _jax_rings(frames)
    ref = jax.vmap(lambda pp, rl, rc, sm: J.mc_frame(pp, rl, rc, sm, has_b))(
        _jp(planes), jL, jC, jnp.asarray(smap))
    p = planes_to_torch(planes, {"wp", "wp8"}, "cpu")
    tL, tC = rings_from_numpy(jL, jC, "cpu")
    got = M.mc_frame(p, tL, tC, torch.as_tensor(smap), has_b)
    for n, a, b in zip(("pred_y", "pred_cb", "pred_cr", "mask_y", "mask_c"),
                       ref, got):
        assert np.array_equal(np.asarray(a), b.numpy()), n
    kern = M.mc_predict(p, torch.as_tensor(smap), tL, tC, has_b, mbW, mbH)
    for a, b in zip(got, kern):
        assert torch.equal(a, b)


# (mbW, mbH, S1): the edges of JAX's int32 words and past them
WORD_CASES = [
    (253, 2, 9),            # the widest frame JAX's words reach
    (254, 2, 9),            # one mb wider: past its 12-bit x
    (2, 253, 9),            # the tallest
    (2, 254, 9),            # one mb taller: past its 12-bit y
    (4, 4, 31),             # 31 slots: luma planes up to 123
    (4, 4, 32),             # 32 slots: past JAX's gate (S1*4 < 128)
    (4, 4, 65),             # a ring doubled to 64 slots + the write-off
    (253, 253, 31),         # all three edges at once
    (256, 135, 9),          # DCI 4K
    (1023, 2, 9),           # the front end's widest row
    (2, 1056, 9)]           # and its tallest column


@pytest.mark.parametrize("mbW, mbH, S1", WORD_CASES)
def test_mc_words_hold_the_largest_clamps(mbW, mbH, S1):
    """The largest fields pack_mc_params can build for the geometry (list
    0 at the far clamps, on ring index S1 - 1) stand in the words
    unchanged; where the ring fits the CPU, the kernels' route on the
    plain versions (mc_predict) equals mc_frame, on that input and on
    random vectors over every ring index."""
    # every cell on DPB slot 0; list 0's mvs at the far clamps with the
    # +1 phase offsets (quarter-pel phase 3, 3), list 1's at the near
    K, BH, BW = 1, 4 * mbH, 4 * mbW
    p = {"refslot": torch.zeros((K, BH, BW, 2), dtype=torch.int32),
         "mvs": torch.full((K, BH, BW, 2, 2), (1 << 14) + 3,
                           dtype=torch.int32)}
    p["mvs"][..., 1, :] = -(1 << 14)
    smap = torch.full((K, 32), S1 - 1, dtype=torch.int32)
    _, pkl, pkc = M.pack_mc_params(p, smap, True, mbW, mbH)
    ph, pw_b, phc, pwc_pad = M.mc_band_dims(mbW, mbH)
    for pk, luma, xmax, ymax in ((pkl, True, pw_b - 5, ph - 5),
                                 (pkc, False, 2 * pwc_pad - 8, phc - 4)):
        w = pk.reshape(-1, 2).long()
        w = w[w[:, 0] >= 0]
        loads = M.load_fields(w[:, 0], w[:, 1], luma)
        for plane, wy, wx in loads:
            assert int(plane.max()) // (4 if luma else 1) == S1 - 1
            assert int(wy.max()) <= ymax and int(wx.max()) <= xmax
        assert max(int(wy.max()) for _, wy, _ in loads) == ymax < 1 << 15
        assert max(int(wx.max()) for _, _, wx in loads) == xmax < 1 << 15
    if mbW * mbH > 4096:
        return
    rng = np.random.RandomState(mbW + mbH + S1)
    H, W = 16 * mbH, 16 * mbW
    # rings as the decoders make them (edge-replicated padding, which the
    # arms' different clamps rely on), from random frames
    tL, tC = _torch_rings(tuple(
        rng.randint(0, 256, (K, S1, h, w), dtype=np.uint8)
        for h, w in ((H, W), (H // 2, W // 2), (H // 2, W // 2))))
    planes, _, _ = _mk(mbW, mbH, K, 32, seed=S1, mvmax=600)
    ring = torch.as_tensor(rng.permutation(max(S1, 32))[:32] % S1,
                           dtype=torch.int32)
    ring[0] = S1 - 1
    smaps = torch.stack([smap[0], ring])[:, None]
    cases = [(dict(p, wp=torch.zeros((K, mbH, mbW, 24), dtype=torch.int32),
                   wp8=torch.zeros((K, 2 * mbH, 2 * mbW, 2, 3, 2),
                                   dtype=torch.int32),
                   mb_flags=torch.full((K, mbH, mbW), 64 | 32,
                                       dtype=torch.int32)), smaps[0]),
             (planes_to_torch(planes, {"wp", "wp8"}, "cpu"), smaps[1])]
    for q, sm in cases:
        want = M.mc_frame(q, tL, tC, sm, True)
        got = M.mc_predict(q, sm, tL, tC, True, mbW, mbH)
        for a, b in zip(want, got):
            assert torch.equal(a, b)
