"""The port's whole-frame functions (ops/frame.py) == the JAX package's
decode_frame_jit, decode_frame_inter_jit, decode_frame_arena and
decode_frame_inter_arena on the CPU, frame by frame over real streams;
and decode_batch_step, which runs the same routine, == the JAX package's
decode_batch_step."""

import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

import edge264_tpu.ops.batched as JB  # noqa: E402
import edge264_tpu.ops.jaxdec as J  # noqa: E402
from chip_smoke import RouteLog, decoded_planes  # noqa: E402
from edge264_tpu_torch import streams  # noqa: E402
from edge264_tpu_torch.convert import CONDITIONAL, \
    planes_to_torch  # noqa: E402
from edge264_tpu_torch.ops import arena as A  # noqa: E402
from edge264_tpu_torch.ops import batched as B  # noqa: E402
from edge264_tpu_torch.ops import frame as F  # noqa: E402
from edge264_tpu_torch.ops import mc as M  # noqa: E402

S = 4                    # reference ring slots of the whole-frame cases


@functools.lru_cache(maxsize=None)
def _stream(kind):
    g = streams.avcgen()
    if kind == "cabac_ipb":
        return g.gen_random_cabac_ipb_stream(
            6, 4, n_gops=1, seed=12, closed=True, gop_pb=2, density=0.1,
            max_level=4, intra_prob=0.1)
    if kind == "high_ipp":       # 8x8 transforms in P frames
        return g.gen_random_high_ipp_stream(5, 4, n_frames=3, seed=6,
                                            density=0.1)
    if kind == "high_pcm":
        return g.gen_random_high_stream(
            6, 4, n_frames=2, seed=3, kinds=("i4", "i8", "i16", "pcm"))
    assert kind == "truncated"   # concealment: mb_errors, blended mbs
    return streams.truncate_slice(
        g.gen_random_intra_stream(6, 5, n_frames=2, seed=7, density=0.3), 1,
        frac=0.5)


def _assert_same(want, got, what):
    for c, a, b in zip(("y", "cb", "cr"), want, got):
        assert b.dtype == torch.uint8 and b.shape[0] == 1, (what, c)
        assert np.array_equal(np.asarray(a), b[0].numpy()), (what, c)


@pytest.mark.parametrize("kind", ["cabac_ipb", "high_ipp", "high_pcm",
                                  "truncated"])
def test_whole_frame_functions_match_jax(kind):
    """Each frame through decode_frame (no reference yet) or
    decode_frame_inter (a ring of the earlier reference frames), both as
    planes and as arenas, against the JAX functions; the ring is filled
    from the JAX frames."""
    frames = decoded_planes(_stream(kind))
    assert len(frames) >= 2
    pl0 = frames[0][0]
    mbW, mbH = pl0.mb_w, pl0.mb_h
    ph, pw_b, phc, pwc_pad = M.mc_band_dims(mbW, mbH)
    ringL = np.zeros((S, 4, ph, pw_b), np.uint8)
    ringC = np.zeros((S, phc, 2 * pwc_pad), np.uint8)
    slot_ring, smap = {}, np.zeros(32, np.int32)
    n_inter = 0
    for i, (pl, sm4, sm8, slot, is_ref) in enumerate(frames):
        tarena, tlayout = A.pack_planes(pl, keep=CONDITIONAL)
        jarena, jlayout = J.pack_planes(pl, keep=CONDITIONAL)
        tp = planes_to_torch([pl], CONDITIONAL, "cpu")
        jp = J.planes_to_jax(pl)
        assert tlayout == jlayout, i
        assert np.array_equal(tarena, np.asarray(jarena)), i
        jsm4, jsm8 = jnp.asarray(sm4), jnp.asarray(sm8)
        tsm4, tsm8 = torch.as_tensor(sm4)[None], torch.as_tensor(sm8)[None]
        ta = torch.from_numpy(tarena)[None]
        if slot_ring:
            n_inter += 1
            jr = (jnp.asarray(ringL), jnp.asarray(ringC), jnp.asarray(smap))
            tr = (torch.from_numpy(ringL.copy())[None],
                  torch.from_numpy(ringC.copy())[None],
                  torch.as_tensor(smap)[None])
            want = J.decode_frame_inter_jit(jp, jsm4, jsm8, *jr, mbW, mbH)
            got = F.decode_frame_inter(tp, tsm4, tsm8, *tr, mbW, mbH)
            wa = J.decode_frame_inter_arena(jarena, jsm4, jsm8, *jr,
                                            layout=jlayout, mbW=mbW, mbH=mbH)
            ga = F.decode_frame_inter_arena(ta, tsm4, tsm8, *tr,
                                            layout=tlayout, mbW=mbW, mbH=mbH)
        else:
            want = J.decode_frame_jit(jp, jsm4, jsm8, mbW, mbH)
            got = F.decode_frame(tp, tsm4, tsm8, mbW, mbH)
            wa = J.decode_frame_arena(jarena, jsm4, jsm8, layout=jlayout,
                                      mbW=mbW, mbH=mbH)
            ga = F.decode_frame_arena(ta, tsm4, tsm8, layout=tlayout,
                                      mbW=mbW, mbH=mbH)
        _assert_same(want, got, (i, "planes"))
        _assert_same(wa, ga, (i, "arena"))
        if is_ref:
            r = slot_ring.setdefault(slot, len(slot_ring) % S)
            smap[slot] = r
            l4, ch = J.make_ref_planes(*wa)
            ringL[r], ringC[r] = np.asarray(l4), np.asarray(ch)
    assert n_inter == len(frames) - 1      # every frame after the IDR
    if kind == "truncated":                  # the arena forms blended
        assert any(np.asarray(f[0].mb_errors).any() for f in frames)


def test_frame_route_past_the_words():
    """decode_frame_inter takes the kernels' route below and past the
    JAX package's load words (a ring of 31, 32 and 65 slots), never
    mc_frame; every frame equals the JAX function's (which takes
    jaxdec.mc_frame at every ring size)."""
    frames = decoded_planes(_stream("cabac_ipb"))
    (pl0, sm4, sm8, slot0, _), (pl1, sm4b, sm8b, _, _) = frames[:2]
    jp0, jp = J.planes_to_jax(pl0), J.planes_to_jax(pl1)
    tp = planes_to_torch([pl1], CONDITIONAL, "cpu")
    mbW, mbH = pl0.mb_w, pl0.mb_h
    y, cb, cr = J.decode_frame_jit(jp0, jnp.asarray(sm4), jnp.asarray(sm8),
                                   mbW, mbH)
    l4, ch = (np.asarray(a) for a in J.make_ref_planes(y, cb, cr))
    smap = np.zeros(32, np.int32)
    for S1 in (31, 32, 65):
        # the reference in the ring's last slot: the largest plane field
        smap[slot0] = S1 - 1
        ringL = np.zeros((S1,) + l4.shape, np.uint8)
        ringC = np.zeros((S1,) + ch.shape, np.uint8)
        ringL[S1 - 1], ringC[S1 - 1] = l4, ch
        want = J.decode_frame_inter_jit(
            jp, jnp.asarray(sm4b), jnp.asarray(sm8b), jnp.asarray(ringL),
            jnp.asarray(ringC), jnp.asarray(smap), mbW, mbH)
        with RouteLog() as rl:
            got = F.decode_frame_inter(
                tp, torch.as_tensor(sm4b)[None], torch.as_tensor(sm8b)[None],
                torch.from_numpy(ringL)[None], torch.from_numpy(ringC)[None],
                torch.as_tensor(smap)[None], mbW, mbH)
        assert rl.routes == ["kernels"]
        _assert_same(want, got, S1)


def _step_args(frames, lanes_frames, S1):
    """One lockstep step's arena [K, L] for the given frames (one per
    lane), with every lane's slot map pointing DPB slots at ring index 0
    and the destination ring slot S1 - 1."""
    pls = [frames[i][0] for i in lanes_frames]
    K = len(pls)
    smap = np.zeros((K, 32), np.int32)
    meta = B.pack_meta([frames[i][1] for i in lanes_frames],
                       [frames[i][2] for i in lanes_frames], smap,
                       [S1 - 1] * K)
    buf, layout, meta_off = A.pack_planes_batch(
        pls, pls[0], keep=CONDITIONAL, coef8=False, extra=meta,
        gat_state=None, device=torch.device("cpu"))
    return buf, layout, meta_off


@pytest.mark.parametrize("emit, lanes", [("flat", (1, 2)),
                                         ("digest", (1, 2)),
                                         ("flat", (2,))])
def test_step_matches_jax(emit, lanes):
    """A P/B step (through the whole-frame routine, frame._frame) on rings
    holding the lanes' IDR frame: the frames, aux and updated rings
    against the JAX step."""
    data = _stream("cabac_ipb")
    frames = decoded_planes(data)
    pl = frames[0][0]
    mbW, mbH = pl.mb_w, pl.mb_h
    S1 = 3
    # every lane's ring index 0 holds the IDR (frame 0)
    jp0, sm4, sm8 = J.planes_to_jax(pl), frames[0][1], frames[0][2]
    y, cb, cr = J.decode_frame_jit(jp0, jnp.asarray(sm4), jnp.asarray(sm8),
                                   mbW, mbH)
    l4, ch = (np.asarray(a) for a in J.make_ref_planes(y, cb, cr))
    K = len(lanes)
    refL = np.zeros((K, S1) + l4.shape, np.uint8)
    refC = np.zeros((K, S1) + ch.shape, np.uint8)
    refL[:, 0], refC[:, 0] = l4, ch
    refL[:, 1] = 7                 # a slot no map names, to see it kept
    buf, layout, meta_off = _step_args(frames, list(lanes), S1)
    kw = dict(layout=layout, meta_off=meta_off, mbW=mbW, mbH=mbH,
              intra_mode="sheared", mc=True, emit=emit)
    want = JB.decode_batch_step(jnp.asarray(buf.numpy()),
                                (jnp.asarray(refL), jnp.asarray(refC)), None,
                                has_b=True, **kw)
    tL, tC = torch.from_numpy(refL.copy()), torch.from_numpy(refC.copy())
    got = B.decode_batch_step(buf, (tL, tC), **kw)
    for i, (a, b) in enumerate(zip(want, got)):
        assert np.array_equal(np.asarray(a).astype(np.int64),
                              b.numpy().astype(np.int64)), i
    assert not np.array_equal(got[4].numpy(), refL)    # the step wrote
