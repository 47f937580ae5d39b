"""Port sparse-intra level rounds == jaxdec.intra_rounds and port depth plane
== jaxdec.intra_round_plane (exact), on random sparse planes and on the
planes of real streams."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import edge264_tpu.ops.jaxdec as J  # noqa: E402
from edge264_tpu_torch import streams  # noqa: E402
from edge264_tpu_torch.api import find_start_code  # noqa: E402
from edge264_tpu_torch.convert import planes_to_torch  # noqa: E402
from edge264_tpu_torch.native import EV_FRAME_DONE, NativeDecoder  # noqa
from edge264_tpu_torch.ops.intra import intra_round_plane, \
    intra_rounds  # noqa: E402
from test_torch_intra import _inputs  # noqa: E402


def _sparse(seed, mbW, mbH, K, has_t8, has_pcm):
    """_inputs' random planes and frames with ~25% of the mbs intra (the
    rest inter), redrawn until every lane has a depth plane."""
    rng = np.random.RandomState(seed)
    planes, imgs = _inputs(seed, mbW, mbH, K, has_t8)
    for pl in planes:
        while True:
            fl = np.where(rng.rand(mbH, mbW) < 0.25, pl["mb_flags"],
                          64 | 32).astype(np.int32)
            if not has_pcm:
                fl = np.where(fl & 4, 1 | 32, fl).astype(np.int32)
            if (fl & 1).any() and intra_round_plane(fl, mbW, mbH):
                break
        pl["mb_flags"] = fl
    return planes, imgs


@pytest.mark.parametrize("has_t8,has_pcm,explicit", [
    (True, True, True), (True, True, False), (False, False, False)])
def test_intra_rounds_matches_jax(has_t8, has_pcm, explicit):
    mbW, mbH, K = 7, 5, 2
    planes, imgs = _sparse(11 + has_t8 + 2 * explicit, mbW, mbH, K, has_t8,
                           has_pcm)
    tabs = [intra_round_plane(pl["mb_flags"], mbW, mbH) for pl in planes]
    R = max(t[1] for t in tabs)
    lvl = np.stack([t[0] for t in tabs]) if explicit else None
    p_np = {k: np.stack([pl[k] for pl in planes]) for k in planes[0]}
    want = jax.vmap(
        lambda yy, cc, rr, ry, rcb, rcr, pp, lv: J.intra_rounds(
            yy, cc, rr, ry, rcb, rcr, pp, lv, mbW, mbH, R, has_t8, has_pcm),
        in_axes=(0,) * 7 + (0 if explicit else None,)
    )(*[jnp.asarray(a) for a in imgs],
      {k: jnp.asarray(v) for k, v in p_np.items()},
      None if lvl is None else jnp.asarray(lvl))
    keep = ({"coef_y8", "i8_modes"} if has_t8 else set()) | \
        ({"pcm_y", "pcm_c"} if has_pcm else set())
    p = planes_to_torch(planes, keep, "cpu")
    n = intra_rounds.launches
    got = intra_rounds(*[torch.as_tensor(a) for a in imgs], p,
                       None if lvl is None else torch.as_tensor(lvl),
                       mbW, mbH, R, has_t8, has_pcm)
    assert intra_rounds.launches == n + 1
    for name, a, b in zip(("y", "cb", "cr"), want, got):
        assert b.dtype == torch.int32, name
        assert np.array_equal(np.asarray(a), b.numpy()), name


def _stream_flags():
    """mb_flags of every frame of a CABAC IPB stream (sparse intra in P/B)
    and of a High intra stream (dense)."""
    g = streams.avcgen()
    data = g.gen_random_cabac_ipb_stream(
        8, 6, n_gops=1, seed=5, closed=True, gop_pb=2, density=0.1,
        intra_prob=0.15) + g.gen_random_high_cabac_stream(
        6, 4, n_frames=1, seed=2, kinds=("i4", "i8", "i16"))
    nd = NativeDecoder()
    out = []
    pos = find_start_code(data, 0)
    while pos < len(data):
        end = find_start_code(data, pos + 3)
        _, events = nd.decode_nal(data[pos + 3:end])
        for e in events:
            if e[0] == EV_FRAME_DONE:
                out.append(np.array(nd.planes(e[1]).mb_flags))
        while (info := nd.get_frame()) is not None:
            nd.return_frame(info["slot"])
        pos = end
    nd.close()
    return out


def test_intra_round_plane_matches_jax():
    rng = np.random.RandomState(4)
    cases = _stream_flags()
    cases += [np.where(rng.rand(6, 9) < d, 1, 64).astype(np.int32)
              for d in (0.0, 0.05, 0.2, 0.35, 0.45, 0.9)]
    # a diagonal chain deeper than the largest bucket: no plane
    chain = np.full((10, 10), 64, np.int32)
    chain[np.arange(10), np.arange(10)] = 1
    cases.append(chain)
    kinds = set()
    for fl in cases:
        mbH, mbW = fl.shape
        want = J.intra_round_plane(fl, mbW, mbH)
        got = intra_round_plane(fl, mbW, mbH)
        assert (want is None) == (got is None)
        if got is None:
            kinds.add("none")
            continue
        kinds.add(got[1])
        assert got[1] == want[1]
        assert got[0].dtype == np.int32
        assert np.array_equal(got[0], want[0])
    assert {"none", 2}.issubset(kinds) and kinds & {4, 8}, kinds
