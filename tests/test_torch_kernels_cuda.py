"""The hand-written CUDA kernels against their plain PyTorch versions, and
the lockstep and single-frame decodes on the card against the CPU path.  These need a CUDA
device (the kernels have no CPU mode) and skip without one.  The file
imports nothing of JAX, so on a machine with a card and no JAX:

    python -m pytest --noconftest -p no:cacheprovider -m cuda \
        tests/test_torch_kernels_cuda.py
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from chip_smoke import intra_inputs  # noqa: E402
from edge264_tpu_torch import streams  # noqa: E402
from edge264_tpu_torch.api import decode_annexb  # noqa: E402
from edge264_tpu_torch.convert import planes_to_torch  # noqa: E402
from edge264_tpu_torch.ops import deblock as D  # noqa: E402
from edge264_tpu_torch.ops import intra as I  # noqa: E402
from edge264_tpu_torch.ops import mc as M  # noqa: E402
from edge264_tpu_torch.parallel.batch import \
    decode_gops_batched  # noqa: E402

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    return torch.device("cuda")


def test_deblock_kernel_matches_plain(dev):
    g = torch.Generator(device=dev).manual_seed(3)
    K, mbW, mbH = 2, 120, 6

    def ri(lo, hi, shape):
        return torch.randint(lo, hi, shape, generator=g, device=dev,
                             dtype=torch.int32)

    H, W = 16 * mbH, 16 * mbW
    db = torch.full((K, mbH, mbW), 7, dtype=torch.int32, device=dev)
    db[:, :, 0] &= ~1
    db[:, 0, :] &= ~2
    p = {"qp": ri(10, 45, (K, mbH, mbW, 4)),
         "deblock_ab": ri(-2, 3, (K, mbH, mbW, 2)), "deblock": db,
         "mb_flags": ri(0, 2, (K, mbH, mbW)) * 9}
    frames = (ri(0, 255, (K, H, W)), ri(0, 255, (K, H // 2, W // 2)),
              ri(0, 255, (K, H // 2, W // 2)))
    bs = (ri(0, 5, (K, 4 * mbH, 4 * mbW)), ri(0, 5, (K, 4 * mbH, 4 * mbW)))
    want = D.deblock_scan(*frames, p, *bs, mbW, mbH)
    n = D.deblock_batch.launches
    got = D.deblock_batch(*[f.clone() for f in frames], p, *bs, mbW, mbH)
    torch.cuda.synchronize()
    assert D.deblock_batch.launches == n + 1
    for a, b in zip(want, got):
        assert torch.equal(a, b)


@pytest.mark.parametrize("has_b", [True, False])
def test_mc_kernels_match_plain(dev, has_b):
    rng = np.random.RandomState(5)
    K, S, mbW, mbH = 2, 3, 120, 4
    BH, BW = 4 * mbH, 4 * mbW
    planes = []
    for _ in range(K):
        mv8 = rng.randint(-300, 301, (BH // 2, BW // 2, 2, 2))
        rs8 = rng.randint(-1, S, (BH // 2, BW // 2, 2))
        pair = np.repeat(rng.rand(BH // 2, BW // 4) < 0.3, 2, 1)
        mv8 = np.where(pair[..., None, None], np.repeat(mv8[:, ::2], 2, 1),
                       mv8)
        rs8 = np.where(pair[..., None], np.repeat(rs8[:, ::2], 2, 1), rs8)
        mvs = np.repeat(np.repeat(mv8, 2, 0), 2, 1)
        sub = np.repeat(np.repeat(rng.rand(BH // 2, BW // 2) < 0.3, 2, 0),
                        2, 1)
        mvs = np.where(sub[..., None, None],
                       rng.randint(-300, 301, (BH, BW, 2, 2)), mvs)
        planes.append({"refslot": np.repeat(np.repeat(rs8, 2, 0), 2, 1),
                       "mvs": mvs})
    p = planes_to_torch(planes, set(), dev)
    smap = np.zeros((K, 32), np.int32)
    smap[:, :S] = np.arange(S)
    flg, pkl, pkc = M.pack_mc_params(p, torch.as_tensor(smap).to(dev),
                                     has_b, mbW, mbH)
    y = torch.randint(0, 256, (K * (S + 1), 16 * mbH, 16 * mbW),
                      dtype=torch.uint8, device=dev)
    c = torch.randint(0, 256, (2, K * (S + 1), 8 * mbH, 8 * mbW),
                      dtype=torch.uint8, device=dev)
    L, C = M.make_ref_planes(y, c[0], c[1])
    BR, BC = flg.shape[1], flg.shape[3]
    n = 2 if has_b else 1
    f3 = flg.reshape(K, BR, BC)
    band = L.reshape(K, -1, L.shape[-2], L.shape[-1])
    bandC = C.reshape((K, S + 1) + C.shape[1:])
    for kern, plain, pk, bd in ((M.mc_luma, M.mc_luma_plain, pkl, band),
                                (M.mc_chroma, M.mc_chroma_plain, pkc,
                                 bandC)):
        args = (f3, pk.reshape(K, BR, BC * 16), bd, n)
        got, want = kern(*args), plain(*args)
        torch.cuda.synchronize()
        assert len(got) == len(want) == n
        for a, b in zip(got, want):
            assert torch.equal(a, b)


@pytest.mark.parametrize("has_t8,has_pcm", [(True, True), (False, False)])
def test_intra_kernel_matches_plain(dev, has_t8, has_pcm):
    K, mbW, mbH = 2, 120, 3
    p, frames = intra_inputs(np.random.RandomState(8 + has_t8), K, mbW, mbH,
                             has_t8, has_pcm)
    p = {k: torch.as_tensor(v, dtype=torch.int32, device=dev)
         for k, v in p.items()}
    frames = [torch.as_tensor(f, dtype=torch.int32, device=dev)
              for f in frames]
    want = I.intra_scan_sheared(*frames, p, mbW, mbH, has_t8, has_pcm)
    n = I.intra_batch.launches
    got = I.intra_batch(*[f.clone() for f in frames], p, mbW, mbH, has_t8,
                        has_pcm)
    torch.cuda.synchronize()
    assert I.intra_batch.launches == n + 1
    for a, b in zip(want, got):
        assert torch.equal(a, b)


def test_lockstep_on_card_matches_cpu(dev):
    data = b"".join(streams.avcgen().gen_random_cabac_ipb_stream(
        8, 6, n_gops=1, seed=s, closed=True, gop_pb=1 + s, density=0.1,
        max_level=4, intra_prob=0.1) for s in (0, 1))
    want = list(decode_gops_batched(data, lanes=2, device="cpu"))
    got = list(decode_gops_batched(data, lanes=2))
    assert len(got) == len(want) > 0
    for a, b in zip(want, got):
        for n in ("y", "cb", "cr"):
            assert np.array_equal(getattr(a, n), getattr(b, n))


def test_decode_annexb_on_card_matches_cpu(dev):
    data = streams.avcgen().gen_random_cabac_ipb_stream(
        8, 6, n_gops=1, seed=4, closed=True, gop_pb=2, density=0.1,
        max_level=4, intra_prob=0.1)
    want = list(decode_annexb(data, device="cpu"))
    n = (I.intra_batch.launches, D.deblock_batch.launches,
         M.mc_luma.launches, M.mc_chroma.launches)
    got = list(decode_annexb(data))
    assert len(got) == len(want) == 5
    for a, b in zip(want, got):
        assert a.frame_id == b.frame_id
        for c in ("y", "cb", "cr"):
            assert np.array_equal(getattr(a, c), getattr(b, c))
    # intra + deblock on every frame, MC on the four with a reference
    assert (I.intra_batch.launches - n[0], D.deblock_batch.launches - n[1],
            M.mc_luma.launches - n[2], M.mc_chroma.launches - n[3]) == \
        (5, 5, 4, 4)
