"""Goldens from the JAX package for the port's stream tests: the JAX
package's scalar oracle (`decode_annexb(backend="numpy")`) on a whole
stream or on each of its closed GOPs, a stand-in for the reference binary
built on it, and the frame comparison the port's tests share."""

import contextlib

import numpy as np

from edge264_tpu.api import decode_annexb as jax_decode_annexb
from edge264_tpu.parallel.gop import split_gops as jax_split_gops

VIEWS = ("y", "cb", "cr", "y_mvc", "cb_mvc", "cr_mvc")


def assert_same_frames(want, got, ctx=""):
    """Frame count, frame ids (both views), crop, mb_errors and every
    plane of both MVC views byte for byte."""
    assert len(got) == len(want) > 0, (ctx, len(got), len(want))
    for i, (a, b) in enumerate(zip(want, got)):
        assert (a.frame_id, a.frame_id_mvc, a.crop_offsets) == \
            (b.frame_id, b.frame_id_mvc, b.crop_offsets), (ctx, i)
        for n in VIEWS:
            x, y = getattr(a, n), getattr(b, n)
            assert (x is None) == (y is None), (ctx, i, n)
            if x is not None:
                assert isinstance(y, np.ndarray) and y.dtype == np.uint8
                assert np.array_equal(np.asarray(x), y), (ctx, i, n)
        assert (a.mb_errors is None) == (b.mb_errors is None), (ctx, i)
        if a.mb_errors is not None:
            assert np.array_equal(a.mb_errors, b.mb_errors), (ctx, i)


def numpy_frames(data):
    """The JAX package's scalar oracle on the whole stream."""
    return list(jax_decode_annexb(data, backend="numpy"))


def numpy_frames_by_gop(data, whole=None):
    """The JAX package's scalar oracle on each closed GOP alone
    (edge264_tpu.parallel.gop.split_gops), concatenated: what both
    packages' lockstep drivers decode, a fresh decoder a GOP, so frame
    ids restart at each GOP.  `whole`: the oracle's frames of the whole
    stream, which a stream of one GOP reuses."""
    gops = jax_split_gops(data)
    if len(gops) == 1 and whole is not None:
        return whole
    return [f for gop in gops for f in numpy_frames(gop)]


@contextlib.contextmanager
def torch_threads(n):
    """The port's CPU decodes run small tensors, which one intra-op
    thread serves best (several only spin against the other test
    workers); the previous count is restored after the block."""
    import torch
    saved = torch.get_num_threads()
    torch.set_num_threads(n)
    try:
        yield
    finally:
        torch.set_num_threads(saved)


class NumpyOracle:
    """Stands in for tools.ref_oracle.RefOracle: decode_yuv(data) returns
    the JAX package's backend="numpy" frames in the reference binary's
    (frames_meta, yuv, yuv2) form."""

    def decode_yuv(self, data):
        frames = numpy_frames(data)
        meta = [(f.frame_id, f.y.shape[1], f.y.shape[0], f.cb.shape[1],
                 f.cb.shape[0]) for f in frames]
        yuv = b"".join(np.asarray(f.y).tobytes() + np.asarray(f.cb).tobytes()
                       + np.asarray(f.cr).tobytes() for f in frames)
        yuv2 = b"".join(np.asarray(f.y_mvc).tobytes()
                        + np.asarray(f.cb_mvc).tobytes()
                        + np.asarray(f.cr_mvc).tobytes()
                        for f in frames if f.y_mvc is not None)
        return meta, yuv, yuv2


# The corpus classes split between two test files, so each stays within
# a few minutes on one worker (test_torch_corpus.py checks the split).
CORPUS_INTRA_FILE = (
    "cavlc_intra_slices", "deblock_idc2_offsets", "high_intra_scaling_pcm",
    "high_ipp_t8", "high_cabac_i8_pcm", "mvc_stereo", "extreme_levels",
    "truncated_concealment", "qp_extremes", "cabac_ipb_deblock_off",
    "cavlc_ipb_open_gop")
CORPUS_INTER_FILE = (
    "cavlc_ipp_5refs", "cavlc_ipb_implicit_temporal",
    "cabac_ipb_slices_init2", "explicit_wp_p", "explicit_wp_b_cavlc",
    "explicit_w_cabac", "long_term_mmco_rplm")


def check_corpus_class(name):
    """One corpus class on the CPU against the JAX package: the port's
    decode_annexb, its backend="numpy" and its lockstep driver.  The
    lockstep decodes each closed GOP with a fresh decoder, as the JAX
    lockstep does, so it is held to the oracle GOP by GOP; on the
    truncated class it is held to the JAX lockstep itself, which does
    not blend recovered mbs either.  Returns the two goldens (the
    oracle's frames, the lockstep's)."""
    from edge264_tpu.parallel.batch import \
        decode_gops_batched as jax_decode_gops_batched
    from edge264_tpu_torch import corpus
    from edge264_tpu_torch.api import decode_annexb
    from edge264_tpu_torch.parallel.batch import decode_gops_batched

    data = corpus.build(name)
    want = numpy_frames(data)
    assert_same_frames(want, list(decode_annexb(data, device="cpu")),
                       f"{name}: decode_annexb")
    assert_same_frames(want, list(decode_annexb(data, backend="numpy")),
                       f"{name}: numpy backend")
    if name == "truncated_concealment":
        assert any(f.mb_errors is not None for f in want)
        lock_want = list(jax_decode_gops_batched(data, lanes=2))
    else:
        lock_want = numpy_frames_by_gop(data, want)
    assert_same_frames(
        lock_want, list(decode_gops_batched(data, lanes=2, device="cpu")),
        f"{name}: lockstep")
    return want, lock_want
