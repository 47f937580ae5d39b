"""The port's stream corpus (edge264_tpu_torch/corpus.py) on the CPU
against the JAX package, part 1 of 2: the intra, High, MVC, level,
concealment, QP, deblocking and open-GOP classes.  Each class's stream goes
through the port's decode_annexb (device="cpu"), its backend="numpy" and
its lockstep driver (lanes=2), each byte-identical to the JAX package's
backend="numpy" (jax_golden.check_corpus_class); part 2 is
test_torch_corpus_inter.py."""

import pytest

torch = pytest.importorskip("torch")

from edge264_tpu_torch import corpus  # noqa: E402
from jax_golden import CORPUS_INTER_FILE, CORPUS_INTRA_FILE, \
    check_corpus_class, torch_threads  # noqa: E402


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    with torch_threads(1):
        yield


def test_the_two_files_cover_every_class_once():
    names = CORPUS_INTRA_FILE + CORPUS_INTER_FILE
    assert sorted(names) == sorted(corpus.CPU_CLASSES)
    assert not set(corpus.CARD_CLASSES) & set(names)


@pytest.mark.parametrize("name", CORPUS_INTRA_FILE)
def test_corpus_class_matches_jax(name):
    frames, _ = check_corpus_class(name)
    if name == "mvc_stereo":
        assert all(f.y_mvc is not None for f in frames)
