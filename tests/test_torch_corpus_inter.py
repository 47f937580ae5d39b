"""The port's stream corpus on the CPU against the JAX package, part 2
of 2: the inter classes (references, B frames, weights, long-term
references and list reordering).  Held as in test_torch_corpus.py."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from jax_golden import CORPUS_INTER_FILE, check_corpus_class, \
    torch_threads  # noqa: E402


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    with torch_threads(1):
        yield


@pytest.mark.parametrize("name", CORPUS_INTER_FILE)
def test_corpus_class_matches_jax(name):
    want, lock_want = check_corpus_class(name)
    if name == "long_term_mmco_rplm":
        # The fourth GOP's list reordering (test_rplm_duplicate_ref's
        # recipe) names picNum 2, its own frame_num: no reference has it.
        # A whole-stream decoder then takes a stale entry of the GOP
        # before; the lockstep's fresh decoder a GOP, in both packages,
        # has none.  So the two oracles differ on that one frame, and the
        # lockstep follows the GOP-by-GOP one.
        differ = [i for i, (a, b) in enumerate(zip(want, lock_want))
                  if not np.array_equal(a.y, b.y)]
        assert differ == [13]
