"""Every case of tests/test_conformance_cases.py that takes `ref_oracle`,
held to the JAX package instead of the reference binary: the case's own
body runs unchanged, with its `decode_annexb` pointed at the port's CPU
decode (device="cpu") and a stand-in oracle (jax_golden.NumpyOracle)
whose decode_yuv returns the JAX package's backend="numpy" frames.

The JAX file is imported, never edited, inside streams.scoped_tools(),
where its `tools.avcgen` imports resolve without the reference sources;
its bodies import the generator lazily, so they run in the block too.
test_randomized_sweep builds the binary; its seeds run in
test_torch_conformance_sweep.py instead."""

import importlib.util
import inspect
import os

import pytest

torch = pytest.importorskip("torch")

from edge264_tpu_torch import streams  # noqa: E402
from edge264_tpu_torch.api import decode_annexb  # noqa: E402
from jax_golden import NumpyOracle, torch_threads  # noqa: E402

CASES_FILE = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                          "test_conformance_cases.py")
REPLACED = {"test_randomized_sweep"}


def _load_cases():
    spec = importlib.util.spec_from_file_location("_jax_conformance_cases",
                                                  CASES_FILE)
    mod = importlib.util.module_from_spec(spec)
    with streams.scoped_tools():
        spec.loader.exec_module(mod)
    return mod


CASES = _load_cases()


def _oracle_cases():
    """(case id, test name, keyword arguments besides ref_oracle) for
    every test of the JAX file that takes ref_oracle, its parametrised
    cases expanded."""
    out = []
    for name, fn in vars(CASES).items():
        if not (name.startswith("test_") and callable(fn)) \
                or name in REPLACED \
                or "ref_oracle" not in inspect.signature(fn).parameters:
            continue
        params = [{}]
        for mark in getattr(fn, "pytestmark", []):
            if mark.name != "parametrize":
                continue
            argnames, values = mark.args[0], mark.args[1]
            argnames = [a.strip() for a in argnames.split(",")] \
                if isinstance(argnames, str) else list(argnames)
            params = [dict(p, **dict(zip(argnames, v if len(argnames) > 1
                                         else (v,))))
                      for p in params for v in values]
        for p in params:
            tag = "-".join(str(v) for v in p.values())
            out.append((f"{name}[{tag}]" if tag else name, name, p))
    return out


ORACLE_CASES = _oracle_cases()


def _port_cpu_decode(data, **_kw):
    """The port's single-frame decode on the CPU, whatever backend the
    case asks the JAX package for."""
    return decode_annexb(data, device="cpu")


def test_every_oracle_case_is_held():
    names = {n for _i, n, _p in ORACLE_CASES}
    assert len(ORACLE_CASES) >= 40
    assert "test_extreme_residual_levels" in names
    assert not names & REPLACED


@pytest.mark.parametrize("name,kw", [(n, p) for _i, n, p in ORACLE_CASES],
                         ids=[i for i, _n, _p in ORACLE_CASES])
def test_conformance_case_on_the_port(name, kw, monkeypatch):
    monkeypatch.setattr(CASES, "decode_annexb", _port_cpu_decode)
    with torch_threads(1), streams.scoped_tools():
        getattr(CASES, name)(ref_oracle=NumpyOracle(), **kw)
