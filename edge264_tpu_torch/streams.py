"""Scoped loader for the repository's test-stream generator (`tools/`).

`tools.avcgen` builds CABAC streams through `tools.cabac_enc`, which reads
the CABAC constant tables at import time through
`tools.gen_cabac_tables.parse_*` -- and those parse the reference
decoder's C sources.  Where those sources are absent, this loader supplies
the same four tables parsed from the port's own generated
`native/src/cabac_tables.cpp` (the file `tools/gen_cabac_tables.py`
emits from them).

The generator modules are imported as a private `tools` package:
`sys.modules`, any `tools` package already imported and its submodules
are exactly as they were before and after every call here, so code that
probes `import tools.avcgen` sees no change.

    from edge264_tpu_torch import streams
    data = streams.avcgen().gen_random_cabac_ipb_stream(8, 6, n_gops=1)
    with streams.scoped_tools():        # `import tools.avcgen` resolves to
        ...                             # the private modules in the block
    broken = streams.truncate_slice(data, 1, frac=0.5)   # a damaged slice
"""

from __future__ import annotations

import contextlib
import functools
import importlib
import os
import re
import sys
import threading
import types

from .api import find_start_code

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_TOOLS = os.path.join(_REPO, "tools")
_TABLES_CPP = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                           "native", "src", "cabac_tables.cpp")
_LOCK = threading.RLock()


def _block(src: str, decl: str) -> str:
    """Body of the C initializer that follows the FULL declaration `decl`
    (the bare table names first appear in the file's header comment)."""
    start = src.index(decl)
    return src[src.index("=", start) + 1:src.index(";", start)]


def parse_init_tables():
    """CTX_INIT[4][1024][2] -> [[(m, n)] * 1024] * 4, the shape
    `tools.gen_cabac_tables.parse_init_tables` returns."""
    src = open(_TABLES_CPP).read()
    pairs = re.findall(r"\{\s*(-?\d+),\s*(-?\d+)\}",
                       _block(src, "CTX_INIT[4][1024][2]"))
    if len(pairs) != 4 * 1024:
        raise ValueError(f"CTX_INIT: {len(pairs)} pairs")
    return [[(int(m), int(n)) for m, n in pairs[i * 1024:(i + 1) * 1024]]
            for i in range(4)]


def parse_bitstream_tables():
    """(range_lps [256] flat pStateIdx-major, trans_mps [64],
    trans_lps [64]) -- `tools.gen_cabac_tables.parse_bitstream_tables`."""
    src = open(_TABLES_CPP).read()
    out = []
    for decl, n in (("RANGE_LPS[64][4]", 256), ("TRANS_MPS[64]", 64),
                    ("TRANS_LPS[64]", 64)):
        vals = [int(v) for v in re.findall(r"-?\d+", _block(src, decl))]
        if len(vals) != n:
            raise ValueError(f"{decl}: {len(vals)} values")
        out.append(vals)
    return tuple(out)


def _tools_names():
    return [n for n in sys.modules if n == "tools" or n.startswith("tools.")]


@contextlib.contextmanager
def _swapped(mods: dict):
    """Replace every `tools*` entry of sys.modules by `mods` for the block;
    afterwards remove whatever `tools*` entries exist and put the saved
    ones back."""
    with _LOCK:
        saved = {n: sys.modules.pop(n) for n in _tools_names()}
        sys.modules.update(mods)
        try:
            yield
        finally:
            for n in _tools_names():
                del sys.modules[n]
            sys.modules.update(saved)


@functools.cache
def _private_tools() -> dict:
    """Import the generator as a private `tools` package; returns its
    modules by name."""
    if not os.path.isdir(_TOOLS):
        raise FileNotFoundError(f"stream generator not found: {_TOOLS}")
    pkg = types.ModuleType("tools")
    pkg.__path__ = [_TOOLS]
    pkg.__file__ = os.path.join(_TOOLS, "__init__.py")
    with _swapped({"tools": pkg}):
        gt = importlib.import_module("tools.gen_cabac_tables")
        if not (os.path.exists(gt.REF_MAIN) and os.path.exists(gt.REF_BITS)):
            gt.parse_init_tables = parse_init_tables
            gt.parse_bitstream_tables = parse_bitstream_tables
        importlib.import_module("tools.avcgen")
        return {n: sys.modules[n] for n in _tools_names()}


@contextlib.contextmanager
def scoped_tools():
    """Within the block, `import tools.avcgen` (and its helpers) resolve to
    the private generator modules; yields `tools.avcgen`."""
    mods = _private_tools()
    with _swapped(mods):
        yield mods["tools.avcgen"]


def avcgen():
    """The private `tools.avcgen` module (gen_random_*_stream, ...)."""
    return _private_tools()["tools.avcgen"]


def truncate_slice(data: bytes, slice_index: int, frac: float = 0.5) -> bytes:
    """Cut the payload of the `slice_index`-th slice NAL (types 1 and 5) at
    `frac` of its length, keeping every later NAL: a stream that exercises
    slice error recovery and concealment."""
    starts = []
    pos = find_start_code(data, 0)
    while pos < len(data):
        starts.append(pos)
        pos = find_start_code(data, pos + 3)
    starts.append(len(data))
    slices = [i for i in range(len(starts) - 1)
              if data[starts[i] + 3] & 31 in (1, 5)]
    s = slices[slice_index]
    cut = starts[s] + max(5, int((starts[s + 1] - starts[s]) * frac))
    return data[:cut] + data[starts[s + 1]:]
