"""The port stands alone: it imports neither jax nor the JAX package, its
entry points run on the CPU only when asked to, and its stream loader
leaves the `tools` modules as it found them."""

import ast
import os
import subprocess
import sys

import pytest

torch = pytest.importorskip("torch")

from edge264_tpu_torch import streams  # noqa: E402
from edge264_tpu_torch.api import Decoder, decode_annexb  # noqa: E402
from edge264_tpu_torch.parallel.batch import \
    decode_gops_batched  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BLOCKED = ("jax", "jaxlib", "edge264_tpu")

_BLOCKER = """
import importlib.abc, sys
class Block(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in %r:
            raise ImportError("blocked: " + name)
        return None
for n in [n for n in sys.modules if n.split(".")[0] in %r]:
    del sys.modules[n]
sys.meta_path.insert(0, Block())
""" % (BLOCKED, BLOCKED)

_BODY = """
import pkgutil, importlib
import edge264_tpu_torch
mods = [m.name for m in pkgutil.walk_packages(edge264_tpu_torch.__path__,
                                              "edge264_tpu_torch.")]
for m in mods:
    importlib.import_module(m)
assert {"edge264_tpu_torch." + m for m in (
    "ops.oracle", "ops.deblock_oracle", "ops.frame", "ops.intra",
    "parallel.mesh", "parallel.distributed")} <= set(mods)
from edge264_tpu_torch import streams
from edge264_tpu_torch.api import decode_annexb
from edge264_tpu_torch.parallel.batch import decode_gops_batched
data = streams.avcgen().gen_random_cabac_ipb_stream(
    2, 2, n_gops=1, seed=1, closed=True, gop_pb=1)
n = len(list(decode_gops_batched(data, lanes=1, device="cpu")))
assert len(list(decode_annexb(data, device="cpu"))) == n
assert len(list(decode_annexb(data, backend="numpy"))) == n
bad = [m for m in sys.modules if m.split(".")[0] in %r]
print("OK", len(mods), n, bad)
""" % (BLOCKED,)


def test_imports_and_decodes_with_jax_blocked():
    env = dict(os.environ, PYTHONPATH=REPO)
    r = subprocess.run([sys.executable, "-c", _BLOCKER + _BODY], cwd=REPO,
                       env=env, capture_output=True, text=True, timeout=600)
    assert r.returncode == 0, r.stderr[-4000:]
    last = r.stdout.strip().splitlines()[-1].split(" ", 3)
    assert last[0] == "OK" and int(last[1]) >= 14 and int(last[2]) == 3, last
    assert last[3] == "[]", last


def _py_files():
    root = os.path.join(REPO, "edge264_tpu_torch")
    out = [os.path.join(REPO, "chip_smoke.py")]
    for d, _, files in os.walk(root):
        out += [os.path.join(d, f) for f in files if f.endswith(".py")]
    return out


def test_no_jax_import_anywhere_in_the_port():
    files = _py_files()
    assert len(files) >= 15
    for path in files:
        tree = ast.parse(open(path).read(), path)
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module or ""]
            else:
                continue
            for n in names:
                assert n.split(".")[0] not in BLOCKED, (path, n)


def test_entry_point_needs_a_card_unless_told_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for call in (lambda **kw: decode_gops_batched(b"", **kw),
                 lambda **kw: decode_annexb(b"", **kw), Decoder):
        for kw in ({}, {"device": "cuda"}):
            with pytest.raises(RuntimeError, match="CUDA"):
                call(**kw)
    assert list(decode_gops_batched(b"", device="cpu")) == []
    assert list(decode_annexb(b"", device="cpu")) == []
    Decoder(device="cpu").close()


def _tools_state():
    mods = {n: m for n, m in sys.modules.items()
            if n == "tools" or n.startswith("tools.")}
    pkg = mods.get("tools")
    return mods, (dict(vars(pkg)) if pkg is not None else None)


def test_stream_loader_leaves_tools_untouched():
    before = _tools_state()
    g = streams.avcgen()
    data = g.gen_random_cabac_ipb_stream(2, 2, n_gops=1, seed=2)
    assert data[:4] == b"\x00\x00\x01\x67"         # SPS NAL
    assert _tools_state() == before
    with streams.scoped_tools() as avc:
        import tools.avcgen
        assert tools.avcgen is avc is g
    assert _tools_state() == before


def test_cabac_tables_from_the_port_sources():
    """The fallback tables parse to the shapes gen_cabac_tables returns."""
    init = streams.parse_init_tables()
    assert len(init) == 4 and all(len(t) == 1024 for t in init)
    rl, tm, tl = streams.parse_bitstream_tables()
    assert (len(rl), len(tm), len(tl)) == (256, 64, 64)
    assert rl[:4] == [128, 176, 208, 240] and tm[62:] == [62, 63]


def test_package_exports_what_the_jax_package_exports():
    """`import edge264_tpu_torch` gives every public name that
    `import edge264_tpu` gives (its submodules aside), and stays light:
    the package's import loads no torch."""
    import types

    import edge264_tpu
    import edge264_tpu_torch
    want = {n for n, v in vars(edge264_tpu).items()
            if not n.startswith("_") and not isinstance(v, types.ModuleType)}
    assert want >= {"Decoder", "Frame", "decode_annexb", "find_start_code"}
    assert want <= set(edge264_tpu_torch.__all__)
    for n in want:
        assert callable(getattr(edge264_tpu_torch, n)), n
    r = subprocess.run(
        [sys.executable, "-c", "import sys, edge264_tpu_torch; "
         "print('torch' in sys.modules)"],
        cwd=REPO, capture_output=True, text=True, timeout=120)
    assert r.returncode == 0 and r.stdout.strip() == "False", r
