"""The port's command-line app on the CPU: golden YUV written from the JAX
package's frames gives PASS, one flipped byte FAIL with a diff map, and
-o writes the JAX package's y4m bytes."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from edge264_tpu import cli as jax_cli  # noqa: E402
from edge264_tpu.api import decode_annexb as jax_decode_annexb  # noqa: E402
from edge264_tpu_torch import cli, streams  # noqa: E402


@pytest.fixture(scope="module")
def case(tmp_path_factory):
    """A stream file and its golden YUV, from the JAX package's frames."""
    d = tmp_path_factory.mktemp("cli")
    data = streams.avcgen().gen_random_cabac_ipb_stream(
        6, 4, n_gops=1, seed=9, closed=True, gop_pb=1, density=0.1,
        max_level=4, intra_prob=0.1)
    (d / "s.264").write_bytes(data)
    yuv = b"".join(np.asarray(getattr(f, c)).tobytes()
                   for f in jax_decode_annexb(data, backend="jax")
                   for c in ("y", "cb", "cr"))
    return d, yuv


def test_cli_pass(case, capsys):
    d, yuv = case
    (d / "s.yuv").write_bytes(yuv)
    assert cli.main([str(d / "s.264"), "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert "PASS (3 frames, 3/3 bit-exact)" in out
    # a directory argument checks every .264 beside its .yuv
    assert cli.main([str(d), "--device", "cpu"]) == 0
    assert "PASS" in capsys.readouterr().out


def test_cli_fail_shows_diff_map(case, capsys):
    d, yuv = case
    bad = bytearray(yuv)
    bad[6 * 16 * 4 * 16 * 3 // 2 + 100] ^= 1      # a luma byte of frame 1
    (d / "bad.yuv").write_bytes(bytes(bad))
    assert cli.main([str(d / "s.264"), "-y", str(d / "bad.yuv"),
                     "--device", "cpu"]) == 1
    out = capsys.readouterr().out
    assert "FAIL (3 frames, 2/3 bit-exact)" in out
    assert "frame 1: MISMATCH" in out
    assert "\x1b[31mX\x1b[0m" in out and "frame 0: MISMATCH" not in out


def test_cli_y4m_matches_jax(case, tmp_path):
    d, _ = case
    got, want = tmp_path / "t.y4m", tmp_path / "j.y4m"
    assert cli.main([str(d / "s.264"), "-y", str(tmp_path / "none.yuv"),
                     "-o", str(got), "--device", "cpu"]) == 0
    assert jax_cli.decode_file(str(d / "s.264"), out_y4m=str(want),
                               quiet=True)
    assert got.read_bytes() == want.read_bytes()
    assert got.read_bytes().startswith(b"YUV4MPEG2 W96 H64 ")


def test_cli_numpy_backend(case, capsys, monkeypatch):
    """--backend numpy decodes with the scalar oracle on the host: PASS
    against the JAX package's frames, with no card and --device left at
    its default."""
    d, yuv = case
    (d / "s.yuv").write_bytes(yuv)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert cli.main([str(d / "s.264"), "--backend", "numpy", "-b"]) == 0
    out = capsys.readouterr().out
    assert "PASS (3 frames, 3/3 bit-exact)" in out and "fps:" in out
