"""Command-line test app of the PyTorch port: decode, check against golden
YUV, benchmark (a port of the JAX package's `cli.py`, itself the
reference's edge264_test.c rebuilt).

Usage:
  python -m edge264_tpu_torch.cli FILE.264 [-y FILE.yuv] [-b] [-m]
                                  [-o FILE.y4m] [--device cuda|cpu]
                                  [--backend torch|numpy]
  python -m edge264_tpu_torch.cli DIR      # every .264 with a matching .yuv

Compares each decoded frame macroblock by macroblock against golden YUV
when there is one (MVC second views check FILE.1.yuv), prints a coloured
per-mb diff map of the luma for each mismatching frame, and with -b
reports wall and CPU time, frames/s and peak RSS.  The pixel path runs on
the card unless --device cpu is given; --backend numpy decodes with the
scalar oracle on the host instead (--device is then ignored).
"""

from __future__ import annotations

import argparse
import os
import resource
import sys
import time

import numpy as np

from .api import decode_annexb


def _read_yuv(path, w, h, n):
    fs = w * h * 3 // 2
    data = np.fromfile(path, np.uint8)
    return data[:min(n, data.size // fs) * fs].reshape(-1, fs)


def check_frame(i, frame, golden, w, h):
    """mb-by-mb comparison with a coloured diff map (edge264_test.c:207)."""
    got = np.concatenate([np.asarray(frame.y).ravel(),
                          np.asarray(frame.cb).ravel(),
                          np.asarray(frame.cr).ravel()])
    if np.array_equal(got, golden):
        return True
    y = np.asarray(frame.y)
    gy = golden[:w * h].reshape(h, w)
    mbW, mbH = (w + 15) // 16, (h + 15) // 16
    print(f"frame {i}: MISMATCH (luma diff map, . = ok, X = differs)")
    for my in range(mbH):
        row = ""
        for mx in range(mbW):
            a = y[my * 16:my * 16 + 16, mx * 16:mx * 16 + 16]
            b = gy[my * 16:my * 16 + 16, mx * 16:mx * 16 + 16]
            bad = not np.array_equal(a[:b.shape[0], :b.shape[1]], b)
            row += "\x1b[31mX\x1b[0m" if bad else "."
        print("  " + row)
    return False


def decode_file(path, yuv=None, device=None, bench=False, quiet=False,
                n_tasks=0, out_y4m=None, backend="torch"):
    """Decode one file, check it against `yuv` if given, write `out_y4m`
    if given.  True when every frame matched (or there was nothing to
    compare)."""
    with open(path, "rb") as fh:
        data = fh.read()
    t0 = time.perf_counter()
    c0 = time.process_time()
    frames = list(decode_annexb(data, device=device, n_tasks=n_tasks,
                                backend=backend))
    wall = time.perf_counter() - t0
    cpu = time.process_time() - c0
    n_ok = n_total = None
    if yuv and os.path.exists(yuv) and frames:
        h, w = frames[0].y.shape
        golden = _read_yuv(yuv, w, h, len(frames))
        golden2 = None
        y1 = os.path.splitext(yuv)[0] + ".1.yuv"
        if os.path.exists(y1):
            golden2 = _read_yuv(y1, w, h, len(frames))
        n_ok = n_total = 0
        for i, f in enumerate(frames):
            n_total += 1
            if i < len(golden) and check_frame(i, f, golden[i], w, h):
                n_ok += 1
            if golden2 is not None and f.y_mvc is not None:
                n_total += 1
                view = argparse.Namespace(y=f.y_mvc, cb=f.cb_mvc,
                                          cr=f.cr_mvc)
                if i < len(golden2) and check_frame(i, view, golden2[i],
                                                    w, h):
                    n_ok += 1
        status = "PASS" if n_ok == n_total else "FAIL"
    else:
        status = "DECODED"
    if not quiet:
        msg = f"{path}: {status} ({len(frames)} frames"
        if n_ok is not None:
            msg += f", {n_ok}/{n_total} bit-exact"
        print(msg + ")")
    if out_y4m and frames:
        h, w = frames[0].y.shape
        # frame rate from the VUI timing when present: time_scale ticks a
        # second, 2 ticks a progressive frame (E-1); else 30:1
        nuit, tsc = frames[0].timing
        fn, fd = (tsc, 2 * nuit) if nuit and tsc else (30, 1)
        with open(out_y4m, "wb") as fh:
            fh.write(f"YUV4MPEG2 W{w} H{h} F{fn}:{fd} Ip A1:1 C420\n"
                     .encode())
            for f in frames:
                fh.write(b"FRAME\n")
                fh.write(f.y.tobytes())
                fh.write(f.cb.tobytes())
                fh.write(f.cr.tobytes())
        if not quiet:
            print(f"  wrote {out_y4m} ({len(frames)} frames)")
    if bench:
        rss = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss // 1024
        print(f"  wall: {wall * 1000:.1f} ms  cpu: {cpu * 1000:.1f} ms  "
              f"fps: {len(frames) / wall:.2f}  peak RSS: {rss} MB")
    return status in ("PASS", "DECODED")


def main(argv=None):
    ap = argparse.ArgumentParser(
        description="Decode/validate/benchmark H.264 streams with the "
                    "PyTorch port (edge264_test analog)")
    ap.add_argument("input", help=".264 file or directory of test streams")
    ap.add_argument("-y", "--yuv", help="golden YUV file to compare")
    ap.add_argument("-b", "--bench", action="store_true",
                    help="print timing + memory stats")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                    help="where the pixel path runs")
    ap.add_argument("--backend", default="torch", choices=("torch", "numpy"),
                    help="pixel backend: the port's (torch) or the scalar "
                         "oracle on the host (numpy)")
    ap.add_argument("-m", "--multithread", action="store_true",
                    help="frame-task workers, one per hardware thread "
                         "(the reference's -m)")
    ap.add_argument("-o", "--output", metavar="FILE.y4m",
                    help="write decoded video as YUV4MPEG2")
    args = ap.parse_args(argv)
    n_tasks = -1 if args.multithread else 0

    if os.path.isdir(args.input):
        ok = True
        for name in sorted(os.listdir(args.input)):
            if not name.endswith(".264"):
                continue
            p = os.path.join(args.input, name)
            yuv = os.path.splitext(p)[0] + ".yuv"
            ok &= decode_file(p, yuv if os.path.exists(yuv) else None,
                              args.device, args.bench, n_tasks=n_tasks,
                              backend=args.backend)
        return 0 if ok else 1
    yuv = args.yuv or os.path.splitext(args.input)[0] + ".yuv"
    ok = decode_file(args.input, yuv if os.path.exists(yuv) else None,
                     args.device, args.bench, n_tasks=n_tasks,
                     out_y4m=args.output, backend=args.backend)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
