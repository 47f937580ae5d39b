"""Time the CPU single-frame path's two intra routes on one stream.

`TorchBackend` on the CPU runs P/B intra through the level-gather scan
(`intra.intra_scan` over `intra.intra_level_tables`) wherever the tables
exist, and through the sheared wavefront scan (`intra.intra_batch`)
otherwise.  This script decodes the same stream with `decode_annexb(
device="cpu")` in turns with the tables on ("levels") and off ("sheared":
`intra_level_tables` answers None), checks that both give the same bytes,
and prints the seconds of every run (after one warm-up decode), the
frames that took each route, and the seconds spent in each route.

    python -m edge264_tpu_torch.bench_intra_route            # 1080p
    python -m edge264_tpu_torch.bench_intra_route --mbw 20 --mbh 12

The default stream is the one `chip_smoke.py` decodes at 1080p: two closed
CABAC GOPs of IDR + P + B, 5 % intra macroblocks in P and B
(`--intra-prob` sets that share).  `TorchBackend` keeps a frame's tables
only while every level holds at most 128 macroblocks, as `JaxBackend`
does.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import time

import numpy as np
import torch

from . import streams
from .api import decode_annexb
from .ops import backend, frame


@contextlib.contextmanager
def _route(levels: bool, log: dict):
    """Tables on or off for TorchBackend; counts the levels frames and
    times every intra call."""
    tables, scan, batch = (backend.intra_level_tables, frame.intra_scan,
                           frame.intra_batch)

    def timed(name, fn):
        def run(*a, **kw):
            t0 = time.perf_counter()
            out = fn(*a, **kw)
            log[name] = log.get(name, 0) + 1
            log[name + "_s"] = log.get(name + "_s", 0.0) + (
                time.perf_counter() - t0)
            return out
        return run

    if not levels:
        backend.intra_level_tables = lambda *a: None
    frame.intra_scan = timed("levels", scan)
    frame.intra_batch = timed("sheared", batch)
    try:
        yield
    finally:
        backend.intra_level_tables = tables
        frame.intra_scan, frame.intra_batch = scan, batch


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--mbw", type=int, default=120)
    ap.add_argument("--mbh", type=int, default=68)
    ap.add_argument("--gops", type=int, default=2)
    ap.add_argument("--intra-prob", type=float, default=0.05,
                    help="share of intra macroblocks in P and B frames")
    ap.add_argument("--rounds", type=int, default=2,
                    help="levels/sheared pairs, taken in turns")
    args = ap.parse_args(argv)
    data = streams.avcgen().gen_random_cabac_ipb_stream(
        args.mbw, args.mbh, n_gops=args.gops, seed=42, closed=True,
        gop_pb=1, density=0.05, max_level=4, intra_prob=args.intra_prob)
    print(f"stream {len(data)} bytes at {16 * args.mbw}x{16 * args.mbh}, "
          f"intra share {args.intra_prob} in P/B, torch "
          f"{torch.__version__}, {torch.get_num_threads()} threads")
    list(decode_annexb(data, device="cpu"))   # warm-up, not counted
    runs, want = [], None
    order = ["levels", "sheared", "sheared", "levels"] * args.rounds
    for name in order[:2 * args.rounds]:
        log = {}
        with _route(name == "levels", log):
            t0 = time.perf_counter()
            got = [tuple(np.asarray(c) for c in (f.y, f.cb, f.cr))
                   for f in decode_annexb(data, device="cpu")]
            s = time.perf_counter() - t0
        if want is None:
            want = got
        same = len(got) == len(want) and all(
            np.array_equal(a, b) for fa, fb in zip(got, want)
            for a, b in zip(fa, fb))
        if not same:
            raise AssertionError(f"{name} run differs from the first run")
        runs.append({"route": name, "s": s, "frames": len(got),
                     "levels_frames": log.get("levels", 0),
                     "sheared_frames": log.get("sheared", 0),
                     "levels_s": log.get("levels_s", 0.0),
                     "sheared_s": log.get("sheared_s", 0.0)})
        print(json.dumps(runs[-1]))
    return runs


if __name__ == "__main__":
    main()
