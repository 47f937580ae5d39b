#!/usr/bin/env python3
"""Where the lockstep packer's host time goes: every step of
`ops/arena.pack_planes_batch` in a K=8 lockstep decode of the benchmark's
1080p stream, split into its parts, on a card.

    python3 pack_breakdown.py [--seed 42] [--decodes 3] [--out FILE]
    python3 pack_breakdown.py --device cpu     # a rehearsal, 8x6 mbs

The stream is the benchmark's (`bench_torch.build_stream`, cached in the
temporary directory).  Each mode runs one warm-up decode, then
`--decodes` timed decodes of `decode_gops_batched(lanes=8,
sink="digest")`:
  busy  in `parallel/batch._decode_group`'s order: whatever lane threads
        it has started parse while the main thread packs;
  idle  each pack first waits for the lane threads to finish.
The parts are timed by wrapping what the packer calls through its module
and through the planes' class, so the package holds no timing code:
`_check_geometry`; the native `pack_probe` calls; `plan_layout` with
`_native_entries`; `_arena_buf` (the staging buffer), and within it the
wait on its old uploads (`torch.cuda.Event.synchronize`); the native
`pack_row` calls; and the meta block's copy, timed again on the returned
buffer.  For each part and step: `sum_ms`, the summed wall ms of its
calls; `span_ms`, from its first call's start to its last call's end (the
part's wall time when its calls run side by side); `cpu_ms`, the summed
CPU ms of the threads that made the calls.  `total_ms` is the whole
call's wall time, `total_cpu_ms` the calling thread's CPU ms in it.
The card's name and power limit, os.cpu_count() and the interpreter's
switch interval go beside them.  The result goes to --out as JSON, and a
summary (means over the timed steps) to standard output.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import sys
import threading
import time
import types

import torch

import bench_torch
from edge264_tpu_torch import native
from edge264_tpu_torch import streams
from edge264_tpu_torch.ops import arena as A
from edge264_tpu_torch.parallel import batch as TB

PARTS = ("check_geometry", "probe", "plan_layout", "native_entries",
         "arena_buf", "staging_wait", "pack_row", "meta_copy")
CONFIG = "h264_1080p_cabac_ipb_bbb"


class Recorder:
    """The parts of the pack call under way: (part, start, end, cpu ms)
    from any thread (list.append holds under the interpreter lock)."""

    def __init__(self):
        self.cur = None
        self.steps = []

    def wrap(self, part, fn):
        rec = self

        def timed(*a, **kw):
            cur = rec.cur
            if cur is None:
                return fn(*a, **kw)
            c0 = time.thread_time()
            t0 = time.perf_counter()
            try:
                return fn(*a, **kw)
            finally:
                cur.append((part, t0, time.perf_counter(),
                            (time.thread_time() - c0) * 1e3))
        return timed


def summarize(calls, t0, t1, cpu):
    out = {"total_ms": (t1 - t0) * 1e3, "total_cpu_ms": cpu}
    for p in PARTS:
        got = [c for c in calls if c[0] == p]
        out[p] = {
            "calls": len(got),
            "sum_ms": sum((b - a) * 1e3 for _p, a, b, _c in got),
            "span_ms": ((max(b for _p, _a, b, _c in got)
                         - min(a for _p, a, _b, _c in got)) * 1e3
                        if got else 0.0),
            "cpu_ms": sum(c for *_x, c in got)}
    return out


def instrument(rec, mode, lane_threads):
    """Patch the packer's parts; returns the undo list."""
    saved = []

    def patch(owner, name, new):
        saved.append((owner, name, getattr(owner, name)))
        setattr(owner, name, new)

    sp = native.SyntaxPlanes
    patch(A, "_check_geometry", rec.wrap("check_geometry",
                                         A._check_geometry))
    patch(sp, "pack_probe", rec.wrap("probe", sp.pack_probe))
    patch(sp, "pack_row", rec.wrap("pack_row", sp.pack_row))
    patch(A, "plan_layout", rec.wrap("plan_layout", A.plan_layout))
    patch(A, "_native_entries", rec.wrap("native_entries",
                                         A._native_entries))
    patch(A, "_arena_buf", rec.wrap("arena_buf", A._arena_buf))
    if torch.cuda.is_available():
        ev = torch.cuda.Event
        patch(ev, "synchronize", rec.wrap("staging_wait", ev.synchronize))

    class LaneThread(threading.Thread):
        def start(self):
            lane_threads.append(self)
            super().start()

    patch(TB, "threading", types.SimpleNamespace(Thread=LaneThread))
    pack = A.pack_planes_batch

    def timed_pack(planes_list, *a, extra=None, **kw):
        if mode == "idle":
            for t in lane_threads:
                t.join()
        lane_threads[:] = [t for t in lane_threads if t.is_alive()]
        live = sum(pl is not None for pl in planes_list)
        rec.cur = calls = []
        c0 = time.thread_time()
        t0 = time.perf_counter()
        try:
            buf, layout, off = pack(planes_list, *a, extra=extra, **kw)
        finally:
            t1 = time.perf_counter()
            cpu = (time.thread_time() - c0) * 1e3
            rec.cur = None
        if extra is not None:
            m0 = time.perf_counter()
            buf.numpy()[:, off:] = extra
            calls.append(("meta_copy", m0, time.perf_counter(), 0.0))
        s = summarize(calls, t0, t1, cpu)
        s.update(lanes=len(planes_list), live=live, bytes=buf.nbytes,
                 running_lane_threads=len(lane_threads))
        rec.steps.append(s)
        return buf, layout, off

    patch(A, "pack_planes_batch", timed_pack)
    return saved


def run_mode(data, dev, mode, decodes):
    rec = Recorder()
    threads = []
    saved = instrument(rec, mode, threads)
    try:
        list(TB.decode_gops_batched(data, lanes=8, sink="digest",
                                    device=dev))       # warm-up
        rec.steps.clear()
        t0 = time.perf_counter()
        for _ in range(decodes):
            list(TB.decode_gops_batched(data, lanes=8, sink="digest",
                                        device=dev))
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)
        wall = time.perf_counter() - t0
    finally:
        for owner, name, old in reversed(saved):
            setattr(owner, name, old)
    return {"steps": rec.steps, "decode_s": wall / decodes}


def mean_table(steps):
    keys = ["total_ms", "total_cpu_ms"]
    out = {k: statistics.fmean(s[k] for s in steps) for k in keys}
    for p in PARTS:
        for f in ("sum_ms", "span_ms", "cpu_ms"):
            out[f"{p}.{f}"] = statistics.fmean(s[p][f] for s in steps)
    out["parts_span_ms"] = sum(out[f"{p}.span_ms"] for p in PARTS
                               if p not in ("staging_wait",
                                            "native_entries"))
    out["rest_ms"] = out["total_ms"] - out["parts_span_ms"]
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=42)
    ap.add_argument("--decodes", type=int, default=3)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--out", default=os.path.join("chiprun_out",
                                                  "pack_breakdown.json"))
    opts = ap.parse_args(argv)
    dev = torch.device(opts.device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            sys.exit("pack_breakdown: no CUDA device")
        from edge264_tpu_torch.kernels import build
        build.build_all()
        args = bench_torch.stream_args(CONFIG, opts.seed)
        data, _s, _c = bench_torch.build_stream(
            bench_torch.load_bench()[0][CONFIG]["stream"]["generator"], args)
        card = {"kind": torch.cuda.get_device_name(0),
                "smi": bench_torch.smi()}
    else:
        data = streams.avcgen().gen_random_cabac_ipb_stream(
            8, 6, n_gops=8, seed=opts.seed, closed=True, gop_pb=1,
            density=0.05, max_level=4, intra_prob=0.05)
        card = {"kind": "cpu", "smi": "not measured"}
    res = {"device": card, "cpu_count": os.cpu_count(),
           "affinity": len(os.sched_getaffinity(0)),
           "switch_interval_s": sys.getswitchinterval(),
           "stream_bytes": len(data), "seed": opts.seed, "modes": {}}
    for mode in ("busy", "idle", "busy", "idle"):
        r = run_mode(data, dev, mode, opts.decodes)
        res["modes"].setdefault(mode, []).append(r)
        t = mean_table(r["steps"])
        print(f"[{mode}] {len(r['steps'])} steps, decode "
              f"{r['decode_s'] * 1e3:.1f} ms; a step's pack: "
              + ", ".join(f"{k} {v:.3f}" for k, v in t.items()), flush=True)
    os.makedirs(os.path.dirname(opts.out) or ".", exist_ok=True)
    with open(opts.out, "w") as f:
        json.dump(res, f, indent=1)
    print(f"cpu_count {res['cpu_count']}, affinity {res['affinity']}, "
          f"switch interval {res['switch_interval_s']} s; {card['smi']}")


if __name__ == "__main__":
    main()
