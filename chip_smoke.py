#!/usr/bin/env python3
"""On-card smoke test of edge264_tpu_torch: the quickest proof that the
port builds, is exact and runs its main path on an NVIDIA GPU.

    python3 chip_smoke.py        # from the repository root; needs one GPU

Phases (any failure raises and exits non-zero):
  1. build    g++ for the native front end, nvcc (sm_90a) for the kernels,
              all started together; prints the build seconds.
  2. kernels  at 1080p shapes (K=2 lanes, S=8 ring slots, random rings,
              motion vectors overshooting every edge, unused cells; random
              intra planes with every mb kind, availability bit and mode)
              each kernel against its plain PyTorch version on the card:
              exact equality required; both timed with CUDA events around
              the call, and the kernel also by its own device time from
              torch.profiler's events (device_ms: no host work inside).
              Every kernel timed so at K=8 too (bench.py's lanes); the MC
              kernels held exact at K=8, on K=3 5x3 mbs, on mvs driven to
              every clamp and with one list, and their ring reads counted
              in 32-byte sectors (the sector floor).  The MC kernels' route
              (pack_mc_params -> mc.cu -> combine_mc) held exact against
              mc_frame, the plain gathers that share no packing with it,
              at DCI 4K (K=1, 256x135 mbs) and with a 33-slot 1080p ring;
              both kernels exact against their plain versions at the
              front end's widest row (1023x2 mbs) and tallest column
              (2x1056 mbs).  Also the intra kernel against the level
              rounds (intra_rounds) on one intra-sparse input, both timed;
              the intra and deblock kernels held exact on an odd geometry
              (K=3, 3x5 mbs) and at K=16 (1088 row workers), and the intra
              kernel at the front end's widest row (K=1, 1023x2 mbs).
              Then the four stage kernels (residual.cu, bs.cu, mcpack.cu,
              combine.cu) against their plain versions, exact, at 1080p
              K=1 and K=8 on random inputs with their extremes (levels
              +-2063, QP 0 and 51, the 8x8 transform on and off, every
              weighted-prediction mode, orphan inter cells, scaling
              matrices and slot maps as lane views), packing and combine
              on every MC arm, at the clamps and with one list; each
              timed with CUDA events and by its device time at K=1 and
              K=8, beside its plain version's time and its least bytes.
  3. decode   the main path: a 1080p (120x68 mb) CABAC IPB stream of 2
              closed GOPs (IDR+P+B) through decode_gops_batched(lanes=2)
              on cuda with sink="frames" and sink="digest", and on the CPU
              (device="cpu", the plain versions) as the reference: every
              frame byte-identical, every digest == host_frame_digest;
              every kernel used (residual.cu, bs.cu and deblock.cu once a
              step, mcpack.cu and combine.cu with the MC kernels), the MC
              kernels on every inter step and
              intra.cu on every step with an intra mb, no plain version
              of a kernel (intra_rounds, mc_frame) on the card; each
              step's arena bytes (beside the int32 bytes planes_to_torch
              would send), the packer's host ms, and the host ms of the
              step's intra route choice (beside the CPU route's depth
              planes on the same flags).
  4. single   the single-frame path: decode_annexb on cuda over the same
              stream, every frame byte-identical to phase 3's CPU frames,
              all four kernels launched, each frame's arena bytes and
              pack ms; then both paths on a 5x3-mb stream (an mb count
              that is no multiple of 4), byte-identical to the CPU.
  5. profile  one more decode of each path under torch.profiler: the
              device's busy ms and idle share of the wall time, the
              device ms of the top kernels, each kernel's device launches
              per wrapper call (each must be one), and the host-to-device
              copies by pinned and pageable source (every arena upload
              must be one pinned copy).
  6. entry    decode_annexb_parallel (two worker threads) and the
              command-line app (cli.main, golden YUV from phase 3's CPU
              frames) on cuda: byte-identical, PASS.
  7. wide     a 4096x512 (256x32 mb) CABAC IPB stream (DCI 4K's width)
              through decode_annexb and the lockstep driver on cuda: the
              MC kernels on every inter step (no mc_frame), intra.cu on
              every step with an intra mb, deblocking on every step,
              every frame byte-identical to the CPU path; the stages' ms.
  8. frame    decode_frame and decode_frame_inter (ops/frame.py) on phase
              3's first IDR + P pair on cuda, against the CPU.
  9. oracle   a CIF-class stream (22x18 mbs, IDR + 2 x (P+B)) decoded by
              backend="numpy", the scalar oracle on the host that shares
              no code with the port's tensor path (its seconds printed):
              decode_annexb and the lockstep driver on cuda byte-identical
              to it, and the lockstep driver with a 33-slot ring (the MC
              kernels on every inter step) on cuda and on the CPU too.
 10. mesh     the multi-device paths: phase 3's stream through
              decode_gops_batched(lanes=2) over a mesh of two shards on
              cuda:0 (and over every card when there are more), both
              sinks, frames byte-identical to phase 3's CPU frames and
              digests to host_frame_digest, with deblock and both MC
              kernels launched on every shard, intra.cu on each of its
              steps with an intra mb, the level rounds never;
              decode_batch_sharded on the stream's two IDR frames over two
              shards against the CPU (phase 8's IDR, phase 3's frame);
              decode_stream_multihost in two processes on the card
              (torch.distributed, gloo on 127.0.0.1), one GOP each, their
              frames in rank order byte-identical to phase 3's.  Seconds
              and frames/s of each: two shards or two processes on one
              card measure no scaling.
 11. classes  every class of the port's stream corpus (edge264_tpu_torch/
              corpus.py: CAVLC, High 8x8 / scaling / PCM, explicit and
              implicit weights, temporal direct, multi-slice, deblocking
              off and at slice edges with alpha/beta offsets, long-term
              references, MMCO and list reordering, MVC, levels past
              int8, concealment, QP 0 and 51; two at 1080p) through
              decode_annexb and the lockstep driver (lanes=2) on cuda:
              frames, ids, crop, mb_errors and both MVC views
              byte-identical to the port's CPU path and, for the small
              classes, to backend="numpy" (the lockstep GOP by GOP; on the
              truncated class the lockstep to the CPU lockstep only); no
              plain version of a kernel on the card; intra.cu on frames
              with 8x8 and PCM mbs, deblock.cu with edges off inside a
              frame, every optional arena plane uploaded and a lockstep
              step sent as int16, each at least once.  The CPU goldens run
              in worker processes beside the card decodes.  One line a
              class: frames, seconds and launches of each path.
 12. report   per-stage device ms (unpack_planes among them) and frames/s
              of both paths, the wide stream's stages, then the `kernels`
              JSON line, the card's name and power limit, and the final
              JSON line.  Details also go to chiprun_out/chip_smoke.json.
"""

import contextlib
import io
import json
import os
import socket
import subprocess
import sys
import threading
import time
import types

import numpy as np
import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

from edge264_tpu_torch import cli, corpus, native, streams
from edge264_tpu_torch.api import decode_annexb, find_start_code
from edge264_tpu_torch.convert import ALIGN, CONDITIONAL, PLANE_KEYS, \
    planes_to_torch
from edge264_tpu_torch.kernels import build
from edge264_tpu_torch.native import EV_FRAME_DONE, NativeDecoder
from edge264_tpu_torch.ops import arena as A
from edge264_tpu_torch.ops import backend as BK
from edge264_tpu_torch.ops import batched as B
from edge264_tpu_torch.ops import deblock as D
from edge264_tpu_torch.ops import frame as F
from edge264_tpu_torch.ops import intra as I
from edge264_tpu_torch.ops import mc as M
from edge264_tpu_torch.ops import residual as R
from edge264_tpu_torch.parallel import batch as TB
from edge264_tpu_torch.parallel import decode_batch_sharded, make_decode_mesh
from edge264_tpu_torch.parallel.batch import decode_gops_batched
from edge264_tpu_torch.parallel.gop import decode_annexb_parallel, \
    split_gops

MBW, MBH, K, S = 120, 68, 2, 8
REPO = os.path.dirname(os.path.abspath(__file__))
HBM_BYTES_PER_S = 3.35e12        # H100 SXM device memory
SCALAR_OPS_PER_S = 67e12         # H100 SXM non-tensor 32-bit rate
OUT_DIR = "chiprun_out"
TRACE_TRIES = 3                  # traced runs before a short trace counts
QUEUE_SLEEP_CYCLES = 200_000_000  # ~0.1 s at the H100's 1.98 GHz


def log(msg):
    print(msg, flush=True)


def card():
    r = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                        "--format=csv,noheader"], capture_output=True,
                       text=True, check=True, timeout=60)
    return r.stdout.strip().splitlines()[0]


def cuda_ms(fn, reps):
    """Mean device ms of fn() over `reps` calls, after one warm-up call."""
    fn()
    torch.cuda.synchronize()
    total = 0.0
    for _ in range(reps):
        a, b = torch.cuda.Event(enable_timing=True), \
            torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        total += a.elapsed_time(b)
    return total / reps


# ---------------------------------------------------------------------------
# phase 1

def phase_build():
    t0 = time.perf_counter()
    box = {}
    th = threading.Thread(
        target=lambda: box.update(lib=native.build(force=True)))
    th.start()
    secs = build.build_all(force=True)
    th.join()
    if "lib" not in box:
        raise RuntimeError("native build failed")
    total = time.perf_counter() - t0
    for n, s in secs.items():
        log(f"[build] {n}.cu: nvcc {s:.1f} s")
        for ln in build.build_log[n].splitlines():
            if "registers" in ln or "Compiling entry" in ln:
                log(f"[build]   {ln.strip()}")
    log(f"[build] native front end + kernels: {total:.1f} s")
    return {"build_s": total, "nvcc_s": secs}


# ---------------------------------------------------------------------------
# phase 2: each kernel against its plain version at 1080p shapes

# (share of 16x8 pairs, share of split 8x8 blocks) for each forced arm
MC_ARMS = {None: (0.3, 0.3), "uniform": (0.0, 0.0), "pair": (1.0, 0.0),
           "quad": (0.0, 1.0), "unused": (0.3, 0.3)}


def mc_planes(rng, K, S, mbW, mbH, mvmax=300, arm=None):
    """_mk-style refslot / mvs planes (tests/test_torch_mc.py) for K
    lanes: per-8x8 uniform mvs up to +-mvmax quarter-pels (300 overshoots
    every edge, 2000 drives every arm to its clamps), 10% unused 8x8
    blocks, and with arm=None some 16x8 pairs and split blocks.  `arm`
    forces one kernel arm on every block: "uniform" (8x8), "pair" (16x8),
    "quad" (per 4x4 cell, with unused cells too) or "unused" (no list
    used)."""
    pair_p, sub_p = MC_ARMS[arm]
    BH, BW = 4 * mbH, 4 * mbW
    planes = []
    for _ in range(K):
        mv8 = rng.randint(-mvmax, mvmax + 1, (BH // 2, BW // 2, 2, 2))
        rs8 = rng.randint(0, S, (BH // 2, BW // 2, 2))
        rs8 = np.where(rng.rand(BH // 2, BW // 2, 2) < 0.1, -1, rs8)
        if arm == "unused":
            rs8[:] = -1
        pair = np.repeat(rng.rand(BH // 2, BW // 4) < pair_p, 2, 1)
        mv8 = np.where(pair[..., None, None], np.repeat(mv8[:, ::2], 2, 1),
                       mv8)
        rs8 = np.where(pair[..., None], np.repeat(rs8[:, ::2], 2, 1), rs8)
        mvs = np.repeat(np.repeat(mv8, 2, 0), 2, 1)
        sub = np.repeat(np.repeat(rng.rand(BH // 2, BW // 2) < sub_p, 2, 0),
                        2, 1)
        mvs = np.where(sub[..., None, None],
                       rng.randint(-mvmax, mvmax + 1, (BH, BW, 2, 2)), mvs)
        rs = np.repeat(np.repeat(rs8, 2, 0), 2, 1)
        if arm == "quad":
            rs = np.where(rng.rand(BH, BW, 2) < 0.1, -1, rs)
        planes.append({"refslot": rs, "mvs": mvs})
    return planes


def mc_case(dev, seed=7, K=K, mbW=MBW, mbH=MBH, S=S, **kw):
    """mc_planes(**kw) for K lanes on `dev`, with the planes combine_mc
    reads (no weighted prediction, every mb inter), slot maps sending DPB
    slot s to ring index S - s (so the last slot is read), and rings of
    S + 1 slots made by make_ref_planes from random frames.  Returns
    (planes, slot_maps, refL [K,S+1,4,ph,pw_b], refC
    [K,S+1,phc,2*pwc_pad])."""
    planes = mc_planes(np.random.RandomState(seed), K, S, mbW, mbH, **kw)
    for pl in planes:
        pl.update(wp=np.zeros((mbH, mbW, 24), np.int32),
                  wp8=np.zeros((2 * mbH, 2 * mbW, 2, 3, 2), np.int32),
                  mb_flags=np.full((mbH, mbW), 64 | 32, np.int32))
    p = planes_to_torch(planes, {"wp", "wp8"}, dev)
    smap = np.zeros((K, 32), np.int32)
    smap[:, :S] = np.arange(S, 0, -1)
    g = torch.Generator(device=dev).manual_seed(seed)
    H, W = 16 * mbH, 16 * mbW
    y = torch.randint(0, 256, (K * (S + 1), H, W), generator=g, device=dev,
                      dtype=torch.uint8)
    c = torch.randint(0, 256, (2, K * (S + 1), H // 2, W // 2), generator=g,
                      device=dev, dtype=torch.uint8)
    L, C = M.make_ref_planes(y, c[0], c[1])
    return (p, torch.as_tensor(smap, device=dev),
            L.reshape((K, S + 1) + L.shape[1:]),
            C.reshape((K, S + 1) + C.shape[1:]))


def mc_inputs(dev, seed=7, K=K, mbW=MBW, mbH=MBH, S=S, has_b=True, **kw):
    """One MC kernel input on `dev` (1080p, K=2 lanes, S=8 ring slots by
    default): mc_case(**kw) packed by pack_mc_params.  Returns {name:
    args} for mc_luma and mc_chroma, args = (flags [K,BR,BC], load word
    pairs [K,BR,BC*16], int32, ring band, n_lists), the arguments of the
    wrapper and of its plain version."""
    p, smap, L, C = mc_case(dev, seed, K, mbW, mbH, S, **kw)
    flg, pkl, pkc = M.pack_mc_params(p, smap, has_b, mbW, mbH)
    BR, BC = flg.shape[1], flg.shape[3]
    f3, n = flg.reshape(K, BR, BC), 2 if has_b else 1
    return {"mc_luma": (f3, pkl.reshape(K, BR, BC * 16),
                        L.reshape((K, -1) + L.shape[-2:]), n),
            "mc_chroma": (f3, pkc.reshape(K, BR, BC * 16), C, n)}


MC_PLAIN = {"mc_luma": M.mc_luma_plain, "mc_chroma": M.mc_chroma_plain}
# per arm of each MC kernel: (flag bits that select it, quadrant words
# used, ring rows and bytes a row read from each load word)
MC_SPANS = {"mc_luma": ((M._F_PAIR, 1, 8, 16), (M._F_UNIFORM, 1, 8, 8),
                        (0, 4, 4, 4)),
            "mc_chroma": ((M._F_UNIFORM, 1, 5, 10), (0, 4, 3, 6))}


def mc_sectors(name, flg, pk, band, n_lists):
    """Distinct 32-byte sectors of the ring that one call's used outputs
    read: per used load word pair its arm's rows and bytes (chroma's +1 row
    and +2 column bilinear neighbours included; luma reads two samples, A
    and B, chroma one footprint).  The sector floor of a gather from
    random offsets."""
    K, BR, BC = flg.shape
    _, n_pl, rows_pl, pitch = band.shape
    words = pk.reshape(K, BR, BC, 2, 4, 2)[:, :, :, :n_lists].long()
    f = flg.long()
    lane = torch.arange(K, device=flg.device)[:, None, None, None, None]
    luma = name == "mc_luma"
    taken = torch.zeros_like(f, dtype=torch.bool)
    if luma:
        taken |= (f & M._F_PAIRODD) != 0    # read by the even block's words
    ids = []
    for bits, nq, rows, width in MC_SPANS[name]:
        arm = ~taken & ((f & bits) != 0 if bits else True)
        taken |= arm
        for l in range(n_lists):
            used = arm & (((f >> l) & 1) == 1)
            pos = words[:, :, :, l, :nq, 0][..., None]      # [K,BR,BC,q,1]
            ring = words[:, :, :, l, :nq, 1][..., None]
            ok = (used[..., None, None] & (pos >= 0)).expand(
                pos.shape[:-1] + (rows,))
            r = torch.arange(rows, device=flg.device)
            for plane, wy, wx in M.load_fields(pos, ring, luma):
                start = ((lane * n_pl + plane) * rows_pl + wy + r) * pitch \
                    + wx
                for s in (start, start + width - 1):
                    ids.append((s >> 5)[ok])
    return int(torch.unique(torch.cat(ids)).numel())


def device_ms(name, fn, reps):
    """Mean device ms of one launch of kernel `name`: fn() run `reps`
    times under torch.profiler (after one warm-up call), the summed
    durations of the trace's events of the kernel's device function
    (SYMBOLS) over their number.  No host work is inside the number,
    unlike cuda_ms around a wrapper call.  The trace can lack some of a
    run's kernel events, so dividing by the launches would read low (a
    shortfall is logged), and at times it holds none: the traced run is
    then taken again, TRACE_TRIES times in all, and after that the
    launches are timed by queued_ms."""
    fn()
    torch.cuda.synchronize()
    for attempt in range(1, TRACE_TRIES + 1):
        n0 = COUNTED[name].launches
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        launches = COUNTED[name].launches - n0
        ev = [e for e in prof.events()
              if e.device_type == DeviceType.CUDA and SYMBOLS[name] in e.name]
        if launches != reps or len(ev) > reps:
            raise RuntimeError(f"{name}: {len(ev)} device events for "
                               f"{launches} launches of {reps} calls in the "
                               "trace")
        if ev:
            break
        log(f"[kernels] {name}: trace {attempt} of {TRACE_TRIES} holds no "
            f"device event of its {reps} launches")
    else:
        ms = queued_ms(fn, reps)
        log(f"[kernels] {name}: device_ms {ms:.4f} from CUDA events around "
            "queued launches")
        return ms
    if len(ev) < reps:
        log(f"[kernels] {name}: the trace holds {len(ev)} of {reps} device "
            f"events; device_ms is their mean")
    return sum(e.time_range.elapsed_us() for e in ev) / 1e3 / len(ev)


def queued_ms(fn, reps):
    """Mean device ms of fn() from a CUDA event pair around each of `reps`
    calls (after one warm-up call), all queued behind torch.cuda._sleep so
    that the device runs them back to back: the pairs then time the
    device work without the host's launch gaps.  If the sleep ran out
    before the last call was queued, it is taken again with a sleep twice
    as long, TRACE_TRIES times in all, and then raises."""
    fn()
    cycles = QUEUE_SLEEP_CYCLES
    for _ in range(TRACE_TRIES):
        pairs = [(torch.cuda.Event(enable_timing=True),
                  torch.cuda.Event(enable_timing=True)) for _ in range(reps)]
        torch.cuda.synchronize()
        torch.cuda._sleep(cycles)
        for a, b in pairs:
            a.record()
            fn()
            b.record()
        drained = pairs[0][0].query()
        torch.cuda.synchronize()
        if not drained:
            return sum(a.elapsed_time(b) for a, b in pairs) / reps
        cycles *= 2
    raise RuntimeError("queued_ms: the device drained the queue before "
                       "the last call was issued")


def deblock_inputs(dev, seed=11, K=K, mbW=MBW, mbH=MBH,
                   random_flags=False):
    """tests/test_pallas_deblock.py-style random frames and planes, 1080p
    by default (no mb edge flags on the frame border).  Every edge on and
    the 8x8 transform on the intra mbs; with random_flags, each mb's left,
    top and inner edge bits and its transform-8x8 bit at random (edges
    off inside the frame, as disable_deblocking_filter_idc 1 and 2 give).
    Returns (y, cb, cr, planes, bs_v, bs_h)."""
    g = torch.Generator(device=dev).manual_seed(seed)

    def ri(lo, hi, shape):
        return torch.randint(lo, hi, shape, generator=g, device=dev,
                             dtype=torch.int32)

    H, W = 16 * mbH, 16 * mbW
    if random_flags:
        db = ri(0, 8, (K, mbH, mbW))
        flags = ri(0, 2, (K, mbH, mbW)) | ri(0, 2, (K, mbH, mbW)) * 8
    else:
        db = torch.full((K, mbH, mbW), 7, dtype=torch.int32, device=dev)
        flags = ri(0, 2, (K, mbH, mbW)) * 9
    db[:, :, 0] &= ~1
    db[:, 0, :] &= ~2
    p = {"qp": ri(10, 45, (K, mbH, mbW, 4)),
         "deblock_ab": ri(-2, 3, (K, mbH, mbW, 2)), "deblock": db,
         "mb_flags": flags}
    return (ri(0, 255, (K, H, W)), ri(0, 255, (K, H // 2, W // 2)),
            ri(0, 255, (K, H // 2, W // 2)), p,
            ri(0, 5, (K, 4 * mbH, 4 * mbW)), ri(0, 5, (K, 4 * mbH, 4 * mbW)))


def intra_inputs(rng, K, mbW, mbH, t8=True, pcm=True, intra_share=1.0):
    """Random frames, residuals and planes for the intra kernel: every mb
    kind (I4x4, I16x16, PCM, inter, I8x8), random availability bits, and
    some directional modes outside the tables (they predict 0).  With
    intra_share < 1 all but that share of the mbs turn inter, as in a
    decode's P/B frames.  Returns numpy (planes, [y, cb, cr, res_y,
    res_cb, res_cr])."""
    H, W = 16 * mbH, 16 * mbW
    kinds = rng.randint(0, 5, (K, mbH, mbW))
    fl = np.choose(kinds, [1 | 32, 1 | 2 | 32, (1 | 4 if pcm else 1) | 32,
                           64 | 32, (1 | 8 if t8 else 1) | 32])
    if intra_share < 1:
        fl = np.where(rng.rand(K, mbH, mbW) < intra_share, fl, 64 | 32)
    p = {"mb_flags": fl,
         "i4_modes": rng.randint(0, 128, (K, 4 * mbH, 4 * mbW)),
         "i8_modes": rng.randint(0, 10, (K, 2 * mbH, 2 * mbW))
         | (rng.randint(0, 16, (K, 2 * mbH, 2 * mbW)) << 4),
         "i16_modes": rng.randint(0, 4, (K, mbH, mbW))
         | (rng.randint(0, 4, (K, mbH, mbW)) << 4),
         "ch_modes": rng.randint(0, 4, (K, mbH, mbW))
         | (rng.randint(0, 4, (K, mbH, mbW)) << 4),
         "pcm_y": rng.randint(0, 256, (K, H, W)),
         "pcm_c": rng.randint(0, 256, (K, 2, H // 2, W // 2))}
    frames = [rng.randint(0, 256, (K, H, W)),
              rng.randint(0, 256, (K, H // 2, W // 2)),
              rng.randint(0, 256, (K, H // 2, W // 2)),
              rng.randint(-40, 40, (K, H, W)),
              rng.randint(-40, 40, (K, H // 2, W // 2)),
              rng.randint(-40, 40, (K, H // 2, W // 2))]
    return p, frames


def intra_case(dev, seed, intra_share=1.0, K=K, mbW=MBW, mbH=MBH):
    """intra_inputs (1080p, K lanes by default) as int32 tensors on
    `dev`: (planes, [y, cb, cr, res_y, res_cb, res_cr])."""
    p, frames = intra_inputs(np.random.RandomState(seed), K, mbW, mbH,
                             intra_share=intra_share)
    return ({k: torch.as_tensor(v, dtype=torch.int32, device=dev)
             for k, v in p.items()},
            [torch.as_tensor(f, dtype=torch.int32, device=dev)
             for f in frames])


def check_equal(name, got, want):
    err = 0
    for a, b in zip(got, want):
        if a.shape != b.shape or a.dtype != b.dtype:
            raise AssertionError(f"{name}: {a.shape}/{a.dtype} vs "
                                 f"{b.shape}/{b.dtype}")
        err = max(err, int((a.to(torch.int64) - b.to(torch.int64))
                           .abs().max()))
    if err:
        raise AssertionError(f"{name}: kernel != plain, max |err| {err}")
    return err


def _shift(a, dy, dx):
    """a[..., y + dy, x + dx], False outside the mb grid."""
    out = np.zeros_like(a)
    H, W = a.shape[-2:]
    out[..., max(0, -dy):H - max(0, dy), max(0, -dx):W - max(0, dx)] = \
        a[..., max(0, dy):H + min(0, dy), max(0, dx):W + min(0, dx)]
    return out


def _edge_samples(pred, work, n, corner_from=None):
    """Samples of mbs without work that predicted mbs read, once each: an
    mb's right column (n) for the mb on its right, its bottom row (n) for
    the mb below, its bottom-right sample for the mb below-right, and (when
    `corner_from` is given) the first 8 of its bottom row for those mbs
    below-left (the top-right samples of I4x4 / I8x8)."""
    right, below = _shift(pred, 0, 1), _shift(pred, 1, 0)
    corner = _shift(pred, 1, 1)
    row = np.where(below, n, 0)
    if corner_from is not None:
        row = np.where(~below & _shift(corner_from, 1, -1), 8, row)
    per = (row + np.where(right, n, 0) - (right & below)
           + (corner & ~right & ~below))
    return int(np.where(work, 0, per).sum())


def intra_bytes(flags, has_t8=True, has_pcm=True):
    """Least bytes of one intra.cu call on these mb flags [K, mbH, mbW],
    every plane int32: the flag plane read once; per mb with luma work
    (intra.cu's kinds()) its 256 samples written, 256 residual or PCM
    samples read and the mode entries its kind uses (I4x4 16, I8x8 4,
    I16x16 1); per mb with chroma work its 2 x 64 samples written and
    2 x 64 residual or PCM samples read, and a predicted one's chroma mode;
    and once each, the samples of neighbouring mbs without work that
    predicted mbs read.  Mbs without work cost only their flag."""
    fl = np.asarray(flags)
    intra, i16 = (fl & 1) > 0, (fl & 2) > 0
    pcm, t8 = (fl & 4) > 0, (fl & 8) > 0
    l_pcm = pcm & bool(has_pcm)
    l_i16 = ~l_pcm & i16
    l_i8 = ~l_pcm & ~i16 & intra & t8 & ~pcm & bool(has_t8)
    l_i4 = ~l_pcm & ~i16 & ~l_i8 & intra & ~pcm & ~t8
    luma_pred = l_i16 | l_i8 | l_i4
    luma = luma_pred | l_pcm
    c_pred = intra & ~pcm
    chroma = c_pred | l_pcm
    samples = (fl.size + 512 * int(luma.sum()) + 256 * int(chroma.sum())
               + 16 * int(l_i4.sum()) + 4 * int(l_i8.sum())
               + int(l_i16.sum()) + int(c_pred.sum())
               + _edge_samples(luma_pred, luma, 16, l_i4 | l_i8)
               + 2 * _edge_samples(c_pred, chroma, 8))
    return 4 * samples


def mc_cost(name, flg, pk, band, n_lists):
    """(least bytes, integer operations, ring sectors, sector-floor bytes)
    of one MC call.  Least bytes: flags and load word pairs read once,
    the outputs written once, and per used output sample the distinct
    ring bytes it needs (luma: one sample of each of 2 half-pel planes;
    chroma: 1, the 2x2 footprints of neighbouring samples overlap).  The
    sector floor, an estimate: the same with the ring read in the 32-byte
    sectors that this data's offsets touch (mc_sectors)."""
    K, BR, BC = flg.shape
    fl = flg.cpu()
    used = sum(int(((fl >> l) & 1).sum()) for l in range(n_lists)) * 64
    luma = name == "mc_luma"
    samples = used if luma else used // 2
    words = flg.numel() * flg.element_size() + pk.numel() * pk.element_size()
    out_bytes = n_lists * K * (8 if luma else 4) * BR * 8 * BC
    sectors = mc_sectors(name, flg, pk, band, n_lists)
    return (words + out_bytes + (2 if luma else 1) * samples,
            12 * samples,         # address + filter integer ops / sample
            sectors, words + out_bytes + 32 * sectors)


def mc_reach(dev):
    """The load words' reach: the MC kernels' route (mc_predict: pack ->
    mc.cu -> combine) against mc_frame, the plain gathers that share no
    packing with it, at DCI 4K (K=1, 256x135 mbs) and with a 33-slot
    1080p ring (K=1), random vectors, exact; then each kernel against
    its plain version at the front end's widest row (1023x2 mbs) and
    tallest column (2x1056 mbs); then each kernel's device ms at phase
    7's geometry (K=1, 256x32 mbs) and on the 33-slot ring."""
    out = {}
    for label, kw in (("DCI 4K 256x135", dict(mbW=256, mbH=135)),
                      ("33-slot ring", dict(S=32))):
        p, smap, L, C = mc_case(dev, 19, K=1, **kw)
        mbW, mbH = kw.get("mbW", MBW), kw.get("mbH", MBH)
        n = M.mc_luma.launches, M.mc_chroma.launches
        got = M.mc_predict(p, smap, L, C, True, mbW, mbH)
        if (M.mc_luma.launches - n[0], M.mc_chroma.launches - n[1]) != (1, 1):
            raise AssertionError(f"MC route {label}: the kernels did not "
                                 "launch once each")
        out[label] = check_equal(f"MC route {label} vs mc_frame", got,
                                 M.mc_frame(p, L, C, smap, True))
        del p, smap, L, C, got
    for label, kw in (("1023x2", dict(mbW=1023, mbH=2)),
                      ("2x1056", dict(mbW=2, mbH=1056))):
        for name, args in mc_inputs(dev, 20, K=1, **kw).items():
            out[f"{name} {label}"] = check_equal(
                f"{name} {label}", COUNTED[name](*args),
                MC_PLAIN[name](*args))
    log("[kernels] MC route exact against mc_frame at DCI 4K (256x135 "
        "mbs) and on a 33-slot ring; mc_luma and mc_chroma exact against "
        "their plain versions at 1023x2 and 2x1056 mbs")
    for label, kw in (("4096x512", dict(mbW=WIDE_W, mbH=WIDE_H)),
                      ("33-slot ring", dict(S=32))):
        for name, args in mc_inputs(dev, 21, K=1, **kw).items():
            nbytes, _ops, sectors, sbytes = mc_cost(name, *args)
            r = out[f"{name} {label} K=1"] = dict(
                device_ms=device_ms(name, lambda: COUNTED[name](*args), 10),
                bytes=nbytes, sector_bytes=sbytes, ring_sectors=sectors)
            log(f"[kernels] {name} {label}, K=1: device "
                f"{r['device_ms']:.4f} ms; bound "
                f"{nbytes / HBM_BYTES_PER_S * 1e3:.4f} ms, sector floor "
                f"{sbytes / HBM_BYTES_PER_S * 1e3:.4f} ms")
    return out


def phase_kernels(dev):
    out = {}
    case = mc_inputs(dev)
    for name in ("mc_luma", "mc_chroma"):
        kern, plain, args = COUNTED[name], MC_PLAIN[name], case[name]
        err = check_equal(name, kern(*args), plain(*args))
        torch.cuda.synchronize()
        ms = cuda_ms(lambda: kern(*args), 20)
        dms = device_ms(name, lambda: kern(*args), 20)
        plain_ms = cuda_ms(lambda: plain(*args), 3)
        nbytes, ops, sectors, sector_bytes = mc_cost(name, *args)
        out[name] = dict(max_abs_err=err, ms=ms, device_ms=dms,
                         plain_ms=plain_ms, bytes=nbytes, ops=ops,
                         ring_sectors=sectors, sector_bytes=sector_bytes)
        log(f"[kernels] {name}: exact; {ms:.3f} ms (device {dms:.4f} ms) "
            f"vs plain {plain_ms:.3f} ms; {sectors} ring sectors, bound "
            f"{nbytes / HBM_BYTES_PER_S * 1e3:.4f} ms, sector floor "
            f"{sector_bytes / HBM_BYTES_PER_S * 1e3:.4f} ms")
    del case

    # K=8 (bench.py's lanes): times; then exact on K=8, an odd geometry,
    # the clamp input and one list
    case = mc_inputs(dev, 8, K=8)
    for name, args in case.items():
        check_equal(f"{name} K=8", COUNTED[name](*args),
                    MC_PLAIN[name](*args))
        out[name]["ms_k8"] = cuda_ms(lambda: COUNTED[name](*args), 20)
        out[name]["device_ms_k8"] = device_ms(
            name, lambda: COUNTED[name](*args), 20)
    del case, args
    for label, kw in (("K=3 5x3 mbs", dict(K=3, mbW=5, mbH=3)),
                      ("clamp", dict(mvmax=2000)),
                      ("one list", dict(has_b=False))):
        for name, args in mc_inputs(dev, 9, **kw).items():
            check_equal(f"{name} {label}", COUNTED[name](*args),
                        MC_PLAIN[name](*args))
    log(f"[kernels] K=8: mc_luma {out['mc_luma']['ms_k8']:.3f} ms (device "
        f"{out['mc_luma']['device_ms_k8']:.4f}), mc_chroma "
        f"{out['mc_chroma']['ms_k8']:.3f} ms (device "
        f"{out['mc_chroma']['device_ms_k8']:.4f}); MC exact at K=8, on "
        f"K=3 5x3 mbs, the clamp input (mvs to +-2000) and one list")
    out["mc_reach"] = mc_reach(dev)

    y, cb, cr, pd, bs_v, bs_h = deblock_inputs(dev)
    want = D.deblock_scan(y.clone(), cb.clone(), cr.clone(), pd, bs_v, bs_h,
                          MBW, MBH)
    got = D.deblock_batch(y.clone(), cb.clone(), cr.clone(), pd, bs_v, bs_h,
                          MBW, MBH)
    err = check_equal("deblock", got, want)
    frames = [(y.clone(), cb.clone(), cr.clone()) for _ in range(6)]
    it = iter(frames)
    ms = cuda_ms(lambda: D.deblock_batch(*next(it), pd, bs_v, bs_h, MBW,
                                         MBH), 5)
    # in place: each traced call filters a fresh copy (the copies are
    # other device functions, outside the kernel's sum)
    dms = device_ms("deblock", lambda: D.deblock_batch(
        y.clone(), cb.clone(), cr.clone(), pd, bs_v, bs_h, MBW, MBH), 5)
    plain_ms = cuda_ms(lambda: D.deblock_scan(y, cb, cr, pd, bs_v, bs_h,
                                              MBW, MBH), 1)
    # least bytes: every sample read and written once (int32), the
    # per-mb planes and per-block bS read once
    samples = y.numel() + cb.numel() + cr.numel()
    nbytes = 2 * 4 * samples + 4 * sum(t.numel() for t in (
        pd["qp"], pd["deblock_ab"], pd["deblock"], pd["mb_flags"], bs_v,
        bs_h))
    # operations: each bS > 0 4x4 edge segment of this data filters 4 luma
    # lines and at most 4 chroma lines, ~40 integer ops a line
    act = (bs_v > 0).sum() + (bs_h > 0).sum()
    ops = int(act) * 8 * 40
    out["deblock"] = dict(max_abs_err=err, ms=ms, device_ms=dms,
                          plain_ms=plain_ms, bytes=nbytes, ops=ops)
    log(f"[kernels] deblock: exact; {ms:.3f} ms (device {dms:.4f} ms) vs "
        f"plain {plain_ms:.3f} ms")
    # random edge and transform-8x8 bits: the kernel's edge-off arms
    y, cb, cr, pd, bs_v, bs_h = deblock_inputs(dev, 19, random_flags=True)
    check_equal("deblock random edge and t8 flags",
                D.deblock_batch(y.clone(), cb.clone(), cr.clone(), pd, bs_v,
                                bs_h, MBW, MBH),
                D.deblock_scan(y, cb, cr, pd, bs_v, bs_h, MBW, MBH))
    log("[kernels] deblock exact on random edge and transform-8x8 flags "
        "(1080p, K=2)")

    p, frames = intra_case(dev, 13)
    want = I.intra_scan_sheared(*frames, p, MBW, MBH)
    got = I.intra_batch(*[f.clone() for f in frames], p, MBW, MBH)
    err = check_equal("intra", got, want)
    copies = [[f.clone() for f in frames[:3]] + frames[3:]
              for _ in range(6)]
    it = iter(copies)
    ms = cuda_ms(lambda: I.intra_batch(*next(it), p, MBW, MBH), 5)
    dms = device_ms("intra", lambda: I.intra_batch(
        *[f.clone() for f in frames[:3]], *frames[3:], p, MBW, MBH), 5)
    plain_ms = cuda_ms(lambda: I.intra_scan_sheared(*frames, p, MBW, MBH), 1)
    nbytes = intra_bytes(p["mb_flags"].cpu().numpy())
    # operations: ~12 integer ops per reconstructed sample (3-tap sum or
    # DC/plane term, residual add, clip, address), 384 samples per mb of
    # this data's intra and PCM mbs
    n_intra = int(((p["mb_flags"] & 1) > 0).sum())
    ops = 12 * 384 * n_intra
    out["intra"] = dict(max_abs_err=err, ms=ms, device_ms=dms,
                        plain_ms=plain_ms, bytes=nbytes, ops=ops,
                        waves=MBW + 2 * MBH - 2)
    log(f"[kernels] intra: exact; {ms:.3f} ms (device {dms:.4f} ms) vs "
        f"plain {plain_ms:.3f} ms")

    # intra-sparse input: the level rounds (the lockstep route on P/B
    # steps) against the kernel on the same frames
    p, frames = intra_case(dev, 17, intra_share=0.05)
    tabs = [I.intra_round_plane(f, MBW, MBH)
            for f in p["mb_flags"].cpu().numpy()]
    if any(t is None for t in tabs):
        raise AssertionError("sparse intra input has no depth plane")
    R = max(t[1] for t in tabs)
    want = I.intra_rounds(*frames, p, None, MBW, MBH, R)
    got = I.intra_batch(*[f.clone() for f in frames], p, MBW, MBH)
    check_equal("intra sparse: kernel vs rounds", got, want)
    copies = [[f.clone() for f in frames[:3]] + frames[3:]
              for _ in range(11)]
    it = iter(copies)
    k_ms = cuda_ms(lambda: I.intra_batch(*next(it), p, MBW, MBH), 10)
    r_ms = cuda_ms(lambda: I.intra_rounds(*frames, p, None, MBW, MBH, R), 3)
    out["intra_sparse"] = dict(kernel_ms=k_ms, rounds_ms=r_ms, rounds=R,
                               intra_mbs=int(((p["mb_flags"] & 1) > 0)
                                             .sum()))
    log(f"[kernels] intra-sparse input ({out['intra_sparse']['intra_mbs']} "
        f"intra mbs, rounds{R}): kernel {k_ms:.3f} ms, level rounds "
        f"{r_ms:.3f} ms, equal")

    # K=8, bench.py's lanes: the kernels' times (1080p)
    y, cb, cr, pd, bs_v, bs_h = deblock_inputs(dev, 12, K=8)
    it = iter([(y.clone(), cb.clone(), cr.clone()) for _ in range(6)])
    out["deblock"]["ms_k8"] = cuda_ms(
        lambda: D.deblock_batch(*next(it), pd, bs_v, bs_h, MBW, MBH), 5)
    out["deblock"]["device_ms_k8"] = device_ms("deblock", lambda: (
        D.deblock_batch(y.clone(), cb.clone(), cr.clone(), pd, bs_v, bs_h,
                        MBW, MBH)), 5)
    p, frames = intra_case(dev, 14, K=8)
    it = iter([[f.clone() for f in frames[:3]] + frames[3:]
               for _ in range(6)])
    out["intra"]["ms_k8"] = cuda_ms(
        lambda: I.intra_batch(*next(it), p, MBW, MBH), 5)
    out["intra"]["device_ms_k8"] = device_ms("intra", lambda: I.intra_batch(
        *[f.clone() for f in frames[:3]], *frames[3:], p, MBW, MBH), 5)
    log(f"[kernels] K=8: deblock {out['deblock']['ms_k8']:.3f} ms (device "
        f"{out['deblock']['device_ms_k8']:.4f}), intra "
        f"{out['intra']['ms_k8']:.3f} ms (device "
        f"{out['intra']['device_ms_k8']:.4f})")
    del y, cb, cr, pd, bs_v, bs_h, p, frames, it

    # exact on an odd geometry and at K=16 (1088 row workers)
    for k_, w_, h_ in ((3, 3, 5), (16, MBW, MBH)):
        y, cb, cr, pd, bs_v, bs_h = deblock_inputs(dev, 15, k_, w_, h_)
        check_equal(f"deblock K={k_} {w_}x{h_}",
                    D.deblock_batch(y.clone(), cb.clone(), cr.clone(), pd,
                                    bs_v, bs_h, w_, h_),
                    D.deblock_scan(y, cb, cr, pd, bs_v, bs_h, w_, h_))
        del y, cb, cr, pd, bs_v, bs_h
        p, frames = intra_case(dev, 16, K=k_, mbW=w_, mbH=h_)
        check_equal(f"intra K={k_} {w_}x{h_}",
                    I.intra_batch(*[f.clone() for f in frames[:3]],
                                  *frames[3:], p, w_, h_),
                    I.intra_scan_sheared(*frames, p, w_, h_))
        del p, frames
        log(f"[kernels] deblock and intra exact at K={k_}, {w_}x{h_} mbs")
    # the front end's widest row, past the former 512-mb work mask
    p, frames = intra_case(dev, 18, K=1, mbW=1023, mbH=2)
    check_equal("intra K=1 1023x2",
                I.intra_batch(*[f.clone() for f in frames[:3]], *frames[3:],
                              p, 1023, 2),
                I.intra_scan_sheared(*frames, p, 1023, 2))
    del p, frames
    log("[kernels] intra exact at K=1, 1023x2 mbs")
    out.update(stage_kernels(dev))
    return out


# ---------------------------------------------------------------------------
# phase 2, continued: the four stage kernels (residual.cu, mcpack.cu,
# combine.cu, bs.cu) against their plain versions

def _i32(a, dev):
    return torch.as_tensor(np.ascontiguousarray(a), dtype=torch.int32,
                           device=dev)


def lane_views(a, dev, lead=3):
    """a [K, ...] int32 on `dev` as lane views of longer rows, each
    starting `lead` words in (12 bytes: off a 16-byte boundary), as the
    meta block's scaling matrices and slot maps are views of a step's
    arena rows."""
    K = a.shape[0]
    n = int(np.prod(a.shape[1:]))
    rows = torch.zeros((K, lead + n + 1), dtype=torch.int32, device=dev)
    rows[:, lead:lead + n] = _i32(a, dev).reshape(K, n)
    return rows[:, lead:lead + n].reshape(a.shape)


def residual_case(dev, seed, K, mbW=MBW, mbH=MBH):
    """Random residual inputs: every mb kind (I4x4, I16x16, I8x8, PCM,
    inter with and without the 8x8 transform, skip), levels up to +-40
    with 5% at +-2063, QP random with 0 and 51 in a fifth of the mbs, and
    random scaling matrices as lane views.  Returns (planes, sm4,
    sm8)."""
    rng = np.random.RandomState(seed)
    H, W = mbH, mbW

    def lv(shape):
        v = rng.randint(-40, 41, shape)
        return np.where(rng.rand(*shape) < 0.05,
                        rng.choice([-2063, 2063], shape), v)

    qp = rng.randint(0, 52, (K, H, W, 4))
    qp = np.where(rng.rand(K, H, W, 1) < 0.2,
                  rng.choice([0, 51], (K, H, W, 1)), qp)
    p = {"mb_flags": rng.choice([1 | 32, 1 | 2 | 32, 1 | 8 | 32, 1 | 4 | 32,
                                 64 | 32, 64 | 8 | 32, 64 | 16 | 32],
                                (K, H, W)),
         "qp": qp, "coef_y": lv((K, 4 * H, 4 * W, 16)),
         "coef_y8": lv((K, 2 * H, 2 * W, 64)),
         "coef_y_dc": lv((K, H, W, 16)), "coef_c_dc": lv((K, H, W, 2, 4)),
         "coef_cb": lv((K, 2 * H, 2 * W, 16)),
         "coef_cr": lv((K, 2 * H, 2 * W, 16))}
    return ({k: _i32(v, dev) for k, v in p.items()},
            lane_views(rng.randint(1, 256, (K, 6, 16)), dev),
            lane_views(rng.randint(1, 256, (K, 6, 64)), dev))


def bs_case(dev, seed, K, mbW=MBW, mbH=MBH):
    """Random bS inputs: intra, inter and 8x8-transform mbs, sparse
    nonzero counts, one, two or no reference slots a cell (0-3, so
    neighbours often share them) and vectors within +-8 (so differences
    fall on both sides of 4)."""
    rng = np.random.RandomState(seed)
    BH, BW = 4 * mbH, 4 * mbW
    p = {"mb_flags": rng.choice([1 | 32, 64 | 32, 64 | 8 | 32, 1 | 8 | 32,
                                 64 | 16 | 32], (K, mbH, mbW),
                                p=[0.1, 0.5, 0.2, 0.1, 0.1]),
         "nz_y": rng.randint(0, 4, (K, BH, BW)) * (rng.rand(K, BH, BW) < .2),
         "refslot": np.where(rng.rand(K, BH, BW, 2) < 0.3, -1,
                             rng.randint(0, 4, (K, BH, BW, 2))),
         "mvs": rng.randint(-8, 9, (K, BH, BW, 2, 2))}
    return {k: _i32(v, dev) for k, v in p.items()}


def combine_case(dev, seed, K, has_b=True, **kw):
    """mc_case's planes (slot maps as lane views) with every weighted
    prediction mode (0 default, 1 explicit, 2 implicit) and logWD 0-7 at
    random per mb, random wp8 weights and offsets, a fifth of the mbs
    intra and the rest inter, so inter mbs whose cells use no list are
    the orphans; and the MC kernels' per-list planes on them.  Returns
    (planes, slot maps, flat)."""
    p, smap, L, C = mc_case(dev, seed, K=K, **kw)
    rng = np.random.RandomState(seed)
    _, H, W = p["mb_flags"].shape
    wp = np.zeros((K, H, W, 24), np.int64)
    wp[..., 0] = rng.randint(0, 3, (K, H, W))
    wp[..., 1:3] = rng.randint(0, 8, (K, H, W, 2))
    p = dict(p, wp=_i32(wp, dev),
             wp8=_i32(rng.randint(-128, 128, (K, 2 * H, 2 * W, 2, 3, 2)),
                      dev),
             mb_flags=_i32(np.where(rng.rand(K, H, W) < 0.2, 1 | 32,
                                    64 | 32), dev))
    smap = lane_views(smap.cpu().numpy(), dev)
    flg, pkl, pkc = M.pack_mc_params(p, smap, has_b, W, H)
    return p, smap, M.run_mc_kernels(flg, pkl, pkc, L, C, has_b, W, H)


def stage_calls(dev, seed, K, mbW=MBW, mbH=MBH, **kw):
    """{name: (kernel call, plain call, least bytes, integer operations)}
    of the four stage kernels on one random input of K lanes, 1080p by
    default (the MC ones on mc_case's, arms and clamps per kw).  Least
    bytes: what the call's data needs read once and written once
    (residual: per mb its
    flags, qp, the 256 luma coefficients of the transform its flag
    selects, its Intra 16x16 DC where it has one, 8 chroma DC and 128
    chroma coefficients, and 384 samples out; bS: per 4x4 block its nz,
    slots and vectors in, 2 strengths out, and the mb flags; packing:
    each cell's slots and vectors and the slot maps in, the flags and 32
    words of every padded block out; combine: each cell's slots, the
    mb's 3 weight fields and the 8x8 block's 12 weights in, both lists'
    samples in and the samples and masks out)."""
    out = {}
    p, sm4, sm8 = residual_case(dev, seed, K, mbW, mbH)
    fl = p["mb_flags"].cpu().numpy()
    i16 = ((fl & 2) > 0) & ~((fl & 8) > 0)
    n_mb = fl.size
    nbytes = 4 * (n_mb * (1 + 4 + 256 + 8 + 128 + 384) + 16 * int(i16.sum())
                  + K * (96 + 384))
    out["residual"] = (lambda: R.residual_cuda(p, sm4, sm8, True),
                       lambda: R.residual_frame_plain(p, sm4, sm8, True),
                       nbytes, 16 * 384 * n_mb)
    out["residual_no_t8"] = (
        lambda: R.residual_cuda(p, sm4, sm8, False),
        lambda: R.residual_frame_plain(p, sm4, sm8, False), None, None)
    pb = bs_case(dev, seed + 1, K, mbW, mbH)
    cells = pb["nz_y"].numel()
    out["bs"] = (lambda: D.deblock_bs_cuda(pb),
                 lambda: D.deblock_bs_plain(pb),
                 4 * (cells * (1 + 2 + 4 + 2) + pb["mb_flags"].numel()),
                 60 * cells)
    pm, smap, _L, _C = mc_case(dev, seed + 2, K=K, mbW=mbW, mbH=mbH, **kw)
    smap = lane_views(smap.cpu().numpy(), dev)
    BR, BC = 2 * mbH, M._pack_dims(mbW)[1]
    cells = pm["refslot"].shape[0] * pm["refslot"][0, ..., 0].numel()
    out["mcpack"] = (
        lambda: M.pack_mc_params_cuda(pm, smap, True, mbW, mbH),
        lambda: M.pack_mc_params_plain(pm, smap, True, mbW, mbH),
        4 * (cells * 6 + K * 32 + K * BR * BC * 33), 150 * K * BR * BC)
    del _L, _C
    pc, smc, flat = combine_case(dev, seed + 3, K, mbW=mbW, mbH=mbH, **kw)
    cells = pc["refslot"].shape[0] * pc["refslot"][0, ..., 0].numel()
    out["combine"] = (
        lambda: M.combine_mc_cuda(pc, flat, True),
        lambda: M.combine_mc_plain(pc, smc, flat, True),
        cells * (8 + 2 * 4 * 24 + 4 * 24 + 24) + 4 * (
            3 * pc["mb_flags"].numel() + 12 * pc["wp8"][..., 0, 0, 0]
            .numel()), 20 * 24 * cells)
    return out


def stage_kernels(dev):
    """The four stage kernels against their plain versions, exact, at
    1080p: K=1 (the single-frame path) and K=8 (the lockstep cell) on
    random inputs with their extremes (levels +-2063, QP 0 and 51, every
    weighted-prediction mode, orphan inter cells, the 8x8 transform on
    and off), packing on every MC arm and at the clamps, with one list
    and two; each timed with CUDA events around the call (ms) and by its
    device time (device_ms) at K=1 and K=8, beside the plain version's
    time at K=1, its least bytes and integer operations."""
    res = {}
    for K_ in (1, 8):
        calls = stage_calls(dev, 30 + K_, K_)
        for name, (kern, plain, nbytes, ops) in calls.items():
            err = check_equal(f"{name} K={K_}", kern(), plain())
            if nbytes is None:
                continue
            r = res.setdefault(name, {"max_abs_err": err, "lanes": 1})
            r["max_abs_err"] = max(r["max_abs_err"], err)
            tag = "" if K_ == 1 else "_k8"
            r["ms" + tag] = cuda_ms(kern, 20)
            r["device_ms" + tag] = device_ms(name, kern, 20)
            r["bytes" + tag], r["ops" + tag] = nbytes, ops
            if K_ == 1:
                r["plain_ms"] = cuda_ms(plain, 3)
        del calls
    for label, kw in (("uniform", dict(arm="uniform")),
                      ("pair", dict(arm="pair")), ("quad", dict(arm="quad")),
                      ("unused", dict(arm="unused")),
                      ("clamp", dict(mvmax=2000))):
        for has_b in (True, False):
            pm, smap, L, C = mc_case(dev, 40, K=2, **kw)
            got = M.pack_mc_params_cuda(pm, smap, has_b, MBW, MBH)
            check_equal(f"mcpack {label} has_b={has_b}", got,
                        M.pack_mc_params_plain(pm, smap, has_b, MBW, MBH))
            flat = M.run_mc_kernels(*got, L, C, has_b, MBW, MBH)
            check_equal(f"combine {label} has_b={has_b}",
                        M.combine_mc_cuda(pm, flat, has_b),
                        M.combine_mc_plain(pm, smap, flat, has_b))
            pc, smc, flat = combine_case(dev, 41, 2, has_b, **kw)
            check_equal(f"combine weighted {label} has_b={has_b}",
                        M.combine_mc_cuda(pc, flat, has_b),
                        M.combine_mc_plain(pc, smc, flat, has_b))
            del pm, smap, L, C, got, flat, pc, smc
    for name, r in res.items():
        log(f"[kernels] {name}: exact at K=1 and K=8; {r['ms']:.3f} ms "
            f"(device {r['device_ms']:.4f}) vs plain {r['plain_ms']:.3f} ms "
            f"at K=1; K=8 {r['ms_k8']:.3f} ms (device "
            f"{r['device_ms_k8']:.4f}); bound "
            f"{r['bytes'] / HBM_BYTES_PER_S * 1e3:.4f} ms (K=1)")
    log("[kernels] mcpack and combine exact on every MC arm, at the clamps "
        "(mvs to +-2000), with one list and two; combine on every weighted "
        "prediction mode with orphan inter cells; residual with the 8x8 "
        "transform on and off")
    return res


# ---------------------------------------------------------------------------
# phase 3: the main path

# (module, stage functions called through it): both paths run the
# whole-frame routine (ops.frame._frame), whose MC route's stages are
# called from ops.mc (mc_predict); the step (ops.batched) and the
# single-frame backend (ops.backend) unpack the arena, emit and ring
FRAME_STAGES = (F, ("residual_frame", "intra_batch", "intra_rounds",
                    "deblock_bs", "deblock_batch", "blend_recovered"))
MC_STAGES = (M, ("pack_mc_params", "run_mc_kernels", "combine_mc",
                 "mc_frame"))
STAGES = ((B, ("unpack_planes", "_emit_aux", "make_ref_planes")),
          FRAME_STAGES, MC_STAGES)
STAGES_1 = ((F, FRAME_STAGES[1] + ("unpack_planes",)), MC_STAGES,
            (BK, ("make_ref_planes",)))


def dense_int32_bytes(layout, K):
    """The bytes convert.planes_to_torch would upload for the same step:
    every plane of the layout as int32, each start rounded up to 16
    bytes, and the meta block."""
    n = sum(-(-K * int(np.prod(shape)) // ALIGN) * ALIGN
            for _k, _dt, shape, _off, _m in layout)
    return 4 * (n + K * B.META_WORDS)


class PackMeter:
    """Wraps arena.pack_planes_batch (both decode paths call it through
    the module): per call the host ms (perf_counter), the arena's bytes
    (the one upload) and the int32 bytes planes_to_torch would have sent
    for the same layout."""

    def __enter__(self):
        self.calls = []
        self.saved = A.pack_planes_batch

        def timed(planes_list, *a, **kw):
            t0 = time.perf_counter()
            buf, layout, off = self.saved(planes_list, *a, **kw)
            self.calls.append(dict(
                ms=(time.perf_counter() - t0) * 1e3, bytes=buf.nbytes,
                dense_bytes=dense_int32_bytes(layout, len(planes_list)),
                pinned=buf.is_pinned()))
            return buf, layout, off
        A.pack_planes_batch = timed
        return self

    def __exit__(self, *exc):
        A.pack_planes_batch = self.saved

    def summary(self):
        c = self.calls
        return {"uploads": len(c),
                "arena_bytes": [x["bytes"] for x in c],
                "dense_int32_bytes": [x["dense_bytes"] for x in c],
                "pack_host_ms": [x["ms"] for x in c],
                "pinned": all(x["pinned"] for x in c)}


def log_pack(tag, unit, s):
    log(f"[{tag}] arena upload per {unit}: "
        + ", ".join(f"{b:,}" for b in s["arena_bytes"])
        + " bytes (planes_to_torch would send "
        + ", ".join(f"{b:,}" for b in s["dense_int32_bytes"])
        + "); pack host ms " + ", ".join(f"{m:.2f}" for m in
                                         s["pack_host_ms"]))


class StageTimer:
    """Wraps stage functions ((module, names) pairs: STAGES, STAGES_1)
    with CUDA events on the current stream; device ms per stage, no host
    sync."""

    def __init__(self, spec=STAGES):
        self.where = {n: m for m, names in spec for n in names}
        self.events = {n: [] for n in self.where}

    def __enter__(self):
        self.saved = {n: getattr(m, n) for n, m in self.where.items()}
        for n, fn in self.saved.items():
            setattr(self.where[n], n, self._wrap(n, fn))
        return self

    def _wrap(self, name, fn):
        def timed(*a, **kw):
            s, e = torch.cuda.Event(enable_timing=True), \
                torch.cuda.Event(enable_timing=True)
            s.record()
            r = fn(*a, **kw)
            e.record()
            self.events[name].append((s, e))
            return r
        return timed

    def __exit__(self, *exc):
        for n, fn in self.saved.items():
            setattr(self.where[n], n, fn)

    def ms(self):
        torch.cuda.synchronize()
        return {n: sum(s.elapsed_time(e) for s, e in ev)
                for n, ev in self.events.items()}


COUNTED = {"intra": I.intra_batch, "intra_rounds": I.intra_rounds,
           "deblock": D.deblock_batch, "mc_luma": M.mc_luma,
           "mc_chroma": M.mc_chroma, "residual": R.residual_cuda,
           "mcpack": M.pack_mc_params_cuda, "combine": M.combine_mc_cuda,
           "bs": D.deblock_bs_cuda}
KERNELS = ("intra", "deblock", "mc_luma", "mc_chroma", "residual", "mcpack",
           "combine", "bs")


def reset_counts():
    for fn in COUNTED.values():
        fn.launches = 0


def read_counts():
    """Launches per kernel wrapper, and calls of the level rounds (a
    route, not a kernel)."""
    return {n: fn.launches for n, fn in COUNTED.items()}


class RouteLog:
    """Records the route of each inter prediction: "kernels" for each
    run_mc_kernels call (pack_mc_params -> mc_luma + mc_chroma, the CUDA
    kernels on a card and their plain versions on the CPU) and "frame"
    for each mc_frame call (plain gathers, which no decode path takes);
    `launches`, after the block, the MC kernels' launches in it."""

    def __enter__(self):
        self.routes = []
        self.saved = (M.run_mc_kernels, M.mc_frame)
        self.n0 = (M.mc_luma.launches, M.mc_chroma.launches)

        def rec(fn, route):
            def wrapped(*a, **kw):
                self.routes.append(route)
                return fn(*a, **kw)
            return wrapped
        M.run_mc_kernels = rec(self.saved[0], "kernels")
        M.mc_frame = rec(self.saved[1], "frame")
        return self

    def __exit__(self, *exc):
        M.run_mc_kernels, M.mc_frame = self.saved
        self.launches = {"mc_luma": M.mc_luma.launches - self.n0[0],
                         "mc_chroma": M.mc_chroma.launches - self.n0[1]}


class IntraModes:
    """Wraps parallel.batch._intra_mode, the lockstep step's intra route
    choice on the host: each step's route and host ms.  plane_ms(), after
    the run, times on copies of the same flags the depth planes that the
    CPU route builds (intra_round_plane for every lane)."""

    def __enter__(self):
        self.modes, self.ms, self.flags = [], [], []
        self.saved = TB._intra_mode

        def rec(flags_list, mbW, mbH, on_cpu):
            t0 = time.perf_counter()
            mode = self.saved(flags_list, mbW, mbH, on_cpu)
            self.ms.append((time.perf_counter() - t0) * 1e3)
            self.modes.append(mode)
            self.flags.append(([np.array(f) for f in flags_list], mbW, mbH))
            return mode
        TB._intra_mode = rec
        return self

    def __exit__(self, *exc):
        TB._intra_mode = self.saved

    @property
    def non_skip(self):
        return sum(m != "skip" for m in self.modes)

    def plane_ms(self):
        out = []
        for flags_list, mbW, mbH in self.flags:
            t0 = time.perf_counter()
            for f in flags_list:
                I.intra_round_plane(f, mbW, mbH)
            out.append((time.perf_counter() - t0) * 1e3)
        return out


def check_no_plain(name, launches, routes, intra_steps=None):
    """The card ran no plain version of a kernel (routes: a RouteLog): no
    level rounds, no mc_frame, both MC kernels launched for every inter
    prediction and mcpack.cu and combine.cu with them, residual.cu and
    bs.cu once for every deblock.cu launch (one each a step or frame)
    and, where intra_steps is given, intra.cu once for each step or frame
    with intra work."""
    n = len(routes.routes)
    if launches["intra_rounds"] or "frame" in routes.routes \
            or routes.launches != {"mc_luma": n, "mc_chroma": n} \
            or launches["mcpack"] != launches["mc_luma"] \
            or launches["combine"] != launches["mc_luma"] \
            or launches["residual"] != launches["deblock"] \
            or launches["bs"] != launches["deblock"] \
            or intra_steps not in (None, launches["intra"]):
        raise AssertionError(
            f"{name} on cuda: launches {launches}, MC routes "
            f"{routes.routes} (MC launches {routes.launches}), "
            f"{intra_steps} steps with intra work")


def check_frames(name, want, got):
    if len(got) != len(want):
        raise AssertionError(f"{name}: {len(got)} frames, want {len(want)}")
    for i, (a, b) in enumerate(zip(want, got)):
        for c in ("y", "cb", "cr"):
            if not np.array_equal(getattr(a, c), getattr(b, c)):
                raise AssertionError(f"{name} frame {i} {c} differs")


def phase_decode():
    t0 = time.perf_counter()
    data = streams.avcgen().gen_random_cabac_ipb_stream(
        MBW, MBH, n_gops=2, seed=42, closed=True, gop_pb=1, density=0.05,
        max_level=4, intra_prob=0.05)
    log(f"[decode] stream: {len(data)} bytes, 2 closed GOPs IDR+P+B at "
        f"{16 * MBW}x{16 * MBH}, generated in "
        f"{time.perf_counter() - t0:.1f} s")
    res = {"stream_bytes": len(data)}

    # warm-up pass (kernel libraries loaded, allocator warm), not counted
    list(decode_gops_batched(data, lanes=2, sink="digest"))

    reset_counts()
    with PackMeter() as pm, RouteLog() as rl, IntraModes() as im:
        t0 = time.perf_counter()
        frames = list(decode_gops_batched(data, lanes=2))
        res["frames_s"] = time.perf_counter() - t0
    res["launches"] = read_counts()
    res["pack"] = pm.summary()
    res["mc_routes"] = rl.routes
    res["intra_modes"] = im.modes
    res["intra_mode_host_ms"] = im.ms
    res["depth_plane_host_ms"] = im.plane_ms()
    if rl.routes != ["kernels", "kernels"]:
        raise AssertionError(f"1080p lockstep MC routes {rl.routes}")
    if not res["pack"]["pinned"] or res["pack"]["uploads"] != 3:
        raise AssertionError(f"lockstep arena uploads: {res['pack']}")
    log_pack("decode", "step", res["pack"])
    check_no_plain("1080p lockstep", res["launches"], rl, im.non_skip)
    if not all(res["launches"][k] for k in KERNELS):
        raise AssertionError(f"a kernel never ran: {res['launches']}")
    log(f"[decode] intra route of each step {im.modes}: its host ms "
        + ", ".join(f"{m:.3f}" for m in im.ms) + " (the CPU route's depth "
        "planes on the same flags: " + ", ".join(
            f"{m:.3f}" for m in res["depth_plane_host_ms"]) + ")")

    reset_counts()
    with RouteLog() as rl, IntraModes() as im:
        t0 = time.perf_counter()
        digests = list(decode_gops_batched(data, lanes=2, sink="digest"))
        res["digest_s"] = time.perf_counter() - t0
    res["launches_digest"] = read_counts()
    check_no_plain("1080p lockstep, digest", res["launches_digest"], rl,
                   im.non_skip)

    with StageTimer() as st:
        t0 = time.perf_counter()
        list(decode_gops_batched(data, lanes=2, sink="digest"))
        res["timed_s"] = time.perf_counter() - t0
    res["stage_ms"] = st.ms()
    res["steps"] = len(st.events["residual_frame"])

    t0 = time.perf_counter()
    ref = list(decode_gops_batched(data, lanes=2, device="cpu"))
    res["cpu_s"] = time.perf_counter() - t0
    n = len(ref)
    if n != len(frames) or n != len(digests) or n != 6:
        raise AssertionError(f"frame counts {n} {len(frames)} "
                             f"{len(digests)}, want 6")
    for i, (a, b, d) in enumerate(zip(ref, frames, digests)):
        for c in ("y", "cb", "cr"):
            if not np.array_equal(getattr(a, c), getattr(b, c)):
                raise AssertionError(f"frame {i} {c}: cuda != cpu")
        if d.digest != B.host_frame_digest(b.y, b.cb, b.cr):
            raise AssertionError(f"frame {i}: device digest mismatch")
    res["frames"] = n
    pk = res["pack"]["pack_host_ms"]
    log(f"[decode] {n} frames byte-identical cuda vs cpu; digests match; "
        f"launches {res['launches']} beside a pack of "
        f"{sum(pk) / len(pk):.2f} host ms a step (K=2, the lane pool); MC "
        f"route of each inter step {res['mc_routes']}")
    return res, data, ref


# ---------------------------------------------------------------------------
# phase 4: the single-frame path

def phase_single(data, ref):
    res = {}
    list(decode_annexb(data))          # warm-up, not counted
    reset_counts()
    with PackMeter() as pm, RouteLog() as rl:
        t0 = time.perf_counter()
        frames = list(decode_annexb(data))
        res["frames_s"] = time.perf_counter() - t0
    res["launches"] = read_counts()
    res["pack"] = pm.summary()
    res["mc_routes"] = rl.routes
    if rl.routes != ["kernels"] * (len(ref) - 1):
        raise AssertionError(f"1080p decode_annexb MC routes {rl.routes}")
    if not res["pack"]["pinned"] or res["pack"]["uploads"] != len(ref):
        raise AssertionError(f"single-frame arena uploads: {res['pack']}")
    log_pack("single", "frame", res["pack"])
    check_no_plain("1080p decode_annexb", res["launches"], rl, len(ref))
    if not all(res["launches"][n] for n in KERNELS):
        raise AssertionError(f"a kernel never ran: {res['launches']}")
    if len(frames) != len(ref):
        raise AssertionError(f"{len(frames)} frames, want {len(ref)}")
    for i, (a, b) in enumerate(zip(ref, frames)):
        for c in ("y", "cb", "cr"):
            if not np.array_equal(getattr(a, c), getattr(b, c)):
                raise AssertionError(f"frame {i} {c}: decode_annexb on "
                                     f"cuda != lockstep cpu")
    with StageTimer(STAGES_1) as st:
        list(decode_annexb(data))
    res["stage_ms"] = st.ms()
    res["frames"] = len(frames)
    log(f"[single] {len(frames)} frames of decode_annexb on cuda "
        f"byte-identical to the cpu reference; launches {res['launches']}; "
        f"MC routes {res['mc_routes']}")

    # 5x3 mbs: K * 15 is no multiple of 4, yet every plane of the shared
    # upload buffer must start 16-byte aligned for the kernels' cp.async
    small = streams.avcgen().gen_random_cabac_ipb_stream(
        5, 3, n_gops=1, seed=3, closed=True, gop_pb=1, density=0.1,
        max_level=4, intra_prob=0.1)
    for name, run in (("decode_annexb", decode_annexb),
                      ("lockstep", lambda d, **kw: decode_gops_batched(
                          d, lanes=2, **kw))):
        want = list(run(small, device="cpu"))
        reset_counts()
        with RouteLog() as rl:
            got = list(run(small))
        check_no_plain(f"5x3 {name}", read_counts(), rl)
        if len(got) != len(want) or len(want) != 3:
            raise AssertionError(f"5x3 {name}: {len(got)} frames, want 3")
        for i, (a, b) in enumerate(zip(want, got)):
            for c in ("y", "cb", "cr"):
                if not np.array_equal(getattr(a, c), getattr(b, c)):
                    raise AssertionError(f"5x3 {name} frame {i} {c}: "
                                         f"cuda != cpu")
    log("[single] 5x3-mb stream: decode_annexb and lockstep (lanes=2) on "
        "cuda byte-identical to the cpu")
    return res


# ---------------------------------------------------------------------------
# phase 5: device busy and idle shares of both paths under torch.profiler

PROFILE_TOP = 12


def busy_us(events):
    """Length of the union of the device events' time intervals (us)."""
    iv = sorted((e.time_range.start, e.time_range.end) for e in events)
    total, end = 0.0, float("-inf")
    for a, b in iv:
        if b > end:
            total += b - max(a, end)
            end = b
    return total


# each kernel's device function, as the trace names it
SYMBOLS = {"intra": "intra_rows", "deblock": "deblock_rows",
           "mc_luma": "mc_luma", "mc_chroma": "mc_chroma",
           "residual": "residual_jobs", "mcpack": "pack_blocks",
           "combine": "combine_cells", "bs": "bs_blocks"}


def htod_copies(prof, name):
    """The trace's host-to-device copies as (label, bytes, us), label
    "Pinned" or "Pageable" as the profiler names the source memory.  The
    bytes are only in the exported trace's event arguments."""
    os.makedirs(OUT_DIR, exist_ok=True)
    path = os.path.join(OUT_DIR, f"trace_{name}.json")
    prof.export_chrome_trace(path)
    with open(path) as f:
        trace = json.load(f)
    os.remove(path)
    out = []
    for e in trace["traceEvents"]:
        n = e.get("name", "")
        if "Memcpy HtoD" in n:
            out.append(("Pinned" if "Pinned" in n else "Pageable",
                        int(e.get("args", {}).get("bytes", -1)),
                        float(e.get("dur", 0))))
    return out


def upload_check(name, copies, arena_bytes):
    """No arena upload of the run may be a pageable copy (arena.upload
    also refuses a pageable buffer, and PackMeter sees every packed
    buffer pinned).  The trace can lack some of a run's device events
    (phase 2 sees it for kernels), so arena uploads missing from it are
    logged, not failed.  Returns the copies' count, bytes and device ms
    by label, and the arena uploads found as pinned copies."""
    pinned = sorted(b for lab, b, _ in copies if lab == "Pinned")
    pageable = {b for lab, b, _ in copies if lab == "Pageable"}
    found = 0
    for b in arena_bytes:
        if b in pageable:
            raise AssertionError(f"{name}: an arena upload of {b} bytes "
                                 "is pageable")
        if b in pinned:
            pinned.remove(b)
            found += 1
    largest = sorted(copies, key=lambda c: -c[1])[:8]
    if found < len(arena_bytes):
        log(f"[profile] {name}: the trace holds {found} of "
            f"{len(arena_bytes)} arena uploads as pinned copies; its "
            f"largest host-to-device copies: {largest}")
    out = {lab: {"count": sum(1 for x in copies if x[0] == lab),
                 "bytes": sum(x[1] for x in copies if x[0] == lab),
                 "device_ms": sum(x[2] for x in copies if x[0] == lab)
                 / 1e3}
           for lab in ("Pinned", "Pageable")}
    out["arena_uploads"] = {"run": len(arena_bytes), "in_trace": found}
    out["largest"] = largest
    return out


def profiled(name, run):
    """One traced decode (the path already warm): wall ms with the device
    synchronized at both ends, device busy ms (the union of the kernel
    and copy intervals), the idle share 1 - busy / wall, the device ms of
    the top kernels by name, each kernel's device launches per wrapper
    call, and the host-to-device copies ("Memcpy HtoD") by source memory,
    every arena upload required pinned.  A trace that holds fewer of a
    kernel's device events than its wrapper calls (the trace can drop
    events) is taken again, TRACE_TRIES runs in all."""
    for attempt in range(1, TRACE_TRIES + 1):
        torch.cuda.synchronize()
        reset_counts()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof, \
                PackMeter() as pm:
            t0 = time.perf_counter()
            n = len(list(run()))
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        dev = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
        calls = read_counts()
        short = [k for k, sym in SYMBOLS.items()
                 if sum(1 for e in dev if sym in e.name) < calls[k]]
        if dev and not short:
            break
        log(f"[profile] {name}: trace {attempt} of {TRACE_TRIES} holds "
            f"{len(dev)} device events, fewer than the launches of "
            f"{short or 'any kernel'}")
    htod = upload_check(name, htod_copies(prof, name),
                        pm.summary()["arena_bytes"])
    if not dev:
        raise RuntimeError("the trace holds no device time")
    busy = busy_us(dev) / 1e3
    by_name = {}
    for e in dev:
        by_name[e.name] = by_name.get(e.name, 0.0) + e.time_range.elapsed_us()
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:PROFILE_TOP]
    per_call, kernel_ms = {}, {}
    for k, sym in SYMBOLS.items():
        ev = [e for e in dev if sym in e.name]
        kernel_ms[k] = sum(e.time_range.elapsed_us() for e in ev) / 1e3
        if calls[k]:
            per_call[k] = len(ev) / calls[k]
    return {"frames": n, "wall_ms": wall * 1e3, "device_busy_ms": busy,
            "idle_share": 1 - busy / (wall * 1e3),
            "device_events": len(dev),
            "top_kernels_ms": [(k[:80], v / 1e3) for k, v in top],
            "kernel_device_ms": kernel_ms, "htod": htod,
            "calls": calls, "device_launches_per_call": per_call}


def phase_profile(data):
    res = {}
    for name, run in (
            ("decode_gops_batched", lambda: decode_gops_batched(data,
                                                                lanes=2)),
            ("decode_annexb", lambda: decode_annexb(data))):
        res[name] = r = profiled(name, run)
        for k in KERNELS:
            if r["device_launches_per_call"].get(k) != 1:
                raise AssertionError(
                    f"{name}: {k} is not one device launch a call: "
                    f"{r['device_launches_per_call']}")
        log(f"[profile] {name}: device {100 * r['idle_share']:.1f}% idle "
            f"({r['device_busy_ms']:.1f} ms busy of {r['wall_ms']:.1f} ms "
            f"wall); top: " + ", ".join(f"{k[:40]} {v:.1f} ms"
                                        for k, v in r["top_kernels_ms"][:3])
            + f"; device launches a call {r['device_launches_per_call']}; "
            f"port kernels' device ms " + ", ".join(
                f"{k} {v:.3f}" for k, v in r["kernel_device_ms"].items()))
        log(f"[profile] {name}: Memcpy HtoD " + "; ".join(
            f"{lab} {r['htod'][lab]['count']} copies, "
            f"{r['htod'][lab]['bytes']:,} bytes, "
            f"{r['htod'][lab]['device_ms']:.3f} ms"
            for lab in ("Pinned", "Pageable"))
            + f"; arena uploads found pinned in the trace "
            f"{r['htod']['arena_uploads']['in_trace']} of "
            f"{r['htod']['arena_uploads']['run']}, none pageable")
    return res


# ---------------------------------------------------------------------------
# phase 6: the other entry points on the card

def phase_entry_points(data, ref):
    """decode_annexb_parallel (two worker threads, one GOP each) and the
    command-line app, both on cuda, against phase 3's CPU frames."""
    res = {}
    reset_counts()
    with RouteLog() as rl:
        t0 = time.perf_counter()
        got = list(decode_annexb_parallel(data, n_workers=2))
        res["parallel_s"] = time.perf_counter() - t0
    # two threads: the launch counts may lose an update, so only the
    # routes are checked here
    if read_counts()["intra_rounds"] or "frame" in rl.routes:
        raise AssertionError(f"decode_annexb_parallel on cuda: "
                             f"{read_counts()}, MC routes {rl.routes}")
    if len(got) != len(ref):
        raise AssertionError(f"parallel: {len(got)} frames, want {len(ref)}")
    for i, (a, b) in enumerate(zip(ref, got)):
        for c in ("y", "cb", "cr"):
            if not np.array_equal(getattr(a, c), getattr(b, c)):
                raise AssertionError(f"parallel frame {i} {c}: cuda != cpu")
    log(f"[entry] decode_annexb_parallel(n_workers=2): {len(got)} frames "
        f"byte-identical to the cpu reference, "
        f"{len(got) / res['parallel_s']:.2f} frames/s")

    os.makedirs(OUT_DIR, exist_ok=True)
    stream, yuv = (os.path.join(OUT_DIR, "smoke." + e) for e in ("264",
                                                                "yuv"))
    with open(stream, "wb") as f:
        f.write(data)
    with open(yuv, "wb") as f:
        for fr in ref:
            for c in ("y", "cb", "cr"):
                f.write(np.ascontiguousarray(getattr(fr, c)).tobytes())
    out = io.StringIO()
    reset_counts()
    with contextlib.redirect_stdout(out), RouteLog() as rl:
        rc = cli.main([stream, "-y", yuv, "-b"])
    check_no_plain("cli", read_counts(), rl)
    text = out.getvalue()
    os.remove(stream)
    os.remove(yuv)
    res["cli_rc"], res["cli_out"] = rc, text
    if rc != 0 or "PASS" not in text:
        raise AssertionError(f"cli: rc {rc}, output {text!r}")
    log("[entry] cli: " + " | ".join(ln.strip() for ln in text.splitlines()))
    return res


# ---------------------------------------------------------------------------
# phases 7-9: frames past the MC words, the whole-frame functions, the
# independent golden

WIDE_W, WIDE_H = 256, 32      # DCI 4K's width; the height cut to 32 rows


def phase_wide():
    """A 4096-wide CABAC IPB stream (one closed GOP, IDR + P + B, at
    bench.py's density, max_level and intra_prob) through decode_annexb
    and the lockstep driver (lanes=1) on cuda: the MC kernels on every
    inter step (mc_frame never), intra.cu on every step with an intra mb
    (the level rounds never), deblocking on every step.  Every frame
    byte-identical to the CPU path."""
    t0 = time.perf_counter()
    data = streams.avcgen().gen_random_cabac_ipb_stream(
        WIDE_W, WIDE_H, n_gops=1, seed=44, closed=True, gop_pb=1,
        density=0.05, max_level=4, intra_prob=0.05)
    res = {"stream_bytes": len(data), "gen_s": time.perf_counter() - t0}
    t0 = time.perf_counter()
    ref = list(decode_gops_batched(data, lanes=1, device="cpu"))
    res["cpu_s"] = time.perf_counter() - t0
    for name, run, spec in (
            ("decode_annexb", lambda: decode_annexb(data), STAGES_1),
            ("lockstep", lambda: decode_gops_batched(data, lanes=1),
             STAGES)):
        list(run())                    # warm-up, not counted
        reset_counts()
        with RouteLog() as rl, IntraModes() as im, StageTimer(spec) as st:
            t0 = time.perf_counter()
            frames = list(run())
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        launches = read_counts()
        if rl.routes != ["kernels", "kernels"] \
                or launches["deblock"] != len(ref):
            raise AssertionError(f"wide {name}: MC routes {rl.routes}, "
                                 f"launches {launches}")
        check_no_plain(f"wide {name}", launches, rl,
                       im.non_skip if name == "lockstep" else len(ref))
        check_frames(f"wide {name}", ref, frames)
        ms = st.ms()
        res[name] = {"routes": rl.routes, "launches": launches,
                     "intra_modes": im.modes, "stage_ms": ms,
                     "wall_s": wall, "frames": len(frames)}
        mc_ms = sum(ms[n] for n in MC_STAGES[1])
        log(f"[wide] {name} {16 * WIDE_W}x{16 * WIDE_H}: {len(frames)} "
            f"frames byte-identical to the cpu; MC route of each inter "
            f"step {rl.routes}; MC {mc_ms:.2f} ms (pack_mc_params "
            f"{ms['pack_mc_params']:.2f}, run_mc_kernels "
            f"{ms['run_mc_kernels']:.2f}, combine_mc {ms['combine_mc']:.2f},"
            f" mc_frame {ms['mc_frame']:.2f}), intra kernel "
            f"{ms['intra_batch']:.2f} ms (level rounds "
            f"{ms['intra_rounds']:.2f}), deblock kernel "
            f"{ms['deblock_batch']:.2f} ms over the decode; launches "
            f"{launches}")
    return res


def decoded_planes(data, n=None):
    """The completed frames of a stream in decode order, the first n (or
    all): (a snapshot of the native planes, every key of PLANE_KEYS with
    mb_w / mb_h, sm4 [6,16], sm8 [6,64] (batched.scaling8), DPB slot,
    is_ref) each."""
    nd = NativeDecoder()
    out = []

    def pump(nal):
        ret, events = nd.decode_nal(nal)
        for kind, slot, _a, is_ref, _c, _d in events:
            if kind == EV_FRAME_DONE:
                pl = nd.planes(slot)
                snap = types.SimpleNamespace(
                    mb_w=pl.mb_w, mb_h=pl.mb_h,
                    **{k: np.array(getattr(pl, k)) for k in PLANE_KEYS})
                out.append((snap, np.asarray(pl.sm4, np.int32).copy(),
                            B.scaling8(pl.sm8), slot, bool(is_ref)))
        while (info := nd.get_frame()) is not None:
            nd.return_frame(info["slot"])
        return ret

    pos = find_start_code(data, 0)
    while pos < len(data) and (n is None or len(out) < n):
        end = find_start_code(data, pos + 3)
        pump(data[pos + 3:end])
        pos = end
    while (n is None or len(out) < n) and pump(b"") == 105:
        pass                          # ENOBUFS: drain the rest
    nd.close()
    return out[:n]


def phase_frame(data, dev):
    """The whole-frame functions (ops/frame.py) on phase 3's first IDR
    and P frame at 1080p: decode_frame, then decode_frame_inter from a
    one-slot ring of the IDR, on cuda against the CPU."""
    (p0, sm4a, sm8a, *_), (p1, sm4b, sm8b, *_) = decoded_planes(data, 2)
    out, res = {}, {}
    for tag, d in (("cpu", torch.device("cpu")), ("cuda", dev)):
        def t(a):
            return torch.as_tensor(a, device=d)[None]
        reset_counts()
        with RouteLog() as rl:
            t0 = time.perf_counter()
            idr = F.decode_frame(planes_to_torch([p0], CONDITIONAL, d),
                                 t(sm4a), t(sm8a), MBW, MBH)
            l4, ch = M.make_ref_planes(*idr)
            # every DPB slot (the IDR's among them) -> ring index 0
            smap = torch.zeros((1, 32), dtype=torch.int32, device=d)
            p = F.decode_frame_inter(planes_to_torch([p1], CONDITIONAL, d),
                                     t(sm4b), t(sm8b), l4[:, None],
                                     ch[:, None], smap, MBW, MBH)
            out[tag] = [a.cpu() for a in idr + p]
            res[tag + "_s"] = time.perf_counter() - t0
        res[tag + "_launches"] = read_counts()
        res[tag + "_routes"] = rl.routes
    launches = res["cuda_launches"]
    if res["cuda_routes"] != ["kernels"] or launches["intra_rounds"] or any(
            launches[k] != n for k, n in (
                ("intra", 2), ("deblock", 2), ("residual", 2), ("bs", 2),
                ("mc_luma", 1), ("mc_chroma", 1), ("mcpack", 1),
                ("combine", 1))):
        raise AssertionError(f"decode_frame on cuda: routes "
                             f"{res['cuda_routes']}, launches {launches}")
    for i, (a, b) in enumerate(zip(out["cpu"], out["cuda"])):
        if not torch.equal(a, b):
            raise AssertionError(f"decode_frame plane {i}: cuda != cpu")
    log(f"[frame] decode_frame (IDR) and decode_frame_inter (P, MC route "
        f"{res['cuda_routes']}) at {16 * MBW}x{16 * MBH} on cuda "
        f"byte-identical to the cpu; launches {launches}")
    return res, out["cpu"][:3]


def phase_oracle():
    """The independent golden: a CIF-class CABAC IPB stream (22x18 mbs,
    IDR + 2 x (P + B)) decoded by the scalar numpy oracle on the host
    (backend="numpy", no code shared with the port's tensor path);
    decode_annexb and the lockstep driver on cuda byte-identical to it,
    and the lockstep driver with a 33-slot ring (the MC kernels on every
    inter step, mc_frame never) on cuda and on the CPU."""
    data = streams.avcgen().gen_random_cabac_ipb_stream(
        22, 18, n_gops=1, seed=5, closed=True, gop_pb=2, density=0.05,
        max_level=4, intra_prob=0.05)
    t0 = time.perf_counter()
    gold = list(decode_annexb(data, backend="numpy"))
    res = {"oracle_s": time.perf_counter() - t0, "frames": len(gold)}
    if len(gold) != 5:
        raise AssertionError(f"oracle: {len(gold)} frames, want 5")
    log(f"[oracle] numpy backend: {len(gold)} frames of 352x288 in "
        f"{res['oracle_s']:.1f} s on the host")
    reset_counts()
    with RouteLog() as rl:
        check_frames("oracle: decode_annexb on cuda", gold,
                     list(decode_annexb(data)))
        check_frames("oracle: lockstep on cuda", gold,
                     list(decode_gops_batched(data, lanes=2)))
    res["launches"] = read_counts()
    check_no_plain("oracle", res["launches"], rl)
    saved = TB.RING_SLOTS
    TB.RING_SLOTS = 32
    try:
        check_frames("oracle: lockstep, 33-slot ring, cpu", gold,
                     list(decode_gops_batched(data, lanes=1, device="cpu")))
        reset_counts()
        with RouteLog() as rl, IntraModes() as im:
            got = list(decode_gops_batched(data, lanes=1))
        res["ring33_launches"] = read_counts()
    finally:
        TB.RING_SLOTS = saved
    res["ring33_routes"] = rl.routes
    if rl.routes != ["kernels"] * 4:
        raise AssertionError(f"33-slot ring: routes {rl.routes}, launches "
                             f"{res['ring33_launches']}")
    check_no_plain("33-slot ring", res["ring33_launches"], rl, im.non_skip)
    check_frames("oracle: lockstep, 33-slot ring, cuda", gold, got)
    log(f"[oracle] decode_annexb and lockstep on cuda byte-identical to "
        f"the oracle (launches {res['launches']}); a 33-slot lockstep ring "
        f"takes {rl.routes} on cuda (launches {res['ring33_launches']}), "
        f"byte-identical on cuda and cpu")
    return res


# ---------------------------------------------------------------------------
# phase 10: the multi-device paths

class ShardCounts:
    """Wraps batched.decode_batch_step, which decode_batch_step_sharded
    calls once a shard in shard order: each kernel's launches (read_counts)
    summed by shard, and each shard's steps with intra work (a route
    other than "skip": "intra_steps")."""

    def __init__(self, n):
        self.n = n

    def __enter__(self):
        self.saved = B.decode_batch_step
        self.per = [dict.fromkeys(COUNTED, 0) | {"intra_steps": 0}
                    for _ in range(self.n)]
        self.calls = 0

        def rec(*a, **kw):
            before = read_counts()
            out = self.saved(*a, **kw)
            after = read_counts()
            shard = self.per[self.calls % self.n]
            self.calls += 1
            for k in COUNTED:
                shard[k] += after[k] - before[k]
            shard["intra_steps"] += kw["intra_mode"] != "skip"
            return out
        B.decode_batch_step = rec
        return self

    def __exit__(self, *exc):
        B.decode_batch_step = self.saved


# One process of decode_stream_multihost: joins a gloo process group on
# 127.0.0.1, decodes its share and saves its frames.  Arguments: port,
# rank, world, lanes, device ("cuda" for the default), stream file, output
# file.
MULTIHOST_WORKER = r"""
import sys
import numpy as np
import torch.distributed as dist
from edge264_tpu_torch.ops import intra as I
from edge264_tpu_torch.ops import mc as M
from edge264_tpu_torch.parallel.distributed import decode_stream_multihost
port, rank, world, lanes, device, stream, out = sys.argv[1:8]
dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                        rank=int(rank), world_size=int(world))
with open(stream, "rb") as f:
    data = f.read()
mc_frame_calls = []
real_mc_frame = M.mc_frame
M.mc_frame = lambda *a, **kw: (mc_frame_calls.append(1)
                              or real_mc_frame(*a, **kw))
frames = list(decode_stream_multihost(
    data, lanes=int(lanes), device=None if device == "cuda" else device))
dist.barrier()
dist.destroy_process_group()
counts = [I.intra_batch.launches, M.mc_luma.launches,
          I.intra_rounds.launches, len(mc_frame_calls)]
np.savez(out, n=len(frames), counts=np.array(counts),
         **{f"{c}{i}": getattr(fr, c) for i, fr in enumerate(frames)
            for c in ("y", "cb", "cr")})
"""
# the order of a MULTIHOST_WORKER process's `counts`
MULTIHOST_COUNTS = ("intra", "mc_luma", "intra_rounds", "mc_frame")


def run_multihost(data, world, lanes, device, workdir, timeout):
    """Decode `data` with decode_stream_multihost in `world` processes
    (torch.distributed on gloo, 127.0.0.1, a free port); each process gets
    `timeout` seconds, then is killed.  Returns (per rank its frames as
    (y, cb, cr) arrays, per rank {name: count} of MULTIHOST_COUNTS: its
    kernel launches, level-rounds calls and mc_frame calls); raises with
    the processes' output if one fails."""
    os.makedirs(workdir, exist_ok=True)
    stream = os.path.join(workdir, "stream.264")
    with open(stream, "wb") as f:
        f.write(data)
    with socket.socket() as sk:
        sk.bind(("127.0.0.1", 0))
        port = sk.getsockname()[1]
    path = [REPO] + [p for p in os.environ.get("PYTHONPATH", "").split(
        os.pathsep) if p]
    env = dict(os.environ, GLOO_SOCKET_IFNAME="lo",
               PYTHONPATH=os.pathsep.join(path))
    outs = [os.path.join(workdir, f"rank{r}.npz") for r in range(world)]
    logs = [open(os.path.join(workdir, f"rank{r}.log"), "w+")
            for r in range(world)]
    # LOCAL_RANK / LOCAL_WORLD_SIZE as torchrun sets them: each process's
    # default device is its own card (all on one card share it)
    procs = [subprocess.Popen(
        [sys.executable, "-c", MULTIHOST_WORKER, str(port), str(r),
         str(world), str(lanes), device, stream, outs[r]], cwd=REPO,
        env=dict(env, LOCAL_RANK=str(r), LOCAL_WORLD_SIZE=str(world)),
        stdout=logs[r], stderr=subprocess.STDOUT) for r in range(world)]
    rcs = []
    try:
        for pr in procs:
            rcs.append(pr.wait(timeout=timeout))
    except subprocess.TimeoutExpired:
        rcs.append("timeout")
    finally:
        for pr in procs:
            if pr.poll() is None:
                pr.kill()
                pr.wait()
    text = []
    for r, lg in enumerate(logs):
        lg.seek(0)
        text.append(f"--- rank {r} ---\n{lg.read()[-4000:]}")
        lg.close()
    if rcs != [0] * world:
        raise RuntimeError(f"decode_stream_multihost processes: {rcs}\n"
                           + "\n".join(text))
    frames, counts = [], []
    for o in outs:
        with np.load(o) as z:
            frames.append([tuple(z[f"{c}{i}"] for c in ("y", "cb", "cr"))
                           for i in range(int(z["n"]))])
            counts.append(dict(zip(MULTIHOST_COUNTS,
                                   (int(v) for v in z["counts"]))))
        os.remove(o)
    os.remove(stream)
    return frames, counts


def phase_mesh(data, ref, idr_cpu, gpu):
    """The multi-device paths on the card against phase 3's CPU frames:
    the lockstep driver over meshes, decode_batch_sharded, and
    decode_stream_multihost in two processes."""
    res = {}
    meshes = [("2 shards on cuda:0", make_decode_mesh(["cuda:0", "cuda:0"]))]
    if torch.cuda.device_count() > 1:
        meshes.append((f"{torch.cuda.device_count()} cards",
                       make_decode_mesh()))
    n_gops = len(ref) // 3
    for label, mesh in meshes:
        lanes = max(2, mesh.size)
        list(decode_gops_batched(data, lanes=lanes, mesh=mesh,
                                 sink="digest"))       # warm-up, not counted
        reset_counts()
        with ShardCounts(mesh.size) as sc, RouteLog() as rl:
            t0 = time.perf_counter()
            frames = list(decode_gops_batched(data, lanes=lanes, mesh=mesh))
            secs = time.perf_counter() - t0
        launches = read_counts()
        check_frames(f"mesh {label}", ref, frames)
        check_no_plain(f"mesh {label}", launches, rl)
        # every shard that holds a GOP runs every kernel, intra.cu on each
        # of its steps with intra work, and never the level rounds
        for i, per in enumerate(sc.per[:n_gops]):
            if not all(per[k] for k in KERNELS) or per["intra_rounds"] \
                    or per["intra"] != per["intra_steps"]:
                raise AssertionError(f"mesh {label}: shard {i} launches "
                                     f"{per}")
        reset_counts()
        with RouteLog() as rl:
            t0 = time.perf_counter()
            digests = list(decode_gops_batched(data, lanes=lanes, mesh=mesh,
                                               sink="digest"))
            dsecs = time.perf_counter() - t0
        check_no_plain(f"mesh {label}, digest", read_counts(), rl)
        if len(digests) != len(ref):
            raise AssertionError(f"mesh {label}: {len(digests)} digests")
        for i, (a, d) in enumerate(zip(ref, digests)):
            if d.digest != B.host_frame_digest(a.y, a.cb, a.cr):
                raise AssertionError(f"mesh {label} frame {i}: digest")
        res[label] = {"lanes": lanes, "devices": [str(d) for d in
                                                  mesh.devices],
                      "frames_s": secs, "digest_s": dsecs,
                      "launches": launches, "shard_launches": sc.per}
        for i, per in enumerate(sc.per):
            log(f"[mesh] {label}, shard {i} ({mesh.devices[i]}): launches "
                f"{per}")
        log(f"[mesh] {label}, lanes={lanes}: {len(frames)} frames "
            f"byte-identical to the cpu, digests match; {secs:.2f} s, "
            f"{len(frames) / secs:.2f} frames/s (sink=frames), "
            f"{len(frames) / dsecs:.2f} (sink=digest) ({gpu}; shards on one "
            f"card run one after another: no scaling measured)")

    # the frame batch: the stream's two IDR frames, one a shard
    idrs = [f for f in decoded_planes(data)
            if (np.asarray(f[0].mb_flags) & 1).all()][:2]
    if len(idrs) != 2 or not all(np.array_equal(idrs[0][j], idrs[1][j])
                                 for j in (1, 2)):
        raise AssertionError("frame batch: want two IDR frames sharing "
                             "their scaling matrices")
    p = {k: np.stack([np.asarray(getattr(f[0], k)) for f in idrs])
         for k in PLANE_KEYS}
    p["coef_c_dc"] = p["coef_c_dc"].reshape(2, MBH, MBW, 2, 4)
    reset_counts()
    t0 = time.perf_counter()
    got = decode_batch_sharded(p, idrs[0][1], idrs[0][2], MBW, MBH,
                               make_decode_mesh(["cuda:0", "cuda:0"]))
    torch.cuda.synchronize()
    bsecs = time.perf_counter() - t0
    blaunch = read_counts()
    if blaunch["intra"] != 2 or blaunch["deblock"] != 2 \
            or blaunch["intra_rounds"]:
        raise AssertionError(f"frame batch launches {blaunch}")
    for c, (want, parts) in enumerate(zip(idr_cpu, got)):
        if not torch.equal(parts[0].cpu(), want):
            raise AssertionError(f"frame batch shard 0 plane {c}: cuda != "
                                 "phase 8's cpu")
    h, w = ref[3].y.shape           # the second GOP's IDR, cropped
    for c, parts in zip(("y", "cb", "cr"), got):
        hc, wc = (h, w) if c == "y" else (h // 2, w // 2)
        if not np.array_equal(parts[1][0, :hc, :wc].cpu().numpy(),
                              getattr(ref[3], c)):
            raise AssertionError(f"frame batch shard 1 {c}: cuda != phase "
                                 "3's cpu frame")
    res["frame_batch"] = {"s": bsecs, "launches": blaunch}
    log(f"[mesh] decode_batch_sharded: 2 IDR frames over 2 shards on cuda:0 "
        f"byte-identical to the cpu; {bsecs:.3f} s, {2 / bsecs:.2f} "
        f"frames/s ({gpu}; two shards on one card: no scaling measured); "
        f"launches {blaunch}")

    # two processes, one GOP each
    t0 = time.perf_counter()
    per_rank, counts = run_multihost(data, 2, 1, "cuda",
                                     os.path.join(OUT_DIR, "multihost"), 300)
    msecs = time.perf_counter() - t0
    check_frames("decode_stream_multihost", ref,
                 [types.SimpleNamespace(y=y, cb=cb, cr=cr)
                  for frames in per_rank for y, cb, cr in frames])
    for r, c in enumerate(counts):
        if c["intra_rounds"] or c["mc_frame"] or not c["intra"] \
                or not c["mc_luma"]:
            raise AssertionError(f"decode_stream_multihost rank {r}: {c}")
    res["multihost"] = {"s": msecs, "frames": [len(f) for f in per_rank],
                        "counts": counts}
    log(f"[mesh] decode_stream_multihost, 2 processes on cuda:0: "
        f"{[len(f) for f in per_rank]} frames by rank, byte-identical to the "
        f"cpu in rank order, counts by rank {counts}; {msecs:.2f} s from "
        f"spawn to exit, "
        f"{len(ref) / msecs:.2f} frames/s ({gpu}; two processes on one card: "
        f"no scaling measured)")
    return res


# ---------------------------------------------------------------------------
# phase 11: every stream class of the corpus through both paths

OPTIONAL_PLANES = ("coef_y8", "i8_modes", "pcm_y", "pcm_c", "mb_errors",
                   "slice_id", "wp", "wp8")
CLASS_WORKERS = 5                # CPU golden processes (the card has 8 cores)


def class_goldens(name):
    """In a worker process: the class's stream and its CPU goldens, the
    port's CPU paths (device="cpu") and, for the small classes, the numpy
    oracle (backend="numpy") on the stream and on each of its GOPs alone
    (what the lockstep's fresh decoder a GOP decodes).  The 1080p
    classes are one GOP each, so their CPU lockstep is the golden of both
    card paths."""
    torch.set_num_threads(2 if name in corpus.CARD_CLASSES else 1)
    t0 = time.perf_counter()
    data = corpus.build(name)
    out = {"data": data, "gen_s": time.perf_counter() - t0}
    t0 = time.perf_counter()
    out["cpu_lockstep"] = list(decode_gops_batched(data, lanes=2,
                                                   device="cpu"))
    if name in corpus.CARD_CLASSES:
        out["cpu_single"] = out["cpu_lockstep"]
    else:
        out["cpu_single"] = list(decode_annexb(data, device="cpu"))
        out["numpy"] = list(decode_annexb(data, backend="numpy"))
        gops = split_gops(data)
        out["numpy_by_gop"] = out["numpy"] if len(gops) == 1 else [
            f for g in gops for f in decode_annexb(g, backend="numpy")]
    out["cpu_s"] = time.perf_counter() - t0
    return out


def check_views(name, want, got):
    """Frame count, frame ids, crop, mb_errors and both MVC views."""
    if len(got) != len(want) or not want:
        raise AssertionError(f"{name}: {len(got)} frames, want {len(want)}")
    for i, (a, b) in enumerate(zip(want, got)):
        if (a.frame_id, a.frame_id_mvc, a.crop_offsets) != \
                (b.frame_id, b.frame_id_mvc, b.crop_offsets):
            raise AssertionError(f"{name} frame {i}: ids or crop differ")
        for c in ("y", "cb", "cr", "y_mvc", "cb_mvc", "cr_mvc",
                  "mb_errors"):
            x, y = getattr(a, c), getattr(b, c)
            if (x is None) != (y is None) or (
                    x is not None and not np.array_equal(x, y)):
                raise AssertionError(f"{name} frame {i} {c} differs")


class ArmLog:
    """Records, for each card launch of intra.cu and deblock.cu through
    the whole-frame routine (ops.frame), the arms its planes reach:
    has_t8 / has_pcm with an intra-8x8 / PCM mb in the frame, and deblock
    edges off inside the frame (some mb edge or inner edge bit clear
    away from the border) with or without edges on beside them.  Each
    arena packed in the block: its present optional planes, and whether
    its levels went as int16 (`int16_tags`: the tag of each run that
    packed one)."""

    def __init__(self):
        self.intra_t8 = self.intra_pcm = 0
        self.deblock_off = self.deblock_mixed = 0
        self.planes = set()
        self.int16_tags = set()
        self.tag = None

    def __enter__(self):
        self.saved = (F.intra_batch, F.deblock_batch, A.pack_planes_batch)

        def intra(y, cb, cr, res_y, res_cb, res_cr, p, mbW, mbH,
                  has_t8=True, has_pcm=True):
            if y.is_cuda:
                fl = p["mb_flags"]
                self.intra_t8 += has_t8 and bool(
                    ((fl & 9) == 9).any())
                self.intra_pcm += has_pcm and bool(((fl & 4) > 0).any())
            return self.saved[0](y, cb, cr, res_y, res_cb, res_cr, p, mbW,
                                 mbH, has_t8, has_pcm)

        def deblock(y, cb, cr, p, bs_v, bs_h, mbW, mbH):
            if y.is_cuda:
                db = p["deblock"]
                off = torch.cat([(db[:, :, 1:] & 1).flatten() == 0,
                                 (db[:, 1:, :] & 2).flatten() == 0,
                                 (db & 4).flatten() == 0])
                self.deblock_off += bool(off.any())
                self.deblock_mixed += bool(off.any() and not off.all())
            return self.saved[1](y, cb, cr, p, bs_v, bs_h, mbW, mbH)

        def pack(planes_list, *a, **kw):
            buf, layout, off = self.saved[2](planes_list, *a, **kw)
            for k, dt, _shape, o, _m in layout:
                if o == -1:
                    continue
                self.planes.add(k)
                if k in A.COEF_PLANES and dt == "int16":
                    self.int16_tags.add(self.tag)
            return buf, layout, off
        F.intra_batch, F.deblock_batch, A.pack_planes_batch = \
            intra, deblock, pack
        return self

    def __exit__(self, *exc):
        F.intra_batch, F.deblock_batch, A.pack_planes_batch = self.saved


def phase_classes():
    """Every class of the port's stream corpus (edge264_tpu_torch/
    corpus.py: CAVLC, High 8x8 / scaling / PCM, weighted prediction,
    multi-slice and deblocking off, long-term references, MVC, levels past
    int8, concealment; two at 1080p) through decode_annexb and the
    lockstep driver (lanes=2) on cuda.  Every frame byte-identical to the
    port's CPU path and, for the small classes, to the numpy oracle (the
    lockstep to the oracle GOP by GOP; on the truncated class the lockstep
    only to the CPU lockstep: it does not blend recovered mbs); no plain
    version of a kernel on the card.  The goldens are computed in worker
    processes while the card decodes."""
    import multiprocessing
    from concurrent.futures import ProcessPoolExecutor, as_completed

    names = corpus.CARD_CLASSES + corpus.CPU_CLASSES   # longest first
    res = {}
    t_phase = time.perf_counter()
    with ArmLog() as arms, ProcessPoolExecutor(
            CLASS_WORKERS,
            mp_context=multiprocessing.get_context("spawn")) as ex:
        futs = {ex.submit(class_goldens, n): n for n in names}
        for fut in as_completed(futs):
            name = futs[fut]
            gold = fut.result()
            data = gold["data"]
            row = {"frames": len(gold["cpu_single"]),
                   "gen_s": gold["gen_s"], "cpu_s": gold["cpu_s"]}
            for path, run, want, oracle in (
                    ("decode_annexb", lambda: decode_annexb(data),
                     gold["cpu_single"], gold.get("numpy")),
                    ("lockstep",
                     lambda: decode_gops_batched(data, lanes=2),
                     gold["cpu_lockstep"],
                     None if name == "truncated_concealment"
                     else gold.get("numpy_by_gop"))):
                arms.tag = (name, path)
                reset_counts()
                with RouteLog() as rl, IntraModes() as im:
                    t0 = time.perf_counter()
                    got = list(run())
                    torch.cuda.synchronize()
                    secs = time.perf_counter() - t0
                launches = read_counts()
                check_no_plain(f"{name} {path}", launches, rl,
                               im.non_skip if path == "lockstep" else None)
                if not (launches["intra"] and launches["deblock"]):
                    raise AssertionError(f"{name} {path}: launches "
                                         f"{launches}")
                check_views(f"{name} {path}: cuda vs cpu", want, got)
                if oracle is not None:
                    check_views(f"{name} {path}: cuda vs numpy", oracle,
                                got)
                row[path] = {"s": secs, "launches": launches}
            res[name] = row
            log(f"[classes] {name}: {row['frames']} frames, byte-identical"
                f" to the cpu" + ("" if name in corpus.CARD_CLASSES
                                  else " and the numpy oracle")
                + f"; decode_annexb {row['decode_annexb']['s']:.2f} s "
                f"{row['decode_annexb']['launches']}, lockstep "
                f"{row['lockstep']['s']:.2f} s "
                f"{row['lockstep']['launches']}; cpu goldens "
                f"{row['cpu_s']:.1f} s")
    missing = set(OPTIONAL_PLANES) - arms.planes
    if missing or not (arms.intra_t8 and arms.intra_pcm
                       and arms.deblock_off and arms.deblock_mixed) \
            or not any(tag[1] == "lockstep" for tag in arms.int16_tags
                       if tag):
        raise AssertionError(
            f"classes: arms not reached: planes never uploaded {missing}, "
            f"intra.cu with an i8 / PCM frame {arms.intra_t8} / "
            f"{arms.intra_pcm}, deblock.cu with edges off inside "
            f"{arms.deblock_off} (beside edges on {arms.deblock_mixed}), "
            f"int16 arenas {arms.int16_tags}")
    summary = {"intra_launches_t8": arms.intra_t8,
               "intra_launches_pcm": arms.intra_pcm,
               "deblock_launches_edges_off": arms.deblock_off,
               "deblock_launches_mixed": arms.deblock_mixed,
               "optional_planes": sorted(set(OPTIONAL_PLANES)
                                         & arms.planes),
               "int16_runs": sorted(map(list, arms.int16_tags)),
               "s": time.perf_counter() - t_phase}
    log(f"[classes] {len(names)} classes in {summary['s']:.1f} s: intra.cu "
        f"on {arms.intra_t8} launches with i8 mbs and {arms.intra_pcm} "
        f"with PCM mbs, deblock.cu on {arms.deblock_off} with edges off "
        f"inside the frame ({arms.deblock_mixed} beside edges on), every "
        f"optional plane uploaded, int16 levels in "
        f"{summary['int16_runs']}")
    return {"classes": res, "summary": summary}


def main():
    if not torch.cuda.is_available():
        sys.exit("chip_smoke: no CUDA device")
    t_start = time.perf_counter()
    dev = torch.device("cuda")
    kind = torch.cuda.get_device_name(0)
    gpu = card()
    log(f"[card] {gpu}; torch {torch.__version__} cuda {torch.version.cuda}")
    report = {"card": gpu, "build": phase_build()}
    report["kernels"] = phase_kernels(dev)
    dec, data, ref = phase_decode()
    report["decode"] = dec
    report["single"] = one = phase_single(data, ref)
    report["profile"] = phase_profile(data)
    report["entry_points"] = phase_entry_points(data, ref)
    report["wide"] = wide = phase_wide()
    report["frame"], idr_cpu = phase_frame(data, dev)
    report["oracle"] = phase_oracle()
    report["mesh"] = phase_mesh(data, ref, idr_cpu, gpu)
    report["classes"] = phase_classes()

    steps = dec["steps"]
    for n, v in dec["stage_ms"].items():
        log(f"[stage] lockstep {n}: {v / steps:.2f} ms/step ({gpu})")
    log(f"[stage] lockstep sum: {sum(dec['stage_ms'].values()) / steps:.2f}"
        f" ms/step ({gpu})")
    for n, v in one["stage_ms"].items():
        log(f"[stage] single-frame {n}: {v / one['frames']:.2f} ms/frame "
            f"({gpu})")
    log(f"[stage] single-frame sum: "
        f"{sum(one['stage_ms'].values()) / one['frames']:.2f} ms/frame "
        f"({gpu})")
    log(f"[decode] lockstep intra route host ms a step: "
        f"{sum(dec['intra_mode_host_ms']) / steps:.3f} (the CPU route's "
        f"depth planes on the same flags: "
        f"{sum(dec['depth_plane_host_ms']) / steps:.3f}) ({gpu})")
    for path in ("decode_annexb", "lockstep"):
        w = wide[path]
        log(f"[stage] wide {path}: " + ", ".join(
            f"{n} {v:.2f}" for n, v in w["stage_ms"].items())
            + f" ms over {w['frames']} frames ({gpu})")
    log(f"[decode] lockstep frames/s: {dec['frames'] / dec['frames_s']:.2f} "
        f"(sink=frames), {dec['frames'] / dec['digest_s']:.2f} "
        f"(sink=digest), cpu reference {dec['frames'] / dec['cpu_s']:.3f} "
        f"({gpu})")
    log(f"[single] decode_annexb frames/s: "
        f"{one['frames'] / one['frames_s']:.2f} ({gpu})")
    log(f"[classes] {len(report['classes']['classes'])} corpus classes "
        f"through both paths in {report['classes']['summary']['s']:.1f} s "
        f"({gpu})")
    for tag, r, unit in (("decode", dec, "step"), ("single", one, "frame")):
        p = r["pack"]
        log(f"[{tag}] arena {sum(p['arena_bytes']) / p['uploads']:,.0f} "
            f"bytes a {unit} (planes_to_torch "
            f"{sum(p['dense_int32_bytes']) / p['uploads']:,.0f}), pack "
            f"{sum(p['pack_host_ms']) / p['uploads']:.2f} host ms a {unit}"
            f" ({gpu})")

    rows = []
    for name, src, repl in (
            ("intra", "edge264_tpu_torch/kernels/csrc/intra.cu",
             "edge264_tpu/ops/pallas_intra.py:118"),
            ("deblock", "edge264_tpu_torch/kernels/csrc/deblock.cu",
             "edge264_tpu/ops/pallas_deblock.py:265"),
            ("mc_luma", "edge264_tpu_torch/kernels/csrc/mc.cu",
             "edge264_tpu/ops/pallas_mc.py:253"),
            ("mc_chroma", "edge264_tpu_torch/kernels/csrc/mc.cu",
             "edge264_tpu/ops/pallas_mc.py:339"),
            # the plain stages (XLA in the JAX package, no Pallas kernel)
            ("residual", "edge264_tpu_torch/kernels/csrc/residual.cu",
             "edge264_tpu/ops/jaxdec.py:203"),
            ("mcpack", "edge264_tpu_torch/kernels/csrc/mcpack.cu",
             "edge264_tpu/ops/pallas_mc.py:118"),
            ("combine", "edge264_tpu_torch/kernels/csrc/combine.cu",
             "edge264_tpu/ops/pallas_mc.py:523"),
            ("bs", "edge264_tpu_torch/kernels/csrc/bs.cu",
             "edge264_tpu/ops/jaxdec.py:1271")):
        k = report["kernels"][name]
        t_bytes = k["bytes"] / HBM_BYTES_PER_S * 1e3
        t_ops = k["ops"] / SCALAR_OPS_PER_S * 1e3
        rows.append({"name": name, "route": "cuda", "source": src,
                     "replaces": repl, "launches": dec["launches"][name],
                     "launches_decode_annexb": one["launches"][name],
                     "launches_classes": sum(
                         r[p]["launches"][name]
                         for r in report["classes"]["classes"].values()
                         for p in ("decode_annexb", "lockstep")),
                     "max_abs_err": k["max_abs_err"], "ms": k["ms"],
                     "device_ms": k["device_ms"], "ms_k8": k["ms_k8"],
                     "device_ms_k8": k["device_ms_k8"],
                     "plain_ms": k["plain_ms"],
                     "ms_lanes": k.get("lanes", K),
                     "bound_ms": max(t_bytes, t_ops),
                     "bound_by": "bytes" if t_bytes >= t_ops
                     else "operations",
                     "library_ms": None,
                     "device_launches_per_call": report["profile"][
                         "decode_annexb"]["device_launches_per_call"][name]})
    os.makedirs(OUT_DIR, exist_ok=True)
    with open(os.path.join(OUT_DIR, "chip_smoke.json"), "w") as f:
        json.dump(dict(report, rows=rows), f, indent=1, default=str)
    log(f"[report] chip_smoke.py ran {time.perf_counter() - t_start:.0f} s")
    print(json.dumps({"kernels": rows}))
    print(gpu)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
