"""K-lane lockstep GOP decoding on one device or over a mesh of devices.

A stream splits into closed GOPs (independent by construction); K of them
decode in LOCKSTEP: every device step processes one frame from each lane
as one batched step (ops/batched.decode_batch_step), so every stage is one
batched call for all K.  A group holds consecutive GOPs of one frame size
and crop (the step's lanes share one layout); the JAX package's driver
does not split, and decodes a group of mixed sizes wrongly.  Host entropy for the K lanes runs on worker
threads (the C++ front end releases the GIL), overlapped with the
previous step's device work.

Within a lane, frames decode in order (P/B need their references'
pixels); lanes that exhaust their GOP early idle out with all-zero steps
until the group drains.  MVC streams ride the same machinery: each
view-frame is one step (base first, then the non-base view referencing
it), and output pairs the views per access unit.

The lane axis is also the multi-device axis: with a mesh
(parallel/mesh.py) each shard holds a contiguous block of K/n lanes, its
rings and its step on its own device; GOP lanes are reference-closed, so
the shards exchange nothing.  The step's lanes are still packed into one
buffer with one layout, and each shard's block of rows goes to its
device.

Port of `parallel/batch.py`.
"""

from __future__ import annotations

import itertools
import threading

import numpy as np
import torch

from ..api import Frame, find_start_code, pixel_device
from ..native import EV_FORMAT, EV_FRAME_DONE, EV_UNPIN, NativeDecoder
from ..ops import arena as A
from ..ops import batched as B
from ..ops.intra import intra_round_plane
from ..ops.tables import MBF_BLEND, MBF_INTRA, MBF_IPCM, MBF_T8x8
from .gop import split_gops
from .mesh import DecodeMesh

RING_SLOTS = 8      # initial per-lane reference ring slots (grows by doubling)


class _Lane:
    """One GOP's native front end, pumped frame-by-frame.

    Drives decode_nal until EV_FRAME_DONE, then exposes the completed
    slot's planes for the batched device step; out_frames collects the
    output order."""

    def __init__(self, stream: bytes, S: int):
        self.nd = NativeDecoder()
        self.stream = stream
        self.pos = find_start_code(stream, 0) + 3
        self.done_slots = []      # (slot, frame_id, is_ref|is_mvc_base)
        self.out_frames = []      # get_frame info dicts in output order
        self.ring_map = {}        # DPB slot -> ring index
        self.S = S
        self.ring_free = list(range(S))
        self.slot_ring = np.zeros(32, np.int32)
        self.finished = False
        self.fmt = None
        self.store = {}           # frame_id -> (step, lane) into step_out
        # outputs are taken with borrow=True so their DPB slots stay
        # PINNED (plane memory intact) until their step has uploaded them,
        # which makes it safe to parse the NEXT frame on a worker thread
        self.fid_step = {}        # frame_id -> index into done_slots
        self.unreturned = []      # borrowed infos awaiting upload

    def _pump_events(self, events):
        for kind, slot, a, b, _c, _d in events:
            if kind == EV_FORMAT:
                self.fmt = self.nd.format()
            elif kind == EV_FRAME_DONE:
                self.fid_step[a] = len(self.done_slots)
                self.done_slots.append((slot, a, b))
            elif kind == EV_UNPIN:
                i = self.ring_map.pop(slot, None)
                if i is not None and i != self.S:   # S = write-off slot
                    self.ring_free.append(i)

    def _drain_output(self):
        while (info := self.nd.get_frame(borrow=True)) is not None:
            self.out_frames.append(info)
            self.unreturned.append(info)

    def parse_next_frame(self):
        """Advance the bitstream until one more frame completes (appends
        to done_slots) or the stream ends."""
        want = len(self.done_slots) + 1
        stall = 0
        while len(self.done_slots) < want:
            if self.pos >= len(self.stream):
                if self.finished:
                    return False
                ret, events = self.nd.decode_nal(b"")
                self._pump_events(events)
                self._drain_output()
                if ret != 105:          # != ENOBUFS: fully drained
                    self.finished = True
                continue
            end = find_start_code(self.stream, self.pos)
            ret, events = self.nd.decode_nal(self.stream[self.pos:end])
            self._pump_events(events)
            self._drain_output()
            if ret == 105:
                stall += 1
                if stall > 64:
                    return False
            else:
                stall = 0
                self.pos = end + 3
        return True


class DigestFrame:
    """Per-frame record yielded by sink="digest": the pixels stay in device
    memory; `digest` is the 64-bit device checksum (two uint32 words),
    equal to ops.batched.host_frame_digest of the frame."""

    __slots__ = ("frame_id", "digest", "frame_id_mvc", "digest_mvc")

    def __init__(self, frame_id, digest):
        self.frame_id = frame_id
        self.digest = digest
        self.frame_id_mvc = None
        self.digest_mvc = None


def _return_packed(ln: _Lane, step: int):
    """Release output borrows whose planes were uploaded at done index
    <= step (both views for MVC pairs).  Must run while the lane's parse
    thread is idle (native calls are not synchronized against
    decode_nal)."""
    still = []
    for info in ln.unreturned:
        s = ln.fid_step.get(info["frame_id"], 1 << 30)
        if info["slot_mvc"] >= 0:
            s = max(s, ln.fid_step.get(info["frame_id_mvc"], 1 << 30))
        if s <= step:
            ln.nd.return_frame(info["slot"])
            if info["slot_mvc"] >= 0:
                ln.nd.return_frame(info["slot_mvc"])
        else:
            still.append(info)
    ln.unreturned = still


def _to_host(t):
    """Start copying a step's output to host memory without waiting for
    the device (pinned buffer); CPU tensors are already there."""
    if t.device.type == "cpu":
        return t
    h = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
    h.copy_(t, non_blocking=True)
    return h


def decode_gops_batched(stream: bytes, *, lanes: int = 4, mesh=None,
                        sink: str = "frames", device=None):
    """Decode a whole Annex-B stream with its closed GOPs in K-lane
    lockstep; returns an iterator of frames in stream order.

    device: None -> "cuda" (raises when no CUDA device is present);
    pass device="cpu" to run the plain versions on the CPU.
    mesh: a parallel.mesh.DecodeMesh to split the lanes over (then
    `device` must be None, and `lanes` a multiple of the mesh size); a
    group short of `lanes` GOPs is padded with dead lanes, which emit
    nothing.
    sink="frames": Frames with host numpy planes.
    sink="digest": the frames stay on the device; yields DigestFrames
    carrying the 64-bit device checksum of each frame."""
    if mesh is None:
        mesh = DecodeMesh((pixel_device(device),))
        pad = False
    else:
        if device is not None:
            raise ValueError("pass either mesh or device, not both")
        if lanes % mesh.size:
            raise ValueError(f"lanes={lanes} is not a multiple of the mesh "
                             f"size {mesh.size}")
        pad = True
    if sink not in ("frames", "digest"):
        raise ValueError(f"sink={sink!r}")
    if lanes < 1:
        raise ValueError(f"lanes={lanes}")
    return _decode_all(split_gops(stream), lanes, sink, mesh, pad)


def _geometry(ln: _Lane):
    """A lane's frame size and crop once its first frame is parsed; None
    for a lane that decoded nothing."""
    f = ln.fmt
    if f is None or not ln.done_slots:
        return None
    return (f["mb_w"], f["mb_h"], f["crop_top"], f["crop_right"],
            f["crop_bottom"], f["crop_left"])


def _decode_all(gops, lanes, sink, mesh, pad):
    """Groups of up to `lanes` consecutive GOPs of one geometry, in stream
    order.  The lanes of a step share one arena layout, one ring and one
    crop, so a GOP whose frame size or crop differs from the group's
    starts the next group.  The geometry is the first frame's, so each
    candidate lane parses its first frame here (on worker threads, as the
    group would); a lane cut off keeps it and leads the next group."""
    todo = iter(gops)
    ready = []              # lanes with their first frame parsed
    while True:
        fresh = [_Lane(g, RING_SLOTS)
                 for g in itertools.islice(todo, lanes - len(ready))]
        threads = [threading.Thread(target=ln.parse_next_frame)
                   for ln in fresh]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        ready += fresh
        if not ready:
            return
        geoms = [_geometry(ln) for ln in ready]
        first = next((g for g in geoms if g is not None), None)
        n = next((i for i, g in enumerate(geoms)
                  if g is not None and g != first), len(ready))
        group, ready = ready[:n], ready[n:]
        if pad:
            # the shards split the full lane count: missing GOPs become
            # dead lanes (empty streams decode to nothing)
            group += [_Lane(b"", RING_SLOTS)
                      for _ in range(lanes - len(group))]
        yield from _decode_group(group, sink, mesh)


def _intra_mode(flags_list, mbW, mbH, on_cpu):
    """The step's intra route from the live lanes' mb_flags.  On the CPU,
    from their depth planes (intra_round_plane), as the JAX package's
    lockstep loop chooses: "skip" when no lane has an intra mb,
    "rounds{R}" when every lane is intra-sparse (R the largest bucket; the
    buckets nest), else "sheared": one dense lane (an IDR) sends the whole
    step to the wavefront, as the lanes share one step.  On a card every
    step with an intra mb takes intra.cu whatever the route's name, so
    only that is computed there: "skip" or "sheared"."""
    if not on_cpu:
        return ("sheared" if any((f & MBF_INTRA).any() for f in flags_list)
                else "skip")
    tabs = [intra_round_plane(f, mbW, mbH) for f in flags_list]
    if any(t is None for t in tabs):
        return "sheared"
    if all(int(t[0].max()) == 0 for t in tabs):
        return "skip"
    return f"rounds{max(t[1] for t in tabs)}"


def _decode_group(lane_objs, sink, mesh):
    S = RING_SLOTS
    K = len(lane_objs)
    devices = mesh.devices
    b = K // mesh.size                  # lanes a shard

    def start_parsing(at_step):
        ts = []
        for ln in lane_objs:
            if len(ln.done_slots) <= at_step and not ln.finished:
                t = threading.Thread(target=ln.parse_next_frame)
                t.start()
                ts.append(t)
        return ts

    def live_at(at_step):
        return [i for i, ln in enumerate(lane_objs)
                if len(ln.done_slots) > at_step]

    rings = None            # per shard (refL, refC)
    keep = set()            # sticky: conditional planes some frame needed
    gat_state = {}          # sticky sparse-row buckets (pack_planes_batch)
    # residual levels go as int8 while every frame fits, on the card as
    # the JAX package does on its TPU; the first level out of range sends
    # the group to int16 for good
    coef8 = devices[0].type == "cuda"
    step = 0
    step_out = []           # per step: host copies of each shard's aux
    # PIPELINE: step N+1's entropy threads start after step N's pack and
    # before its upload and device work, so host parsing overlaps both.
    # Output borrows keep uploaded-pending slots pinned; every other
    # native API call is made while the lane threads are idle (the pack's
    # on the arena's pool, the rest on this thread).
    threads = start_parsing(0)
    while True:
        for t in threads:
            t.join()
        live = live_at(step)
        if not live:
            # a reorder backlog plus not-yet-returned borrows can wedge
            # parse_next_frame's ENOBUFS stall cap: release every
            # uploaded borrow and retry once before declaring the group done
            for ln in lane_objs:
                _return_packed(ln, step - 1)
            for t in start_parsing(step):
                t.join()
            live = live_at(step)
        if not live:
            break

        mbW = lane_objs[live[0]].fmt["mb_w"]
        mbH = lane_objs[live[0]].fmt["mb_h"]
        # grow the rings by doubling when any lane runs out of slots
        if any(ln.done_slots[step][2] and not ln.ring_free
               for ln in lane_objs if len(ln.done_slots) > step):
            S2 = S * 2
            if rings is not None:
                rings = [B.grow_ref_rings(L, C, S, S2) for L, C in rings]
            for ln in lane_objs:
                ln.ring_free.extend(range(S, S2))
                ln.S = S2
            S = S2

        planes_list, lane_flags = [], []
        sm4s, sm8s, ring_slots, slot_maps = [], [], [], []
        for ln in lane_objs:
            if len(ln.done_slots) > step:
                slot, _fid, is_ref = ln.done_slots[step]
                pl = ln.nd.planes(slot)
                flags = np.asarray(pl.mb_flags)
                if (flags & MBF_T8x8).any():
                    keep |= {"coef_y8", "i8_modes"}
                if (flags & MBF_IPCM).any():
                    keep |= {"pcm_y", "pcm_c"}
                if (flags & MBF_BLEND).any():
                    keep |= {"mb_errors", "slice_id"}
                if np.asarray(pl.wp).any() or np.asarray(pl.wp8).any():
                    keep |= {"wp", "wp8"}
                planes_list.append(pl)
                lane_flags.append(flags)
                sm4s.append(np.asarray(pl.sm4, np.int32))
                sm8s.append(B.scaling8(pl.sm8))
                # only REFERENCE frames occupy ring slots (non-refs are
                # never read back; they go to the write-off slot S)
                if is_ref and ln.ring_free:
                    ri = ln.ring_free.pop()
                    ln.ring_map[slot] = ri
                else:
                    ri = S
                ln.slot_ring[slot] = ri
                ring_slots.append(ln.slot_ring[slot])
                smap = np.zeros(32, np.int32)
                for s_, r_ in ln.ring_map.items():
                    smap[s_] = min(r_, S - 1)
                slot_maps.append(smap)
            else:
                planes_list.append(None)
                sm4s.append(np.full((6, 16), 16, np.int32))
                sm8s.append(np.full((6, 64), 16, np.int32))
                ring_slots.append(S)
                slot_maps.append(np.zeros(32, np.int32))

        intra_mode = _intra_mode(lane_flags, mbW, mbH,
                                 devices[0].type == "cpu")
        # borrows uploaded at earlier steps are safe to release now
        # (native calls only while the lane threads are idle)
        for ln in lane_objs:
            _return_packed(ln, step - 1)
        # ONE packed buffer per step: every lane's planes plus the step's
        # meta block in one [K, L] arena (dead lanes are zero rows), and
        # one upload a shard of its block of rows.  The lanes pack side by
        # side on every core, so the NEXT step's entropy starts only
        # after the pack, and overlaps this step's upload and device work
        # (this step's slots stay pinned)
        ref_pl = next(pl for pl in planes_list if pl is not None)
        meta = B.pack_meta(sm4s, sm8s, slot_maps, ring_slots)
        if coef8 and gat_state.get("coef8_off"):
            coef8 = False
        buf, layout, meta_off = A.pack_planes_batch(
            planes_list, ref_pl, keep=keep, coef8=coef8, extra=meta,
            gat_state=gat_state, device=devices[0])
        threads = start_parsing(step + 1)
        arenas = [A.upload(buf[i * b:(i + 1) * b], d)
                  for i, d in enumerate(devices)]

        if rings is None:
            rings = [B.alloc_ref_rings(b, S, mbW, mbH, d) for d in devices]
        fmt = lane_objs[live[0]].fmt
        crop = (fmt["crop_top"], fmt["crop_right"], fmt["crop_bottom"],
                fmt["crop_left"])
        outs = B.decode_batch_step_sharded(
            arenas, rings, layout=layout, meta_off=meta_off, mbW=mbW,
            mbH=mbH, intra_mode=intra_mode, mc=step > 0,
            emit="digest" if sink == "digest" else "flat", crop=crop,
            mesh=mesh)
        rings = [(o[4], o[5]) for o in outs]
        step_out.append(([_to_host(o[3]) for o in outs],
                         outs[0][0].shape[1:], outs[0][1].shape[1:]))
        for i, ln in enumerate(lane_objs):
            if planes_list[i] is not None:
                ln.store[ln.done_slots[step][1]] = (step, i)
        step += 1
    for d in set(devices):
        if d.type == "cuda":
            torch.cuda.synchronize(d)
    yield from _emit_frames(lane_objs, step_out, sink)


def _emit_frames(lane_objs, step_out, sink):
    """Frames of every lane in output order, from the steps' host copies
    (each step's shards concatenated in lane order)."""
    host_steps = {}

    def step_np(s):
        if s not in host_steps:
            parts, yshape, cshape = step_out[s]
            a = torch.cat(parts).numpy()
            if sink == "digest":
                host_steps[s] = a
            else:
                ny = yshape[0] * yshape[1]
                nc = cshape[0] * cshape[1]
                host_steps[s] = (a[:, :ny].reshape((-1,) + yshape),
                                 a[:, ny:ny + nc].reshape((-1,) + cshape),
                                 a[:, ny + nc:].reshape((-1,) + cshape))
        return host_steps[s]

    for lane, ln in enumerate(lane_objs):
        fmt = ln.fmt
        if fmt is None:
            ln.nd.close()
            continue
        ct, cr_, cb_, cl = (fmt["crop_top"], fmt["crop_right"],
                            fmt["crop_bottom"], fmt["crop_left"])
        wY, hY = fmt["mb_w"] * 16, fmt["mb_h"] * 16

        def crop(s, k):
            yb, cbb, crb = step_np(s)
            return (yb[k][ct:hY - cb_, cl:wY - cr_],
                    cbb[k][ct // 2:(hY - cb_) // 2, cl // 2:(wY - cr_) // 2],
                    crb[k][ct // 2:(hY - cb_) // 2, cl // 2:(wY - cr_) // 2])

        def digest(s, k):
            return tuple(int(v) for v in step_np(s)[k])

        for info in ln.out_frames:
            frame_id = info["frame_id"]
            mvc = info["slot_mvc"] >= 0
            if sink == "digest":
                f = DigestFrame(frame_id, digest(*ln.store[frame_id]))
                if mvc:
                    f.frame_id_mvc = info["frame_id_mvc"]
                    f.digest_mvc = digest(*ln.store[f.frame_id_mvc])
                yield f
                continue
            ya, cba, cra = crop(*ln.store[frame_id])
            f = Frame(y=ya, cb=cba, cr=cra, frame_id=frame_id,
                      crop_offsets=(ct, cr_, cb_, cl),
                      return_arg=info["slot"])
            if mvc:                # paired MVC view (edge264.c:373-399)
                f.frame_id_mvc = info["frame_id_mvc"]
                f.y_mvc, f.cb_mvc, f.cr_mvc = crop(
                    *ln.store[f.frame_id_mvc])
            yield f
        ln.nd.close()
