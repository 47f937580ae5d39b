"""The host arena: one step's syntax planes packed into ONE host buffer
and sent to the device with ONE copy, then expanded there into int32
planes.

Port of the JAX package's arena (`jaxdec.py`: `GAT_TAGS` ...
`_unpack_planes`).  The layouts and the packed bytes equal the JAX
package's byte for byte.  What shrinks the upload:
  - planes no frame of the step uses are left out (`plan_layout`), and
    come back as device zeros;
  - every plane keeps its native type (int16 / int8 / uint8), and with
    `coef8` the residual levels go as int8 while every level fits;
  - with a `gat_state`, the coefficient planes go as a coded-row bitmap
    plus only the coded rows (taken from the entropy pass's dirty lists),
    and `mvs` / `refslot` as a per-mb base plus the rows of the mbs whose
    cells differ.
The native packer (`native/src/pack.cpp`, the interpreter lock released)
packs planes that come from the native front end; `pack_into` (numpy)
packs any other planes object.  Neither stands in for the other.

Deliberate differences from the JAX package:
  - the int8 range check runs whenever `coef8` is on (the JAX packer skips
    it when gathering is off and then wraps levels outside [-128, 127]);
  - on `cuda` the host buffer is a view into one of two pinned staging
    buffers of the calling thread, uploaded with one non-blocking copy a
    device (`upload`); on the CPU every step gets a fresh buffer;
  - there are no environment switches: callers choose the path by what
    they pass (a plain planes object packs with numpy, gat_state=None packs
    dense).
"""

from __future__ import annotations

import functools
import os
import threading
from concurrent.futures import ThreadPoolExecutor, wait

import numpy as np
import torch

from ..convert import PLANE_KEYS
from ..native import PackEntry
from .tables import MBF_BLEND, MBF_IPCM, MBF_T8x8

I32 = torch.int32

# gatherable planes: key -> (native dirty tag Planes::DP_*, row elems).
# The entropy pass records every coded coefficient block in the frame's
# dirty list (its lazy-clear bookkeeping): the coded-row index for free.
GAT_TAGS = {"coef_y": (0, 16), "coef_y8": (1, 64), "coef_y_dc": (2, 16),
            "coef_c_dc": (3, 8), "coef_cb": (4, 16), "coef_cr": (5, 16)}

# base+exception planes: per-4x4-cell data that is usually uniform across
# its macroblock (one-partition inter mbs, skips, intra): a per-mb base
# plus the full rows of the mbs that are split.  key -> elements a cell.
BASE_EXC = {"mvs": 4, "refslot": 2}

COEF_PLANES = frozenset({"coef_y", "coef_y8", "coef_y_dc", "coef_c_dc",
                         "coef_cb", "coef_cr"})


def split_mb_idx(planes):
    """Sorted indices of the mbs whose 4x4-cell `mvs` / `refslot` are not
    uniform within the mb (the numpy packer's exception rows)."""
    H, W = planes.mb_h, planes.mb_w
    mv = np.asarray(planes.mvs).reshape(H, 4, W, 4, 4)
    uni_mv = (mv == mv[:, :1, :, :1]).all(axis=(1, 3, 4))
    rs = np.asarray(planes.refslot).reshape(H, 4, W, 4, 2)
    uni_rs = (rs == rs[:, :1, :, :1]).all(axis=(1, 3, 4))
    return {"mvs": np.flatnonzero(~uni_mv.reshape(-1)),
            "refslot": np.flatnonzero(~uni_rs.reshape(-1))}


def gat_masks(planes):
    """Sorted unique coded-row indices (int64) of each gatherable plane
    from the dirty list, or None when the list is unreliable (dirty_all
    after a recovery)."""
    if getattr(planes, "dirty_all", True):
        return None
    d = planes.dirty
    tags = (d >> np.uint64(48)).astype(np.int32)
    offs = (d & np.uint64((1 << 48) - 1)).astype(np.int64)
    return {k: np.unique(offs[tags == tag] // row_elems)
            for k, (tag, row_elems) in GAT_TAGS.items()}


def coef_fits_int8(planes) -> bool:
    """True when every residual level is in [-128, 127], so the
    coefficient planes can go as int8.  Motion vectors stay int16."""
    for k in COEF_PLANES:
        a = np.asarray(getattr(planes, k))
        if int(a.max()) > 127 or int(a.min()) < -128:
            return False
    return True


def plan_layout(planes, keep=frozenset(), coef8=False, gat=None):
    """The arena layout of `planes` and its byte size, copying nothing.

    Entries are (key, dtype, shape, off, meta):
      off >= 0   dense plane at byte offset off (meta None)
      off == -1  left out: the device reads zeros (meta None)
      off == -2  gathered: (bm_off, tab_off, rows, row_elems, U), a U-bit
                 little-endian bitmap of the coded rows at bm_off and a
                 [rows, row_elems] table of them at tab_off
      off == -3  base+exception: (base_off, bm_off, tab_off, rows, be, U),
                 the per-mb base [U, be], a U-bit bitmap of the split mbs
                 and a [rows, 16 * be] table of their cells
    `keep` pins conditional planes into the layout; `gat` maps a GAT_TAGS
    or BASE_EXC key to its row bucket (None: dense)."""
    flags = np.asarray(planes.mb_flags)
    skip = {"nz_c"}         # read by no device stage
    if not (flags & MBF_T8x8).any():
        skip |= {"coef_y8", "i8_modes"}
    if not (flags & MBF_IPCM).any():
        skip |= {"pcm_y", "pcm_c"}
    if not (flags & MBF_BLEND).any():
        skip |= {"mb_errors", "slice_id"}
    if not (np.asarray(planes.wp).any() or np.asarray(planes.wp8).any()):
        # all-zero weights reproduce the default combine exactly
        skip |= {"wp", "wp8"}
    skip -= set(keep)
    layout = []
    off = 0
    for k in PLANE_KEYS:
        a = getattr(planes, k)
        shape = tuple(a.shape)
        if k == "coef_c_dc":
            shape = (shape[0], shape[1], 2, 4)
        dt = np.dtype(np.int8) if (coef8 and k in COEF_PLANES) \
            else np.dtype(a.dtype)
        if k in skip:
            layout.append((k, str(dt), shape, -1, None))
            continue
        rows = (gat or {}).get(k)
        if rows is not None and k in GAT_TAGS:
            _tag, row_elems = GAT_TAGS[k]
            U = int(np.prod(shape)) // row_elems
            off += (-off) % 8
            bm_off = off
            off += (U + 7) // 8
            off += (-off) % 8
            tab_off = off
            off += rows * row_elems * dt.itemsize
            layout.append((k, str(dt), shape, -2,
                           (bm_off, tab_off, rows, row_elems, U)))
            continue
        if rows is not None and k in BASE_EXC:
            be = BASE_EXC[k]
            U = int(np.prod(shape)) // (16 * be)      # mbs
            off += (-off) % 8
            base_off = off
            off += U * be * dt.itemsize
            off += (-off) % 8
            bm_off = off
            off += (U + 7) // 8
            off += (-off) % 8
            tab_off = off
            off += rows * 16 * be * dt.itemsize
            layout.append((k, str(dt), shape, -3,
                           (base_off, bm_off, tab_off, rows, be, U)))
            continue
        off += (-off) % 8
        layout.append((k, str(dt), shape, off, None))
        off += int(np.prod(shape)) * dt.itemsize
    return tuple(layout), off


def pack_into(planes, layout, out, masks=None):
    """The numpy packer: each live plane copied once into `out` (a 1-D
    uint8 array of at least plan_layout's size), the gaps zeroed.
    Gathered and base+exception entries need `masks[key]`, the sorted row
    indices (gat_masks, split_mb_idx)."""
    prev_end = 0
    for k, dt, shape, off, meta in layout:
        if off == -1:
            continue
        a = np.asarray(getattr(planes, k))
        if k == "coef_c_dc":
            a = a.reshape(shape)
        if off == -2:
            bm_off, tab_off, rows, row_elems, U = meta
            idx = masks[k]
            out[prev_end:bm_off] = 0
            mask = np.zeros(U, bool)
            mask[idx] = True
            bm = np.packbits(mask, bitorder="little")
            out[bm_off:bm_off + bm.nbytes] = bm
            out[bm_off + bm.nbytes:tab_off] = 0
            sel = a.reshape(U, row_elems)[idx].astype(dt, copy=False)
            if sel.shape[0] > rows:
                raise ValueError(f"{k}: {sel.shape[0]} rows, bucket {rows}")
            n = sel.nbytes
            out[tab_off:tab_off + n] = \
                np.ascontiguousarray(sel).reshape(-1).view(np.uint8)
            prev_end = tab_off + rows * row_elems * np.dtype(dt).itemsize
            out[tab_off + n:prev_end] = 0
            continue
        if off == -3:
            base_off, bm_off, tab_off, rows, be, U = meta
            idx = masks[k]
            H, W = shape[0] // 4, shape[1] // 4
            a6 = a.reshape(H, 4, W, 4, be)
            base = np.ascontiguousarray(a6[:, 0, :, 0]).astype(dt,
                                                                copy=False)
            out[prev_end:base_off] = 0
            out[base_off:base_off + base.nbytes] = \
                base.reshape(-1).view(np.uint8)
            mask = np.zeros(U, bool)
            mask[idx] = True
            bm = np.packbits(mask, bitorder="little")
            out[base_off + base.nbytes:bm_off] = 0
            out[bm_off:bm_off + bm.nbytes] = bm
            out[bm_off + bm.nbytes:tab_off] = 0
            sel = a6[idx // W, :, idx % W].astype(dt, copy=False)
            if sel.shape[0] > rows:
                raise ValueError(f"{k}: {sel.shape[0]} rows, bucket {rows}")
            n = sel.nbytes
            out[tab_off:tab_off + n] = \
                np.ascontiguousarray(sel).reshape(-1).view(np.uint8)
            prev_end = tab_off + rows * 16 * be * np.dtype(dt).itemsize
            out[tab_off + n:prev_end] = 0
            continue
        a = a.astype(dt, copy=False)
        out[prev_end:off] = 0                 # alignment padding
        n = a.nbytes
        out[off:off + n] = a.reshape(-1).view(np.uint8)
        prev_end = off + n


def pack_planes(planes, keep=frozenset(), coef8=False):
    """One frame's arena with the numpy packer: (uint8 [size] host array,
    layout), the bytes of the JAX package's `pack_planes`.  With coef8 the
    levels go as int8 only if every one fits."""
    coef8 = coef8 and coef_fits_int8(planes)
    layout, size = plan_layout(planes, keep=keep, coef8=coef8)
    arena = np.empty(size, np.uint8)
    pack_into(planes, layout, arena)
    return arena, layout


# ---------------------------------------------------------------------------
# host staging

# Per thread, two pinned buffers taken in turn: a step packs into one
# while the previous step's copy may still read the other.  Each grows to
# the largest step it has held (layouts change between IDR and P steps,
# and a pinned allocation is slow), and before it is refilled the host
# waits on the events recorded after its uploads (one per copy: the mesh
# path uploads each shard's rows of one buffer to that shard's device), so
# the packer never overwrites bytes still in flight.  Thread-local:
# decode_annexb_parallel runs whole decoders on worker threads.
_STAGING = threading.local()
_GROW = 1 << 20          # staging capacity granule (bytes)


class _Staging:
    def __init__(self):
        self.bufs = [None, None]     # pinned uint8 tensors
        self.done = [[], []]         # CUDA events after each one's uploads
        self.turn = 0


def _staging():
    st = getattr(_STAGING, "st", None)
    if st is None:
        st = _STAGING.st = _Staging()
    return st


def _arena_buf(n, rows, device):
    """A [rows, n] uint8 host tensor for one step's arena: a fresh one
    for the CPU, else a view into the calling thread's next pinned
    staging buffer, once its previous upload has finished."""
    if device.type != "cuda":
        return torch.from_numpy(np.empty((rows, n), np.uint8))
    st = _staging()
    i = st.turn
    st.turn ^= 1
    for ev in st.done[i]:
        ev.synchronize()
    st.done[i] = []
    need = rows * n
    if st.bufs[i] is None or st.bufs[i].numel() < need:
        st.bufs[i] = None
        st.bufs[i] = torch.empty(-(-need // _GROW) * _GROW,
                                 dtype=torch.uint8, pin_memory=True)
    return st.bufs[i][:need].view(rows, n)


def upload(buf, device):
    """The host-to-device copy of a packed arena (a buffer of
    pack_planes_batch, or one shard's block of its rows on the mesh path).
    On cuda: a non-blocking copy from pinned memory on the device's
    current stream, with an event that the staging buffer's next refill
    waits on; a pageable buffer is refused.  On the CPU the buffer is the
    arena."""
    if device.type != "cuda":
        return buf
    if not buf.is_pinned():
        raise ValueError("upload: the arena is not in pinned host memory")
    out = buf.to(device, non_blocking=True)
    st = _staging()
    for i, b in enumerate(st.bufs):
        if b is not None and b.data_ptr() <= buf.data_ptr() < \
                b.data_ptr() + b.numel():
            ev = torch.cuda.Event()
            ev.record(torch.cuda.current_stream(device))
            st.done[i].append(ev)
    return out


# ---------------------------------------------------------------------------
# packing a step

def _check_geometry(planes_list, ref_planes):
    """Every live lane has the layout's frame size and plane shapes."""
    want = (getattr(ref_planes, "mb_w", None),
            getattr(ref_planes, "mb_h", None))
    for k, pl in enumerate(planes_list):
        if pl is None:
            continue
        bad = [key for key in PLANE_KEYS if np.shape(getattr(pl, key))
               != np.shape(getattr(ref_planes, key))]
        got = (getattr(pl, "mb_w", None), getattr(pl, "mb_h", None))
        if got != want or bad:
            raise ValueError(
                f"lane {k}: {got[0]}x{got[1]} mbs (planes {bad}) do not fit "
                f"the layout's {want[0]}x{want[1]} mbs")


def _probe(pl, want_exc, lane):
    pr = pl.pack_probe(want_exc)
    if pr is None:
        raise RuntimeError(f"lane {lane}: e264t_pack_probe failed")
    return pr


# The lanes of a step pack on one thread pool for the whole process, made
# on first use: one thread a core at most, started as tasks arrive, so a
# step of K lanes keeps min(K, cores) of them busy.  The native calls
# release the interpreter lock, so the lanes' probes and row copies run
# side by side.  No task submits to the pool, so threads that pack at
# once share it without deadlock.
_POOL = None
_POOL_LOCK = threading.Lock()


def _pool():
    global _POOL
    with _POOL_LOCK:
        if _POOL is None:
            _POOL = ThreadPoolExecutor(max_workers=os.cpu_count() or 1,
                                       thread_name_prefix="arena-pack")
        return _POOL


def _each_lane(fn, lanes, pooled):
    """[fn(k) for k in lanes]: on the pool when `pooled`, else inline.
    Every task ends before the first error in lane order is raised, so no
    worker still writes into the caller's buffer."""
    if not pooled:
        return [fn(k) for k in lanes]
    pool = _pool()
    futs = [pool.submit(fn, k) for k in lanes]
    wait(futs)
    return [f.result() for f in futs]


def pack_planes_batch(planes_list, ref_planes, keep=frozenset(),
                      coef8=False, extra=None, gat_state=None,
                      device="cpu"):
    """Pack K frames' planes into ONE [K, L] host buffer, for one upload
    per step.  `ref_planes` sizes the shared layout; None entries of
    planes_list (dead lanes) pack as zero rows.  Callers fold every lane's
    conditional planes into `keep`, so the layout fits all lanes.  `extra`
    ([K, E] uint8, the step's meta block) is appended to every row at
    extra_off.

    `gat_state` (a dict the caller keeps for a stream or group) turns on
    sparse packing: a gatherable plane goes as bitmap + coded rows when
    that is at most half its dense size, with row buckets that grow as
    powers of two from 128 and stay grown, so layouts repeat.  Once a
    frame's levels do not fit int8, `gat_state["coef8_off"]` is set.

    With native planes and two or more live lanes, the lanes' probes and
    then their rows pack on the process's pool (`_pool`), each lane into
    its own row; the probes merge here in lane order, so the bytes, the
    layout and `gat_state` equal those of one lane after another.  A
    native failure raises RuntimeError naming its lane.

    `device` is where the arena goes: on cuda the buffer is pinned
    staging (see upload).  Returns (buf uint8 [K, L] host tensor, layout,
    extra_off).  A lane whose frame size or plane shapes differ from
    `ref_planes` raises ValueError before any native call: the native
    packer would write it past the smaller layout's entries."""
    _check_geometry(planes_list, ref_planes)
    device = torch.device(device)
    native = all(pl is None or hasattr(pl, "pack_probe")
                 for pl in planes_list)
    live = [k for k, pl in enumerate(planes_list) if pl is not None]
    pooled = native and len(live) >= 2
    gat = None
    masks_list = [None] * len(planes_list)
    if gat_state is not None:
        counts = {k: 0 for k in (*GAT_TAGS, *BASE_EXC)}
        all_masks = []
        ok = True
        do_bx = True
        if native:
            # one C-side probe per lane: coded-row counts from the dirty
            # lists, the split-mb scan and the int8 verdict
            probes = _each_lane(
                lambda k: _probe(planes_list[k], True, k), live, pooled)
            for pr in probes:
                if coef8 and not pr.coef8_ok:
                    coef8 = False
                    gat_state["coef8_off"] = True
                if pr.dirty_all:
                    ok = False
                    continue
                for k, (tag, _re) in GAT_TAGS.items():
                    counts[k] = max(counts[k], pr.gat_counts[tag])
                counts["mvs"] = max(counts["mvs"], pr.exc_counts[0])
                counts["refslot"] = max(counts["refslot"], pr.exc_counts[1])
        else:
            # the numpy split-mb scan is slow, so while the content keeps
            # choosing dense it runs only every 8th step
            tick = gat_state.get("_bx_tick", 0)
            gat_state["_bx_tick"] = tick + 1
            do_bx = gat_state.get("_bx_on", True) or tick % 8 == 0
            for pl in planes_list:
                if pl is None:
                    all_masks.append(None)
                    continue
                # every live lane is range-checked, also after a lane
                # without a reliable dirty list (the JAX loop stops there)
                if coef8 and not coef_fits_int8(pl):
                    coef8 = False
                    gat_state["coef8_off"] = True
                if not ok:
                    continue
                m = gat_masks(pl)
                if m is None:          # a recovery: pack dense
                    ok = False
                    continue
                if do_bx:
                    m.update(split_mb_idx(pl))
                all_masks.append(m)
                for k, mm in m.items():
                    counts[k] = max(counts[k], len(mm))
        if ok:
            gat = {}
            itemsize = 1 if coef8 else 2
            for k, (_tag, row_elems) in GAT_TAGS.items():
                U = int(np.prod(getattr(ref_planes, k).shape)) // row_elems
                b = max(gat_state.get(k, 0), 128)
                while b < counts[k]:
                    b *= 2
                if (U + 7) // 8 + b * row_elems * itemsize \
                        <= U * row_elems * itemsize // 2:
                    gat[k] = b
                    gat_state[k] = b       # sticky growth only when used
                else:
                    gat[k] = None          # a dense step (an IDR)
            for k, be in BASE_EXC.items():
                if not do_bx:
                    gat[k] = None          # dense between probes
                    continue
                a = np.asarray(getattr(ref_planes, k))
                isz = a.dtype.itemsize
                U = int(np.prod(a.shape)) // (16 * be)   # mbs
                b = max(gat_state.get(k, 0), 128)
                while b < counts[k]:
                    b *= 2
                sparse = U * be * isz + (U + 7) // 8 + b * 16 * be * isz
                if sparse <= U * 16 * be * isz // 2:
                    gat[k] = b
                    gat_state[k] = b
                else:
                    gat[k] = None
            gat_state["_bx_on"] = any(
                gat.get(k) is not None for k in BASE_EXC)
            masks_list = all_masks
    elif coef8:
        # The JAX packer checks the int8 range only when it gathers; here
        # the check runs whenever coef8 is on, and a level outside
        # [-128, 127] sends the step as int16.
        if native:
            coef8 = all(pr.coef8_ok for pr in _each_lane(
                lambda k: _probe(planes_list[k], False, k), live, pooled))
        else:
            coef8 = all(coef_fits_int8(planes_list[k]) for k in live)
    layout, size = plan_layout(ref_planes, keep=keep, coef8=coef8, gat=gat)
    extra_off = size + (-size) % 8
    total = extra_off + (extra.shape[1] if extra is not None else 0)
    buf = _arena_buf(total, len(planes_list), device)
    bn = buf.numpy()
    ents = _native_entries(layout, size) if native else None

    def fill(k):
        pl, row = planes_list[k], bn[k]
        if pl is None:
            row[:extra_off] = 0
            return
        if native:
            rc = pl.pack_row(ents[0], ents[1], row, size)
            if rc != 0:
                raise RuntimeError(f"lane {k}: e264t_pack_row failed rc={rc}")
        else:
            pack_into(pl, layout, row, masks=masks_list[k])
        row[size:extra_off] = 0

    _each_lane(fill, range(len(planes_list)), pooled)
    if extra is not None:
        bn[:, extra_off:] = extra
    return buf, layout, extra_off


def _entry_end(dt, shape, off, meta):
    """The byte just past a live layout entry."""
    isz = np.dtype(dt).itemsize
    if off >= 0:
        return off + int(np.prod(shape)) * isz
    if off == -2:
        _bm, tab_off, rows, row_elems, _U = meta
        return tab_off + rows * row_elems * isz
    _base, _bm, tab_off, rows, be, _U = meta
    return tab_off + rows * 16 * be * isz


@functools.lru_cache(maxsize=64)
def _native_entries(layout, size):
    """Layout -> (PackEntry array, n) for e264t_pack_row, shared by every
    lane of a step (layouts are sticky, so this caches well).  The C
    function checks an entry's end only after writing it, so an entry
    that ends past `size` is refused here."""
    items = []
    for k, dt, shape, off, meta in layout:
        if off == -1:
            continue
        if _entry_end(dt, shape, off, meta) > size:
            raise ValueError(f"layout entry {k} ends past {size} bytes")
        e = PackEntry()
        e.key = PLANE_KEYS.index(k)
        e.dst_item = np.dtype(dt).itemsize
        if off >= 0:
            e.kind, e.off = 0, off
        elif off == -2:
            bm_off, tab_off, rows, row_elems, U = meta
            e.kind = 2
            e.bm_off, e.tab_off = bm_off, tab_off
            e.rows, e.row_elems, e.U = rows, row_elems, U
        else:
            base_off, bm_off, tab_off, rows, be, U = meta
            e.kind, e.be = 3, be
            e.base_off, e.bm_off, e.tab_off = base_off, bm_off, tab_off
            e.rows, e.U = rows, U
        items.append(e)
    return (PackEntry * len(items))(*items), len(items)


# ---------------------------------------------------------------------------
# the device side

# the layout's numpy dtypes as torch views of the arena bytes; uint16
# (slice_id) is read as int16 and masked after widening
_VIEW = {"uint8": torch.uint8, "int8": torch.int8, "int16": torch.int16,
         "uint16": torch.int16, "int32": torch.int32}


def _elems(arenas, off, n, dt):
    """[K, n] elements of dtype `dt` at byte offset `off` of every arena
    row, a view of the arena bytes (offsets are multiples of 8 and rows
    of 4 bytes, so every view is legal)."""
    isz = np.dtype(dt).itemsize
    return arenas[:, off:off + n * isz].view(_VIEW[dt])


def _int32(src, shape, dt):
    """`src` widened into a new contiguous int32 tensor [K, *shape]
    (sign-extended, or zero-extended for the unsigned dtypes).  Never a
    view of the arena: the kernels read each plane with 16-byte copies
    from its own aligned start."""
    out = torch.empty((src.shape[0],) + tuple(shape), dtype=I32,
                      device=src.device)
    out.view(src.shape).copy_(src)
    if dt == "uint16":
        out &= 0xFFFF
    return out


def _coded(arenas, bm_off, U):
    """The little-endian bitmap at bm_off as [K, U] 0/1 uint8."""
    K = arenas.shape[0]
    bm = arenas[:, bm_off:bm_off + (U + 7) // 8]
    shifts = torch.arange(8, dtype=torch.uint8, device=arenas.device)
    return ((bm[:, :, None] >> shifts) & 1).reshape(K, -1)[:, :U]


def _row_gather(coded, tab, rows):
    """[K, U, ...]: the coded rows take the table's rows in order, the
    others a zero row appended after the table's `rows`."""
    K = coded.shape[0]
    tab = torch.cat([tab, tab.new_zeros((K, 1) + tab.shape[2:])], 1)
    idx = torch.where(coded > 0, coded.to(torch.int64).cumsum(1) - 1, rows)
    lanes = torch.arange(K, device=coded.device)[:, None]
    return tab[lanes, idx]


def unpack_planes(arenas, layout):
    """Device side: arenas [K, L] uint8 (one layout for every lane) ->
    {key: int32 [K, ...]}, every plane a contiguous tensor of its own.
    Left-out planes are zeros; gathered and base+exception planes expand
    bitmap -> cumsum -> row gather (the JAX package's `_unpack_planes`,
    batched over K)."""
    K = arenas.shape[0]
    dev = arenas.device
    p = {}
    for k, dt, shape, off, meta in layout:
        if off == -1:
            p[k] = torch.zeros((K,) + tuple(shape), dtype=I32, device=dev)
        elif off == -2:
            bm_off, tab_off, rows, row_elems, U = meta
            tab = _elems(arenas, tab_off, rows * row_elems, dt)
            got = _row_gather(_coded(arenas, bm_off, U),
                              tab.reshape(K, rows, row_elems), rows)
            p[k] = _int32(got.reshape(K, -1), shape, dt)
        elif off == -3:
            base_off, bm_off, tab_off, rows, be, U = meta
            H, W = shape[0] // 4, shape[1] // 4
            base = _elems(arenas, base_off, U * be, dt).reshape(K, H, W, be)
            dense0 = base.repeat_interleave(4, 1).repeat_interleave(4, 2)
            coded = _coded(arenas, bm_off, U)
            tab = _elems(arenas, tab_off, rows * 16 * be, dt)
            exc = (_row_gather(coded, tab.reshape(K, rows, 16 * be), rows)
                   .reshape(K, H, W, 4, 4, be).permute(0, 1, 3, 2, 4, 5)
                   .reshape(K, 4 * H, 4 * W, be))
            m4 = (coded.reshape(K, H, W) > 0).repeat_interleave(4, 1) \
                .repeat_interleave(4, 2)[..., None]
            p[k] = _int32(torch.where(m4, exc, dense0).reshape(K, -1),
                          shape, dt)
        else:
            n = int(np.prod(shape))
            p[k] = _int32(_elems(arenas, off, n, dt), shape, dt)
    return p
