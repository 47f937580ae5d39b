"""Build-on-demand + ctypes binding for the C++ syntax front end.

The native library implements the bit-serial half of the decoder (NAL,
entropy, headers, DPB bookkeeping) and exposes per-frame syntax planes as
raw memory wrapped zero-copy as numpy arrays.  The sources under `src/`
are byte-identical to the JAX package's front end; the library is built
into `edge264_tpu_torch/_build/` and loaded under that path, so it never
shares a file (or a dlopen handle) with the JAX package's copy.
"""

from __future__ import annotations

import ctypes as C
import os
import subprocess
import threading

import numpy as np

_DIR = os.path.dirname(os.path.abspath(__file__))
_SRC = os.path.join(_DIR, "src")
_BUILD = os.path.join(os.path.dirname(_DIR), "_build")
_LIB = os.path.join(_BUILD, "libe264t.so")

SOURCES = ["tables.cpp", "cabac_tables.cpp", "cavlc.cpp", "cabac.cpp",
           "headers.cpp", "slice.cpp", "mb_cavlc.cpp", "mb_inter.cpp",
           "mb_cabac.cpp", "tasks.cpp", "api.cpp", "pack.cpp"]
CXXFLAGS = ["-std=c++17", "-O3", "-march=native", "-fno-plt", "-fPIC",
            "-shared", "-pthread", "-Wall", "-Wno-unused-function"]


def _needs_build() -> bool:
    if not os.path.exists(_LIB):
        return True
    lib_mtime = os.path.getmtime(_LIB)
    return any(os.path.getmtime(os.path.join(_SRC, f)) > lib_mtime
               for f in os.listdir(_SRC)
               if f.endswith((".cpp", ".h", ".inc")))


def build(force: bool = False) -> str:
    """Compile the front end with g++ (once; rebuilt when a source is newer
    than the library).  The temporary name is per process, so concurrent
    test workers never link into each other's output, and the build runs
    under a lock, so threads of one process (decode_annexb_parallel's
    workers) build it once."""
    with _lock:
        if force or _needs_build():
            os.makedirs(_BUILD, exist_ok=True)
            tmp = f"{_LIB}.{os.getpid()}.tmp"
            cmd = ["g++", *CXXFLAGS,
                   *[os.path.join(_SRC, s) for s in SOURCES], "-o", tmp]
            r = subprocess.run(cmd, capture_output=True, text=True)
            if r.returncode != 0:
                raise RuntimeError(f"native build failed:\n{r.stderr}")
            os.replace(tmp, _LIB)
    return _LIB


class Event(C.Structure):
    _fields_ = [("kind", C.c_int32), ("slot", C.c_int32),
                ("a", C.c_int32), ("b", C.c_int32),
                ("c", C.c_int32), ("d", C.c_int32)]


EV_FORMAT = 1
EV_FRAME_START = 2
EV_SLICE_DONE = 3
EV_FRAME_DONE = 4
EV_OUTPUT = 5
EV_UNPIN = 6

_PLANE_PTRS = ["mb_flags", "qp", "i4_modes", "i16_modes", "i8_modes",
               "ch_modes", "nz_y", "nz_c", "coef_y", "coef_y8", "coef_y_dc",
               "coef_c_dc", "coef_cb", "coef_cr", "mvs", "refslot", "pcm_y",
               "pcm_c", "deblock", "deblock_ab", "wp", "slice_id", "wp8",
               "sm4", "sm8", "mb_errors"]


class PlanesStruct(C.Structure):
    _fields_ = [("mb_w", C.c_int32), ("mb_h", C.c_int32)] + [
        (n, C.c_void_p) for n in _PLANE_PTRS]


class PackEntry(C.Structure):
    """One arena-layout entry for e264t_pack_row (native/src/pack.cpp;
    ops/arena.plan_layout makes the layout)."""
    _fields_ = [("key", C.c_int32), ("kind", C.c_int32),
                ("dst_item", C.c_int32), ("be", C.c_int32),
                ("off", C.c_int64), ("bm_off", C.c_int64),
                ("tab_off", C.c_int64), ("base_off", C.c_int64),
                ("rows", C.c_int64), ("row_elems", C.c_int64),
                ("U", C.c_int64)]


class PackProbe(C.Structure):
    _fields_ = [("gat_counts", C.c_int64 * 6),
                ("exc_counts", C.c_int64 * 2),
                ("coef8_ok", C.c_int32), ("dirty_all", C.c_int32)]


_lib = None
_lock = threading.RLock()     # one build and one load per process


def load():
    global _lib
    with _lock:
        if _lib is None:
            _lib = _bind(C.CDLL(build()))
    return _lib


def _bind(lib):
    """Declare every entry point's argument and result types."""
    lib.e264t_alloc.restype = C.c_void_p
    lib.e264t_free.argtypes = [C.c_void_p]
    lib.e264t_flush.argtypes = [C.c_void_p]
    lib.e264t_decode_nal.argtypes = [C.c_void_p, C.c_char_p, C.c_size_t]
    lib.e264t_decode_nal.restype = C.c_int
    lib.e264t_poll.argtypes = [C.c_void_p, C.POINTER(Event)]
    lib.e264t_poll.restype = C.c_int
    lib.e264t_planes.argtypes = [C.c_void_p, C.c_int,
                                 C.POINTER(PlanesStruct)]
    lib.e264t_planes.restype = C.c_int
    lib.e264t_format.argtypes = [C.c_void_p, C.POINTER(C.c_int32)]
    lib.e264t_get_frame.argtypes = [C.c_void_p, C.c_int,
                                    C.POINTER(C.c_int32)]
    lib.e264t_get_frame.restype = C.c_int
    lib.e264t_return_frame.argtypes = [C.c_void_p, C.c_int]
    lib.e264t_get_log.argtypes = [C.c_void_p, C.c_char_p, C.c_size_t]
    lib.e264t_get_log.restype = C.c_size_t
    lib.e264t_set_logging.argtypes = [C.c_void_p, C.c_int, C.c_int]
    lib.e264t_slot_info.argtypes = [C.c_void_p, C.c_int,
                                    C.POINTER(C.c_int32)]
    lib.e264t_set_threads.argtypes = [C.c_void_p, C.c_int]
    lib.e264t_wait_frame.argtypes = [C.c_void_p]
    lib.e264t_wait_frame.restype = C.c_int
    lib.e264t_dirty.argtypes = [C.c_void_p, C.c_int,
                                C.POINTER(C.POINTER(C.c_uint64)),
                                C.POINTER(C.c_size_t),
                                C.POINTER(C.c_int)]
    lib.e264t_dirty.restype = C.c_int
    lib.e264t_pack_probe.argtypes = [C.c_void_p, C.c_int, C.c_int,
                                     C.POINTER(PackProbe)]
    lib.e264t_pack_probe.restype = C.c_int
    lib.e264t_pack_row.argtypes = [C.c_void_p, C.c_int,
                                   C.POINTER(PackEntry), C.c_int,
                                   C.POINTER(C.c_uint8), C.c_int64]
    lib.e264t_pack_row.restype = C.c_int
    return lib


class SyntaxPlanes:
    """Zero-copy numpy views over one DPB slot's syntax planes.

    Shapes (mb grid W x H, luma block grid 4W x 4H, chroma 2W x 2H):
      mb_flags  [H, W]        int32       qp        [H, W, 4]    int8
      i4_modes  [4H, 4W]      uint8       i16_modes [H, W]       uint8
      ch_modes  [H, W]        uint8       nz_y      [4H, 4W]     uint8
      nz_c      [2H, 2W, 2]   uint8
      coef_y    [4H, 4W, 16]  int16       coef_y8   [2H, 2W, 64] int16
      coef_y_dc [H, W, 16]    int16       coef_c_dc [H, W, 2, 4] int16
      coef_cb   [2H, 2W, 16]  int16       coef_cr   [2H, 2W, 16] int16
      mvs       [4H, 4W, 2, 2] int16      refslot   [4H, 4W, 2]  int8
      pcm_y     [16H, 16W]    uint8       pcm_c     [2, 8H, 8W]  uint8
      deblock   [H, W]        uint8       deblock_ab [H, W, 2]   int8
      wp        [H, W, 24]    int8        slice_id  [H, W]       uint16
    """

    def __init__(self, handle, slot):
        lib = load()
        s = PlanesStruct()
        if lib.e264t_planes(handle, slot, C.byref(s)) != 0:
            raise ValueError(f"bad slot {slot}")
        W, H = s.mb_w, s.mb_h
        self.mb_w, self.mb_h = W, H
        self._handle, self._slot = handle, slot

        def arr(ptr, shape, dtype):
            n = int(np.prod(shape)) * np.dtype(dtype).itemsize
            ct = np.ctypeslib.as_array(C.cast(ptr, C.POINTER(C.c_uint8)),
                                       (n,))
            return ct.view(dtype).reshape(shape)

        self.mb_flags = arr(s.mb_flags, (H, W), np.int32)
        self.qp = arr(s.qp, (H, W, 4), np.int8)
        self.i4_modes = arr(s.i4_modes, (4 * H, 4 * W), np.uint8)
        self.i16_modes = arr(s.i16_modes, (H, W), np.uint8)
        self.i8_modes = arr(s.i8_modes, (2 * H, 2 * W), np.uint8)
        self.ch_modes = arr(s.ch_modes, (H, W), np.uint8)
        self.nz_y = arr(s.nz_y, (4 * H, 4 * W), np.uint8)
        self.nz_c = arr(s.nz_c, (2 * H, 2 * W, 2), np.uint8)
        self.coef_y = arr(s.coef_y, (4 * H, 4 * W, 16), np.int16)
        self.coef_y8 = arr(s.coef_y8, (2 * H, 2 * W, 64), np.int16)
        self.coef_y_dc = arr(s.coef_y_dc, (H, W, 16), np.int16)
        self.coef_c_dc = arr(s.coef_c_dc, (H, W, 2, 4), np.int16)
        self.coef_cb = arr(s.coef_cb, (2 * H, 2 * W, 16), np.int16)
        self.coef_cr = arr(s.coef_cr, (2 * H, 2 * W, 16), np.int16)
        self.mvs = arr(s.mvs, (4 * H, 4 * W, 2, 2), np.int16)
        self.refslot = arr(s.refslot, (4 * H, 4 * W, 2), np.int8)
        self.pcm_y = arr(s.pcm_y, (16 * H, 16 * W), np.uint8)
        self.pcm_c = arr(s.pcm_c, (2, 8 * H, 8 * W), np.uint8)
        self.deblock = arr(s.deblock, (H, W), np.uint8)
        self.deblock_ab = arr(s.deblock_ab, (H, W, 2), np.int8)
        self.wp = arr(s.wp, (H, W, 24), np.int8)
        self.wp8 = arr(s.wp8, (2 * H, 2 * W, 2, 3, 2), np.int8)
        self.sm4 = arr(s.sm4, (6, 16), np.uint8)
        self.sm8 = arr(s.sm8, (2, 64), np.uint8)
        self.mb_errors = arr(s.mb_errors, (H, W), np.uint8)
        self.slice_id = arr(s.slice_id, (H, W), np.uint16)
        # the dirty-block records (tag << 48 | element offset, one per coded
        # coefficient block, kept by the entropy pass for its lazy clears);
        # dirty_all: a recovery cleared ranges wholesale, so the list is
        # unreliable
        dp = C.POINTER(C.c_uint64)()
        dn = C.c_size_t()
        da = C.c_int()
        if lib.e264t_dirty(handle, slot, C.byref(dp), C.byref(dn),
                           C.byref(da)) != 0:
            # an empty list marked reliable would ship all-zero
            # coefficient planes from the sparse packer
            self.dirty = np.empty(0, np.uint64)
            self.dirty_all = True
        else:
            n = int(dn.value)
            self.dirty = (np.ctypeslib.as_array(dp, (n,)).copy() if n
                          else np.empty(0, np.uint64))
            self.dirty_all = bool(da.value)

    def pack_probe(self, want_exc: bool = True):
        """The native arena packer's probe: coded-row counts per gathered
        plane (from the dirty list), split-mb counts for the base+exception
        planes (want_exc), and whether every coefficient fits int8.  The
        row lists stay on the slot for pack_row.  A PackProbe, or None on
        a bad slot."""
        pr = PackProbe()
        rc = load().e264t_pack_probe(self._handle, self._slot,
                                     1 if want_exc else 0, C.byref(pr))
        return pr if rc == 0 else None

    def pack_row(self, entries, n: int, out_row: np.ndarray,
                 size: int) -> int:
        """Pack this slot's planes by `n` PackEntry `entries` into the
        first `size` bytes of `out_row` (the interpreter lock is released
        for the call).  The C function checks its bounds only after it has
        written an entry, so a row shorter than `size` is refused here.
        Returns 0 on success, else the C function's error code."""
        if (out_row.dtype != np.uint8 or out_row.ndim != 1
                or not out_row.flags.c_contiguous or out_row.size < size):
            raise ValueError(f"pack_row: out_row of {out_row.size} "
                             f"{out_row.dtype} bytes cannot hold {size}")
        return load().e264t_pack_row(
            self._handle, self._slot, entries, n,
            out_row.ctypes.data_as(C.POINTER(C.c_uint8)), C.c_int64(size))


class NativeDecoder:
    """Thin pythonic wrapper over the C ABI.

    log / log_mbs: YAML syntax logging (per macroblock with log_mbs), read
    back with get_log; n_tasks > 0 parses frames on that many worker
    threads (the native layer stays synchronous while logging)."""

    def __init__(self, log: bool = False, log_mbs: bool = False,
                 n_tasks: int = 0):
        self._lib = load()
        self._h = self._lib.e264t_alloc()
        if log or log_mbs:
            self._lib.e264t_set_logging(self._h, 1, 1 if log_mbs else 0)
        if n_tasks:
            self._lib.e264t_set_threads(self._h, n_tasks)
        self._logbuf = None

    def close(self):
        if self._h:
            self._lib.e264t_free(self._h)
            self._h = None

    def __del__(self):
        self.close()

    def decode_nal(self, data: bytes) -> tuple[int, list]:
        ret = self._lib.e264t_decode_nal(self._h, data, len(data))
        return ret, self.poll()

    def poll(self) -> list:
        """Drain pending events (frames retired by worker tasks since the
        last decode_nal surface here)."""
        evs = []
        ev = Event()
        while self._lib.e264t_poll(self._h, C.byref(ev)):
            evs.append((ev.kind, ev.slot, ev.a, ev.b, ev.c, ev.d))
        return evs

    def wait_frame(self) -> int:
        """Block until the oldest queued output frame completes; 0 when a
        frame should be gettable, -1 if no tasks are in flight."""
        return self._lib.e264t_wait_frame(self._h)

    def get_log(self) -> str:
        if self._logbuf is None:
            self._logbuf = C.create_string_buffer(1 << 22)
        n = self._lib.e264t_get_log(self._h, self._logbuf,
                                    len(self._logbuf))
        return self._logbuf[:n].decode("utf-8", "replace")

    def planes(self, slot: int) -> SyntaxPlanes:
        return SyntaxPlanes(self._h, slot)

    def format(self):
        out = (C.c_int32 * 9)()
        self._lib.e264t_format(self._h, out)
        return dict(mb_w=out[0], mb_h=out[1], crop_left=out[2],
                    crop_right=out[3], crop_top=out[4], crop_bottom=out[5],
                    chroma_format_idc=out[6], num_units_in_tick=out[7],
                    time_scale=out[8])

    def get_frame(self, borrow: bool = False):
        out = (C.c_int32 * 4)()
        if self._lib.e264t_get_frame(self._h, int(borrow), out) != 0:
            return None
        return dict(slot=out[0], slot_mvc=out[1], frame_id=out[2],
                    frame_id_mvc=out[3])

    def return_frame(self, slot: int):
        self._lib.e264t_return_frame(self._h, slot)

    def slot_info(self, slot: int):
        out = (C.c_int32 * 4)()
        self._lib.e264t_slot_info(self._h, slot, out)
        return dict(poc=out[0], frame_num=out[1], complete=out[2],
                    is_ref=out[3])

    def flush(self):
        self._lib.e264t_flush(self._h)
