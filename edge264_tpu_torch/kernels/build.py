"""Build and load the hand-written CUDA kernels (`csrc/*.cu`).

Each source is compiled by `nvcc` for Hopper (`sm_90a`) into its own
shared library with a plain C interface under `edge264_tpu_torch/_build/`
and loaded with ctypes.  Every entry point takes device pointers and the
CUDA stream as `void*`, launches on that stream, and returns
`cudaGetLastError()`.  Nothing here runs at import time: the first call
of a wrapper builds (once per process) what it needs.

    python -m edge264_tpu_torch.kernels.build      # build all, print times
"""

from __future__ import annotations

import ctypes as C
import os
import shutil
import subprocess
import threading
import time

_DIR = os.path.dirname(os.path.abspath(__file__))
_CSRC = os.path.join(_DIR, "csrc")
_BUILD = os.path.join(os.path.dirname(_DIR), "_build")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC"]

_P, _I = C.c_void_p, C.c_int
# library -> {entry: argtypes}; every entry returns int (cudaError_t)
ENTRIES = {
    "deblock": {"e264t_deblock": [_P] * 10 + [_I, _I, _I, _P]},
    "intra": {"e264t_intra": [_P] * 15 + [_I] * 5 + [_P]},
    "mc": {"e264t_mc_luma": [_P] * 5 + [_I] * 7 + [_P],
           "e264t_mc_chroma": [_P] * 5 + [_I] * 7 + [_P]},
    "residual": {"e264t_residual": [_P] * 13 + [_I] * 6 + [_P]},
    "mcpack": {"e264t_mcpack": [_P] * 6 + [_I] * 10 + [_P]},
    "combine": {"e264t_combine": [_P] * 13 + [_I] * 3 + [_P]},
    "bs": {"e264t_bs": [_P] * 6 + [_I] * 3 + [_P]},
}

# one build and one load of each library per process, whichever thread
# (decode_annexb_parallel's workers) asks first
_lock = threading.RLock()
_libs: dict = {}
build_log: dict = {}     # name -> nvcc -Xptxas -v output of the last build


def _nvcc() -> str:
    for cand in (shutil.which("nvcc"),
                 os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                              "bin", "nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found (CUDA toolkit required to build the "
                       "edge264_tpu_torch kernels)")


def _lib_path(name: str) -> str:
    return os.path.join(_BUILD, f"lib{name}.so")


def _stale(name: str) -> bool:
    """The library is missing or older than its source or any header."""
    out = _lib_path(name)
    srcs = [os.path.join(_CSRC, f) for f in os.listdir(_CSRC)
            if f == f"{name}.cu" or f.endswith(".cuh")]
    return not os.path.exists(out) or \
        max(map(os.path.getmtime, srcs)) > os.path.getmtime(out)


def build_all(names=tuple(ENTRIES), force: bool = False) -> dict:
    """Compile the named sources, one nvcc process each, all started
    together.  Returns {name: seconds} for the ones compiled; raises with
    nvcc's output when one fails."""
    with _lock:
        return _build_all(names, force)


def _build_all(names, force):
    todo = [n for n in names if force or _stale(n)]
    if not todo:
        return {}
    os.makedirs(_BUILD, exist_ok=True)
    nvcc = _nvcc()
    procs = {}
    t0 = time.perf_counter()
    for n in todo:
        tmp = f"{_lib_path(n)}.{os.getpid()}.tmp"
        cmd = [nvcc, *NVCC_FLAGS, "-Xptxas", "-v", "-o", tmp,
               os.path.join(_CSRC, f"{n}.cu")]
        procs[n] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                     stderr=subprocess.STDOUT, text=True),
                    tmp)
    secs, failed = {}, []
    for n, (pr, tmp) in procs.items():
        out = pr.communicate()[0]
        secs[n] = time.perf_counter() - t0
        if pr.returncode != 0:
            failed.append(f"--- {n}.cu ---\n{out}")
        else:
            os.replace(tmp, _lib_path(n))
            build_log[n] = out
    if failed:
        raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
    return secs


def lib(name: str) -> C.CDLL:
    """The loaded kernel library `name`.  Loading one builds every stale
    library of ENTRIES first, all nvcc processes at once, so a decode's
    first use of each kernel does not wait for its own build in turn."""
    with _lock:
        if name not in _libs:
            build_all()
            dll = C.CDLL(_lib_path(name))
            for fn, argtypes in ENTRIES[name].items():
                f = getattr(dll, fn)
                f.argtypes = argtypes
                f.restype = C.c_int
            _libs[name] = dll
        return _libs[name]


def check_args(args, dtype, device):
    """Raise unless every (tensor, shape) pair is a contiguous `dtype`
    tensor of that shape on `device`, a CUDA device, starting on a 16-byte
    boundary (check_tensors)."""
    require_cuda(device)
    check_tensors(args, dtype, device)


def require_cuda(device):
    if device.type != "cuda":
        raise ValueError(f"kernels run on CUDA tensors, not {device}")


def check_tensors(args, dtype, device):
    """check_args on any device: every (tensor, shape) pair a contiguous
    `dtype` tensor of that shape on `device`, starting on a 16-byte
    boundary (the kernels' cp.async and int4 loads need it; a view into a
    larger buffer may not).  Raises ValueError."""
    for i, (t, shape) in enumerate(args):
        if t.device != device or t.dtype != dtype:
            raise ValueError(f"arg {i}: {t.dtype} on {t.device}, want "
                             f"{dtype} on {device}")
        if tuple(t.shape) != tuple(shape):
            raise ValueError(f"arg {i}: shape {tuple(t.shape)}, want "
                             f"{tuple(shape)}")
        if not t.is_contiguous():
            raise ValueError(f"arg {i}: not contiguous")
        if t.data_ptr() % 16:
            raise ValueError(f"arg {i}: address {t.data_ptr():#x} not "
                             "16-byte aligned")


def lane_stride(t, shape, dtype, device) -> int:
    """The lane stride in elements of `t`, a `dtype` tensor of `shape`
    ([K, ...]) on `device` whose lanes are each contiguous and start on
    an element boundary, as the meta block's views of a step's arena rows
    are (scaling matrices, slot maps: the kernels read them an element at
    a time).  Raises ValueError otherwise."""
    if t.device != device or t.dtype != dtype:
        raise ValueError(f"{t.dtype} on {t.device}, want {dtype} on "
                         f"{device}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"shape {tuple(t.shape)}, want {tuple(shape)}")
    inner = t[0] if t.shape[0] else t
    if not inner.is_contiguous() or t.data_ptr() % t.element_size():
        raise ValueError("a lane is not contiguous and element-aligned")
    return t.stride(0)


def raise_on(rc: int, what: str):
    if rc != 0:
        raise RuntimeError(f"{what} kernel launch failed: cudaError {rc}")


def launch(name: str, entry: str, device, tensors, *ints):
    """Run `entry` of library `name` on `device`'s current stream with the
    tensors' device pointers (None: a null pointer), then the ints; raise
    when the launch fails."""
    import torch
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        rc = getattr(lib(name), entry)(
            *[C.c_void_p(None if t is None else t.data_ptr())
              for t in tensors], *ints, C.c_void_p(stream))
    raise_on(rc, entry)


if __name__ == "__main__":
    for n, s in build_all(force=True).items():
        print(f"{n}.cu built in {s:.1f} s")
        print(build_log[n])
