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
    """The loaded kernel library `name` (built on first use)."""
    with _lock:
        if name not in _libs:
            build_all((name,))
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
    boundary (the kernels' cp.async and int4 loads need it; a view into a
    larger buffer may not)."""
    if device.type != "cuda":
        raise ValueError(f"kernels run on CUDA tensors, not {device}")
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


def raise_on(rc: int, what: str):
    if rc != 0:
        raise RuntimeError(f"{what} kernel launch failed: cudaError {rc}")


if __name__ == "__main__":
    for n, s in build_all(force=True).items():
        print(f"{n}.cu built in {s:.1f} s")
        print(build_log[n])
