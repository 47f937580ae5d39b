"""Build a kernel source of edge264_tpu_torch/kernels/csrc for the host.

The four stage kernels (residual.cu, bs.cu, mcpack.cu, combine.cu) use no
shared memory, no barrier and no warp operation: each thread computes its
own outputs from global memory.  So the same source, with CUDA's
qualifiers, `__ldg` and vector types given host meanings and its one
`<<<...>>>` launch replaced by a loop over blocks and threads, compiles
with g++ into a library whose C entry points run the kernel thread by
thread on host memory.  The CPU tests call it through the port's own
wrappers on CPU tensors and hold it to the plain PyTorch versions; only
the card shows that nvcc compiles it and that the launch is right.
"""

from __future__ import annotations

import ctypes as C
import os
import re
import subprocess

CSRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "edge264_tpu_torch", "kernels", "csrc")

SHIM = r"""
#include <algorithm>
#include <cstddef>
#include <cstdint>
#include <cstdlib>
using std::max;
using std::min;
#define __global__
#define __device__
#define __forceinline__ inline
#define __launch_bounds__(n)
#define __constant__
struct int2 { int x, y; };
struct int4 { int x, y, z, w; };
struct uchar2 { unsigned char x, y; };
struct uchar4 { unsigned char x, y, z, w; };
inline int2 make_int2(int a, int b) { return {a, b}; }
inline int4 make_int4(int a, int b, int c, int d) { return {a, b, c, d}; }
inline uchar2 make_uchar2(unsigned char a, unsigned char b) {
  return {a, b};
}
inline uchar4 make_uchar4(unsigned char a, unsigned char b,
                          unsigned char c, unsigned char d) {
  return {a, b, c, d};
}
// a vector load must be aligned to its size, as on the card
template <class T> inline T __ldg(const T* p) {
  if (reinterpret_cast<uintptr_t>(p) % sizeof(T)) abort();
  return *p;
}
struct dim3 { size_t x = 0; };
static dim3 blockIdx, threadIdx, blockDim;
typedef void* cudaStream_t;
const int cudaErrorInvalidValue = 1;
inline int cudaGetLastError() { return 0; }
template <class F, class P>
void host_launch(F kernel, size_t blocks, unsigned threads, const P& p) {
  blockDim.x = threads;
  for (size_t b = 0; b < blocks; ++b)
    for (unsigned t = 0; t < threads; ++t) {
      blockIdx.x = b;
      threadIdx.x = t;
      kernel(p);
    }
}
"""

LAUNCH = re.compile(r"(\w+)<<<([^,]+),\s*([^,]+),\s*0,\s*"
                    r"static_cast<cudaStream_t>\(stream\)>>>\((\w+)\);")


def build(name: str, out_dir: str, entries: dict) -> C.CDLL:
    """csrc/{name}.cu compiled for the host into out_dir, loaded, its
    entries typed from `entries` ({entry: argtypes}, kernels/build.py's
    ENTRIES[name])."""
    with open(os.path.join(CSRC, f"{name}.cu")) as f:
        src = f.read()
    src, n = LAUNCH.subn(r"host_launch(\1, \2, \3, \4);", src)
    if n != 1:
        raise ValueError(f"{name}.cu: {n} launches, want 1")
    src = src.replace("#include <cuda_runtime.h>", SHIM)
    cpp = os.path.join(out_dir, f"{name}_host.cpp")
    lib = os.path.join(out_dir, f"lib{name}_host.so")
    with open(cpp, "w") as f:
        f.write(src)
    subprocess.run(["g++", "-std=c++17", "-O1", "-shared", "-fPIC",
                    "-I", CSRC, "-o", lib, cpp], check=True,
                   capture_output=True)
    dll = C.CDLL(lib)
    for fn, argtypes in entries.items():
        getattr(dll, fn).argtypes = argtypes
        getattr(dll, fn).restype = C.c_int
    return dll
