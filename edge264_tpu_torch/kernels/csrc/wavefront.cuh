// Row-synchronised wavefront: the hand-off helpers shared by intra.cu and
// deblock.cu.
//
// Both kernels walk the macroblocks of a frame in the order the standard
// fixes: macroblock (mx, my) may start only when its left neighbour and the
// row above, up to some column past mx, are final.  One block of three
// warps is the worker of one row.  Blocks take rows from an atomic ticket
// counter in order (ticket t -> row t / K of lane t % K), walk their row
// left to right, and publish a per-row progress counter in device memory;
// before a macroblock reads the row above, the worker waits on that row's
// counter.  A worker only ever waits on a row of a smaller ticket, held by
// a block that is already running, so the launch cannot deadlock whatever
// the grid size and occupancy.
//
// The three warps of a worker split the latencies apart (warp
// specialisation), so that the warp on the dependency chain touches only
// shared memory:
// - the load warp stages macroblock after macroblock into a ring of NS
//   shared-memory stages: it starts the cp.async of everything the
//   macroblock needs that the wavefront does not order, then waits on the
//   row above (acquire) and loads the top context through L2 (__ldcg,
//   never the read-only path) while the copies are in flight;
// - the compute warp takes a stage once it is staged, filters or
//   reconstructs the macroblock there, stores the final samples to the
//   frame, and hands the stage back;
// - the publish warp turns the compute warp's shared progress into the
//   row's counter in device memory: __threadfence(), then a release store.
// Inside the block the warps synchronise through shared counters with
// release / acquire at block scope; the publish warp's fence and release
// at device scope are cumulative over the compute warp's stores it has
// acquired.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace wf {

constexpr unsigned FULL = 0xffffffffu;
// A hand-off that takes longer than this is a fault, not a slow card: a
// whole call takes milliseconds.  Past it the kernel traps, so the call
// fails instead of hanging.
constexpr unsigned long long SPIN_LIMIT_NS = 4000000000ull;

__device__ __forceinline__ int ld_acquire(const int* p) {
  int v;
  asm volatile("ld.acquire.gpu.global.s32 %0, [%1];"
               : "=r"(v)
               : "l"(p)
               : "memory");
  return v;
}

__device__ __forceinline__ void st_release(int* p, int v) {
  asm volatile("st.release.gpu.global.s32 [%0], %1;" ::"l"(p), "r"(v)
               : "memory");
}

__device__ __forceinline__ unsigned long long now_ns() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}

// All 32 lanes: return once *p >= need (each lane's own acquire load saw
// it); back off with __nanosleep, trap past SPIN_LIMIT_NS.
__device__ __forceinline__ void wait_at_least(const int* p, int need) {
  if (__all_sync(FULL, ld_acquire(p) >= need)) return;
  const unsigned long long t0 = now_ns();
  unsigned ns = 32;
  for (;;) {
    __nanosleep(ns);
    if (__all_sync(FULL, ld_acquire(p) >= need)) return;
    ns = ns < 256 ? 2 * ns : 256;
    if (__any_sync(FULL, now_ns() - t0 > SPIN_LIMIT_NS)) __trap();
  }
}

// Block-scope release / acquire of a shared counter.
__device__ __forceinline__ int ld_acquire_cta(const int* p) {
  int v;
  asm volatile("ld.acquire.cta.shared.s32 %0, [%1];"
               : "=r"(v)
               : "r"((unsigned)__cvta_generic_to_shared(p))
               : "memory");
  return v;
}

__device__ __forceinline__ void st_release_cta(int* p, int v) {
  asm volatile("st.release.cta.shared.s32 [%0], %1;" ::"r"(
                   (unsigned)__cvta_generic_to_shared(p)),
               "r"(v)
               : "memory");
}

// All 32 lanes: wait until the shared counter *p >= need; returns the
// value lane 0 acquired.  Traps past SPIN_LIMIT_NS like wait_at_least.
__device__ __forceinline__ int wait_cta(const int* p, int need) {
  int v = ld_acquire_cta(p);
  if (__all_sync(FULL, v >= need)) return __shfl_sync(FULL, v, 0);
  const unsigned long long t0 = now_ns();
  for (;;) {
    __nanosleep(20);
    v = ld_acquire_cta(p);
    if (__all_sync(FULL, v >= need)) return __shfl_sync(FULL, v, 0);
    if (__any_sync(FULL, now_ns() - t0 > SPIN_LIMIT_NS)) __trap();
  }
}

// All 32 lanes: publish v as the row's progress, after every store this
// warp has made or acquired.
__device__ __forceinline__ void publish(int* p, int v) {
  __threadfence();
  __syncwarp();
  if ((threadIdx.x & 31) == 0) st_release(p, v);
}

// cp.async: 16 bytes through L2 only (frames), or 4 / 8 bytes (planes
// that nothing writes during the call).
__device__ __forceinline__ void cp16(void* s, const void* g) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;" ::"r"(
                   (unsigned)__cvta_generic_to_shared(s)),
               "l"(g)
               : "memory");
}
__device__ __forceinline__ void cp8(void* s, const void* g) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8;" ::"r"(
                   (unsigned)__cvta_generic_to_shared(s)),
               "l"(g)
               : "memory");
}
__device__ __forceinline__ void cp4(void* s, const void* g) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;" ::"r"(
                   (unsigned)__cvta_generic_to_shared(s)),
               "l"(g)
               : "memory");
}
__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;" ::: "memory");
}
// Wait for all of this lane's copies, then a warp barrier so that every
// lane sees every lane's copies.
__device__ __forceinline__ void cp_wait_all() {
  asm volatile("cp.async.wait_group 0;" ::: "memory");
  __syncwarp();
}

// The three warps of a worker, and its shared-memory stages.
constexpr int W_COMPUTE = 0, W_LOAD = 1, W_PUBLISH = 2, THREADS = 96;
constexpr int NS = 3;

// Blocks for `rows` rows: as many as fit on the card at once, at most one
// a row (a block that finishes its row takes the next ticket).
template <typename F>
cudaError_t grid_size(F kernel, int rows, int* blocks) {
  int dev = 0, sms = 0, per = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per, kernel, THREADS, 0);
  if (e != cudaSuccess) return e;
  const int cap = sms * per;
  *blocks = rows < cap ? rows : (cap > 0 ? cap : 1);
  return cudaSuccess;
}

}  // namespace wf
