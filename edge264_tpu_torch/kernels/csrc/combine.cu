// Weighted-prediction combine (ISO/IEC 14496-10 §8.4.2.3) of the MC
// kernels' per-list predictions for K lockstep frames, in one launch.
//
// Replaces the plain PyTorch ops/mc.combine_mc_plain on the card, the port
// of edge264_tpu/ops/pallas_mc.py::combine_mc and jaxdec.py::_mc_combine
// (XLA on the TPU, no Pallas kernel), which expands every per-mb and
// per-block weight to a sample plane and selects the arms with some 150
// where / repeat passes.  This kernel equals it bit for bit: default,
// explicit single-list and explicit / implicit bi-prediction weights from
// wp (mode, luma and chroma logWD per mb) and wp8 (weights and offsets
// per 8x8 block, list and component), and mid-gray 128 for the cells of an
// inter mb that no valid list predicts (a corrupt stream's concealment).
//
// Bound on the H100: memory.  Per 4x4 luma cell it reads 2 lists x (16
// luma + 8 chroma) int32 samples, its reference slots and its weights,
// and writes 24 int32 samples and 24 mask bytes: about 320 bytes, 42 MB
// for a 1080p frame, 12.5 us at 3.35 TB/s; some 20 integer operations a
// sample.
//
// Design: one thread per 4x4 luma cell and its 2x2 chroma cells (both
// components), neighbouring threads on neighbouring cells.  The cell's
// weights are read once; each luma row is a 16-byte vector of each list
// and of the output, each chroma row (Cb, Cr interleaved) one of each
// list.

#include <cuda_runtime.h>
#include <stdint.h>

#include "int32.cuh"

namespace {

constexpr int MBF_INTER = 64;

struct Planes {
  const int *flags, *refslot, *wp, *wp8, *y0, *c0, *y1, *c1;
  int *pred_y, *pred_cb, *pred_cr;
  uint8_t *mask_y, *mask_c;
  int K, mbW, mbH;
};

// one component's weights for this cell: mode, logWD, (w, o) per list
struct Weights {
  int mode, logwd, w0, o0, w1, o1;
};

__device__ __forceinline__ int clip255(int v) { return i32::clamp(v, 0, 255); }

// one sample from the lists' samples p0, p1 (u0, u1: the lists used)
__device__ __forceinline__ int combine(int p0, int p1, bool u0, bool u1,
                                       const Weights& w) {
  if (u0 && u1) {
    if (w.mode == 0) return i32::sar(i32::add(i32::add(p0, p1), 1), 1);
    const int v = i32::sar(
        i32::add(i32::add(i32::mul(p0, w.w0), i32::mul(p1, w.w1)),
                 i32::shl(1, w.logwd)),
        i32::add(w.logwd, 1));
    return clip255(i32::add(v, i32::sar(i32::add(i32::add(w.o0, w.o1), 1),
                                        1)));
  }
  if (!(u0 || u1)) return 0;
  const int ps = u0 ? p0 : p1;
  if (w.mode != 1) return ps;
  const int ws = u0 ? w.w0 : w.w1, os = u0 ? w.o0 : w.o1;
  const int v = w.logwd >= 1
                    ? i32::sar(i32::add(i32::mul(ps, ws),
                                        i32::shl(1, w.logwd - 1)),
                               w.logwd)
                    : i32::mul(ps, ws);
  return clip255(i32::add(v, os));
}

// Thread t: cell column fastest, then cell row, lane
__global__ void __launch_bounds__(128) combine_cells(Planes P) {
  const int BH = 4 * P.mbH, BW = 4 * P.mbW;
  const size_t t = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= (size_t)P.K * BH * BW) return;
  const int bx = t % BW, by = (t / BW) % BH;
  const int k = t / ((size_t)BW * BH);
  const int2 rs = __ldg(reinterpret_cast<const int2*>(P.refslot) + t);
  const bool u0 = rs.x >= 0, u1 = P.y1 && rs.y >= 0;
  const size_t mb = ((size_t)k * P.mbH + (by >> 2)) * P.mbW + (bx >> 2);
  const int* wp = P.wp + mb * 24;
  const int mode = __ldg(wp), lwd = __ldg(wp + 1), cwd = __ldg(wp + 2);
  // wp8 [K, 2H, 2W, list, component, (w, o)]
  const int* w8 =
      P.wp8 + (((size_t)k * 2 * P.mbH + (by >> 1)) * 2 * P.mbW + (bx >> 1)) *
                  12;
  Weights w[3];
#pragma unroll
  for (int c = 0; c < 3; ++c)
    w[c] = {mode, c ? cwd : lwd, __ldg(w8 + 2 * c), __ldg(w8 + 2 * c + 1),
            __ldg(w8 + 6 + 2 * c), __ldg(w8 + 7 + 2 * c)};
  const bool orphan = (__ldg(P.flags + mb) & MBF_INTER) && !(u0 || u1);
  const uint8_t mask = u0 || u1 || orphan;

  // luma: 4 rows of 4 samples
  const int pitch = 16 * P.mbW;
  const size_t oy = ((size_t)k * 16 * P.mbH + 4 * by) * pitch + 4 * bx;
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const size_t o = oy + (size_t)r * pitch;
    const int4 a = __ldg(reinterpret_cast<const int4*>(P.y0 + o));
    const int4 b = P.y1 ? __ldg(reinterpret_cast<const int4*>(P.y1 + o)) : a;
    int4 v;
    v.x = orphan ? 128 : combine(a.x, b.x, u0, u1, w[0]);
    v.y = orphan ? 128 : combine(a.y, b.y, u0, u1, w[0]);
    v.z = orphan ? 128 : combine(a.z, b.z, u0, u1, w[0]);
    v.w = orphan ? 128 : combine(a.w, b.w, u0, u1, w[0]);
    *reinterpret_cast<int4*>(P.pred_y + o) = v;
    *reinterpret_cast<uchar4*>(P.mask_y + o) =
        make_uchar4(mask, mask, mask, mask);
  }

  // chroma: 2 rows of 2 samples, [.., 2] Cb / Cr interleaved per list
  const int cpitch = 8 * P.mbW;
  const size_t oc = ((size_t)k * 8 * P.mbH + 2 * by) * cpitch + 2 * bx;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const size_t o = oc + (size_t)r * cpitch;
    const int4 a = __ldg(reinterpret_cast<const int4*>(P.c0 + 2 * o));
    const int4 b =
        P.c1 ? __ldg(reinterpret_cast<const int4*>(P.c1 + 2 * o)) : a;
    int2 cb, cr;
    cb.x = orphan ? 128 : combine(a.x, b.x, u0, u1, w[1]);
    cr.x = orphan ? 128 : combine(a.y, b.y, u0, u1, w[2]);
    cb.y = orphan ? 128 : combine(a.z, b.z, u0, u1, w[1]);
    cr.y = orphan ? 128 : combine(a.w, b.w, u0, u1, w[2]);
    *reinterpret_cast<int2*>(P.pred_cb + o) = cb;
    *reinterpret_cast<int2*>(P.pred_cr + o) = cr;
    *reinterpret_cast<uchar2*>(P.mask_c + o) = make_uchar2(mask, mask);
  }
}

}  // namespace

// flags [K,H,W], refslot [K,4H,4W,2], wp [K,H,W,24], wp8 [K,2H,2W,2,3,2],
// per list y [K,16H,16W] and c [K,8H,8W,2] (list 1's null without list
// 1); pred_y [K,16H,16W], pred_cb / pred_cr [K,8H,8W] int32; mask_y,
// mask_c bytes of the same shapes (torch.bool).
extern "C" int e264t_combine(void* flags, void* refslot, void* wp, void* wp8,
                             void* y0, void* c0, void* y1, void* c1,
                             void* pred_y, void* pred_cb, void* pred_cr,
                             void* mask_y, void* mask_c, int K, int mbW,
                             int mbH, void* stream) {
  if ((y1 == nullptr) != (c1 == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  const Planes P{static_cast<const int*>(flags),
                 static_cast<const int*>(refslot),
                 static_cast<const int*>(wp),
                 static_cast<const int*>(wp8),
                 static_cast<const int*>(y0),
                 static_cast<const int*>(c0),
                 static_cast<const int*>(y1),
                 static_cast<const int*>(c1),
                 static_cast<int*>(pred_y),
                 static_cast<int*>(pred_cb),
                 static_cast<int*>(pred_cr),
                 static_cast<uint8_t*>(mask_y),
                 static_cast<uint8_t*>(mask_c),
                 K, mbW, mbH};
  const size_t threads = (size_t)K * 16 * mbW * mbH;
  if (threads == 0) return 0;
  combine_cells<<<(threads + 127) / 128, 128, 0,
                  static_cast<cudaStream_t>(stream)>>>(P);
  return static_cast<int>(cudaGetLastError());
}
