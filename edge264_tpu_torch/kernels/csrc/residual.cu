// Residual decode (ISO/IEC 14496-10 §8.5) for K lockstep frames: inverse
// quantisation, the 4x4 and 8x8 inverse transforms and the luma (Intra
// 16x16) and chroma DC Hadamards, in one launch.
//
// Replaces the plain PyTorch ops/residual.residual_frame_plain on the
// card, the port of edge264_tpu/ops/jaxdec.py::residual_frame (XLA on the
// TPU, no Pallas kernel): there each coefficient position is a plane of
// its own, so the transforms unroll into some 300 elementwise operations
// over [K, 4H, 4W] planes, each its own launch.  This kernel equals that
// plain version bit for bit (int32 arithmetic as PyTorch's: int32.cuh).
//
// Bound on the H100: memory.  Each macroblock reads 256 luma coefficients
// (from the 4x4 or the 8x8 plane, as its transform flag says) and 128
// chroma ones, 16 luma DC for Intra 16x16, 8 chroma DC and its qp, and
// writes 384 int32 samples: about 3 KB, 26 MB for a 1080p frame, 8 us at
// 3.35 TB/s.  The arithmetic (a multiply and a shift a coefficient, 16 or
// 24 adds a sample for the transforms) is a few hundred integer operations
// a sample at most; tensor cores do not apply.
//
// Design: one thread per job, six jobs a macroblock: the four luma 8x8
// quadrants (one 8x8 transform, or four 4x4 ones with the Intra 16x16 DC
// in coefficient 0) and the 8x8 of each chroma component (four 4x4
// transforms with the 2x2 DC).  Every job is 64 coefficients, so a warp's
// threads do equal work, and a warp holds 32 macroblocks of one row and
// one job kind, so it takes one code path but for the transform flag.
// Coefficients are read and samples written as 16-byte vectors, each a
// whole row of a 4x4 block or half a row of an 8x8 one; the scaling
// products come from the lane's matrices and the normAdjust classes,
// which fold to constants once the loops unroll.  The DC Hadamards are
// recomputed by each job that needs them (16 or 4 values).

#include <cuda_runtime.h>
#include <stdint.h>

#include "int32.cuh"

namespace {

constexpr int MBF_INTRA = 1, MBF_I16x16 = 2, MBF_T8x8 = 8;
constexpr int JOBS = 6;

// normAdjust4x4 / normAdjust8x8 (§8.5.9) by qp % 6 and position class
__constant__ int c_v4[6][3] = {{10, 16, 13}, {11, 18, 14}, {13, 20, 16},
                               {14, 23, 18}, {16, 25, 20}, {18, 29, 23}};
__constant__ int c_v8[6][6] = {
    {20, 18, 32, 19, 25, 24}, {22, 19, 35, 21, 28, 26},
    {26, 23, 42, 24, 33, 31}, {28, 25, 45, 26, 35, 33},
    {32, 28, 51, 30, 40, 38}, {36, 32, 58, 34, 46, 43}};

// the position class of coefficient (i, j) (ops/tables.py _POS4, _POS8)
__device__ __forceinline__ int pos4(int i, int j) {
  return (i % 2 == 0 && j % 2 == 0) ? 0 : (i % 2 == 1 && j % 2 == 1) ? 1 : 2;
}

__device__ __forceinline__ int pos8(int i, int j) {
  const int a = i % 4, b = j % 4;
  if (a == 0 && b == 0) return 0;
  if (i % 2 == 1 && j % 2 == 1) return 1;
  if (a == 2 && b == 2) return 2;
  if ((a == 0 && j % 2 == 1) || (i % 2 == 1 && b == 0)) return 3;
  if ((a == 0 && b == 2) || (a == 2 && b == 0)) return 4;
  return 5;
}

// §8.5.12.1 / §8.5.13.1 on one coefficient: t = c * LevelScale; s = qp / 6
// against the shift base (4 for 4x4, 6 for 8x8)
__device__ __forceinline__ int dequant(int c, int ls, int s, int base) {
  const int t = i32::mul(c, ls);
  return s >= base ? i32::shl(t, s - base)
                   : i32::sar(i32::add(t, i32::shl(1, base - 1 - s)),
                              base - s);
}

__device__ __forceinline__ uint32_t asr(uint32_t v, int k) {
  return static_cast<uint32_t>(static_cast<int>(v) >> k);
}

// §8.5.12.2 in place on d[16] (row-major), then (x + 32) >> 6
__device__ __forceinline__ void idct4(uint32_t* d) {
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    uint32_t* x = d + 4 * r;
    const uint32_t e0 = x[0] + x[2], e1 = x[0] - x[2];
    const uint32_t e2 = asr(x[1], 1) - x[3], e3 = x[1] + asr(x[3], 1);
    x[0] = e0 + e3;
    x[1] = e1 + e2;
    x[2] = e1 - e2;
    x[3] = e0 - e3;
  }
#pragma unroll
  for (int c = 0; c < 4; ++c) {
    const uint32_t f0 = d[c], f1 = d[4 + c], f2 = d[8 + c], f3 = d[12 + c];
    const uint32_t g0 = f0 + f2, g1 = f0 - f2;
    const uint32_t g2 = asr(f1, 1) - f3, g3 = f1 + asr(f3, 1);
    d[c] = asr(g0 + g3 + 32, 6);
    d[4 + c] = asr(g1 + g2 + 32, 6);
    d[8 + c] = asr(g1 - g2 + 32, 6);
    d[12 + c] = asr(g0 - g3 + 32, 6);
  }
}

// one 1-D pass of §8.5.13.2 on x[0], x[s], ..., x[7s], in place
__device__ __forceinline__ void idct8_pass(uint32_t* x, int s) {
  const uint32_t x0 = x[0], x1 = x[s], x2 = x[2 * s], x3 = x[3 * s];
  const uint32_t x4 = x[4 * s], x5 = x[5 * s], x6 = x[6 * s], x7 = x[7 * s];
  const uint32_t e0 = x0 + x4;
  const uint32_t e1 = x5 - x3 - x7 - asr(x7, 1);
  const uint32_t e2 = x0 - x4;
  const uint32_t e3 = x1 + x7 - x3 - asr(x3, 1);
  const uint32_t e4 = asr(x2, 1) - x6;
  const uint32_t e5 = x7 - x1 + x5 + asr(x5, 1);
  const uint32_t e6 = x2 + asr(x6, 1);
  const uint32_t e7 = x3 + x5 + x1 + asr(x1, 1);
  const uint32_t f0 = e0 + e6, f1 = e1 + asr(e7, 2), f2 = e2 + e4;
  const uint32_t f3 = e3 + asr(e5, 2), f4 = e2 - e4, f5 = asr(e3, 2) - e5;
  const uint32_t f6 = e0 - e6, f7 = e7 - asr(e1, 2);
  x[0] = f0 + f7;
  x[s] = f2 + f5;
  x[2 * s] = f4 + f3;
  x[3 * s] = f6 + f1;
  x[4 * s] = f6 - f1;
  x[5 * s] = f4 - f3;
  x[6 * s] = f2 - f5;
  x[7 * s] = f0 - f7;
}

__device__ __forceinline__ void idct8(uint32_t* d) {
#pragma unroll
  for (int r = 0; r < 8; ++r) idct8_pass(d + 8 * r, 1);
#pragma unroll
  for (int c = 0; c < 8; ++c) idct8_pass(d + c, 8);
#pragma unroll
  for (int i = 0; i < 64; ++i) d[i] = asr(d[i] + 32, 6);
}

__device__ __forceinline__ void load16(const int* __restrict__ src,
                                       uint32_t* d) {
  const int4* v = reinterpret_cast<const int4*>(src);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int4 w = __ldg(v + i);
    d[4 * i] = w.x;
    d[4 * i + 1] = w.y;
    d[4 * i + 2] = w.z;
    d[4 * i + 3] = w.w;
  }
}

__device__ __forceinline__ void store4(int* dst, const uint32_t* d) {
  *reinterpret_cast<int4*>(dst) = make_int4(d[0], d[1], d[2], d[3]);
}

// The four 4x4 blocks (2*bq_y + i, 2*bq_x + j), i, j in {0, 1}, of a
// [*, 4 cols] block grid of coefficient rows (16 a block) into samples;
// dc[i][j] (when given) replaces each block's dequantised coefficient 0.
// ls: the 16 LevelScale4x4 values; s: qp / 6.
__device__ __forceinline__ void four_4x4(const int* __restrict__ coef,
                                         int bcols, int by0, int bx0,
                                         const int* ls, int s,
                                         const int (*dc)[2], int* out,
                                         int pitch) {
#pragma unroll
  for (int i = 0; i < 2; ++i) {
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const int by = by0 + i, bx = bx0 + j;
      uint32_t d[16];
      load16(coef + ((size_t)by * bcols + bx) * 16, d);
#pragma unroll
      for (int n = 0; n < 16; ++n) d[n] = dequant(d[n], ls[n], s, 4);
      if (dc) d[0] = dc[i][j];
      idct4(d);
      int* o = out + (size_t)(4 * by) * pitch + 4 * bx;
#pragma unroll
      for (int r = 0; r < 4; ++r) store4(o + (size_t)r * pitch, d + 4 * r);
    }
  }
}

struct Planes {
  const int *flags, *qp, *coef_y, *coef_y8, *coef_y_dc, *coef_c_dc;
  const int *coef_cb, *coef_cr, *sm4, *sm8;
  int *res_y, *res_cb, *res_cr;
  int K, mbW, mbH, sm4_stride, sm8_stride, has_t8;
};

// luma quadrant (qy, qx) of macroblock (k, my, mx)
__device__ void luma_job(const Planes& P, int k, int my, int mx, int qy,
                         int qx, int flags, int qp) {
  const int s = i32::div6(qp), m = i32::mod6(qp);
  const bool intra = flags & MBF_INTRA;
  const int W = P.mbW, H = P.mbH;
  const int pitch = 16 * W;
  int* out = P.res_y + (size_t)k * 16 * H * pitch;
  if (P.has_t8 && (flags & MBF_T8x8)) {
    const int* sm = P.sm8 + (size_t)k * P.sm8_stride + (intra ? 0 : 64);
    int v[6];
#pragma unroll
    for (int c = 0; c < 6; ++c) v[c] = c_v8[m][c];
    const int by = 2 * my + qy, bx = 2 * mx + qx;
    const int* src = P.coef_y8 + (((size_t)k * 2 * H + by) * 2 * W + bx) * 64;
    uint32_t d[64];
#pragma unroll
    for (int q = 0; q < 4; ++q) load16(src + 16 * q, d + 16 * q);
#pragma unroll
    for (int n = 0; n < 64; ++n)
      d[n] = dequant(d[n], i32::mul(__ldg(sm + n), v[pos8(n / 8, n % 8)]), s,
                     6);
    idct8(d);
    int* o = out + (size_t)(8 * by) * pitch + 8 * bx;
#pragma unroll
    for (int r = 0; r < 8; ++r) {
      store4(o + (size_t)r * pitch, d + 8 * r);
      store4(o + (size_t)r * pitch + 4, d + 8 * r + 4);
    }
    return;
  }
  const int* sm = P.sm4 + (size_t)k * P.sm4_stride + (intra ? 0 : 48);
  int v[3];
#pragma unroll
  for (int c = 0; c < 3; ++c) v[c] = c_v4[m][c];
  int ls[16];
#pragma unroll
  for (int n = 0; n < 16; ++n)
    ls[n] = i32::mul(__ldg(sm + n), v[pos4(n / 4, n % 4)]);
  int dcq[2][2];
  const bool i16 = flags & MBF_I16x16;
  if (i16) {
    // Intra 16x16 DC (§8.5.10): f = H c H over the mb's 4x4 DC, scaled by
    // the intra Y matrix's (0, 0) entry
    uint32_t c[16];
    load16(P.coef_y_dc + (((size_t)k * H + my) * W + mx) * 16, c);
#pragma unroll
    for (int b = 0; b < 4; ++b) {          // along the row index
      const uint32_t x0 = c[b], x1 = c[4 + b], x2 = c[8 + b], x3 = c[12 + b];
      c[b] = x0 + x1 + x2 + x3;
      c[4 + b] = x0 + x1 - x2 - x3;
      c[8 + b] = x0 - x1 - x2 + x3;
      c[12 + b] = x0 - x1 + x2 - x3;
    }
    const int ls00 =
        i32::mul(__ldg(P.sm4 + (size_t)k * P.sm4_stride), c_v4[m][0]);
#pragma unroll
    for (int i = 0; i < 2; ++i) {
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int a = 2 * qy + i, b = 2 * qx + j;
        const uint32_t* x = c + 4 * a;       // along the column index
        const uint32_t f =
            b == 0 ? x[0] + x[1] + x[2] + x[3]
            : b == 1 ? x[0] + x[1] - x[2] - x[3]
            : b == 2 ? x[0] - x[1] - x[2] + x[3]
                     : x[0] - x[1] + x[2] - x[3];
        const int t = i32::mul(static_cast<int>(f), ls00);
        dcq[i][j] = s >= 6 ? i32::shl(t, s - 6)
                           : i32::sar(i32::add(t, i32::shl(1, 5 - s)), 6 - s);
      }
    }
  }
  four_4x4(P.coef_y + (size_t)k * 16 * H * W * 16, 4 * W, 4 * my + 2 * qy,
           4 * mx + 2 * qx, ls, s, i16 ? dcq : nullptr, out, pitch);
}

// chroma component comp (1: Cb, 2: Cr) of macroblock (k, my, mx)
__device__ void chroma_job(const Planes& P, int k, int my, int mx, int comp,
                           int flags, int qpc) {
  const int s = i32::div6(qpc), m = i32::mod6(qpc);
  const bool intra = flags & MBF_INTRA;
  const int W = P.mbW, H = P.mbH;
  const int* sm4 = P.sm4 + (size_t)k * P.sm4_stride;
  const int* sm = sm4 + 16 * (intra ? comp : comp + 3);
  int v[3];
#pragma unroll
  for (int c = 0; c < 3; ++c) v[c] = c_v4[m][c];
  int ls[16];
#pragma unroll
  for (int n = 0; n < 16; ++n)
    ls[n] = i32::mul(__ldg(sm + n), v[pos4(n / 4, n % 4)]);
  // 2x2 DC (§8.5.11), scaled by the intra matrix's (0, 0) entry of comp
  const int4 c = __ldg(reinterpret_cast<const int4*>(
      P.coef_c_dc + ((((size_t)k * H + my) * W + mx) * 2 + comp - 1) * 4));
  const int ls00 = i32::mul(__ldg(sm4 + 16 * comp), v[0]);
  const int f[2][2] = {
      {i32::add(i32::add(c.x, c.y), i32::add(c.z, c.w)),
       i32::add(i32::sub(c.x, c.y), i32::sub(c.z, c.w))},
      {i32::sub(i32::add(c.x, c.y), i32::add(c.z, c.w)),
       i32::sub(i32::sub(c.x, c.y), i32::sub(c.z, c.w))}};
  int dc[2][2];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j)
      dc[i][j] = i32::sar(i32::shl(i32::mul(f[i][j], ls00), s), 5);
  const int* coef = comp == 1 ? P.coef_cb : P.coef_cr;
  int* out = comp == 1 ? P.res_cb : P.res_cr;
  four_4x4(coef + (size_t)k * 4 * H * W * 16, 2 * W, 2 * my, 2 * mx, ls, s,
           dc, out + (size_t)k * 64 * H * W, 8 * W);
}

// Thread t: macroblock column fastest, then row, job, lane
__global__ void __launch_bounds__(128) residual_jobs(Planes P) {
  const int n = P.mbW * P.mbH;
  const size_t t = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= (size_t)P.K * JOBS * n) return;
  const int mx = t % P.mbW, my = (t / P.mbW) % P.mbH;
  const int job = (t / n) % JOBS, k = t / ((size_t)n * JOBS);
  const size_t mb = ((size_t)k * P.mbH + my) * P.mbW + mx;
  const int flags = __ldg(P.flags + mb);
  const int4 qp = __ldg(reinterpret_cast<const int4*>(P.qp) + mb);
  if (job < 4)
    luma_job(P, k, my, mx, job >> 1, job & 1, flags, qp.x);
  else
    chroma_job(P, k, my, mx, job - 3, flags, job == 4 ? qp.y : qp.z);
}

}  // namespace

// flags [K,H,W], qp [K,H,W,4], coef_y [K,4H,4W,16], coef_y8 [K,2H,2W,64]
// (unread, may be null, when has_t8 is 0), coef_y_dc [K,H,W,16],
// coef_c_dc [K,H,W,2,4], coef_cb / coef_cr [K,2H,2W,16], sm4 [K,6,16] and
// sm8 [K,6,64] with lane strides in ints (rows of the step's arena),
// res_y [K,16H,16W], res_cb / res_cr [K,8H,8W]; all int32.
extern "C" int e264t_residual(void* flags, void* qp, void* coef_y,
                              void* coef_y8, void* coef_y_dc,
                              void* coef_c_dc, void* coef_cb, void* coef_cr,
                              void* sm4, void* sm8, void* res_y,
                              void* res_cb, void* res_cr, int K, int mbW,
                              int mbH, int sm4_stride, int sm8_stride,
                              int has_t8, void* stream) {
  const Planes P{static_cast<const int*>(flags),
                 static_cast<const int*>(qp),
                 static_cast<const int*>(coef_y),
                 static_cast<const int*>(coef_y8),
                 static_cast<const int*>(coef_y_dc),
                 static_cast<const int*>(coef_c_dc),
                 static_cast<const int*>(coef_cb),
                 static_cast<const int*>(coef_cr),
                 static_cast<const int*>(sm4),
                 static_cast<const int*>(sm8),
                 static_cast<int*>(res_y),
                 static_cast<int*>(res_cb),
                 static_cast<int*>(res_cr),
                 K, mbW, mbH, sm4_stride, sm8_stride, has_t8};
  const size_t threads = (size_t)K * JOBS * mbW * mbH;
  if (threads == 0) return 0;
  residual_jobs<<<(threads + 127) / 128, 128, 0,
                  static_cast<cudaStream_t>(stream)>>>(P);
  return static_cast<int>(cudaGetLastError());
}
