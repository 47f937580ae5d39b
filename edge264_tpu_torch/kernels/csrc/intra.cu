// Intra reconstruction (ISO/IEC 14496-10 §8.3) for K lockstep frames.
//
// Replaces the TPU kernel edge264_tpu/ops/pallas_intra.py::_kernel (driven
// by intra_pallas_batch), which walks the wavefront of waves w = mx + 2*my
// as a sequential grid, carries the neighbour tiles of waves w-1..w-3 in
// VMEM and predicts with small matmuls.  It computes what the port's plain
// ops/intra.intra_scan_sheared computes.  Blocks on Hopper run in no order,
// so the carry does not translate: this kernel reconstructs the dense int32
// frames IN PLACE, one launch per wave from a host loop (mbW + 2*mbH - 2
// launches; 254 at 1080p), one 256-thread block per (lane, macroblock) of
// the wave.
//
// Why in place is safe: the neighbours a macroblock reads (left, top-left,
// top, top-right) sit on waves w-1, w-3, w-2 and w-1, so they are final
// when wave w runs, and each macroblock writes only its own samples.  A
// neighbour outside the frame reads as 0, as the plain scan's zero tiles do
// (lanes are separate planes, so no lane reads another).
//
// Inside a block the luma work follows the plain schedule: 16 I4x4
// substeps in quad order, or 4 I8x8 substeps (reference lowpass first), or
// I16x16, or I_PCM; then chroma.  Each substep gathers its neighbour vector
// nb into shared memory (the plain version's layout, ops/tables.py), one
// __syncthreads(), then one thread per sample predicts and adds the
// residual, and a second __syncthreads() publishes the block before the
// next substep reads it (an I4x4 top-right may be a sample of the same
// macroblock, read as it stands, as the plain version does).
//
// Directional modes are integer 3-tap sums (n[i0] + 2*n[i1] + n[i2] + 2)>>2
// from the probed tap tables (I4_IDX, I8_IDX, I16_DIR_IDX, CH_DIR_IDX,
// I8_FILT_IDX), uploaded once per device into __constant__ memory; the
// plain version's float64 matmuls compute the same integers.  A mode
// outside the table predicts 0, as the plain version's one-hot selection
// does.
//
// Bound on the H100: neither bytes nor operations.  A 1080p frame pair is
// ~75 MB of int32 read and written once (~0.02 ms at 3.35 TB/s) and a few
// hundred MOPs; the 254 dependent waves, each at most 68 blocks per lane,
// and the up to 32 block-wide barriers of a macroblock's I4x4 chain bound
// it by latency.  The design keeps every wave to one launch over all K
// lanes.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int MBF_INTRA = 1, MBF_I16x16 = 2, MBF_IPCM = 4, MBF_T8x8 = 8;
enum { L_NONE, L_I4, L_I8, L_I16, L_PCM };
enum { C_NONE, C_PRED, C_PCM };

__constant__ uint8_t c_i4[9][16][3];
__constant__ uint8_t c_i8[9][64][3];
__constant__ uint8_t c_i16[2][256][3];
__constant__ uint8_t c_ch[2][64][3];
__constant__ uint8_t c_f8[25][3];

__device__ __forceinline__ int clip255(int v) { return min(max(v, 0), 255); }

__device__ __forceinline__ int tap3(const int* n, const uint8_t* t) {
  return (n[t[0]] + 2 * n[t[1]] + n[t[2]] + 2) >> 2;
}

// sample (x, y) of a w x h plane, 0 outside it
__device__ __forceinline__ int at(const int* p, int w, int h, int x, int y) {
  return (x >= 0 && y >= 0 && x < w && y < h) ? p[(size_t)y * w + x] : 0;
}

// DC with availability: both / left only / top only / 128
__device__ __forceinline__ int dc3(int aA, int aB, int sl, int st, int sh) {
  if (aA && aB) return (sl + st + (1 << (sh - 1))) >> sh;
  if (aA) return (sl + (1 << (sh - 2))) >> (sh - 1);
  if (aB) return (st + (1 << (sh - 2))) >> (sh - 1);
  return 128;
}

__global__ void __launch_bounds__(256) intra_wave(
    int* __restrict__ y, int* __restrict__ cb, int* __restrict__ cr,
    const int* __restrict__ res_y, const int* __restrict__ res_cb,
    const int* __restrict__ res_cr, const int* __restrict__ i4m,
    const int* __restrict__ i8m, const int* __restrict__ i16m,
    const int* __restrict__ chm, const int* __restrict__ flags,
    const int* __restrict__ pcm_y, const int* __restrict__ pcm_c, int mbW,
    int mbH, int w, int my0, int has_t8, int has_pcm) {
  const int k = blockIdx.y;
  const int my = my0 + blockIdx.x;
  const int mx = w - 2 * my;
  if (my >= mbH || mx < 0 || mx >= mbW) return;
  const int W = 16 * mbW, H = 16 * mbH, Wc = 8 * mbW, Hc = 8 * mbH;
  const int mbi = (k * mbH + my) * mbW + mx;
  const int fl = flags[mbi];
  const bool intra = fl & MBF_INTRA, i16 = fl & MBF_I16x16,
             pcm = fl & MBF_IPCM, t8 = fl & MBF_T8x8;
  // the plain schedule's last writer wins: PCM over I16x16 over I8x8
  const int luma = has_pcm && pcm                       ? L_PCM
                   : i16                                ? L_I16
                   : has_t8 && intra && t8 && !pcm      ? L_I8
                   : intra && !pcm && !t8               ? L_I4
                                                        : L_NONE;
  const int chroma = intra && !pcm ? C_PRED : has_pcm && pcm ? C_PCM : C_NONE;
  if (luma == L_NONE && chroma == C_NONE) return;  // block-uniform

  const int t = threadIdx.x;
  const size_t lane = (size_t)k * H * W, lane_c = (size_t)k * Hc * Wc;
  int* Y = y + lane;
  const int* RY = res_y + lane;
  const int X0 = 16 * mx, Y0 = 16 * my;
  auto P = [&](int x, int yy) { return at(Y, W, H, X0 + x, Y0 + yy); };
  __shared__ int nb[33], nbf[25], nbc[2][17];

  if (luma == L_I4) {
    for (int b = 0; b < 16; ++b) {
      const int bx = (b & 1) | ((b >> 1) & 2);
      const int by = ((b >> 1) & 1) | ((b >> 2) & 2);
      const int c0 = 4 * bx, r0 = 4 * by;
      const int m = i4m[((size_t)k * 4 * mbH + 4 * my + by) * 4 * mbW +
                        4 * mx + bx];
      const int mode = m & 15, aA = (m >> 4) & 1, aB = (m >> 5) & 1,
                aC = (m >> 6) & 1;
      if (t < 13) {  // nb = [l3 l2 l1 l0 | tl | t0 .. t7]
        int v;
        if (t < 4) {
          v = P(c0 - 1, r0 + 3 - t);
        } else if (t == 4) {
          v = P(c0 - 1, r0 - 1);
        } else {
          const int j = t - 5;
          const bool rep = j >= 4 && (!aC || (by > 0 && bx == 3));
          v = P(rep ? c0 + 3 : c0 + j, r0 - 1);
        }
        nb[t] = v;
      }
      __syncthreads();
      if (t < 16) {
        int pred;
        if (mode == 2)
          pred = dc3(aA, aB, nb[0] + nb[1] + nb[2] + nb[3],
                     nb[5] + nb[6] + nb[7] + nb[8], 3);
        else
          pred = mode < 9 ? tap3(nb, c_i4[mode][t]) : 0;
        const size_t i = (size_t)(Y0 + r0 + (t >> 2)) * W + X0 + c0 + (t & 3);
        Y[i] = clip255(pred + RY[i]);
      }
      __syncthreads();
    }
  } else if (luma == L_I8) {
    for (int b = 0; b < 4; ++b) {
      const int bx = b & 1, by = b >> 1, c0 = 8 * bx, r0 = 8 * by;
      const int m = i8m[((size_t)k * 2 * mbH + 2 * my + by) * 2 * mbW +
                        2 * mx + bx];
      const int mode = m & 15, aA = (m >> 4) & 1, aB = (m >> 5) & 1,
                aC = (m >> 6) & 1, aD = (m >> 7) & 1;
      if (t < 25) {  // nb = [l7 .. l0 | tl | t0 .. t15]
        int v;
        if (t < 8) {
          v = P(c0 - 1, r0 + 7 - t);
        } else if (t == 8) {
          v = P(c0 - 1, r0 - 1);
        } else {
          const int j = t - 9;
          const bool rep = j >= 8 && (!aC || (by > 0 && bx == 1));
          v = P(rep ? c0 + 7 : c0 + j, r0 - 1);
        }
        nb[t] = v;
      }
      __syncthreads();
      if (t < 25) {  // §8.3.2.2.1 lowpass with the boundary patches
        const int l0 = nb[7], l1 = nb[6], tl0 = nb[8], t0 = nb[9], t1 = nb[10];
        int f;
        if (t == 7)
          f = aD ? (tl0 + 2 * l0 + l1 + 2) >> 2 : (3 * l0 + l1 + 2) >> 2;
        else if (t == 8)
          f = !aD        ? tl0
              : aA && aB ? (t0 + 2 * tl0 + l0 + 2) >> 2
              : aB       ? (3 * tl0 + t0 + 2) >> 2
              : aA       ? (3 * tl0 + l0 + 2) >> 2
                         : tl0;
        else if (t == 9)
          f = aD ? (tl0 + 2 * t0 + t1 + 2) >> 2 : (3 * t0 + t1 + 2) >> 2;
        else
          f = tap3(nb, c_f8[t]);
        if ((t < 8 && !aA) || (t >= 9 && !aB)) f = nb[t];
        nbf[t] = f;
      }
      __syncthreads();
      if (t < 64) {
        int pred;
        if (mode == 2) {
          int st = 0, sl = 0;
          for (int j = 0; j < 8; ++j) {
            sl += nbf[j];
            st += nbf[9 + j];
          }
          pred = dc3(aA, aB, aA ? sl : 0, aB ? st : 0, 4);
        } else {
          pred = mode < 9 ? tap3(nbf, c_i8[mode][t]) : 0;
        }
        const size_t i = (size_t)(Y0 + r0 + (t >> 3)) * W + X0 + c0 + (t & 7);
        Y[i] = clip255(pred + RY[i]);
      }
      __syncthreads();
    }
  } else if (luma == L_I16) {
    const int m = i16m[mbi], mode = m & 3, aA = (m >> 4) & 1,
              aB = (m >> 5) & 1;
    if (t < 33)  // nb = [l15 .. l0 | tl | t0 .. t15], l/t masked
      nb[t] = t < 16     ? (aA ? P(-1, 15 - t) : 0)
              : t == 16 ? P(-1, -1)
                        : (aB ? P(t - 17, -1) : 0);
    __syncthreads();
    int pred;
    if (mode == 2) {
      int sl = 0, st = 0;
      for (int j = 0; j < 16; ++j) {
        sl += nb[j];
        st += nb[17 + j];
      }
      pred = dc3(aA, aB, sl, st, 5);
    } else if (mode == 3) {
      int hs = 0, vs = 0;
      for (int i = 1; i <= 8; ++i) {
        hs += i * (nb[24 + i] - nb[24 - i]);
        vs += i * (nb[8 - i] - nb[8 + i]);
      }
      const int a = 16 * (nb[0] + nb[32]), b_ = (5 * hs + 32) >> 6,
                c_ = (5 * vs + 32) >> 6;
      pred = clip255((a + b_ * ((t & 15) - 7) + c_ * ((t >> 4) - 7) + 16) >> 5);
    } else {
      pred = tap3(nb, c_i16[mode][t]);
    }
    const size_t i = (size_t)(Y0 + (t >> 4)) * W + X0 + (t & 15);
    Y[i] = clip255(pred + RY[i]);
  } else if (luma == L_PCM) {
    const size_t i = (size_t)(Y0 + (t >> 4)) * W + X0 + (t & 15);
    Y[i] = pcm_y[lane + i];
  }

  const int X0c = 8 * mx, Y0c = 8 * my;
  if (chroma == C_PRED) {
    const int m = chm[mbi], mode = m & 3, aA = (m >> 4) & 1,
              aB = (m >> 5) & 1;
    if (t < 34) {  // nbc[c] = [l7 .. l0 | tl | t0 .. t7], l/t masked
      const int c = t / 17, i = t % 17;
      const int* pl = (c ? cr : cb) + lane_c;
      nbc[c][i] = i < 8    ? (aA ? at(pl, Wc, Hc, X0c - 1, Y0c + 7 - i) : 0)
                  : i == 8 ? at(pl, Wc, Hc, X0c - 1, Y0c - 1)
                           : (aB ? at(pl, Wc, Hc, X0c + i - 9, Y0c - 1) : 0);
    }
    __syncthreads();
    if (t < 128) {
      const int c = t >> 6, q = t & 63, px = q & 7, py = q >> 3;
      const int* n = nbc[c];
      int pred;
      if (mode == 0) {  // DC per 4x4 quadrant
        const int ts0 = n[9] + n[10] + n[11] + n[12];
        const int ts1 = n[13] + n[14] + n[15] + n[16];
        const int ls0 = n[7] + n[6] + n[5] + n[4];
        const int ls1 = n[3] + n[2] + n[1] + n[0];
        const bool right = px >= 4, bottom = py >= 4;
        if (!bottom && !right)
          pred = dc3(aA, aB, ls0, ts0, 3);
        else if (!bottom)
          pred = aB ? (ts1 + 2) >> 2 : aA ? (ls0 + 2) >> 2 : 128;
        else if (!right)
          pred = aA ? (ls1 + 2) >> 2 : aB ? (ts0 + 2) >> 2 : 128;
        else
          pred = dc3(aA, aB, ls1, ts1, 3);
      } else if (mode == 3) {
        int hs = 0, vs = 0;
        for (int i = 1; i <= 4; ++i) {
          hs += i * (n[12 + i] - n[12 - i]);
          vs += i * (n[4 - i] - n[4 + i]);
        }
        const int a = 16 * (n[0] + n[16]), b_ = (34 * hs + 32) >> 6,
                  c_ = (34 * vs + 32) >> 6;
        pred = clip255((a + b_ * (px - 3) + c_ * (py - 3) + 16) >> 5);
      } else {
        pred = tap3(n, c_ch[mode - 1][q]);
      }
      const size_t i = lane_c + (size_t)(Y0c + py) * Wc + X0c + px;
      int* C = c ? cr : cb;
      C[i] = clip255(pred + (c ? res_cr : res_cb)[i]);
    }
  } else if (chroma == C_PCM && t < 128) {
    const int c = t >> 6, q = t & 63;
    const size_t i = (size_t)(Y0c + (q >> 3)) * Wc + X0c + (q & 7);
    (c ? cr : cb)[lane_c + i] = pcm_c[((size_t)k * 2 + c) * Hc * Wc + i];
  }
}

// The tap tables, uint8, in this order: I4 [9][16][3], I8 [9][64][3],
// I16 [2][256][3], chroma [2][64][3], I8 lowpass [25][3].
int upload_tables(const uint8_t* tabs) {
  static bool ready[64];
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return static_cast<int>(e);
  if (dev < 64 && ready[dev]) return 0;
  const struct {
    const void* sym;
    size_t n;
  } parts[] = {{c_i4, sizeof(c_i4)},
               {c_i8, sizeof(c_i8)},
               {c_i16, sizeof(c_i16)},
               {c_ch, sizeof(c_ch)},
               {c_f8, sizeof(c_f8)}};
  for (const auto& p : parts) {
    e = cudaMemcpyToSymbol(p.sym, tabs, p.n);
    if (e != cudaSuccess) return static_cast<int>(e);
    tabs += p.n;
  }
  if (dev < 64) ready[dev] = true;
  return 0;
}

}  // namespace

// y [K,16mbH,16mbW], cb/cr [K,8mbH,8mbW] int32 reconstructed in place from
// the residuals res_* (same shapes); i4_modes [K,4mbH,4mbW], i8_modes
// [K,2mbH,2mbW], i16_modes/ch_modes/mb_flags [K,mbH,mbW], pcm_y [K,16mbH,
// 16mbW], pcm_c [K,2,8mbH,8mbW], all int32; tabs the host tap tables
// (4155 bytes, see upload_tables).  has_t8 / has_pcm = 0 skip the Intra_8x8
// and PCM work as the plain version does.
extern "C" int e264t_intra(void* y, void* cb, void* cr, void* res_y,
                           void* res_cb, void* res_cr, void* i4m, void* i8m,
                           void* i16m, void* chm, void* flags, void* pcm_y,
                           void* pcm_c, void* tabs, int K, int mbW, int mbH,
                           int has_t8, int has_pcm, void* stream) {
  int rc = upload_tables(static_cast<const uint8_t*>(tabs));
  if (rc != 0) return rc;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int n_waves = mbW + 2 * mbH - 2;
  for (int w = 0; w < n_waves; ++w) {
    // macroblocks of wave w: mx = w - 2*my in [0, mbW)
    int my0 = w - mbW + 1 > 0 ? (w - mbW + 2) / 2 : 0;
    int my1 = min(mbH - 1, w / 2);
    if (my1 < my0) continue;
    dim3 grid(my1 - my0 + 1, K);
    intra_wave<<<grid, 256, 0, st>>>(
        static_cast<int*>(y), static_cast<int*>(cb), static_cast<int*>(cr),
        static_cast<const int*>(res_y), static_cast<const int*>(res_cb),
        static_cast<const int*>(res_cr), static_cast<const int*>(i4m),
        static_cast<const int*>(i8m), static_cast<const int*>(i16m),
        static_cast<const int*>(chm), static_cast<const int*>(flags),
        static_cast<const int*>(pcm_y), static_cast<const int*>(pcm_c), mbW,
        mbH, w, my0, has_t8, has_pcm);
  }
  return static_cast<int>(cudaGetLastError());
}
