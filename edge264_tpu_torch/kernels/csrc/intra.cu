// Intra reconstruction (ISO/IEC 14496-10 §8.3) for K lockstep frames.
//
// Replaces the TPU kernel edge264_tpu/ops/pallas_intra.py::_kernel (driven
// by intra_pallas_batch), which walks the wavefront of waves w = mx + 2*my
// as a sequential grid, carries the neighbour tiles of waves w-1..w-3 in
// VMEM and predicts with small matmuls.  It computes what the port's plain
// ops/intra.intra_scan_sheared computes, IN PLACE on the dense int32
// frames.
//
// What bounds it on the H100: neither bytes nor operations but the
// dependency chain.  A 1080p frame pair is ~100 MB of int32 moved once
// (~0.03 ms at 3.35 TB/s) and a few tens of MOPs; but macroblock (mx, my)
// needs its left, top-left, top and top-right neighbours final, so the
// last macroblock sits at the end of a chain of mbW + 2*mbH - 2 dependent
// macroblocks (254 at 1080p), and inside an I4x4 macroblock each of the 16
// 4x4 blocks waits on the one before.  The arithmetic is integer 3-tap sums
// and clips on that chain: tensor cores do not apply.
//
// The design (see wavefront.cuh): one launch per call.  A block of three
// warps is the worker of one (lane, macroblock row), taken from a ticket
// counter in order.  Before a macroblock reads the row above, its worker
// waits until that row's progress counter reaches min(mx + 2, mbW) -- the
// top-right neighbour final, exactly the order w = mx + 2*my encodes.  A
// macroblock with no intra or PCM work has no dependency and its samples
// are final before this stage, so the worker publishes past it without
// staging or waiting: on intra-sparse frames the chain is only the intra
// macroblocks' own.
//
// Each macroblock is reconstructed on a shared-memory tile: rows -1..15 by
// columns -1..23 of luma (left column, top-left, 16 top and 8 top-right
// samples around the 16x16 interior), rows -1..7 by columns -1..7 of each
// chroma plane.  The load warp stages it: cp.async of the interior (the
// frame's pre-intra samples, or the PCM samples of an I_PCM macroblock,
// so that an I4x4 top-right sample of the same macroblock not yet
// reconstructed is read as it stands, as the plain schedule reads it),
// the residuals, mode words and flags, and the left column when the left
// neighbour has no work; then, after the wait, the top row from L2.  The
// compute warp carries the left column from the macroblock it just
// reconstructed, runs the substep chain on the tile with warp barriers
// only, and stores the finished tile once; the publish warp publishes.
// The tap tables are uploaded once per device into __constant__ memory and
// packed into shared memory at block start.
//
// The luma work follows the plain schedule: 16 I4x4 substeps in quad
// order, or 4 I8x8 substeps (reference lowpass first), or I16x16, or
// I_PCM, the plain schedule's last writer winning (PCM over I16x16 over
// I8x8); then chroma.  Directional modes are (n[i0] + 2*n[i1] + n[i2] + 2)
// >> 2 from the probed tap tables (I4_IDX, I8_IDX, I16_DIR_IDX, CH_DIR_IDX,
// I8_FILT_IDX); a mode outside the table predicts 0, as the plain
// version's one-hot selection does.  A neighbour outside the frame reads
// as 0, as the plain scan's zero tiles do.

#include <cuda_runtime.h>
#include <stdint.h>

#include "wavefront.cuh"

namespace {

constexpr int MBF_INTRA = 1, MBF_I16x16 = 2, MBF_IPCM = 4, MBF_T8x8 = 8;
enum { L_NONE, L_I4, L_I8, L_I16, L_PCM };
enum { C_NONE, C_PRED, C_PCM };
constexpr int MAX_MBW = 1024;  // the per-row work mask's bits: the
                               // front end's widest row is 1023 mbs
constexpr int MASK_WORDS = MAX_MBW / 32;

__constant__ uint8_t c_i4[9][16][3];
__constant__ uint8_t c_i8[9][64][3];
__constant__ uint8_t c_i16[2][256][3];
__constant__ uint8_t c_ch[2][64][3];
__constant__ uint8_t c_f8[25][3];

// Tile geometry: luma rows -1..15, columns -4..23 (pitch 28, so that the
// interior and the top row start 16-byte aligned); chroma rows -1..7,
// columns -4..7 (pitch 12).
constexpr int LP = 28, LR = 17, CP = 12, CR = 9;
__device__ __forceinline__ int lidx(int x, int y) { return (y + 1) * LP + x + 4; }
__device__ __forceinline__ int cidx(int x, int y) { return (y + 1) * CP + x + 4; }

struct __align__(16) Stage {
  int y[LR * LP];     // luma tile
  int c[2][CR * CP];  // cb, cr tiles
  int ry[256];        // residuals, raster order within the macroblock
  int rc[2][64];
  int i4[16];         // [by][bx]
  int i8[4];          // [by][bx]
  int i16, ch, fl, pad;
};

__device__ __forceinline__ int clip255(int v) { return min(max(v, 0), 255); }

// The tap tables packed one triple a word (i0 | i1 << 8 | i2 << 16), in
// shared memory: a warp's lanes read different taps, which constant
// memory would serialise.
struct Taps {
  uint32_t i4[9][16], i8[9][64], i16[2][256], ch[2][64], f8[25];
};

__device__ void pack_taps(uint32_t* dst, const uint8_t* src, int n) {
  for (int j = threadIdx.x; j < n; j += blockDim.x)
    dst[j] = src[3 * j] | src[3 * j + 1] << 8 | src[3 * j + 2] << 16;
}

__device__ __forceinline__ int tap3(const int* n, uint32_t w) {
  return (n[w & 255] + 2 * n[(w >> 8) & 255] + n[w >> 16] + 2) >> 2;
}

// DC with availability: both / left only / top only / 128
__device__ __forceinline__ int dc3(int aA, int aB, int sl, int st, int sh) {
  if (aA && aB) return (sl + st + (1 << (sh - 1))) >> sh;
  if (aA) return (sl + (1 << (sh - 2))) >> (sh - 1);
  if (aB) return (st + (1 << (sh - 2))) >> (sh - 1);
  return 128;
}

// The plain schedule's luma and chroma work for a macroblock's flags.
__device__ __forceinline__ void kinds(int fl, int has_t8, int has_pcm,
                                      int& luma, int& chroma) {
  const bool intra = fl & MBF_INTRA, i16 = fl & MBF_I16x16,
             pcm = fl & MBF_IPCM, t8 = fl & MBF_T8x8;
  luma = has_pcm && pcm                    ? L_PCM
         : i16                             ? L_I16
         : has_t8 && intra && t8 && !pcm   ? L_I8
         : intra && !pcm && !t8            ? L_I4
                                           : L_NONE;
  chroma = intra && !pcm ? C_PRED : has_pcm && pcm ? C_PCM : C_NONE;
}

// Reconstruct one macroblock on its tile (all 32 lanes).
__device__ void recon(Stage& s, int luma, int chroma, const Taps& tp,
                      int* nb, int* nbf, int (*nbc)[17]) {
  const int t = threadIdx.x & 31;
  int* T = s.y;
  if (luma == L_I4) {
    for (int b = 0; b < 16; ++b) {
      const int bx = (b & 1) | ((b >> 1) & 2);
      const int by = ((b >> 1) & 1) | ((b >> 2) & 2);
      const int c0 = 4 * bx, r0 = 4 * by;
      const int m = s.i4[4 * by + bx];
      const int mode = m & 15, aA = (m >> 4) & 1, aB = (m >> 5) & 1,
                aC = (m >> 6) & 1;
      if (t < 13) {  // nb = [l3 l2 l1 l0 | tl | t0 .. t7]
        int v;
        if (t < 4) {
          v = T[lidx(c0 - 1, r0 + 3 - t)];
        } else if (t == 4) {
          v = T[lidx(c0 - 1, r0 - 1)];
        } else {
          const int j = t - 5;
          const bool rep = j >= 4 && (!aC || (by > 0 && bx == 3));
          v = T[lidx(rep ? c0 + 3 : c0 + j, r0 - 1)];
        }
        nb[t] = v;
      }
      __syncwarp();
      if (t < 16) {
        int pred;
        if (mode == 2)
          pred = dc3(aA, aB, nb[0] + nb[1] + nb[2] + nb[3],
                     nb[5] + nb[6] + nb[7] + nb[8], 3);
        else
          pred = mode < 9 ? tap3(nb, tp.i4[mode][t]) : 0;
        const int x = c0 + (t & 3), yy = r0 + (t >> 2);
        T[lidx(x, yy)] = clip255(pred + s.ry[16 * yy + x]);
      }
      __syncwarp();
    }
  } else if (luma == L_I8) {
    for (int b = 0; b < 4; ++b) {
      const int bx = b & 1, by = b >> 1, c0 = 8 * bx, r0 = 8 * by;
      const int m = s.i8[2 * by + bx];
      const int mode = m & 15, aA = (m >> 4) & 1, aB = (m >> 5) & 1,
                aC = (m >> 6) & 1, aD = (m >> 7) & 1;
      if (t < 25) {  // nb = [l7 .. l0 | tl | t0 .. t15]
        int v;
        if (t < 8) {
          v = T[lidx(c0 - 1, r0 + 7 - t)];
        } else if (t == 8) {
          v = T[lidx(c0 - 1, r0 - 1)];
        } else {
          const int j = t - 9;
          const bool rep = j >= 8 && (!aC || (by > 0 && bx == 1));
          v = T[lidx(rep ? c0 + 7 : c0 + j, r0 - 1)];
        }
        nb[t] = v;
      }
      __syncwarp();
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
          f = tap3(nb, tp.f8[t]);
        if ((t < 8 && !aA) || (t >= 9 && !aB)) f = nb[t];
        nbf[t] = f;
      }
      __syncwarp();
      int dc = 0;
      if (mode == 2) {
        int st = 0, sl = 0;
        for (int j = 0; j < 8; ++j) {
          sl += nbf[j];
          st += nbf[9 + j];
        }
        dc = dc3(aA, aB, aA ? sl : 0, aB ? st : 0, 4);
      }
      for (int q = t; q < 64; q += 32) {
        const int pred =
            mode == 2 ? dc : mode < 9 ? tap3(nbf, tp.i8[mode][q]) : 0;
        const int x = c0 + (q & 7), yy = r0 + (q >> 3);
        T[lidx(x, yy)] = clip255(pred + s.ry[16 * yy + x]);
      }
      __syncwarp();
    }
  } else if (luma == L_I16) {
    const int m = s.i16, mode = m & 3, aA = (m >> 4) & 1, aB = (m >> 5) & 1;
    for (int i = t; i < 33; i += 32)  // nb = [l15 .. l0 | tl | t0 .. t15]
      nb[i] = i < 16    ? (aA ? T[lidx(-1, 15 - i)] : 0)
              : i == 16 ? T[lidx(-1, -1)]
                        : (aB ? T[lidx(i - 17, -1)] : 0);
    __syncwarp();
    int dc = 0, a = 0, b_ = 0, c_ = 0;
    if (mode == 2) {
      int sl = 0, st = 0;
      for (int j = 0; j < 16; ++j) {
        sl += nb[j];
        st += nb[17 + j];
      }
      dc = dc3(aA, aB, sl, st, 5);
    } else if (mode == 3) {
      int hs = 0, vs = 0;
      for (int i = 1; i <= 8; ++i) {
        hs += i * (nb[24 + i] - nb[24 - i]);
        vs += i * (nb[8 - i] - nb[8 + i]);
      }
      a = 16 * (nb[0] + nb[32]);
      b_ = (5 * hs + 32) >> 6;
      c_ = (5 * vs + 32) >> 6;
    }
    for (int q = t; q < 256; q += 32) {
      const int x = q & 15, yy = q >> 4;
      const int pred =
          mode == 2   ? dc
          : mode == 3 ? clip255((a + b_ * (x - 7) + c_ * (yy - 7) + 16) >> 5)
                      : tap3(nb, tp.i16[mode][q]);
      T[lidx(x, yy)] = clip255(pred + s.ry[q]);
    }
    __syncwarp();
  }
  // L_PCM: the interior already holds the PCM samples.

  if (chroma == C_PRED) {
    const int m = s.ch, mode = m & 3, aA = (m >> 4) & 1, aB = (m >> 5) & 1;
    for (int i = t; i < 34; i += 32) {  // [l7 .. l0 | tl | t0 .. t7], masked
      const int c = i / 17, j = i % 17;
      const int* C = s.c[c];
      nbc[c][j] = j < 8    ? (aA ? C[cidx(-1, 7 - j)] : 0)
                  : j == 8 ? C[cidx(-1, -1)]
                           : (aB ? C[cidx(j - 9, -1)] : 0);
    }
    __syncwarp();
    for (int q2 = t; q2 < 128; q2 += 32) {
      const int c = q2 >> 6, q = q2 & 63, px = q & 7, py = q >> 3;
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
        pred = tap3(n, tp.ch[mode - 1][q]);
      }
      s.c[c][cidx(px, py)] = clip255(pred + s.rc[c][q]);
    }
    __syncwarp();
  }
  // C_PCM: the interiors already hold the PCM samples.
}

__global__ void __launch_bounds__(wf::THREADS) intra_rows(
    int* y, int* cb, int* cr, const int* __restrict__ res_y,
    const int* __restrict__ res_cb, const int* __restrict__ res_cr,
    const int* __restrict__ i4m, const int* __restrict__ i8m,
    const int* __restrict__ i16m, const int* __restrict__ chm,
    const int* __restrict__ flags, const int* __restrict__ pcm_y,
    const int* __restrict__ pcm_c, int* progress, int K, int mbW, int mbH,
    int has_t8, int has_pcm) {
  __shared__ Stage st[wf::NS];
  __shared__ Taps taps;
  __shared__ int nb[33], nbf[25], nbc[2][17];
  __shared__ unsigned work[MASK_WORDS];
  // the row's ticket; stages staged, stages computed (both counted from
  // the row's first work mb); the mb count to publish
  __shared__ int row, staged, computed, to_publish;
  const int warp = threadIdx.x >> 5, t = threadIdx.x & 31;
  const int W = 16 * mbW, H = 16 * mbH, Wc = 8 * mbW, Hc = 8 * mbH;
  const int nwords = (mbW + 31) / 32;
  int* ticket = progress + K * mbH;

  pack_taps(&taps.i4[0][0], &c_i4[0][0][0], 9 * 16);
  pack_taps(&taps.i8[0][0], &c_i8[0][0][0], 9 * 64);
  pack_taps(&taps.i16[0][0], &c_i16[0][0][0], 2 * 256);
  pack_taps(&taps.ch[0][0], &c_ch[0][0][0], 2 * 64);
  pack_taps(taps.f8, &c_f8[0][0], 25);
  for (;;) {
    if (threadIdx.x == 0) {
      row = atomicAdd(ticket, 1);
      staged = computed = to_publish = 0;
    }
    __syncthreads();
    const int tk = row;
    if (tk >= K * mbH) return;
    const int my = tk / K, k = tk % K;
    int* prog = progress + k * mbH + my;
    const size_t ly = (size_t)k * H * W, lc = (size_t)k * Hc * Wc;
    int* Y = y + ly;
    int* Cp[2] = {cb + lc, cr + lc};
    const int* frow = flags + ((size_t)k * mbH + my) * mbW;
    const size_t yrow = (size_t)16 * my * W, crow = (size_t)8 * my * Wc;

    if (warp == wf::W_COMPUTE) {  // which mbs of the row have work
      for (int w = 0; w < nwords; ++w) {
        const int mx = 32 * w + t;
        int l = L_NONE, c = C_NONE;
        if (mx < mbW) kinds(frow[mx], has_t8, has_pcm, l, c);
        const unsigned b =
            __ballot_sync(wf::FULL, l != L_NONE || c != C_NONE);
        if (t == 0) work[w] = b;
      }
    }
    __syncthreads();
    auto next_work = [&](int from) {  // first work mb at or after `from`
      for (int w = from >> 5; w < nwords; ++w) {
        const unsigned m =
            work[w] & (w == (from >> 5) ? ~0u << (from & 31) : ~0u);
        if (m) return 32 * w + __ffs(m) - 1;
      }
      return mbW;
    };

    if (warp == wf::W_LOAD) {
      const int* RC[2] = {res_cb + lc, res_cr + lc};
      const int* PC[2] = {pcm_c + 2 * lc, pcm_c + 2 * lc + (size_t)Hc * Wc};
      // cp.async of everything item i (mb n) needs that the wavefront does
      // not order; its left column comes from the compute warp when the
      // previous item is mb n-1 (carried), else from the frame
      auto prefetch = [&](int i, int n, bool carried) {
        if (i >= wf::NS) wf::wait_cta(&computed, i - wf::NS + 1);
        Stage& s = st[i % wf::NS];
        int l, c;
        kinds(frow[n], has_t8, has_pcm, l, c);
        const int* srcY = l == L_PCM ? pcm_y + ly : Y;
        for (int j = t; j < 64; j += 32) {
          const int r = j >> 2, q = j & 3;
          const size_t g = yrow + (size_t)r * W + 16 * n + 4 * q;
          wf::cp16(&s.y[lidx(4 * q, r)], srcY + g);
          if (l != L_PCM && l != L_NONE)
            wf::cp16(&s.ry[16 * r + 4 * q], res_y + ly + g);
        }
        {
          const int ci = t >> 4, r = (t >> 1) & 7, q = t & 1;
          const size_t g = crow + (size_t)r * Wc + 8 * n + 4 * q;
          wf::cp16(&s.c[ci][cidx(4 * q, r)],
                   (c == C_PCM ? PC[ci] : Cp[ci]) + g);
          if (c == C_PRED) wf::cp16(&s.rc[ci][8 * r + 4 * q], RC[ci] + g);
        }
        const size_t mbi = ((size_t)k * mbH + my) * mbW + n;
        if (t < 4)
          wf::cp16(&s.i4[4 * t], i4m + ((size_t)k * 4 * mbH + 4 * my + t) *
                                           4 * mbW + 4 * n);
        else if (t < 6 && has_t8)
          wf::cp8(&s.i8[2 * (t - 4)],
                  i8m + ((size_t)k * 2 * mbH + 2 * my + t - 4) * 2 * mbW +
                      2 * n);
        else if (t == 6)
          wf::cp4(&s.i16, i16m + mbi);
        else if (t == 7)
          wf::cp4(&s.ch, chm + mbi);
        else if (t == 8)
          wf::cp4(&s.fl, flags + mbi);
        if (!carried) {  // lanes 0-15 luma rows, 16-31 chroma rows
          int* dst = t < 16 ? &s.y[lidx(-1, t)]
                            : &s.c[(t - 16) >> 3][cidx(-1, t & 7)];
          if (n == 0)
            *dst = 0;
          else if (t < 16)
            wf::cp4(dst, Y + yrow + (size_t)t * W + 16 * n - 1);
          else
            wf::cp4(dst, Cp[(t - 16) >> 3] + crow + (size_t)(t & 7) * Wc +
                             8 * n - 1);
        }
        wf::cp_commit();
      };

      int i = 0, prev = -2;
      for (int n = next_work(0); n < mbW; prev = n, n = next_work(n + 1)) {
        prefetch(i, n, n == prev + 1);
        Stage& s = st[i % wf::NS];
        // the row above, once its mbs 0 .. n+1 are final
        if (my > 0) wf::wait_at_least(prog - 1, min(n + 2, mbW));
        if (t < 6) {  // top 16 + top-right 8 luma samples, as int4
          int4 v = make_int4(0, 0, 0, 0);
          const int x = 16 * n + 4 * t;  // t >= 4: the top-right mb
          if (my > 0 && x < W)
            v = __ldcg(reinterpret_cast<const int4*>(Y + yrow - W + x));
          *reinterpret_cast<int4*>(&s.y[lidx(4 * t, -1)]) = v;
        } else if (t == 6) {
          s.y[lidx(-1, -1)] =
              my > 0 && n > 0 ? __ldcg(Y + yrow - W + 16 * n - 1) : 0;
        } else if (t < 11) {
          const int ci = (t - 7) >> 1, q = (t - 7) & 1;
          int4 v = make_int4(0, 0, 0, 0);
          if (my > 0)
            v = __ldcg(reinterpret_cast<const int4*>(Cp[ci] + crow - Wc +
                                                     8 * n + 4 * q));
          *reinterpret_cast<int4*>(&s.c[ci][cidx(4 * q, -1)]) = v;
        } else if (t < 13) {
          const int ci = t - 11;
          s.c[ci][cidx(-1, -1)] =
              my > 0 && n > 0 ? __ldcg(Cp[ci] + crow - Wc + 8 * n - 1) : 0;
        }
        wf::cp_wait_all();
        ++i;
        if (t == 0) wf::st_release_cta(&staged, i);
      }
    } else if (warp == wf::W_COMPUTE) {
      int n = next_work(0);
      if (t == 0) wf::st_release_cta(&to_publish, n);  // the leading run
      for (int i = 0; n < mbW; ++i) {
        const int nx = next_work(n + 1);
        wf::wait_cta(&staged, i + 1);
        Stage& s = st[i % wf::NS];
        Stage& s2 = st[(i + 1) % wf::NS];
        int l, c;
        kinds(s.fl, has_t8, has_pcm, l, c);
        recon(s, l, c, taps, nb, nbf, nbc);

        // store the tile, carry its right column, hand the stage back
        for (int j = t; j < 64; j += 32) {
          const int r = j >> 2, q = j & 3;
          *reinterpret_cast<int4*>(Y + yrow + (size_t)r * W + 16 * n +
                                   4 * q) =
              *reinterpret_cast<const int4*>(&s.y[lidx(4 * q, r)]);
        }
        {
          const int ci = t >> 4, r = (t >> 1) & 7, q = t & 1;
          *reinterpret_cast<int4*>(Cp[ci] + crow + (size_t)r * Wc + 8 * n +
                                   4 * q) =
              *reinterpret_cast<const int4*>(&s.c[ci][cidx(4 * q, r)]);
        }
        if (nx == n + 1) {
          if (t < 16)
            s2.y[lidx(-1, t)] = s.y[lidx(15, t)];
          else
            s2.c[(t - 16) >> 3][cidx(-1, t & 7)] =
                s.c[(t - 16) >> 3][cidx(7, t & 7)];
        }
        __syncwarp();
        if (t == 0) {
          wf::st_release_cta(&computed, i + 1);
          wf::st_release_cta(&to_publish, nx);  // mbs n .. nx-1 are final
        }
        n = nx;
      }
    } else {  // W_PUBLISH
      for (int done = 0; done < mbW;) {
        done = wf::wait_cta(&to_publish, done + 1);
        wf::publish(prog, done);
      }
    }
    __syncthreads();
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
// (4155 bytes, see upload_tables); scratch int32 [K*mbH + 1], zero: the
// rows' progress counters, then the row ticket.  has_t8 / has_pcm = 0
// skip the Intra_8x8 and PCM work as the plain version does.  Every frame
// and plane pointer 16-byte aligned (cp.async of 16 bytes).  One launch.
// Rows wider than MAX_MBW mbs return cudaErrorInvalidValue, unlaunched.
extern "C" int e264t_intra(void* y, void* cb, void* cr, void* res_y,
                           void* res_cb, void* res_cr, void* i4m, void* i8m,
                           void* i16m, void* chm, void* flags, void* pcm_y,
                           void* pcm_c, void* tabs, void* scratch, int K,
                           int mbW, int mbH, int has_t8, int has_pcm,
                           void* stream) {
  if (mbW > MAX_MBW) return static_cast<int>(cudaErrorInvalidValue);
  int rc = upload_tables(static_cast<const uint8_t*>(tabs));
  if (rc != 0) return rc;
  int blocks = 0;
  cudaError_t e = wf::grid_size(intra_rows, K * mbH, &blocks);
  if (e != cudaSuccess) return static_cast<int>(e);
  intra_rows<<<blocks, wf::THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<int*>(y), static_cast<int*>(cb), static_cast<int*>(cr),
      static_cast<const int*>(res_y), static_cast<const int*>(res_cb),
      static_cast<const int*>(res_cr), static_cast<const int*>(i4m),
      static_cast<const int*>(i8m), static_cast<const int*>(i16m),
      static_cast<const int*>(chm), static_cast<const int*>(flags),
      static_cast<const int*>(pcm_y), static_cast<const int*>(pcm_c),
      static_cast<int*>(scratch), K, mbW, mbH, has_t8, has_pcm);
  return static_cast<int>(cudaGetLastError());
}
