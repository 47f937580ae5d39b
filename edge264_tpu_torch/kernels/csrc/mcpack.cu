// The MC kernels' parameters (mc.cu's input contract) for K lockstep
// frames: per 8x8 luma block its flags and 2 lists x 4 quadrants x a
// (position, ring) word pair for luma and for chroma, in one launch.
//
// Replaces the plain PyTorch ops/mc.pack_mc_params_plain on the card, the
// port of edge264_tpu/ops/pallas_mc.py::pack_mc_params (XLA on the TPU,
// no Pallas kernel), which builds the words through some 200 where /
// quadrant-reshape passes over [K, 4H, 4W] planes.  This kernel equals it
// bit for bit: the same flags (_F_USED0/1, _F_UNIFORM, _F_PAIR,
// _F_PAIRODD), the same clamps (luma x to pw_b-6 / -10 / -18 for the
// quadrant, 8x8 and 16x8 arms, y to ph-6 / -10; chroma x to pwc_pad-4 /
// -8, y to phc-4 / -8), the _MC_TAB phase columns, and -1 words (flags 0)
// in the padding blocks out to BC.  The word layout is ops/mc.py's
// docstring's: position y << 15 | x, ring ring index << 8 | sel.
//
// Bound on the H100: memory.  Per 8x8 block it reads 4 cells' reference
// slots and motion vectors (96 bytes) and writes 33 words (132 bytes):
// 7.4 MB for a 1080p frame, 2.2 us at 3.35 TB/s; about 150 integer
// operations a block.
//
// Design: one thread per 8x8 block (both lists), neighbouring threads on
// neighbouring blocks of a block row, so the 64-byte word groups of a warp
// are contiguous.  The pair flags need the other block of the 16x8 pair:
// each thread also reads that block's four cells (from L1: its own
// thread reads them too) and decides the pair the same way as its
// partner.

#include <cuda_runtime.h>
#include <stdint.h>

#include "int32.cuh"

namespace {

constexpr int F_UNIFORM = 4, F_PAIR = 8, F_PAIRODD = 16;
constexpr int PADL = 20, PADC = 12;

// _MC_TAB (ops/tables.py) by phase (mvy & 3) * 4 + (mvx & 3): the half-pel
// planes and offsets of samples A and B, (p1, ox1, oy1, p2, ox2, oy2)
__constant__ int c_tab[16][6] = {
    {0, 0, 0, 0, 0, 0}, {0, 0, 0, 1, 0, 0}, {1, 0, 0, 1, 0, 0},
    {0, 1, 0, 1, 0, 0}, {0, 0, 0, 2, 0, 0}, {1, 0, 0, 2, 0, 0},
    {1, 0, 0, 3, 0, 0}, {1, 0, 0, 2, 1, 0}, {2, 0, 0, 2, 0, 0},
    {2, 0, 0, 3, 0, 0}, {3, 0, 0, 3, 0, 0}, {3, 0, 0, 2, 1, 0},
    {0, 0, 1, 2, 0, 0}, {2, 0, 0, 1, 0, 1}, {3, 0, 0, 1, 0, 1},
    {2, 1, 0, 1, 0, 1}};

struct Planes {
  const int *refslot, *mvs, *slot_maps;
  int *flg, *pkl, *pkc;
  int K, mbW, mbH, BC, ph, pwb, phc, pwcp, n_lists, smap_stride;
};

// what the packing reads of one 4x4 cell in one list
struct Cell {
  int used, sidx, mvx, mvy;
};

__device__ __forceinline__ bool same(const Cell& a, const Cell& b) {
  return a.used == b.used && a.sidx == b.sidx && a.mvx == b.mvx &&
         a.mvy == b.mvy;
}

// cells[l][q]: the 4 cells (q = qy * 2 + qx) of 8x8 block (r, b), list l
__device__ void load_block(const Planes& P, int k, int r, int b,
                           Cell (*cells)[4]) {
  const int BH = 4 * P.mbH, BW = 4 * P.mbW;
  const int* smap = P.slot_maps + (size_t)k * P.smap_stride;
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    const size_t cell = ((size_t)k * BH + 2 * r + (q >> 1)) * BW + 2 * b +
                        (q & 1);
    const int2 rs = __ldg(reinterpret_cast<const int2*>(P.refslot) + cell);
    const int4 mv = __ldg(reinterpret_cast<const int4*>(P.mvs) + cell);
#pragma unroll
    for (int l = 0; l < 2; ++l) {
      if (l == P.n_lists) break;
      const int s = l ? rs.y : rs.x;
      cells[l][q] = {s >= 0, __ldg(smap + i32::clamp(s, 0, 31)),
                     l ? mv.z : mv.x, l ? mv.w : mv.y};
    }
  }
}

// every list's four cells agree (_F_UNIFORM)
__device__ __forceinline__ bool uniform(const Cell (*c)[4], int n_lists) {
  bool u = true;
#pragma unroll
  for (int l = 0; l < 2; ++l)
    u = u && (l == n_lists ||
              (same(c[l][0], c[l][1]) && same(c[l][0], c[l][2]) &&
               same(c[l][0], c[l][3])));
  return u;
}

__device__ __forceinline__ int pos_word(int y, int x) {
  return i32::shl(y, 15) | x;
}

__device__ __forceinline__ int ring_word(int sidx, int sel) {
  return i32::shl(sidx, 8) | sel;
}

// the luma word pair of a load at unclamped (gx + (mvx >> 2), gy +
// (mvy >> 2)) of c's vector, x clamped to pwb - xr and y to ph - yr
__device__ __forceinline__ int2 luma_words(const Planes& P, const Cell& c,
                                           int gx, int gy, int xr, int yr) {
  if (!c.used) return make_int2(-1, -1);
  const int px = i32::clamp(i32::add(gx + PADL, c.mvx >> 2), 0, P.pwb - xr);
  const int py = i32::clamp(i32::add(gy + PADL, c.mvy >> 2), 0, P.ph - yr);
  const int* t = c_tab[(c.mvy & 3) * 4 + (c.mvx & 3)];
  const int sel = t[0] << 6 | t[3] << 4 | (t[5] - t[2] + 1) << 2 |
                  (t[4] - t[1] + 1);
  return make_int2(pos_word(py + t[2], px + t[1]), ring_word(c.sidx, sel));
}

// the chroma word pair of a load at the chroma cell (gx, gy) (luma cell
// coordinates halved), x clamped to pwcp - xr and y to phc - yr
__device__ __forceinline__ int2 chroma_words(const Planes& P, const Cell& c,
                                             int gx, int gy, int xr,
                                             int yr) {
  if (!c.used) return make_int2(-1, -1);
  const int px = i32::clamp(i32::add(gx + PADC, c.mvx >> 3), 0, P.pwcp - xr);
  const int py = i32::clamp(i32::add(gy + PADC, c.mvy >> 3), 0, P.phc - yr);
  return make_int2(pos_word(py, 2 * px),
                   ring_word(c.sidx, (c.mvy & 7) << 3 | (c.mvx & 7)));
}

__device__ __forceinline__ void store16(int* dst, const int* w) {
#pragma unroll
  for (int i = 0; i < 4; ++i)
    reinterpret_cast<int4*>(dst)[i] =
        make_int4(w[4 * i], w[4 * i + 1], w[4 * i + 2], w[4 * i + 3]);
}

// Thread t: block column (of BC, padding included) fastest, then block
// row, lane
__global__ void __launch_bounds__(128) pack_blocks(Planes P) {
  const int BR = 2 * P.mbH, bc = 2 * P.mbW;
  const size_t t = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= (size_t)P.K * BR * P.BC) return;
  const int b = t % P.BC, r = (t / P.BC) % BR;
  const int k = t / ((size_t)P.BC * BR);
  int wl[16], wc[16];
  int flags = 0;
#pragma unroll
  for (int i = 0; i < 16; ++i) wl[i] = wc[i] = -1;
  if (b < bc) {
    Cell own[2][4], other[2][4];
    load_block(P, k, r, b, own);
    load_block(P, k, r, b ^ 1, other);
    const bool uni = uniform(own, P.n_lists);
    // the 16x8 pair: both blocks uniform and their top-left cells equal
    bool pair = uni && uniform(other, P.n_lists);
#pragma unroll
    for (int l = 0; l < 2; ++l)
      pair = pair && (l == P.n_lists || same(own[l][0], other[l][0]));
    const bool even = (b & 1) == 0;
    flags = (uni ? F_UNIFORM : 0) |
            (pair ? (even ? F_PAIR : F_PAIRODD) : 0);
    const int gx = 8 * b, gy = 8 * r;       // the block's top-left cell
#pragma unroll
    for (int l = 0; l < 2; ++l) {
      if (l == P.n_lists) break;
      int used = 0;
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const Cell& c = own[l][q];
        used |= c.used;
        const int cx = gx + 4 * (q & 1), cy = gy + 4 * (q >> 1);
        int2 lw = luma_words(P, c, cx, cy, 6, 6);
        int2 cw = chroma_words(P, c, cx >> 1, cy >> 1, 4, 4);
        if (q == 0 && uni) {
          lw = (pair && even) ? luma_words(P, c, gx, gy, 18, 10)
                              : luma_words(P, c, gx, gy, 10, 10);
          cw.x = chroma_words(P, c, gx >> 1, gy >> 1, 8, 8).x;
        }
        wl[l * 8 + 2 * q] = lw.x;
        wl[l * 8 + 2 * q + 1] = lw.y;
        wc[l * 8 + 2 * q] = cw.x;
        wc[l * 8 + 2 * q + 1] = cw.y;
      }
      flags |= used << l;
    }
  }
  P.flg[t] = flags;
  store16(P.pkl + t * 16, wl);
  store16(P.pkc + t * 16, wc);
}

}  // namespace

// refslot [K,4mbH,4mbW,2], mvs [K,4mbH,4mbW,2,2], slot_maps [K,32] with a
// lane stride in ints (rows of the step's arena); flg [K,2mbH,BC],
// pkl / pkc [K,2mbH,BC,16]; all int32.  n_lists 1 leaves list 1's words
// -1.  (ph, pwb, phc, pwcp): mc_band_dims of the geometry.
extern "C" int e264t_mcpack(void* refslot, void* mvs, void* slot_maps,
                            void* flg, void* pkl, void* pkc, int K, int mbW,
                            int mbH, int BC, int ph, int pwb, int phc,
                            int pwcp, int n_lists, int smap_stride,
                            void* stream) {
  if (BC < 2 * mbW || n_lists < 1 || n_lists > 2)
    return static_cast<int>(cudaErrorInvalidValue);
  const Planes P{static_cast<const int*>(refslot),
                 static_cast<const int*>(mvs),
                 static_cast<const int*>(slot_maps),
                 static_cast<int*>(flg),
                 static_cast<int*>(pkl),
                 static_cast<int*>(pkc),
                 K, mbW, mbH, BC, ph, pwb, phc, pwcp, n_lists, smap_stride};
  const size_t threads = (size_t)K * 2 * mbH * BC;
  if (threads == 0) return 0;
  pack_blocks<<<(threads + 127) / 128, 128, 0,
                static_cast<cudaStream_t>(stream)>>>(P);
  return static_cast<int>(cudaGetLastError());
}
