// In-loop deblocking filter (ISO/IEC 14496-10 §8.7) for K lockstep frames.
//
// Replaces the TPU kernel edge264_tpu/ops/pallas_deblock.py::_kernel
// (driven by deblock_pallas_batch), which walks the wavefront of waves
// w = mx + 2*my as a sequential grid and carries left/top halos in VMEM.
// It computes what the port's plain ops/deblock.deblock_scan computes, IN
// PLACE on the dense int32 frames.
//
// What bounds it on the H100: neither bytes nor operations but the
// dependency chain.  A 1080p frame pair is ~19 MB of int32 samples, each
// read and written about once (a few microseconds at 3.35 TB/s), and a few
// tens of MOPs of clipped integer filters, for which tensor cores do not
// apply.  But a macroblock's left-edge filter rewrites the 3 right columns
// of its left neighbour and its top-edge filter the 3 bottom rows of its
// top neighbour, after the top-right neighbour's left edge has rewritten
// the top neighbour's right columns: the standard's macroblock order is a
// chain of mbW + 2*mbH - 2 dependent macroblocks (254 at 1080p).
//
// The design (see wavefront.cuh): one launch per call.  A block of three
// warps is the worker of one (lane, macroblock row), taken from a ticket
// counter in order.  The macroblock's working set lives in a shared-memory
// stage: its own 16x16 luma and 8x8 chroma samples with a 4-column
// (chroma 2) left strip and a 4-row (chroma 2) top strip.  The load warp
// fills it: cp.async of the interior (no other worker touches a
// macroblock's own samples before its row reaches them), qp, bS, the edge
// flags and offsets; then, after the wait, the top strip from L2.  The
// compute warp carries the left strip from the macroblock it just
// filtered: lanes 0-15 own one luma line each, 16-23 one Cb line, 24-31
// one Cr line, held in registers; the vertical edges along the rows, a
// warp barrier, the horizontal edges along the columns, with alpha, beta
// and tC0 from __constant__ tables; then it stores what is final.  The
// publish warp publishes.
//
// The invariant of the progress counter: progress[k][my] = n means that
// macroblocks 0 .. n-1 of row my are final for the row below -- every
// sample holds its value after this row's filtering, including the right
// columns that the next macroblock's left edge rewrote; only the bottom 3
// rows, which the row below's top edges rewrite, will change again.  So
// after filtering macroblock n the worker writes back the top strip's
// bottom 3 rows (final: nobody else touches them), macroblock n's columns
// 0-11 (final), and macroblock n-1's right columns from the left strip
// (final now that n's left edge ran), then publishes n (mbW after the
// last).  The row below's macroblock n reads this row's rows 12-15 of
// macroblock n, so it waits for progress >= n + 1; that is the order
// w = mx + 2*my encodes, with the top-right neighbour done.

#include <cuda_runtime.h>
#include <stdint.h>

#include "wavefront.cuh"

namespace {

__constant__ int c_alpha[52] = {
    0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0,
    4, 4, 5, 6, 7, 8, 9, 10, 12, 13, 15, 17, 20, 22, 25, 28, 32, 36, 40, 45,
    50, 56, 63, 71, 80, 90, 101, 113, 127, 144, 162, 182, 203, 226, 255, 255};
__constant__ int c_beta[52] = {
    0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0,
    2, 2, 2, 3, 3, 3, 3, 4, 4, 4, 6, 6, 7, 7, 8, 8, 9, 9, 10, 10,
    11, 11, 12, 12, 13, 13, 14, 14, 15, 15, 16, 16, 17, 17, 18, 18};
__constant__ int c_tc0[3][52] = {
    {0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0,
     0, 0, 0, 0, 0, 0, 0, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 2, 2, 2,
     2, 3, 3, 3, 4, 4, 4, 5, 6, 6, 7, 8, 9, 10, 11, 13},
    {0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0,
     0, 0, 0, 0, 0, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 2, 2, 2, 2, 3,
     3, 3, 4, 4, 5, 5, 6, 7, 8, 8, 10, 11, 12, 13, 15, 17},
    {0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0,
     0, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 2, 2, 2, 2, 3, 3, 3, 4, 4,
     4, 5, 6, 6, 7, 8, 9, 10, 11, 13, 14, 16, 18, 20, 23, 25}};

constexpr int DBF_LEFT = 1, DBF_TOP = 2, DBF_INNER = 4, MBF_T8x8 = 8;

// Tile geometry: luma rows -4..15 by columns -4..15 (pitch 20); chroma
// rows -2..7 by columns -4..7 (pitch 12, so that the interior starts
// 16-byte aligned; columns -4, -3 unused).
constexpr int LP = 20, CP = 12;
__device__ __forceinline__ int lidx(int x, int y) { return (y + 4) * LP + x + 4; }
__device__ __forceinline__ int cidx(int x, int y) { return (y + 2) * CP + x + 4; }

struct __align__(16) Stage {
  int y[20 * LP];     // luma tile
  int c[2][10 * CP];  // cb, cr tiles
  int qp[4], qpt[4];  // this mb's qp planes, the top mb's
  int bsv[16];        // [row segment][edge]
  int bsh[16];        // [edge][column segment]
  int ab[2];          // slice alpha / beta offsets
  int dbf, fl;        // edge flags, mb flags
};

__device__ __forceinline__ int clip3(int lo, int hi, int v) {
  return min(max(v, lo), hi);
}

struct EdgeParams {
  int alpha, beta, tc0;
};

// indexA/indexB from the two sides' qp and the slice offsets (§8.7.2.2)
__device__ __forceinline__ EdgeParams edge_params(int qpp, int qpq, int offA,
                                                  int offB, int bs) {
  int avg = (qpp + qpq + 1) >> 1;
  int ia = clip3(0, 51, avg + offA), ib = clip3(0, 51, avg + offB);
  EdgeParams e;
  e.alpha = c_alpha[ia];
  e.beta = c_beta[ib];
  e.tc0 = c_tc0[min(bs, 3) - 1][ia];
  return e;
}

// §8.7.2.3/.4 luma line p3 p2 p1 p0 | q0 q1 q2 q3, in registers
__device__ __forceinline__ void filter_luma(int p3, int& p2, int& p1, int& p0,
                                            int& q0, int& q1, int& q2, int q3,
                                            int bs, EdgeParams e) {
  if (!(abs(p0 - q0) < e.alpha && abs(p1 - p0) < e.beta &&
        abs(q1 - q0) < e.beta))
    return;
  const bool ap = abs(p2 - p0) < e.beta, aq = abs(q2 - q0) < e.beta;
  int np0, np1, np2, nq0, nq1, nq2;
  if (bs == 4) {
    const int lim = (e.alpha >> 2) + 2;
    const bool sp = ap && abs(p0 - q0) < lim, sq = aq && abs(p0 - q0) < lim;
    np0 = sp ? (p2 + 2 * p1 + 2 * p0 + 2 * q0 + q1 + 4) >> 3
             : (2 * p1 + p0 + q1 + 2) >> 2;
    np1 = sp ? (p2 + p1 + p0 + q0 + 2) >> 2 : p1;
    np2 = sp ? (2 * p3 + 3 * p2 + p1 + p0 + q0 + 4) >> 3 : p2;
    nq0 = sq ? (q2 + 2 * q1 + 2 * q0 + 2 * p0 + p1 + 4) >> 3
             : (2 * q1 + q0 + p1 + 2) >> 2;
    nq1 = sq ? (q2 + q1 + q0 + p0 + 2) >> 2 : q1;
    nq2 = sq ? (2 * q3 + 3 * q2 + q1 + q0 + p0 + 4) >> 3 : q2;
  } else {
    const int tc = e.tc0 + ap + aq;
    const int delta = clip3(-tc, tc, ((q0 - p0) * 4 + (p1 - q1) + 4) >> 3);
    np0 = clip3(0, 255, p0 + delta);
    nq0 = clip3(0, 255, q0 - delta);
    const int avg = (p0 + q0 + 1) >> 1;
    np1 = ap ? p1 + clip3(-e.tc0, e.tc0, (p2 + avg - 2 * p1) >> 1) : p1;
    nq1 = aq ? q1 + clip3(-e.tc0, e.tc0, (q2 + avg - 2 * q1) >> 1) : q1;
    np2 = p2;
    nq2 = q2;
  }
  p2 = np2;
  p1 = np1;
  p0 = np0;
  q0 = nq0;
  q1 = nq1;
  q2 = nq2;
}

// §8.7.2.3/.4 chroma line p1 p0 | q0 q1, in registers
__device__ __forceinline__ void filter_chroma(int p1, int& p0, int& q0, int q1,
                                              int bs, EdgeParams e) {
  if (!(abs(p0 - q0) < e.alpha && abs(p1 - p0) < e.beta &&
        abs(q1 - q0) < e.beta))
    return;
  if (bs == 4) {
    const int np0 = (2 * p1 + p0 + q1 + 2) >> 2;
    q0 = (2 * q1 + q0 + p1 + 2) >> 2;
    p0 = np0;
  } else {
    const int tc = e.tc0 + 1;
    const int delta = clip3(-tc, tc, ((q0 - p0) * 4 + (p1 - q1) + 4) >> 3);
    p0 = clip3(0, 255, p0 + delta);
    q0 = clip3(0, 255, q0 - delta);
  }
}

// An edge's active bit: edge 0 is the mb edge (needs its DBF bit and a
// neighbour inside the frame), inner luma edges 1 and 3 are skipped in
// transform-8x8 mbs.
__device__ __forceinline__ bool edge_on(int e, int dbf, int edge_bit,
                                        bool has_nb, bool t8_odd) {
  if (e == 0) return (dbf & edge_bit) && has_nb;
  return (dbf & DBF_INNER) && !t8_odd;
}

__device__ __forceinline__ int4 ld4(const int* p) {
  return *reinterpret_cast<const int4*>(p);
}
__device__ __forceinline__ void st4(int* p, int4 v) {
  *reinterpret_cast<int4*>(p) = v;
}
__device__ __forceinline__ int2 ld2(const int* p) {
  return *reinterpret_cast<const int2*>(p);
}
__device__ __forceinline__ void st2(int* p, int2 v) {
  *reinterpret_cast<int2*>(p) = v;
}

__global__ void __launch_bounds__(wf::THREADS) deblock_rows(
    int* y, int* cb, int* cr, const int* __restrict__ qp,
    const int* __restrict__ dbfl, const int* __restrict__ ab,
    const int* __restrict__ flags, const int* __restrict__ bs_v,
    const int* __restrict__ bs_h, int* progress, int K, int mbW, int mbH) {
  __shared__ Stage st[wf::NS];
  // the row's ticket; mbs staged, mbs filtered; the count to publish
  __shared__ int row, staged, computed, to_publish;
  const int warp = threadIdx.x >> 5, t = threadIdx.x & 31;
  const int W = 16 * mbW, H = 16 * mbH, Wc = 8 * mbW, Hc = 8 * mbH;
  const int BW = 4 * mbW;
  int* ticket = progress + K * mbH;

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
    int* Y = y + ly + (size_t)16 * my * W;  // row my's first sample row
    int* Cp[2] = {cb + lc + (size_t)8 * my * Wc,
                  cr + lc + (size_t)8 * my * Wc};
    const size_t mb0 = ((size_t)k * mbH + my) * mbW;

    if (warp == wf::W_LOAD) {
      const size_t bs0 = ((size_t)k * 4 * mbH + 4 * my) * BW;
      // cp.async of mb n's own samples (no other worker touches them
      // before this row reaches them) and its planes
      auto prefetch = [&](int n) {
        if (n >= wf::NS) wf::wait_cta(&computed, n - wf::NS + 1);
        Stage& s = st[n % wf::NS];
        for (int j = t; j < 64; j += 32) {
          const int r = j >> 2, q = j & 3;
          wf::cp16(&s.y[lidx(4 * q, r)], Y + (size_t)r * W + 16 * n + 4 * q);
        }
        {
          const int ci = t >> 4, r = (t >> 1) & 7, q = t & 1;
          wf::cp16(&s.c[ci][cidx(4 * q, r)],
                   Cp[ci] + (size_t)r * Wc + 8 * n + 4 * q);
        }
        const size_t mbi = mb0 + n;
        if (t == 0)
          wf::cp16(s.qp, qp + 4 * mbi);
        else if (t == 1 && my > 0)
          wf::cp16(s.qpt, qp + 4 * (mbi - mbW));
        else if (t >= 2 && t < 6)
          wf::cp16(&s.bsv[4 * (t - 2)],
                   bs_v + bs0 + (size_t)(t - 2) * BW + 4 * n);
        else if (t >= 6 && t < 10)
          wf::cp16(&s.bsh[4 * (t - 6)],
                   bs_h + bs0 + (size_t)(t - 6) * BW + 4 * n);
        else if (t == 10)
          wf::cp8(s.ab, ab + 2 * mbi);
        else if (t == 11)
          wf::cp4(&s.dbf, dbfl + mbi);
        else if (t == 12)
          wf::cp4(&s.fl, flags + mbi);
        wf::cp_commit();
      };

      for (int n = 0; n < mbW; ++n) {
        prefetch(n);
        Stage& s = st[n % wf::NS];
        // the top strip, once the row above has macroblock n final
        if (my > 0 && (__ldg(dbfl + mb0 + n) & DBF_TOP)) {
          wf::wait_at_least(prog - 1, n + 1);
          if (t < 16) {  // luma rows -4..-1, one int4 a lane
            const int r = t >> 2, q = t & 3;
            st4(&s.y[lidx(4 * q, r - 4)],
                __ldcg(reinterpret_cast<const int4*>(
                    Y + (ptrdiff_t)(r - 4) * W + 16 * n + 4 * q)));
          } else if (t < 24) {  // chroma rows -2..-1
            const int ci = (t - 16) >> 2, r = ((t - 16) >> 1) & 1, q = t & 1;
            st4(&s.c[ci][cidx(4 * q, r - 2)],
                __ldcg(reinterpret_cast<const int4*>(
                    Cp[ci] + (ptrdiff_t)(r - 2) * Wc + 8 * n + 4 * q)));
          }
        }
        wf::cp_wait_all();
        if (t == 0) wf::st_release_cta(&staged, n + 1);
      }
    } else if (warp == wf::W_COMPUTE) {
      const bool luma = t < 16;
      const int i = luma ? t : t & 7;  // this lane's line within the mb
      const int comp = luma ? 0 : 1 + ((t - 16) >> 3);
      int qpl = 0;  // the left mb's qp of this lane's plane
      for (int n = 0; n < mbW; ++n) {
        wf::wait_cta(&staged, n + 1);
        Stage& s = st[n % wf::NS];
        Stage& s2 = st[(n + 1) % wf::NS];
        const int dbf = s.dbf, offA = s.ab[0], offB = s.ab[1];
        const bool t8 = s.fl & MBF_T8x8;
        const int qpq = s.qp[comp];
        const bool top_on = my > 0 && (dbf & DBF_TOP);

        // Each lane filters its line in registers: v holds luma samples
        // -4..15 across the edges (chroma -2..7), first along its row for
        // the vertical edges, then along its column for the horizontal.
        int v[20];
        const int bsi = luma ? i >> 2 : i >> 1;  // the line's 4x4 segment
        int* C = luma ? s.y : s.c[comp - 1];

        // ---- vertical edges along this lane's row ----------------------
        if (luma) {
#pragma unroll
          for (int j = 0; j < 5; ++j) {
            const int4 w = ld4(&C[lidx(4 * j - 4, i)]);
            v[4 * j] = w.x, v[4 * j + 1] = w.y, v[4 * j + 2] = w.z,
                  v[4 * j + 3] = w.w;
          }
        } else {
#pragma unroll
          for (int j = 0; j < 5; ++j) {
            const int2 w = ld2(&C[cidx(2 * j - 2, i)]);
            v[2 * j] = w.x, v[2 * j + 1] = w.y;
          }
        }
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          if ((!luma && (e & 1)) ||
              !edge_on(e, dbf, DBF_LEFT, n > 0, luma && (e & 1) && t8))
            continue;
          const int bs = s.bsv[4 * bsi + e];
          if (bs == 0) continue;
          const EdgeParams ep =
              edge_params(e == 0 ? qpl : qpq, qpq, offA, offB, bs);
          if (luma)
            filter_luma(v[4 * e], v[4 * e + 1], v[4 * e + 2], v[4 * e + 3],
                        v[4 * e + 4], v[4 * e + 5], v[4 * e + 6],
                        v[4 * e + 7], bs, ep);
          else
            filter_chroma(v[2 * e], v[2 * e + 1], v[2 * e + 2], v[2 * e + 3],
                          bs, ep);
        }
        if (luma) {
#pragma unroll
          for (int j = 0; j < 5; ++j)
            st4(&C[lidx(4 * j - 4, i)], make_int4(v[4 * j], v[4 * j + 1],
                                                   v[4 * j + 2], v[4 * j + 3]));
        } else {
#pragma unroll
          for (int j = 0; j < 5; ++j)
            st2(&C[cidx(2 * j - 2, i)], make_int2(v[2 * j], v[2 * j + 1]));
        }
        __syncwarp();

        // ---- horizontal edges along this lane's column -----------------
#pragma unroll
        for (int j = 0; j < 20; ++j)
          if (luma || j < 10)
            v[j] = luma ? C[lidx(i, j - 4)] : C[cidx(i, j - 2)];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          if ((!luma && (e & 1)) ||
              !edge_on(e, dbf, DBF_TOP, my > 0, luma && (e & 1) && t8))
            continue;
          const int bs = s.bsh[4 * e + bsi];
          if (bs == 0) continue;
          const EdgeParams ep =
              edge_params(e == 0 ? s.qpt[comp] : qpq, qpq, offA, offB, bs);
          if (luma)
            filter_luma(v[4 * e], v[4 * e + 1], v[4 * e + 2], v[4 * e + 3],
                        v[4 * e + 4], v[4 * e + 5], v[4 * e + 6],
                        v[4 * e + 7], bs, ep);
          else
            filter_chroma(v[2 * e], v[2 * e + 1], v[2 * e + 2], v[2 * e + 3],
                          bs, ep);
        }
#pragma unroll
        for (int j = 0; j < 20; ++j)
          if (luma || j < 10) (luma ? C[lidx(i, j - 4)] : C[cidx(i, j - 2)]) = v[j];
        __syncwarp();

        // ---- store what is final, carry the right columns ---------------
        if (top_on) {  // the top mb's rows 13-15 (chroma 7)
          if (t < 12) {
            const int r = 1 + (t >> 2), q = t & 3;
            st4(Y + (ptrdiff_t)(r - 4) * W + 16 * n + 4 * q,
                ld4(&s.y[lidx(4 * q, r - 4)]));
          } else if (t < 16) {
            const int ci = (t - 12) >> 1, q = t & 1;
            st4(Cp[ci] - Wc + 8 * n + 4 * q, ld4(&s.c[ci][cidx(4 * q, -1)]));
          }
        }
        for (int j = t; j < 48; j += 32) {  // mb n, luma columns 0-11
          const int r = j / 3, q = j % 3;
          st4(Y + (size_t)r * W + 16 * n + 4 * q, ld4(&s.y[lidx(4 * q, r)]));
        }
        {  // mb n, chroma columns 0-5
          const int ci = t >> 4, r = (t >> 1) & 7;
          int* g = Cp[ci] + (size_t)r * Wc + 8 * n;
          if (t & 1)
            st2(g + 4, ld2(&s.c[ci][cidx(4, r)]));
          else
            st4(g, ld4(&s.c[ci][cidx(0, r)]));
        }
        if (n > 0) {  // mb n-1's right columns, from the left strip
          if (t < 16)
            st4(Y + (size_t)t * W + 16 * n - 4, ld4(&s.y[lidx(-4, t)]));
          else
            st2(Cp[(t - 16) >> 3] + (size_t)(t & 7) * Wc + 8 * n - 2,
                ld2(&s.c[(t - 16) >> 3][cidx(-2, t & 7)]));
        }
        if (n + 1 < mbW) {  // carry into the next mb's left strip
          if (t < 16)
            st4(&s2.y[lidx(-4, t)], ld4(&s.y[lidx(12, t)]));
          else
            st2(&s2.c[(t - 16) >> 3][cidx(-2, t & 7)],
                ld2(&s.c[(t - 16) >> 3][cidx(6, t & 7)]));
        } else {  // the last mb's right columns are final as they are
          if (t < 16)
            st4(Y + (size_t)t * W + 16 * n + 12, ld4(&s.y[lidx(12, t)]));
          else
            st2(Cp[(t - 16) >> 3] + (size_t)(t & 7) * Wc + 8 * n + 6,
                ld2(&s.c[(t - 16) >> 3][cidx(6, t & 7)]));
        }
        __syncwarp();
        if (t == 0) {
          wf::st_release_cta(&computed, n + 1);
          wf::st_release_cta(&to_publish, n + 1 < mbW ? n : mbW);
        }
        qpl = qpq;
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

}  // namespace

// y [K,16mbH,16mbW], cb/cr [K,8mbH,8mbW] int32 filtered in place;
// qp [K,mbH,mbW,4], deblock [K,mbH,mbW], deblock_ab [K,mbH,mbW,2],
// mb_flags [K,mbH,mbW], bs_v/bs_h [K,4mbH,4mbW], all int32; scratch int32
// [K*mbH + 1], zero: the rows' progress counters, then the row ticket.
// Every pointer 16-byte aligned (cp.async of 16 bytes).  One launch.
extern "C" int e264t_deblock(void* y, void* cb, void* cr, void* qp,
                             void* dbfl, void* ab, void* flags, void* bs_v,
                             void* bs_h, void* scratch, int K, int mbW,
                             int mbH, void* stream) {
  int blocks = 0;
  cudaError_t e = wf::grid_size(deblock_rows, K * mbH, &blocks);
  if (e != cudaSuccess) return static_cast<int>(e);
  deblock_rows<<<blocks, wf::THREADS, 0,
                 static_cast<cudaStream_t>(stream)>>>(
      static_cast<int*>(y), static_cast<int*>(cb), static_cast<int*>(cr),
      static_cast<const int*>(qp), static_cast<const int*>(dbfl),
      static_cast<const int*>(ab), static_cast<const int*>(flags),
      static_cast<const int*>(bs_v), static_cast<const int*>(bs_h),
      static_cast<int*>(scratch), K, mbW, mbH);
  return static_cast<int>(cudaGetLastError());
}
