// Motion-compensated prediction (§8.4.2.2) for K lockstep frames: the
// quarter-pel luma kernel and the eighth-pel bilinear chroma kernel.
//
// Replace the TPU kernels edge264_tpu/ops/pallas_mc.py::_luma_kernel and
// ::_chroma_kernel (driven by run_mc_kernels), which DMA a lane's whole
// reference band into VMEM and place each block's samples with aligned
// (16, 256) window loads, rolls and masks.  The input contract is kept
// field for field: per 8x8 luma block, flags (_F_USED0/1, _F_UNIFORM,
// _F_PAIR, _F_PAIRODD) and 2 lists x 4 quadrants x a pair of int32 load
// words from pack_mc_params, which has already clamped every coordinate
// into the padded band.  The TPU's pair holds one plane << 24 | y << 12 |
// x word per sample read (chroma: the position, then the phase), which
// reaches 253 mbs and 31 ring slots.  Here the pair is a position word
// (y << 15 | x) and a ring word (ring index << 8 | sel: luma's two
// half-pel planes and B's offset from A, or chroma's eighth-pel phase),
// both -1 = skip: the same bytes, and x, y below 2^15 reach the largest
// frame the front end accepts (1023 x 1056 mbs) and the ring index any
// ring the decoders grow, so every frame size and ring takes this kernel.
// Each arm reads a block's rows straight from the lane's ring planes: luma
// the rounded average of two half-pel planes {G, B, H, J} per sample,
// chroma the 2x2 bilinear footprint (Cb/Cr interleaved, so the horizontal
// neighbour is 2 bytes on).  Outputs: per list [K, 8*BR, 8*BC] (luma) or
// [K, 4*BR, 8*BC] (chroma) uint8, zeros where a list is unused.
//
// Bound on the H100: memory, by sectors rather than bytes.  The byte
// bound counts 2 ring bytes per luma output and ~1 per chroma output, but
// every 8-byte row of a block starts at its own motion-vector offset, so
// it costs one or two 32-byte sectors of each plane it reads, and blocks
// whose vectors differ share none.  The arithmetic is a few integer
// operations per output; tensor cores do not apply (gather plus byte
// averages).
//
// Design, to spend the sectors and nothing else:
// - Grid (block-column group of 16 8x8 blocks = 128 samples, luma block
//   row, lane): no index division at run time beyond shifts.  The group's
//   16 flags and 16 x 16 load words are fetched once with 16-byte loads
//   into shared memory; the pair-odd and uniform arms resolve there.
// - One thread per 8-sample output row of one block and both lists (luma:
//   128 threads = 8 rows x 16 blocks; chroma: 64 = 4 x 16), neighbouring
//   threads on neighbouring blocks, so a warp stores 2 rows of 128
//   contiguous bytes with one 8-byte store a thread and list.
// - A row is read as the aligned 32-bit words that overlap its bytes,
//   through the read-only path (the ring is not written during MC), and
//   shifted into place with __funnelshift_r.  Luma averages four samples
//   at once with __vavgu4 ((a + b + 1) >> 1 a byte, exact); chroma forms
//   its sums two samples at a time in the 16-bit halves of a 32-bit
//   integer (64 * 255 + 32 < 2^16, so no half carries into the other).
//
// Why every word read lies in the ring: a word is read only if it
// overlaps a byte the arm needs, so it starts at most 3 bytes before that
// byte and ends at most 3 after.  pack_mc_params clamps x to at most
// pw_b-6, -10 and -18 for the quadrant, 8x8 and 16x8 arms (plus a half-pel
// offset of at most 1, and the odd half of a pair reads from +8), and y to
// ph-6 / ph-10 (plus at most 1), so the last byte a luma row needs is at
// most pw_b-2, on a row at most ph-2.  Chroma x <= pwc_pad-4 / -8 (stored
// doubled, interleaved, so always even) and y <= phc-4 / -8 put the last
// byte a row needs with its +2 neighbour at most pwc2-3, and the +1 row
// at most phc-2.  Row widths are multiples of 128 (mc_band_dims) and the
// ring starts 16-byte aligned (build.check_args), so each word that
// overlaps an in-row byte lies wholly inside that row of that plane.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int F_UNIFORM = 4, F_PAIR = 8, F_PAIRODD = 16;
constexpr int GROUP = 16;                 // 8x8 blocks a CTA (128 samples)
constexpr int WORDS = 16;                 // load words a block

// The group's flags and load words into shared memory, 16 bytes a load
// (both arrays start 16-byte aligned: BC is a multiple of 16), then one
// barrier.
__device__ __forceinline__ void load_group(const int* __restrict__ flg,
                                           const int* __restrict__ pk,
                                           size_t blk0, int* s_flg,
                                           int* s_pk) {
  constexpr int NW = GROUP * WORDS / 4, NF = GROUP / 4;
  const int4* pw = reinterpret_cast<const int4*>(pk + blk0 * WORDS);
  const int4* pf = reinterpret_cast<const int4*>(flg + blk0);
  for (int j = threadIdx.x; j < NW + NF; j += blockDim.x) {
    if (j < NW)
      reinterpret_cast<int4*>(s_pk)[j] = __ldg(pw + j);
    else
      reinterpret_cast<int4*>(s_flg)[j - NW] = __ldg(pf + j - NW);
  }
  __syncthreads();
}

// Byte offset in a lane's planes of row `ri` of a load at (plane, y, x);
// size_t, as a lane's ring can pass 2^31 bytes.
__device__ __forceinline__ size_t word_offset(size_t plane, int y, int x,
                                              int ri, int rows, int pitch) {
  return (plane * rows + y + ri) * pitch + x;
}

__device__ __forceinline__ int word_y(int pos) { return pos >> 15; }
__device__ __forceinline__ int word_x(int pos) { return pos & 0x7FFF; }

// The byte offsets of row ri of a luma load's two samples: A in half-pel
// plane pA at the position word's (y, x), B in plane pB at (dy, dx) in
// {-1, 0, 1} from it (ring word: index << 8 | pA << 6 | pB << 4 |
// (dy + 1) << 2 | (dx + 1)).
__device__ __forceinline__ void luma_offsets(int pos, int ring, int ri,
                                             int ph, int pwb, size_t* oa,
                                             size_t* ob) {
  const size_t plane = (size_t)(ring >> 8) * 4;
  const int y = word_y(pos), x = word_x(pos);
  *oa = word_offset(plane + ((ring >> 6) & 3), y, x, ri, ph, pwb);
  *ob = word_offset(plane + ((ring >> 4) & 3), y + ((ring >> 2) & 3) - 1,
                    x + (ring & 3) - 1, ri, ph, pwb);
}

// The byte offset of row ri of a chroma load (ring word: index << 8 |
// phase).
__device__ __forceinline__ size_t chroma_offset(int pos, int ring, int ri,
                                                int phc, int pwc2) {
  return word_offset(ring >> 8, word_y(pos), word_x(pos), ri, phc, pwc2);
}

// The 4 bytes at byte offset o (any alignment) of a ring row: one or two
// aligned words, funnel-shifted into place.
__device__ __forceinline__ uint32_t bytes4(const uint8_t* __restrict__ p,
                                          size_t o) {
  const uint32_t* w = reinterpret_cast<const uint32_t*>(p + (o & ~size_t(3)));
  const unsigned sh = (o & 3) * 8;
  const uint32_t a = __ldg(w), b = sh ? __ldg(w + 1) : 0u;
  return __funnelshift_r(a, b, sh);
}

// The 8 bytes at byte offset o (any alignment): two or three words.
__device__ __forceinline__ uint2 bytes8(const uint8_t* __restrict__ p,
                                        size_t o) {
  const uint32_t* w = reinterpret_cast<const uint32_t*>(p + (o & ~size_t(3)));
  const unsigned sh = (o & 3) * 8;
  const uint32_t a = __ldg(w), b = __ldg(w + 1), c = sh ? __ldg(w + 2) : 0u;
  return make_uint2(__funnelshift_r(a, b, sh), __funnelshift_r(b, c, sh));
}

// Luma: 4 (quadrant arm) or 8 (joint arms) samples of row ri, from column
// ci of the load word pair (pka, pkb: position and ring words): the
// rounded average of the two half-pel planes' samples, zero where the
// pair is unused.
__device__ __forceinline__ uint32_t luma4(const uint8_t* __restrict__ bk,
                                          int pka, int pkb, int ri, int ph,
                                          int pwb) {
  if (pka < 0) return 0u;
  size_t oa, ob;
  luma_offsets(pka, pkb, ri, ph, pwb, &oa, &ob);
  return __vavgu4(bytes4(bk, oa), bytes4(bk, ob));
}

__device__ __forceinline__ uint2 luma8(const uint8_t* __restrict__ bk,
                                       int pka, int pkb, int ri, int ci,
                                       int ph, int pwb) {
  if (pka < 0) return make_uint2(0u, 0u);
  size_t oa, ob;
  luma_offsets(pka, pkb, ri, ph, pwb, &oa, &ob);
  const uint2 a = bytes8(bk, oa + ci);
  const uint2 b = bytes8(bk, ob + ci);
  return make_uint2(__vavgu4(a.x, b.x), __vavgu4(a.y, b.y));
}

// Four bilinear outputs ((wa*A + wb*B + wc*C + wd*D + 32) >> 6 a byte,
// weights summing to 64) from the corners' words, two at a time in the
// 16-bit halves of a 32-bit sum.
__device__ __forceinline__ uint32_t bilinear4(uint32_t a, uint32_t b,
                                              uint32_t c, uint32_t d,
                                              uint32_t wa, uint32_t wb,
                                              uint32_t wc, uint32_t wd) {
  constexpr uint32_t M = 0x00FF00FFu, HALF = 0x00200020u;
  const uint32_t ev = (a & M) * wa + (b & M) * wb + (c & M) * wc +
                      (d & M) * wd + HALF;
  const uint32_t od = ((a >> 8) & M) * wa + ((b >> 8) & M) * wb +
                      ((c >> 8) & M) * wc + ((d >> 8) & M) * wd + HALF;
  return ((ev >> 6) & M) | (((od >> 6) & M) << 8);
}

struct Weights {
  uint32_t a, b, c, d;
};

__device__ __forceinline__ Weights chroma_weights(int pkb) {
  const uint32_t dx = pkb & 7, dy = (pkb >> 3) & 7;
  return {(8 - dx) * (8 - dy), dx * (8 - dy), (8 - dx) * dy, dx * dy};
}

// Chroma: 4 interleaved bytes (quadrant arm: 2 Cb + 2 Cr) of row ri of a
// load word; the footprint is 6 bytes of rows ri and ri + 1 (o is even,
// so two aligned words cover it).
__device__ __forceinline__ uint32_t chroma4(const uint8_t* __restrict__ bk,
                                            int pka, int pkb, int ri,
                                            int phc, int pwc2) {
  if (pka < 0) return 0u;
  const Weights w = chroma_weights(pkb);
  const size_t o = chroma_offset(pka, pkb, ri, phc, pwc2);
  const unsigned sh = (o & 3) * 8;
  const uint32_t* p = reinterpret_cast<const uint32_t*>(bk + (o & ~size_t(3)));
  const uint32_t* q = p + pwc2 / 4;
  const uint32_t p0 = __ldg(p), p1 = __ldg(p + 1);
  const uint32_t q0 = __ldg(q), q1 = __ldg(q + 1);
  const unsigned s2 = sh + 16;        // the +2 neighbour; 32 takes p1
  return bilinear4(__funnelshift_r(p0, p1, sh), __funnelshift_rc(p0, p1, s2),
                   __funnelshift_r(q0, q1, sh), __funnelshift_rc(q0, q1, s2),
                   w.a, w.b, w.c, w.d);
}

// Chroma, uniform arm: 8 interleaved bytes (4 Cb + 4 Cr) of row ri; the
// footprint is 10 bytes of rows ri and ri + 1 (three aligned words each).
__device__ __forceinline__ uint2 chroma8(const uint8_t* __restrict__ bk,
                                         int pka, int pkb, int ri, int phc,
                                         int pwc2) {
  if (pka < 0) return make_uint2(0u, 0u);
  const Weights w = chroma_weights(pkb);
  const size_t o = chroma_offset(pka, pkb, ri, phc, pwc2);
  const unsigned sh = (o & 3) * 8;
  const uint32_t* p = reinterpret_cast<const uint32_t*>(bk + (o & ~size_t(3)));
  const uint32_t* q = p + pwc2 / 4;
  const uint32_t p0 = __ldg(p), p1 = __ldg(p + 1), p2 = __ldg(p + 2);
  const uint32_t q0 = __ldg(q), q1 = __ldg(q + 1), q2 = __ldg(q + 2);
  const unsigned s2 = sh + 16;        // the +2 neighbour; 32 takes word 1
  return make_uint2(
      bilinear4(__funnelshift_r(p0, p1, sh), __funnelshift_rc(p0, p1, s2),
                __funnelshift_r(q0, q1, sh), __funnelshift_rc(q0, q1, s2),
                w.a, w.b, w.c, w.d),
      bilinear4(__funnelshift_r(p1, p2, sh), __funnelshift_rc(p1, p2, s2),
                __funnelshift_r(q1, q2, sh), __funnelshift_rc(q1, q2, s2),
                w.a, w.b, w.c, w.d));
}

// flg [K, BR, BC] int32, pk [K, BR, BC*16] int32,
// band [K, nplanes, ph, pwb] uint8, out_l [K, 8*BR, 8*BC] uint8.
// Grid (BC/16, BR, K), 128 threads: thread (row i, block bl) of the group.
__global__ void __launch_bounds__(128)
mc_luma(const int* __restrict__ flg, const int* __restrict__ pk,
        const uint8_t* __restrict__ band, uint8_t* __restrict__ out0,
        uint8_t* __restrict__ out1, int BR, int BC, int nplanes, int ph,
        int pwb, int n_lists) {
  __shared__ __align__(16) int s_pk[GROUP * WORDS];
  __shared__ __align__(16) int s_flg[GROUP];
  const int k = blockIdx.z, r = blockIdx.y;
  const int b0 = blockIdx.x * GROUP;
  load_group(flg, pk, ((size_t)k * BR + r) * BC + b0, s_flg, s_pk);
  const int i = threadIdx.x / GROUP, bl = threadIdx.x % GROUP;
  // the odd half of a 16x8 pair: the even block's joint words cover it
  // from column 8
  int e = bl, ci = 0, f = s_flg[bl];
  if (f & F_PAIRODD) {
    e = bl - 1;
    ci = 8;
    f = s_flg[e];
  }
  const bool joint = f & (F_PAIR | F_UNIFORM);
  const uint8_t* bk = band + (size_t)k * nplanes * ph * pwb;
  const size_t o = ((size_t)k * 8 * BR + 8 * r + i) * (8 * BC) + 8 * (b0 + bl);
  for (int l = 0; l < n_lists; ++l) {
    const int* w = s_pk + e * WORDS + l * 8;
    uint2 v = make_uint2(0u, 0u);
    if ((f >> l) & 1) {
      if (joint) {
        v = luma8(bk, w[0], w[1], i, ci, ph, pwb);
      } else {                        // quadrants (i>>2, 0) and (i>>2, 1)
        const int q = (i >> 2) << 1;
        v.x = luma4(bk, w[2 * q], w[2 * q + 1], i & 3, ph, pwb);
        v.y = luma4(bk, w[2 * q + 2], w[2 * q + 3], i & 3, ph, pwb);
      }
    }
    *reinterpret_cast<uint2*>((l ? out1 : out0) + o) = v;
  }
}

// flg [K, BR, BC], pk [K, BR, BC*16] int32 (chroma words),
// band [K, S1, phc, pwc2] uint8 (Cb/Cr interleaved),
// out_l [K, 4*BR, 8*BC] uint8 interleaved.
// Grid (BC/16, BR, K), 64 threads: thread (row i of 4, block bl).
__global__ void __launch_bounds__(64)
mc_chroma(const int* __restrict__ flg, const int* __restrict__ pk,
          const uint8_t* __restrict__ band, uint8_t* __restrict__ out0,
          uint8_t* __restrict__ out1, int BR, int BC, int S1, int phc,
          int pwc2, int n_lists) {
  __shared__ __align__(16) int s_pk[GROUP * WORDS];
  __shared__ __align__(16) int s_flg[GROUP];
  const int k = blockIdx.z, r = blockIdx.y;
  const int b0 = blockIdx.x * GROUP;
  load_group(flg, pk, ((size_t)k * BR + r) * BC + b0, s_flg, s_pk);
  const int i = threadIdx.x / GROUP, bl = threadIdx.x % GROUP;
  const int f = s_flg[bl];
  const bool uni = f & F_UNIFORM;
  const uint8_t* bk = band + (size_t)k * S1 * phc * pwc2;
  const size_t o = ((size_t)k * 4 * BR + 4 * r + i) * (8 * BC) + 8 * (b0 + bl);
  for (int l = 0; l < n_lists; ++l) {
    const int* w = s_pk + bl * WORDS + l * 8;
    uint2 v = make_uint2(0u, 0u);
    if ((f >> l) & 1) {
      if (uni) {
        v = chroma8(bk, w[0], w[1], i, phc, pwc2);
      } else {                        // quadrants (i>>1, 0) and (i>>1, 1)
        const int q = (i >> 1) << 1;
        v.x = chroma4(bk, w[2 * q], w[2 * q + 1], i & 1, phc, pwc2);
        v.y = chroma4(bk, w[2 * q + 2], w[2 * q + 3], i & 1, phc, pwc2);
      }
    }
    *reinterpret_cast<uint2*>((l ? out1 : out0) + o) = v;
  }
}

}  // namespace

// BC must be a multiple of 16 (pack_mc_params pads block columns to a
// multiple of 128 samples); anything else is refused before launch.
extern "C" int e264t_mc_luma(void* flg, void* pk, void* band, void* out0,
                             void* out1, int K, int BR, int BC, int nplanes,
                             int ph, int pwb, int n_lists, void* stream) {
  if (BC % GROUP || pwb % 4) return static_cast<int>(cudaErrorInvalidValue);
  mc_luma<<<dim3(BC / GROUP, BR, K), 8 * GROUP, 0,
            static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(flg), static_cast<const int*>(pk),
      static_cast<const uint8_t*>(band), static_cast<uint8_t*>(out0),
      static_cast<uint8_t*>(out1), BR, BC, nplanes, ph, pwb, n_lists);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int e264t_mc_chroma(void* flg, void* pk, void* band, void* out0,
                               void* out1, int K, int BR, int BC, int S1,
                               int phc, int pwc2, int n_lists, void* stream) {
  if (BC % GROUP || pwc2 % 4) return static_cast<int>(cudaErrorInvalidValue);
  mc_chroma<<<dim3(BC / GROUP, BR, K), 4 * GROUP, 0,
              static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(flg), static_cast<const int*>(pk),
      static_cast<const uint8_t*>(band), static_cast<uint8_t*>(out0),
      static_cast<uint8_t*>(out1), BR, BC, S1, phc, pwc2, n_lists);
  return static_cast<int>(cudaGetLastError());
}
