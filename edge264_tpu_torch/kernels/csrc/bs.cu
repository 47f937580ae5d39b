// Deblocking boundary strengths (ISO/IEC 14496-10 §8.7.2.1) for K lockstep
// frames: bS of every 4x4 block's left edge (bs_v) and top edge (bs_h), in
// one launch.
//
// Replaces the plain PyTorch ops/deblock.deblock_bs_plain on the card,
// the port of edge264_tpu/ops/jaxdec.py::deblock_bs (XLA on the TPU, no
// Pallas kernel), which forms the neighbours with torch.roll and compares
// every field as a plane of its own: some 120 elementwise launches.  This
// kernel equals it bit for bit everywhere, the wrap-around neighbour that
// torch.roll gives in column and row 0 included (deblocking never reads
// those edges, but the planes match there too).
//
// Bound on the H100: memory.  Per 4x4 block it reads its nonzero count,
// 2 reference slots and 4 motion-vector components, and writes 2
// strengths: 36 bytes, 4.7 MB for a 1080p frame, 1.4 us at 3.35 TB/s;
// some 60 integer operations a block.
//
// Design: one thread per 4x4 block, neighbouring threads on neighbouring
// blocks of a row.  A thread reads its own block and its left and top
// neighbours (each read by three threads, from L1), with the 8x8
// transform's merged nonzero flag read as the 2x2 cells of its 8x8 block.

#include <cuda_runtime.h>
#include <stdint.h>

#include "int32.cuh"

namespace {

constexpr int MBF_INTRA = 1, MBF_T8x8 = 8;

struct Planes {
  const int *flags, *nz, *refslot, *mvs;
  int *bs_v, *bs_h;
  int K, BH, BW;
};

// what §8.7.2.1 reads of one 4x4 block
struct Block {
  bool intra, nz;
  int rs0, rs1, m0x, m0y, m1x, m1y;
};

__device__ __forceinline__ bool nz_at(const int* nz, size_t i) {
  return __ldg(nz + i) > 0;
}

__device__ Block load(const Planes& P, int k, int by, int bx) {
  Block b;
  const int W = P.BW;
  const int flags =
      __ldg(P.flags + ((size_t)k * (P.BH / 4) + by / 4) * (W / 4) + bx / 4);
  b.intra = flags & MBF_INTRA;
  const size_t cell = ((size_t)k * P.BH + by) * W + bx;
  if (flags & MBF_T8x8) {      // the 8x8 block's flag covers its 4 cells
    const size_t c0 = ((size_t)k * P.BH + (by & ~1)) * W + (bx & ~1);
    b.nz = nz_at(P.nz, c0) || nz_at(P.nz, c0 + 1) || nz_at(P.nz, c0 + W) ||
           nz_at(P.nz, c0 + W + 1);
  } else {
    b.nz = nz_at(P.nz, cell);
  }
  const int2 rs = __ldg(reinterpret_cast<const int2*>(P.refslot) + cell);
  const int4 mv = __ldg(reinterpret_cast<const int4*>(P.mvs) + cell);
  b.rs0 = rs.x;
  b.rs1 = rs.y;
  b.m0x = mv.x;
  b.m0y = mv.y;
  b.m1x = mv.z;
  b.m1y = mv.w;
  return b;
}

__device__ __forceinline__ bool far(int ax, int ay, int bx, int by) {
  return i32::abs(i32::sub(ax, bx)) >= 4 || i32::abs(i32::sub(ay, by)) >= 4;
}

// bS of the edge between p (left or top) and q (this block)
__device__ int strength(const Block& p, const Block& q, bool mb_edge) {
  if (p.intra || q.intra) return mb_edge ? 4 : 3;
  if (p.nz || q.nz) return 2;
  const bool pu0 = p.rs0 >= 0, pu1 = p.rs1 >= 0;
  const bool qu0 = q.rs0 >= 0, qu1 = q.rs1 >= 0;
  const int pcnt = pu0 + pu1, qcnt = qu0 + qu1;
  const int pr0 = pu0 ? p.rs0 : 99, pr1 = pu1 ? p.rs1 : 99;
  const int qr0 = qu0 ? q.rs0 : 99, qr1 = qu1 ? q.rs1 : 99;
  const bool refs_diff = pcnt != qcnt || min(pr0, pr1) != min(qr0, qr1) ||
                         max(pr0, pr1) != max(qr0, qr1);
  bool f_mv;
  if (pcnt == 1) {             // p's single vector against q's
    f_mv = far(pu0 ? p.m0x : p.m1x, pu0 ? p.m0y : p.m1y,
               qu0 ? q.m0x : q.m1x, qu0 ? q.m0y : q.m1y);
  } else if (p.rs0 != p.rs1) {
    const bool c0 = p.rs0 == q.rs0;
    f_mv = far(p.m0x, p.m0y, c0 ? q.m0x : q.m1x, c0 ? q.m0y : q.m1y) ||
           far(p.m1x, p.m1y, c0 ? q.m1x : q.m0x, c0 ? q.m1y : q.m0y);
  } else {
    const bool pair_a = !far(p.m0x, p.m0y, q.m0x, q.m0y) &&
                        !far(p.m1x, p.m1y, q.m1x, q.m1y);
    const bool pair_b = !far(p.m0x, p.m0y, q.m1x, q.m1y) &&
                        !far(p.m1x, p.m1y, q.m0x, q.m0y);
    f_mv = !(pair_a || pair_b);
  }
  return refs_diff || f_mv;
}

// Thread t: block column fastest, then row, lane
__global__ void __launch_bounds__(128) bs_blocks(Planes P) {
  const size_t t = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= (size_t)P.K * P.BH * P.BW) return;
  const int bx = t % P.BW, by = (t / P.BW) % P.BH;
  const int k = t / ((size_t)P.BW * P.BH);
  const Block q = load(P, k, by, bx);
  // torch.roll(a, 1, dim): the neighbour of column / row 0 is the last
  const Block left = load(P, k, by, bx == 0 ? P.BW - 1 : bx - 1);
  const Block top = load(P, k, by == 0 ? P.BH - 1 : by - 1, bx);
  P.bs_v[t] = strength(left, q, bx % 4 == 0);
  P.bs_h[t] = strength(top, q, by % 4 == 0);
}

}  // namespace

// flags [K,mbH,mbW], nz_y [K,4mbH,4mbW], refslot [K,4mbH,4mbW,2],
// mvs [K,4mbH,4mbW,2,2]; bs_v, bs_h [K,4mbH,4mbW]; all int32.
extern "C" int e264t_bs(void* flags, void* nz, void* refslot, void* mvs,
                        void* bs_v, void* bs_h, int K, int mbW, int mbH,
                        void* stream) {
  const Planes P{static_cast<const int*>(flags), static_cast<const int*>(nz),
                 static_cast<const int*>(refslot),
                 static_cast<const int*>(mvs), static_cast<int*>(bs_v),
                 static_cast<int*>(bs_h), K, 4 * mbH, 4 * mbW};
  const size_t threads = (size_t)K * 16 * mbW * mbH;
  if (threads == 0) return 0;
  bs_blocks<<<(threads + 127) / 128, 128, 0,
              static_cast<cudaStream_t>(stream)>>>(P);
  return static_cast<int>(cudaGetLastError());
}
