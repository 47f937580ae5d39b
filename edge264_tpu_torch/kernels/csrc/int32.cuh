// int32 arithmetic as PyTorch's integer tensor operations compute it, for
// the kernels that must equal a plain PyTorch version bit for bit
// (residual.cu, mcpack.cu, combine.cu, bs.cu).
//
// PyTorch's int32 products and sums wrap (two's complement); `a << b`
// gives 0 for a count outside [0, 32) and `a >> b` (arithmetic) the sign
// fill for a count outside [0, 31); `//` and `%` round toward minus
// infinity.  In C++ a signed overflow and a left shift of a negative value
// are undefined, and the compiler may rewrite such code on that
// assumption (an `ashr` of an `shl nsw`, say), so these helpers work on
// uint32_t and convert back, which is exact in two's complement.

#pragma once

#include <stdint.h>

namespace i32 {

__device__ __forceinline__ int add(int a, int b) {
  return static_cast<int>(static_cast<uint32_t>(a) + static_cast<uint32_t>(b));
}

__device__ __forceinline__ int sub(int a, int b) {
  return static_cast<int>(static_cast<uint32_t>(a) - static_cast<uint32_t>(b));
}

__device__ __forceinline__ int mul(int a, int b) {
  return static_cast<int>(static_cast<uint32_t>(a) * static_cast<uint32_t>(b));
}

__device__ __forceinline__ int neg(int a) { return sub(0, a); }

// |a| as torch.abs gives it: |INT_MIN| wraps to INT_MIN
__device__ __forceinline__ int abs(int a) { return a < 0 ? neg(a) : a; }

__device__ __forceinline__ int shl(int a, int b) {
  return (b < 0 || b >= 32) ? 0
                            : static_cast<int>(static_cast<uint32_t>(a) << b);
}

__device__ __forceinline__ int sar(int a, int b) {
  return a >> ((b < 0 || b >= 31) ? 31 : b);
}

__device__ __forceinline__ int clamp(int v, int lo, int hi) {
  return v < lo ? lo : (v > hi ? hi : v);
}

// floor division and its remainder by 6 (qp // 6, qp % 6)
__device__ __forceinline__ int div6(int a) {
  const int q = a / 6;
  return (a % 6 != 0 && a < 0) ? q - 1 : q;
}

__device__ __forceinline__ int mod6(int a) { return sub(a, mul(6, div6(a))); }

}  // namespace i32
