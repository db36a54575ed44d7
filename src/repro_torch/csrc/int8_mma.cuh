// Int8 tensor-core fragments shared by the int8 serving kernels
// (qat_dense.cu, fused_forward.cu): the warp-wide mma.sync m16n8k32
// s8 x s8 -> s32 product (IMMA.16832 in SASS), the k permutations that let
// each kernel fill its A registers with wide loads or straight from the
// previous layer's accumulators, the 4 x 4 byte transpose that turns
// row-major (K, N) weights into K-major B fragments, the requantizing
// epilogue, and the mbarrier + bulk-copy helpers.
//
// Fragment layouts (PTX ISA, mma.m16n8k32 .s8), lane = 4 g + t:
//   A (16 x 32, row): a[0] = A[g][4t..4t+3]       a[1] = A[g+8][4t..4t+3]
//                     a[2] = A[g][16+4t..16+4t+3] a[3] = A[g+8][16+4t..]
//   B (32 x 8, col):  b.x  = B[4t..4t+3][g]       b.y  = B[16+4t..][g]
//   D (16 x 8, s32):  d[0], d[1] = D[g][2t], D[g][2t+1]
//                     d[2], d[3] = D[g+8][2t], D[g+8][2t+1]
// byte q of a register is element q (lowest byte first).
//
// The logical k of a 32-wide chunk need not be the weight row it stands
// for: int8 products summed in int32 are exact in any order (|sum| <=
// K * 2^14 < 2^31 for K < 2^17), so a kernel may map logical k to any
// physical row, as long as its A and B registers use the same map.  Two
// maps serve here, for byte q of half h of lane t (h = 0: a[0], a[1], b.x;
// h = 1: a[2], a[3], b.y):
//   kInput: physical 8t + 4h + q — lane t's eight k of a row are
//           contiguous, one 8-byte load of int8 (or two float4 loads of
//           fp32 features to quantize);
//   kChain: physical 16h + 8(q >> 1) + 2t + (q & 1) — exactly the columns
//           lane t holds in the D fragments of the chunk's four n8 tiles,
//           so a layer's requantized outputs are, lane for lane, the next
//           layer's A registers: no shuffle, no transpose.
// B fragments are stored in "fragment order": word ((kc * nt + j) * 32 +
// lane) * 2 + h holds b.x (h = 0) or b.y (h = 1) of chunk kc, n8 tile j
// (nt tiles), so a warp reads one tile's B with one conflict-free 8-byte
// shared load a lane.

#pragma once

#include <cstdint>
#include <cuda_runtime.h>

namespace int8mma {

// d += A B, exact int32 accumulation.
__device__ __forceinline__ void mma(int (&d)[4], const uint32_t (&a)[4],
                                    uint2 b) {
  asm("mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b.x), "r"(b.y));
}

// The word of B fragment (chunk kc, n8 tile j of nt, lane, half h).
__device__ __forceinline__ int frag_word(int kc, int j, int nt, int lane,
                                         int h) {
  return ((kc * nt + j) * 32 + lane) * 2 + h;
}

__device__ __forceinline__ uint2 lds64(const uint32_t* p) {
  return *reinterpret_cast<const uint2*>(p);
}

// r[i] holds bytes (row i, columns 0..3) of a 4 x 4 byte block; afterwards
// r[i] holds (rows 0..3, column i).
__device__ __forceinline__ void transpose4x4(uint32_t (&r)[4]) {
  const uint32_t t0 = __byte_perm(r[0], r[1], 0x5140);  // r0.0 r1.0 r0.1 r1.1
  const uint32_t t1 = __byte_perm(r[0], r[1], 0x7362);  // r0.2 r1.2 r0.3 r1.3
  const uint32_t t2 = __byte_perm(r[2], r[3], 0x5140);
  const uint32_t t3 = __byte_perm(r[2], r[3], 0x7362);
  r[0] = __byte_perm(t0, t2, 0x5410);
  r[1] = __byte_perm(t0, t2, 0x7632);
  r[2] = __byte_perm(t1, t3, 0x5410);
  r[3] = __byte_perm(t1, t3, 0x7632);
}

// The epilogue, op for op the oracle's: (float)(acc + bias) * scale with
// no contraction; then, for an int8 output, round half to even and clamp
// in float before the conversion.
__device__ __forceinline__ float rescale(int acc, int bias, float scale) {
  return __fmul_rn(__int2float_rn(acc + bias), scale);
}

// A float holding an integer in [-2^22, 2^22] as an int, exactly, on the
// FP32 pipe: 1.5 * 2^23 + v is exact there, and its low mantissa bits are
// v in two's complement (__float2int_rn runs on the quarter-rate
// conversion pipe, which the epilogue's int -> float and rintf already
// load).
__device__ __forceinline__ int to_int(float v) {
  return __float_as_int(__fadd_rn(v, 12582912.0f)) - 0x4B400000;
}

__device__ __forceinline__ int requant(float scaled, float lo) {
  return to_int(fminf(fmaxf(rintf(scaled), lo), 127.0f));
}

// --- the bulk copy of an image into shared memory on an mbarrier --------
__device__ __forceinline__ unsigned cta_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(unsigned bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(bar)
               : "memory");
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

__device__ __forceinline__ void mbar_wait(unsigned bar, unsigned parity) {
  asm volatile(
      "{\n .reg .pred done;\n"
      "WAIT_%=:\n"
      " mbarrier.try_wait.parity.shared::cta.b64 done, [%0], %1;\n"
      " @!done bra WAIT_%=;\n}\n" ::"r"(bar), "r"(parity) : "memory");
}

// bytes (a multiple of 16, both addresses 16-byte aligned) from device
// memory to this block's shared memory, completing on mbarrier bar, whose
// one arrival this is.
__device__ __forceinline__ void bulk_load(void* dst, const void* src,
                                          unsigned bytes, unsigned bar) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               ::"r"(bar), "r"(bytes) : "memory");
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1], %2, [%3];\n" ::"r"(cta_addr(dst)), "l"(src),
      "r"(bytes), "r"(bar) : "memory");
}

}  // namespace int8mma
