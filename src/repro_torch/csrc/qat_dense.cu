// Int8 dense layer with int32 accumulation and the requantizing epilogue.
//
// Replaces: src/repro/kernels/qat_dense/kernel.py, qat_dense_call (body
// _kernel) — the TPU's tiled (m, n, k) int8 GEMM whose epilogue adds the
// int32 bias, multiplies by the fp32 per-channel scale, and then either
// writes fp32 (the float head) or rounds half to even and clamps to int8
// ([0, 127] with the fused ReLU, [-128, 127] without).
//
// What bounds it on an H100: at the MRF net's shapes (K, N <= 128) the work
// is tiny — a 1024 x 64 x 64 layer is 8.4 M int ops against 0.14 MB moved —
// so the bound is bytes (0.04 us at 3.35 TB/s) and the real cost is the
// launch.  Design: one 64 x 64 output tile per block of 16 x 16 threads,
// K staged through shared memory 32 bytes at a time, the x tile as rows
// and the w tile transposed to columns so that four consecutive k of both
// operands pack into one 32-bit word for __dp4a (exact int8 dot, int32
// accumulate).  Each thread owns a 4 x 4 micro-tile at rows ty + 16 i and
// columns tx + 16 j; rows of the staged tiles are 9 words apart, so the
// 16 column reads of a warp fall in 16 distinct banks.  Ragged M, N and K
// edges are zero-filled on load and masked on store: the wrapper pads
// nothing.  Tensor-core mma / wgmma is later work.
//
// Bit-exactness: the epilogue is __int2float_rn then __fmul_rn (no
// contraction), rintf (round half to even, never roundf), clamp in float,
// then convert — op for op repro.core.qat.int_dense.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kTile = 64;                // output rows and columns per block
constexpr int kDepth = 32;               // k bytes staged per step
constexpr int kRowWords = kDepth / 4 + 1;  // + 1 word against bank conflicts
constexpr int kSide = 16;                // threads per block side

__global__ void __launch_bounds__(kSide * kSide)
qat_dense_kernel(const int8_t* __restrict__ x, const int8_t* __restrict__ w,
                 const int32_t* __restrict__ bias,
                 const float* __restrict__ scale, void* __restrict__ out,
                 int m, int n, int k, int relu, int float_out) {
  __shared__ int xs[kTile * kRowWords];  // xs[r][kw]: x[m0 + r][k0 + 4 kw ..]
  __shared__ int ws[kTile * kRowWords];  // ws[c][kw]: w[k0 + 4 kw ..][n0 + c]
  int8_t* xsb = reinterpret_cast<int8_t*>(xs);
  int8_t* wsb = reinterpret_cast<int8_t*>(ws);

  const int tx = threadIdx.x, ty = threadIdx.y;
  const int tid = ty * kSide + tx;
  const int m0 = blockIdx.y * kTile, n0 = blockIdx.x * kTile;

  int acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0;

  for (int k0 = 0; k0 < k; k0 += kDepth) {
    for (int e = tid; e < kTile * kDepth; e += kSide * kSide) {
      // x tile: consecutive threads read consecutive k of one row
      const int r = e / kDepth, c = e % kDepth;
      const int gm = m0 + r, gk = k0 + c;
      xsb[r * kRowWords * 4 + c] =
          (gm < m && gk < k) ? x[static_cast<size_t>(gm) * k + gk] : 0;
      // w tile: consecutive threads read consecutive n of one k row
      const int kk = e / kTile, cc = e % kTile;
      const int gk2 = k0 + kk, gn = n0 + cc;
      wsb[cc * kRowWords * 4 + kk] =
          (gk2 < k && gn < n) ? w[static_cast<size_t>(gk2) * n + gn] : 0;
    }
    __syncthreads();
#pragma unroll
    for (int kw = 0; kw < kDepth / 4; ++kw) {
      int a[4], b[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = xs[(ty + kSide * i) * kRowWords + kw];
#pragma unroll
      for (int j = 0; j < 4; ++j) b[j] = ws[(tx + kSide * j) * kRowWords + kw];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = __dp4a(a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }

  const float lo = relu ? 0.0f : -128.0f;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = m0 + ty + kSide * i;
    if (r >= m) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int c = n0 + tx + kSide * j;
      if (c >= n) continue;
      const float scaled =
          __fmul_rn(__int2float_rn(acc[i][j] + bias[c]), scale[c]);
      const size_t o = static_cast<size_t>(r) * n + c;
      if (float_out) {
        static_cast<float*>(out)[o] = scaled;
      } else {
        const float y = fminf(fmaxf(rintf(scaled), lo), 127.0f);
        static_cast<int8_t*>(out)[o] = static_cast<int8_t>(__float2int_rn(y));
      }
    }
  }
}

}  // namespace

// x (m, k) int8, w (k, n) int8, bias (n,) int32, scale (n,) fp32, all
// row-major and contiguous; out (m, n) fp32 if float_out else int8.
// Returns cudaGetLastError() after the launch (0 on success).
extern "C" int qat_dense_launch(const void* x, const void* w, const void* bias,
                                const void* scale, void* out, int m, int n,
                                int k, int relu, int float_out, void* stream) {
  if (m <= 0 || n <= 0) return 0;
  const dim3 grid((n + kTile - 1) / kTile, (m + kTile - 1) / kTile);
  const dim3 block(kSide, kSide);
  qat_dense_kernel<<<grid, block, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int8_t*>(x), static_cast<const int8_t*>(w),
      static_cast<const int32_t*>(bias), static_cast<const float*>(scale), out,
      m, n, k, relu, float_out);
  return static_cast<int>(cudaGetLastError());
}
