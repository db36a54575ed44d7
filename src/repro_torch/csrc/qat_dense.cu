// Int8 dense layer with int32 accumulation and the requantizing epilogue,
// on Hopper's int8 tensor cores.
//
// Replaces: src/repro/kernels/qat_dense/kernel.py, qat_dense_call (body
// _kernel) — the TPU's tiled (m, n, k) int8 GEMM whose epilogue adds the
// int32 bias, multiplies by the fp32 per-channel scale, and then either
// writes fp32 (the float head) or rounds half to even and clamps to int8
// ([0, 127] with the fused ReLU, [-128, 127] without).
//
// What bounds it on an H100: at the MRF net's shapes (K, N <= 128) bytes —
// a 1024 x 64 x 64 layer is 8.4 M int ops against 0.14 MB moved, 0.04 us
// at 3.35 TB/s — so at a served tile the launch and one trip to device
// memory set its time, and at a whole wave (M ~ 281,600) the bytes do.
// Design (int8_mma.cuh holds the fragments and maps):
// - products on the int8 tensor cores, mma.sync m16n8k32 s8 x s8 -> s32;
// - a block owns a slab of 16, 32 or 64 output columns (the narrowest that
//   covers N, up to 64) and stages its (K, slab) weights into shared memory
//   ONCE: 4-byte row loads, a 4 x 4 byte transpose (__byte_perm) into
//   K-major B fragments in fragment order, zero past K (padded to 32) and
//   N (padded to 8).  The public weight layout stays (K, N) row-major;
// - its four warps each carry 16 rows x 2 n8 tiles; the block walks row
//   tiles (a persistent grid capped at 16 blocks an SM), so at M = 1024,
//   N = 64 the work spreads over 64 blocks, and at a whole wave each block
//   stages its weights once for ~8 row tiles;
// - A registers come straight from device memory, one 8-byte load per row
//   and 32-wide chunk (the kInput k map makes a lane's eight k of a row
//   contiguous); the next (tile, chunk)'s loads are issued before this
//   one's products, so one tile's epilogue overlaps the next one's loads;
// - ragged M, N and K are zero-filled on load and masked on store: the
//   wrapper pads nothing.  Where K or N is not a multiple of 8 or 4, the
//   loads narrow to what the row stride allows (4 bytes, else 1).
//
// Bit-exactness: int8 products summed in int32 are exact in any order
// (|acc| <= K * 2^14 < 2^31 for the wrapper's K); the epilogue is
// __int2float_rn then __fmul_rn (no contraction), rintf (round half to
// even, never roundf), clamp in float, then convert — op for op
// repro.core.qat.int_dense.

#include <cstdint>
#include <cuda_runtime.h>

#include "int8_mma.cuh"

namespace {

using int8mma::frag_word;

constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int kBlocksPerSm = 16;  // the persistent grid's cap

// Bytes [c, c + 8) of row `row` of x (m, k), zero past the edges.  VEC:
// the widest load the row stride and base allow (8, 4 or 1 bytes).
template <int VEC>
__device__ __forceinline__ uint2 load_x8(const int8_t* __restrict__ x,
                                         int row, int m, int k, int c) {
  uint2 v = make_uint2(0u, 0u);
  if (row >= m) return v;
  const int8_t* p = x + static_cast<size_t>(row) * k + c;
  if (VEC == 8) {
    if (c < k) v = __ldg(reinterpret_cast<const uint2*>(p));
  } else if (VEC == 4) {
    if (c < k) v.x = __ldg(reinterpret_cast<const unsigned*>(p));
    if (c + 4 < k) v.y = __ldg(reinterpret_cast<const unsigned*>(p) + 1);
  } else {
#pragma unroll
    for (int q = 0; q < 8; ++q) {
      if (c + q < k) {
        const unsigned b = static_cast<uint8_t>(__ldg(p + q));
        if (q < 4) v.x |= b << (8 * q);
        else v.y |= b << (8 * (q - 4));
      }
    }
  }
  return v;
}

// The block's slab of w (columns n0 .. n0 + 8 nt), transposed into B
// fragments of the kInput map, zero past K and N; then its bias and scale.
// WVEC: 4 when N % 4 == 0 and w is 4-byte aligned, else 1.
template <int WVEC>
__device__ void stage_slab(const int8_t* __restrict__ w,
                           const int32_t* __restrict__ bias,
                           const float* __restrict__ scale, uint32_t* frag,
                           int32_t* sbias, float* sscale, int n, int k,
                           int n0, int nt, int kch) {
  const int cols4 = 2 * nt;            // 4-column groups of the slab
  const int blocks = 8 * kch * cols4;  // 4 x 4 byte blocks
  for (int e = threadIdx.x; e < blocks; e += kThreads) {
    const int k4 = 4 * (e / cols4), nl = 4 * (e % cols4), gn = n0 + nl;
    uint32_t r[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      r[i] = 0u;
      if (k4 + i >= k) continue;
      const int8_t* p = w + static_cast<size_t>(k4 + i) * n + gn;
      if (WVEC == 4) {
        if (gn < n) r[i] = __ldg(reinterpret_cast<const unsigned*>(p));
      } else {
#pragma unroll
        for (int q = 0; q < 4; ++q)
          if (gn + q < n)
            r[i] |= static_cast<uint32_t>(static_cast<uint8_t>(__ldg(p + q)))
                    << (8 * q);
      }
    }
    int8mma::transpose4x4(r);
    // r[i]: column nl + i, rows k4 .. k4 + 3 — one B register of the kInput
    // map (physical k = 8t + 4h + q within the 32-wide chunk)
    const int kc = k4 / 32, t = (k4 % 32) / 8, h = (k4 % 8) / 4;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int col = nl + i;
      frag[frag_word(kc, col / 8, nt, 4 * (col % 8) + t, h)] = r[i];
    }
  }
  for (int c = threadIdx.x; c < 8 * nt; c += kThreads) {
    const bool in = n0 + c < n;
    sbias[c] = in ? bias[n0 + c] : 0;
    sscale[c] = in ? scale[n0 + c] : 0.0f;
  }
}

template <int VEC, int WVEC>
__global__ void __launch_bounds__(kThreads)
qat_dense_kernel(const int8_t* __restrict__ x, const int8_t* __restrict__ w,
                 const int32_t* __restrict__ bias,
                 const float* __restrict__ scale, void* __restrict__ out,
                 int m, int n, int k, int relu, int float_out, int warps_n) {
  extern __shared__ __align__(16) uint32_t smem[];
  const int nt = 2 * warps_n;  // n8 tiles of the slab
  const int kch = (k + 31) / 32;
  uint32_t* frag = smem;
  int32_t* sbias = reinterpret_cast<int32_t*>(smem + kch * nt * 64);
  float* sscale = reinterpret_cast<float*>(sbias + 8 * nt);
  const int n0 = blockIdx.y * 8 * nt;
  stage_slab<WVEC>(w, bias, scale, frag, sbias, sscale, n, k, n0, nt, kch);
  __syncthreads();

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int j0 = 2 * (warp % warps_n);       // this warp's two n8 tiles
  const int step = 16 * (kWarps / warps_n);  // rows a block covers at once
  const int stride = gridDim.x * step;
  const float lo = relu ? 0.0f : -128.0f;
  const bool pairs = (n & 1) == 0;           // two columns, one store
  int r0 = blockIdx.x * step + 16 * (warp / warps_n);

  // (tile, chunk) pairs in order; the next pair's A is loaded before this
  // pair's products
  uint2 xa = load_x8<VEC>(x, r0 + g, m, k, 8 * t);
  uint2 xb = load_x8<VEC>(x, r0 + g + 8, m, k, 8 * t);
  for (; r0 < m; r0 += stride) {
    int acc[2][4] = {{0, 0, 0, 0}, {0, 0, 0, 0}};
    for (int kc = 0; kc < kch; ++kc) {
      const bool more = kc + 1 < kch;
      const int nr = more ? r0 : r0 + stride;
      const int nc = 32 * (more ? kc + 1 : 0) + 8 * t;
      const uint2 na = load_x8<VEC>(x, nr + g, m, k, nc);
      const uint2 nb = load_x8<VEC>(x, nr + g + 8, m, k, nc);
      const uint32_t a[4] = {xa.x, xb.x, xa.y, xb.y};
#pragma unroll
      for (int j = 0; j < 2; ++j)
        int8mma::mma(acc[j], a,
                     int8mma::lds64(frag + frag_word(kc, j0 + j, nt, lane, 0)));
      xa = na;
      xb = nb;
    }
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const int cl = 8 * (j0 + j) + 2 * t;  // slab column (even)
      const int c = n0 + cl;
      if (c >= n) continue;
      const bool two = c + 1 < n;
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int row = r0 + g + 8 * half;
        if (row >= m) continue;
        const float y0 = int8mma::rescale(acc[j][2 * half], sbias[cl],
                                          sscale[cl]);
        const float y1 = int8mma::rescale(acc[j][2 * half + 1], sbias[cl + 1],
                                          sscale[cl + 1]);
        const size_t o = static_cast<size_t>(row) * n + c;
        if (float_out) {
          float* po = static_cast<float*>(out) + o;
          if (pairs) {
            *reinterpret_cast<float2*>(po) = make_float2(y0, y1);
          } else {
            po[0] = y0;
            if (two) po[1] = y1;
          }
        } else {
          int8_t* po = static_cast<int8_t*>(out) + o;
          const int q0 = int8mma::requant(y0, lo), q1 = int8mma::requant(y1, lo);
          if (pairs) {
            *reinterpret_cast<uint16_t*>(po) =
                static_cast<uint16_t>((q0 & 0xff) | ((q1 & 0xff) << 8));
          } else {
            po[0] = static_cast<int8_t>(q0);
            if (two) po[1] = static_cast<int8_t>(q1);
          }
        }
      }
    }
  }
}

// Warps across the slab's columns: 1, 2 or 4 (a slab of 16, 32 or 64).
int warps_across(int n) {
  const int n16 = (n + 15) / 16;
  return n16 <= 1 ? 1 : n16 == 2 ? 2 : 4;
}

// Dynamic shared memory of a launch: the (K, slab) weights in fragment
// order plus the slab's bias and scale (kernel.py's smem_bytes).
size_t slab_smem(int n, int k) {
  const int nt = 2 * warps_across(n);
  return static_cast<size_t>((k + 31) / 32) * nt * 256 + 64u * nt;
}

template <int VEC, int WVEC>
int launch(const int8_t* x, const int8_t* w, const int32_t* bias,
           const float* scale, void* out, int m, int n, int k, int relu,
           int float_out, cudaStream_t stream) {
  auto kernel = qat_dense_kernel<VEC, WVEC>;
  const int warps_n = warps_across(n);
  const size_t smem = slab_smem(n, k);
  // per instantiation: the shared-memory limit granted, the SM count and
  // the blocks an SM holds at the last launch's shared memory, so that the
  // common launch makes no extra host call (one process, one card)
  static size_t granted = 48 * 1024;
  static int sms = 0;
  static size_t occ_smem = 0;
  static int occ = 0;
  if (smem > granted) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
    granted = smem;
  }
  if (sms == 0) {
    int dev = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err == cudaSuccess)
      err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  if (occ_smem != smem) {
    const cudaError_t err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &occ, kernel, kThreads, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    occ_smem = smem;
  }
  const int slabs = (n + 16 * warps_n - 1) / (16 * warps_n);
  const int step = 16 * (kWarps / warps_n);
  const long long steps = (static_cast<long long>(m) + step - 1) / step;
  const int per_sm = occ < kBlocksPerSm ? (occ > 0 ? occ : 1) : kBlocksPerSm;
  const long long cap = static_cast<long long>(sms) * per_sm / slabs;
  const int rows = static_cast<int>(steps < cap ? steps : (cap > 0 ? cap : 1));
  kernel<<<dim3(rows, slabs), kThreads, smem, stream>>>(
      x, w, bias, scale, out, m, n, k, relu, float_out, warps_n);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// x (m, k) int8, w (k, n) int8, bias (n,) int32, scale (n,) fp32, all
// row-major and contiguous; out (m, n) fp32 if float_out else int8.
// Returns cudaGetLastError() after the launch (0 on success).
extern "C" int qat_dense_launch(const void* x, const void* w, const void* bias,
                                const void* scale, void* out, int m, int n,
                                int k, int relu, int float_out, void* stream) {
  if (m <= 0 || n <= 0) return 0;
  const auto xa = reinterpret_cast<uintptr_t>(x);
  const auto wa = reinterpret_cast<uintptr_t>(w);
  const int vec = (k % 8 == 0 && xa % 8 == 0) ? 8
                  : (k % 4 == 0 && xa % 4 == 0) ? 4 : 1;
  const bool wvec = n % 4 == 0 && wa % 4 == 0;
  const auto* xs = static_cast<const int8_t*>(x);
  const auto* ws = static_cast<const int8_t*>(w);
  const auto* b = static_cast<const int32_t*>(bias);
  const auto* s = static_cast<const float*>(scale);
  const auto st = static_cast<cudaStream_t>(stream);
  if (wvec) {
    if (vec == 8) return launch<8, 4>(xs, ws, b, s, out, m, n, k, relu, float_out, st);
    if (vec == 4) return launch<4, 4>(xs, ws, b, s, out, m, n, k, relu, float_out, st);
    return launch<1, 4>(xs, ws, b, s, out, m, n, k, relu, float_out, st);
  }
  if (vec == 8) return launch<8, 1>(xs, ws, b, s, out, m, n, k, relu, float_out, st);
  if (vec == 4) return launch<4, 1>(xs, ws, b, s, out, m, n, k, relu, float_out, st);
  return launch<1, 1>(xs, ws, b, s, out, m, n, k, relu, float_out, st);
}
