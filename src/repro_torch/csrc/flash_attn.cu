// Forward flash attention with an online softmax, float32: causal,
// sliding-window and kv-length masks, grouped-query heads.  (bf16 inputs
// run the Hopper kernel of flash_attn_sm90.cu.)
//
// Replaces: src/repro/kernels/flash_attn/kernel.py, flash_attention_call
// (body _kernel) for float32 inputs — the TPU kernel whose grid (B*Hq, q
// blocks, kv blocks) walks the kv blocks in order for each q block,
// carrying the running max m, the running sum l and the f32 accumulator
// acc in VMEM scratch, skipping kv blocks that the causal or window rule
// masks for the whole q block, and reading kv head bh // group for query
// head bh.
//
// What bounds it on an H100: operations, on the f32 FMA units: float32 has
// no tensor-core path that keeps the port's atol 2e-5 (TF32 keeps about
// three decimal digits, and the port runs no TF32).  At the tests' and the
// smoke run's shapes (S 256, 8 heads) it takes well under a millisecond;
// the serving path is bf16 and never reaches it.
//
// Design: the TPU's sequential kv grid axis becomes a loop inside one
// thread block.  One block of 16 x 16 threads owns one (bh, q tile) of
// block_q <= 64 rows: it loads its q tile once into shared memory (as f32),
// then walks the kv tiles of block_k <= 64 rows from the first to the last,
// skipping the same fully masked tiles as the TPU kernel (kernel.py:47-52).
// Each kv tile's K and V are staged in shared memory; thread (ty, tx) owns
// the 4 x 4 scores of rows ty + 16i and columns tx + 16j, and the output
// columns tx + 16j of the same rows.  Row max and row sum reduce over the 16
// threads of a row with an xor butterfly, which leaves every thread of the
// row with the same bits.  The rounded probabilities go through shared
// memory to the P V product.  Query tiles run longest first (the causal
// diagonal's last tiles carry the most kv tiles).
//
// Numerics, as the reference: scores are f32 sums of the products of the
// inputs times 1/sqrt(dh); masked entries are -1e30, never -inf: a row
// whose first visited tile is fully masked sums exp(0) terms, and the next
// real key wipes them with corr = exp(-1e30 - m) = 0, where -inf would give
// NaN; l and P V take the same p (rounding it to v's dtype is the identity
// in float32); l and acc are rescaled with explicitly rounded multiplies
// and adds; the output is acc / max(l, 1e-30) with IEEE division.  Built
// without fast math: expf is the accurate one.  No atomics: a launch and its repeat
// give the same bits.

#include <cmath>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kBlock = 64;               // max rows of a q or kv tile
constexpr int kSide = 16;                // threads per block side
constexpr int kThreads = kSide * kSide;
constexpr int kPStride = 80;             // floats per P row (16 mod 32 banks)
constexpr float kNegInf = -1e30f;

// STEPS: output columns per thread, ceil(dh / 16) rounded up to 1, 2, 4, 8.
template <int STEPS>
__global__ void __launch_bounds__(kThreads)
flash_attn_kernel(const float* __restrict__ q,
                  const float* __restrict__ k, const float* __restrict__ v,
                  float* __restrict__ out, int sq,
                  int sk, int dh, int group, int kv_len, int causal,
                  int window, int block_q, int block_k, float scale) {
  extern __shared__ float smem[];
  const int ld = dh + 1;                 // q and k rows, + 1 against conflicts
  float* qs = smem;                      // [kBlock][ld]
  float* ks = qs + kBlock * ld;          // [kBlock][ld]
  float* vs = ks + kBlock * ld;          // [kBlock][dh]
  float* ps = vs + kBlock * dh;          // [kBlock][kPStride]

  const int tx = threadIdx.x, ty = threadIdx.y;
  const int tid = ty * kSide + tx;
  const int iq = sq / block_q - 1 - static_cast<int>(blockIdx.x);
  const int bh = blockIdx.y;
  const int q_lo = iq * block_q;
  const size_t q_base = (static_cast<size_t>(bh) * sq + q_lo) * dh;
  const size_t kv_base = static_cast<size_t>(bh / group) * sk * dh;

  for (int e = tid; e < kBlock * dh; e += kThreads) {
    const int r = e / dh, c = e % dh;
    qs[r * ld + c] = r < block_q ? q[q_base + e] : 0.0f;
  }

  float m[4], l[4], acc[4][STEPS];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = kNegInf;
    l[i] = 0.0f;
#pragma unroll
    for (int j = 0; j < STEPS; ++j) acc[i][j] = 0.0f;
  }

  const int n_k = sk / block_k;
  for (int ik = 0; ik < n_k; ++ik) {
    const int k_lo = ik * block_k;
    bool run = true;                     // the same for the whole block
    if (causal) run = k_lo <= q_lo + block_q - 1;
    if (window) run = run && (k_lo + block_k - 1 > q_lo - window);
    if (!run) continue;

    __syncthreads();                     // the last tile's readers are done
    for (int e = tid; e < kBlock * dh; e += kThreads) {
      const int r = e / dh, c = e % dh;
      const bool in = r < block_k;
      const size_t g = kv_base + static_cast<size_t>(k_lo) * dh + e;
      ks[r * ld + c] = in ? k[g] : 0.0f;
      if (in) vs[r * dh + c] = v[g];
    }
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.0f;
#pragma unroll 4
    for (int d = 0; d < dh; ++d) {
      float a[4], b[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = qs[(ty + kSide * i) * ld + d];
#pragma unroll
      for (int j = 0; j < 4; ++j) b[j] = ks[(tx + kSide * j) * ld + d];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = fmaf(a[i], b[j], s[i][j]);
    }

    float corr[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = ty + kSide * i;
      const int q_pos = q_lo + r;
      float mx = -INFINITY;              // column tx = 0 is always a key
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = tx + kSide * j;
        const int k_pos = k_lo + c;
        bool keep = k_pos < kv_len;
        if (causal) keep = keep && k_pos <= q_pos;
        if (window) keep = keep && k_pos > q_pos - window;
        s[i][j] = keep ? __fmul_rn(s[i][j], scale) : kNegInf;
        if (c < block_k) mx = fmaxf(mx, s[i][j]);
      }
#pragma unroll
      for (int off = kSide / 2; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m[i], mx);
      corr[i] = expf(m[i] - m_new);
      float sum = 0.0f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = tx + kSide * j;
        if (c < block_k) {
          const float p = expf(s[i][j] - m_new);
          sum = __fadd_rn(sum, p);
          ps[r * kPStride + c] = p;
        }
      }
#pragma unroll
      for (int off = kSide / 2; off > 0; off >>= 1)
        sum = __fadd_rn(sum, __shfl_xor_sync(0xffffffffu, sum, off));
      l[i] = __fadd_rn(__fmul_rn(l[i], corr[i]), sum);
      m[i] = m_new;
    }
    __syncthreads();

    float o[4][STEPS];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < STEPS; ++j) o[i][j] = 0.0f;
    for (int kk = 0; kk < block_k; ++kk) {
      float p[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) p[i] = ps[(ty + kSide * i) * kPStride + kk];
#pragma unroll
      for (int j = 0; j < STEPS; ++j) {
        const int d = tx + kSide * j;
        if (d < dh) {
          const float vv = vs[kk * dh + d];
#pragma unroll
          for (int i = 0; i < 4; ++i) o[i][j] = fmaf(p[i], vv, o[i][j]);
        }
      }
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < STEPS; ++j)
        acc[i][j] = __fadd_rn(__fmul_rn(acc[i][j], corr[i]), o[i][j]);
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = ty + kSide * i;
    if (r >= block_q) continue;
    const float denom = fmaxf(l[i], 1e-30f);
#pragma unroll
    for (int j = 0; j < STEPS; ++j) {
      const int d = tx + kSide * j;
      if (d < dh)
        out[q_base + static_cast<size_t>(r) * dh + d] =
            __fdiv_rn(acc[i][j], denom);
    }
  }
}

template <int STEPS>
int launch(const void* q, const void* k, const void* v, void* out, int bh,
           int sq, int sk, int dh, int group, int kv_len, int causal,
           int window, int block_q, int block_k, cudaStream_t stream) {
  const size_t smem =
      sizeof(float) * (2 * kBlock * (dh + 1) + kBlock * dh + kBlock * kPStride);
  auto kern = flash_attn_kernel<STEPS>;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  const float scale = static_cast<float>(1.0 / std::sqrt(static_cast<double>(dh)));
  const dim3 grid(sq / block_q, bh);
  const dim3 block(kSide, kSide);
  kern<<<grid, block, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(out), sq, sk, dh, group,
      kv_len, causal, window, block_q, block_k, scale);
  return static_cast<int>(cudaGetLastError());
}

int launch_dh(const void* q, const void* k, const void* v, void* out, int bh,
              int sq, int sk, int dh, int group, int kv_len, int causal,
              int window, int block_q, int block_k, cudaStream_t stream) {
  const int steps = (dh + kSide - 1) / kSide;
  if (steps <= 1)
    return launch<1>(q, k, v, out, bh, sq, sk, dh, group, kv_len, causal,
                     window, block_q, block_k, stream);
  if (steps <= 2)
    return launch<2>(q, k, v, out, bh, sq, sk, dh, group, kv_len, causal,
                     window, block_q, block_k, stream);
  if (steps <= 4)
    return launch<4>(q, k, v, out, bh, sq, sk, dh, group, kv_len, causal,
                     window, block_q, block_k, stream);
  return launch<8>(q, k, v, out, bh, sq, sk, dh, group, kv_len, causal,
                   window, block_q, block_k, stream);
}

}  // namespace

// q (bh, sq, dh), k and v (bh / group, sk, dh), out (bh, sq, dh), row-major
// and contiguous, all float32.  sq and sk are multiples of block_q and
// block_k (each in [1, 64]); dh <= 128; kv_len <= sk is the true kv length;
// window 0 means no window.  The wrapper
// checks all of this.  Returns cudaGetLastError() after the launch.
extern "C" int flash_attn_launch(const void* q, const void* k, const void* v,
                                 void* out, int bh, int sq, int sk, int dh,
                                 int group, int kv_len, int causal, int window,
                                 int block_q, int block_k, void* stream) {
  if (bh <= 0 || sq <= 0) return 0;
  return launch_dh(q, k, v, out, bh, sq, sk, dh, group, kv_len, causal,
                   window, block_q, block_k, static_cast<cudaStream_t>(stream));
}
