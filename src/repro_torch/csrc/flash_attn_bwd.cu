// Backward flash attention for Hopper (sm_90a), bf16 (B6-bwd): dQ, dK and
// dV of B6's forward (flash_attn_sm90.cu) from q, k, v, out, dout and the
// per-row log-sum-exp the forward writes; causal, sliding-window and
// kv-length masks, grouped-query heads.
//
// Replaces no TPU kernel: the reference trains through XLA's chunked
// attention (src/repro/models/attention.py:88-126, its VJP by autodiff),
// and its Pallas B6 (src/repro/kernels/flash_attn/kernel.py:86) has no
// VJP.  The port's training path runs B6 forward on the card, so its
// gradient needs a kernel of its own.
//
// What it computes, for each query row r of head bh and key c of kv head
// bh / group (scale = 1/sqrt(dh), masked pairs as in the forward):
//   s   = q_r . k_c * scale      (f32 sum of exact bf16 products, one
//                                  rounded multiply, as the forward)
//   P   = exp(s - lse_r)          (0 where the masks drop the pair)
//   D_r = sum_d dout_rd out_rd    (f32)
//   dP  = dout_r . v_c            (f32)
//   dS  = P (dP - D_r)            (f32, two rounded operations)
//   dV_c += P dout_r,  dQ_r += dS k_c,  dK_c += dS q_r
// with P and dS rounded to bf16 as the products' operands, every sum in
// f32, and dQ and dK scaled once at the end; dK and dV sum over the group
// query heads that read each kv head.  ref.flash_attention_bwd_plain is the
// same formulas in this order; it runs on the CPU and holds this kernel on
// the card.
//
// What bounds it on an H100: the products.  A causal launch at tinyllama's
// training shape (B 8, Hq 32, dh 64, S 2,048) needs 5 products of
// 2*dh flops a kept pair (S, dP, dV, dK, dQ): 10*B*Hq*dh*S(S+1)/2 = 3.44e11
// FLOP, 0.35 ms at the bf16 tensor-core peak, against ~235 MB of inputs and
// outputs (0.07 ms at 3.35 TB/s).
//
// Design: simple and right first; mma.sync, not wgmma/TMA.  Two kernels on
// the caller's stream, each a fixed order of sums and no atomics, so a
// launch and its repeat give the same bits:
//   dq_kernel: a block of 4 warps owns a q tile of 64 rows of one head.  It
//     computes D for its rows (a warp a row at a time, lanes over the
//     columns, a fixed tree over the lanes) and writes it for the second
//     kernel, then walks the kv tiles that the masks do not drop for the
//     whole tile, in order: S and dP by mma.sync m16n8k16 (bf16 in, f32
//     out), P and dS in registers, dQ += dS K with dS taken straight from
//     the accumulator fragments as the A operand (rounded to bf16).
//   dkdv_kernel: a block owns a kv tile of 64 rows of one kv head and walks
//     every q head of its group, then every q tile that the masks do not
//     drop, in order: S^T = K Q^T and dP^T = V dO^T, P^T and dS^T in
//     registers, dV += P^T dO and dK += dS^T Q from the fragments.
// Tiles are staged in shared memory by plain 16-byte loads, rows padded by
// 8 bf16 values (16 bytes) so the fragment loads of a warp hit 32 distinct
// banks; the operands a product reads along its other axis (K^T for dQ,
// Q^T and dO^T for dK and dV) are staged transposed.  No double buffering:
// a block loads a tile, synchronises and computes.  The dK/dV kernel's q
// tile is 64 rows at dh <= 64 and 32 at dh 128 (its two accumulators of
// 16 x dh a warp leave no registers for 64 x 64 score tiles there).
//
// Numerics.  Rows of no kept key: the forward writes lse = m + log(max(l,
// 1e-30)), which is -1e30 there (f32 cannot hold -1e30 + log(l)), and this
// kernel gives such a row P = 0 on every key, so no gradient: a padded row
// (whose dout is 0) has none either way.  Built without fast math: expf is
// the accurate one.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cmath>
#include <cstdint>

namespace {

using bf16 = __nv_bfloat16;

constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr int kTile = 16 * kWarps;  // q tile of dq_kernel, kv tile of both
constexpr int kPad = 8;             // bf16 values after each staged row

template <int DH>
struct Shape {
  static constexpr int kLd = DH + kPad;                 // [rows][dh] stride
  static constexpr int kBqKV = DH <= 64 ? 64 : 32;      // dkdv_kernel q tile
  // dq_kernel: q, dout, k (out's rows before the kv loop), v: [64][kLd];
  // k^T [dh][64 + kPad]; lse and D of the q tile
  static constexpr int kSmemDQ = (4 * kTile * kLd + DH * (kTile + kPad)) * 2 +
                                 2 * kTile * 4;
  // dkdv_kernel: k, v [64][kLd]; q, dout [kBqKV][kLd]; q^T, dout^T
  // [dh][kBqKV + kPad]; lse and D of the q tile
  static constexpr int kSmemKV =
      (2 * kTile * kLd + 2 * kBqKV * kLd + 2 * DH * (kBqKV + kPad)) * 2 +
      2 * kBqKV * 4;
};

// D (16 x 8, f32) += A (16 x 16) B (16 x 8), bf16 operands: A's fragment
// holds rows g and g + 8, columns 2t, 2t + 1 and 2t + 8, 2t + 9; B's rows
// 2t, 2t + 1 and 2t + 8, 2t + 9 of column g; D's rows g and g + 8, columns
// 2t and 2t + 1 (g = lane / 4, t = lane % 4).
__device__ __forceinline__ void mma16816(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t ld2(const bf16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// acc (16 x N) += A (16 x K) B: A the 16 rows at a (row stride lda, K
// contiguous), B given as its transpose bt (N rows of K, row stride ldb).
template <int N, int K>
__device__ __forceinline__ void mma_smem(float (&acc)[N / 8][4], const bf16* a,
                                         int lda, const bf16* bt, int ldb,
                                         int g, int t) {
#pragma unroll
  for (int kk = 0; kk < K; kk += 16) {
    uint32_t af[4];
    af[0] = ld2(a + g * lda + kk + 2 * t);
    af[1] = ld2(a + (g + 8) * lda + kk + 2 * t);
    af[2] = ld2(a + g * lda + kk + 8 + 2 * t);
    af[3] = ld2(a + (g + 8) * lda + kk + 8 + 2 * t);
#pragma unroll
    for (int j = 0; j < N / 8; ++j) {
      const bf16* b = bt + (8 * j + g) * ldb + kk + 2 * t;
      mma16816(acc[j], af, ld2(b), ld2(b + 8));
    }
  }
}

// acc (16 x N) += X B: X (16 x K) the f32 accumulator fragments x of an
// earlier product, rounded to bf16 (fragments 2c and 2c + 1 are the A
// operand's columns 16c .. 16c + 15); B given as its transpose bt.
template <int N, int K>
__device__ __forceinline__ void mma_frag(float (&acc)[N / 8][4],
                                         const float (&x)[K / 8][4],
                                         const bf16* bt, int ldb, int g,
                                         int t) {
#pragma unroll
  for (int c = 0; c < K / 16; ++c) {
    uint32_t af[4];
    af[0] = pack_bf16(x[2 * c][0], x[2 * c][1]);
    af[1] = pack_bf16(x[2 * c][2], x[2 * c][3]);
    af[2] = pack_bf16(x[2 * c + 1][0], x[2 * c + 1][1]);
    af[3] = pack_bf16(x[2 * c + 1][2], x[2 * c + 1][3]);
#pragma unroll
    for (int j = 0; j < N / 8; ++j) {
      const bf16* b = bt + (8 * j + g) * ldb + 16 * c + 2 * t;
      mma16816(acc[j], af, ld2(b), ld2(b + 8));
    }
  }
}

// rows x DH bf16 (global, row stride DH) into shared [rows][DH + kPad]
template <int DH>
__device__ __forceinline__ void stage(bf16* dst, const bf16* src, int rows) {
  constexpr int kVec = DH / 8;  // 16-byte vectors a row
  for (int i = threadIdx.x; i < rows * kVec; i += kThreads) {
    const int r = i / kVec, c = (i % kVec) * 8;
    *reinterpret_cast<uint4*>(dst + r * (DH + kPad) + c) =
        *reinterpret_cast<const uint4*>(src + static_cast<size_t>(r) * DH + c);
  }
}

// rows x DH bf16 (global) into shared, transposed: [DH][rows + kPad]
template <int DH>
__device__ __forceinline__ void stage_t(bf16* dst, const bf16* src, int rows) {
  constexpr int kVec = DH / 8;
  const int ld = rows + kPad;
  for (int i = threadIdx.x; i < rows * kVec; i += kThreads) {
    const int r = i / kVec, c = (i % kVec) * 8;
    const uint4 v =
        *reinterpret_cast<const uint4*>(src + static_cast<size_t>(r) * DH + c);
    const bf16* e = reinterpret_cast<const bf16*>(&v);
#pragma unroll
    for (int j = 0; j < 8; ++j) dst[(c + j) * ld + r] = e[j];
  }
}

// Whether kv tile [k_lo, k_lo + bk) has any pair the masks keep for q tile
// [q_lo, q_lo + bq) (the forward's tile rule, ref.block_runs, plus kv_len).
__device__ __forceinline__ bool tile_runs(int q_lo, int bq, int k_lo, int bk,
                                          int kv_len, int causal, int window) {
  bool run = k_lo < kv_len;
  if (causal) run = run && k_lo <= q_lo + bq - 1;
  if (window) run = run && k_lo + bk - 1 > q_lo - window;
  return run;
}

__device__ __forceinline__ bool kept(int q_pos, int k_pos, int kv_len,
                                     int causal, int window) {
  bool keep = k_pos < kv_len;
  if (causal) keep = keep && k_pos <= q_pos;
  if (window) keep = keep && k_pos > q_pos - window;
  return keep;
}

template <int DH>
__global__ void __launch_bounds__(kThreads)
dq_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
          const bf16* __restrict__ v, const bf16* __restrict__ out,
          const bf16* __restrict__ dout, const float* __restrict__ lse,
          float* __restrict__ delta, bf16* __restrict__ dq, int n_heads,
          int sq, int sk, int group, int kv_len, int causal, int window,
          float scale) {
  using S = Shape<DH>;
  constexpr int LD = S::kLd, LDT = kTile + kPad;
  extern __shared__ __align__(16) uint8_t smem_raw[];
  bf16* qs = reinterpret_cast<bf16*>(smem_raw);  // [64][LD]
  bf16* dos = qs + kTile * LD;                   // [64][LD]
  bf16* ks = dos + kTile * LD;                   // [64][LD]; out's rows first
  bf16* vs = ks + kTile * LD;                    // [64][LD]
  bf16* kt = vs + kTile * LD;                    // [DH][LDT]
  float* lse_s = reinterpret_cast<float*>(kt + DH * LDT);  // [64]
  float* d_s = lse_s + kTile;                              // [64]

  // work items (head, q tile), every head's last q tile first (the causal
  // diagonal's last tiles walk the most kv tiles)
  const int n_q = sq / kTile;
  const int bh = blockIdx.x % n_heads;
  const int q_lo = (n_q - 1 - static_cast<int>(blockIdx.x) / n_heads) * kTile;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  const size_t row0 = static_cast<size_t>(bh) * sq + q_lo;

  stage<DH>(qs, q + row0 * DH, kTile);
  stage<DH>(dos, dout + row0 * DH, kTile);
  stage<DH>(ks, out + row0 * DH, kTile);
  for (int i = threadIdx.x; i < kTile; i += kThreads) lse_s[i] = lse[row0 + i];
  __syncthreads();
  // D = rowsum(dout * out): warp w its 16 rows, lanes over the columns,
  // then a fixed tree over the lanes; lane 0's sum is the row's
  for (int r = 16 * warp; r < 16 * warp + 16; ++r) {
    float part = 0.0f;
    for (int c = lane; c < DH; c += 32)
      part = __fmaf_rn(__bfloat162float(dos[r * LD + c]),
                       __bfloat162float(ks[r * LD + c]), part);
#pragma unroll
    for (int off = 16; off > 0; off /= 2)
      part = __fadd_rn(part, __shfl_xor_sync(0xffffffffu, part, off));
    if (lane == 0) {
      d_s[r] = part;
      delta[row0 + r] = part;
    }
  }
  __syncthreads();

  // this thread's rows of the tile: r0 = 16 warp + g and r0 + 8
  const int r0 = 16 * warp + g;
  const float lse_r[2] = {lse_s[r0], lse_s[r0 + 8]};
  const float d_r[2] = {d_s[r0], d_s[r0 + 8]};
  const int q_pos[2] = {q_lo + r0, q_lo + r0 + 8};
  const size_t kv_row0 = static_cast<size_t>(bh / group) * sk;
  float acc[DH / 8][4] = {};
  for (int k_lo = 0; k_lo < sk; k_lo += kTile) {
    if (!tile_runs(q_lo, kTile, k_lo, kTile, kv_len, causal, window)) continue;
    __syncthreads();  // every warp is done with the last tile
    stage<DH>(ks, k + (kv_row0 + k_lo) * DH, kTile);
    stage<DH>(vs, v + (kv_row0 + k_lo) * DH, kTile);
    stage_t<DH>(kt, k + (kv_row0 + k_lo) * DH, kTile);
    __syncthreads();
    float s[kTile / 8][4] = {}, dp[kTile / 8][4] = {};
    mma_smem<kTile, DH>(s, qs + 16 * warp * LD, LD, ks, LD, g, t);
    mma_smem<kTile, DH>(dp, dos + 16 * warp * LD, LD, vs, LD, g, t);
#pragma unroll
    for (int j = 0; j < kTile / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int h = e / 2;
        const int k_pos = k_lo + 8 * j + 2 * t + e % 2;
        const float p =
            kept(q_pos[h], k_pos, kv_len, causal, window)
                ? expf(__fsub_rn(__fmul_rn(s[j][e], scale), lse_r[h]))
                : 0.0f;
        s[j][e] = __fmul_rn(p, __fsub_rn(dp[j][e], d_r[h]));  // dS
      }
    }
    mma_frag<DH, kTile>(acc, s, kt, LDT, g, t);  // dQ += dS K
  }
#pragma unroll
  for (int j = 0; j < DH / 8; ++j) {
#pragma unroll
    for (int h = 0; h < 2; ++h)
      *reinterpret_cast<uint32_t*>(dq + (row0 + r0 + 8 * h) * DH + 8 * j +
                                   2 * t) =
          pack_bf16(__fmul_rn(acc[j][2 * h], scale),
                    __fmul_rn(acc[j][2 * h + 1], scale));
  }
}

template <int DH>
__global__ void __launch_bounds__(kThreads)
dkdv_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
            const bf16* __restrict__ v, const bf16* __restrict__ dout,
            const float* __restrict__ lse, const float* __restrict__ delta,
            bf16* __restrict__ dk, bf16* __restrict__ dv, int n_kv_heads,
            int sq, int sk, int group, int kv_len, int causal, int window,
            float scale) {
  using S = Shape<DH>;
  constexpr int LD = S::kLd, BQ = S::kBqKV, LDT = BQ + kPad;
  extern __shared__ __align__(16) uint8_t smem_raw[];
  bf16* ks = reinterpret_cast<bf16*>(smem_raw);  // [64][LD]
  bf16* vs = ks + kTile * LD;                    // [64][LD]
  bf16* qs = vs + kTile * LD;                    // [BQ][LD]
  bf16* dos = qs + BQ * LD;                      // [BQ][LD]
  bf16* qt = dos + BQ * LD;                      // [DH][LDT]
  bf16* dot = qt + DH * LDT;                     // [DH][LDT]
  float* lse_s = reinterpret_cast<float*>(dot + DH * LDT);  // [BQ]
  float* d_s = lse_s + BQ;                                  // [BQ]

  // work items (kv head, kv tile), the first kv tiles first (under a causal
  // mask they walk the most q tiles)
  const int hk = blockIdx.x % n_kv_heads;
  const int k_lo = static_cast<int>(blockIdx.x) / n_kv_heads * kTile;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  const size_t kv_row0 = static_cast<size_t>(hk) * sk + k_lo;
  // this thread's kv rows of the tile: c0 = 16 warp + g and c0 + 8
  const int c0 = 16 * warp + g;
  const int k_pos[2] = {k_lo + c0, k_lo + c0 + 8};

  stage<DH>(ks, k + kv_row0 * DH, kTile);
  stage<DH>(vs, v + kv_row0 * DH, kTile);
  float dk_acc[DH / 8][4] = {}, dv_acc[DH / 8][4] = {};
  for (int j = 0; j < group; ++j) {
    const size_t head_row = static_cast<size_t>(hk * group + j) * sq;
    for (int q_lo = 0; q_lo < sq; q_lo += BQ) {
      if (!tile_runs(q_lo, BQ, k_lo, kTile, kv_len, causal, window)) continue;
      __syncthreads();  // every warp is done with the last q tile
      const size_t row0 = head_row + q_lo;
      stage<DH>(qs, q + row0 * DH, BQ);
      stage<DH>(dos, dout + row0 * DH, BQ);
      stage_t<DH>(qt, q + row0 * DH, BQ);
      stage_t<DH>(dot, dout + row0 * DH, BQ);
      for (int i = threadIdx.x; i < BQ; i += kThreads) {
        lse_s[i] = lse[row0 + i];
        d_s[i] = delta[row0 + i];
      }
      __syncthreads();
      float s[BQ / 8][4] = {}, dp[BQ / 8][4] = {};
      mma_smem<BQ, DH>(s, ks + 16 * warp * LD, LD, qs, LD, g, t);    // S^T
      mma_smem<BQ, DH>(dp, vs + 16 * warp * LD, LD, dos, LD, g, t);  // dP^T
#pragma unroll
      for (int jj = 0; jj < BQ / 8; ++jj) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int col = 8 * jj + 2 * t + e % 2;  // the q row in the tile
          const float p =
              kept(q_lo + col, k_pos[e / 2], kv_len, causal, window)
                  ? expf(__fsub_rn(__fmul_rn(s[jj][e], scale), lse_s[col]))
                  : 0.0f;
          s[jj][e] = p;                                          // P^T
          dp[jj][e] = __fmul_rn(p, __fsub_rn(dp[jj][e], d_s[col]));  // dS^T
        }
      }
      mma_frag<DH, BQ>(dv_acc, s, dot, LDT, g, t);  // dV += P^T dO
      mma_frag<DH, BQ>(dk_acc, dp, qt, LDT, g, t);  // dK += dS^T Q
    }
  }
#pragma unroll
  for (int jj = 0; jj < DH / 8; ++jj) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const size_t at = (kv_row0 + c0 + 8 * h) * DH + 8 * jj + 2 * t;
      *reinterpret_cast<uint32_t*>(dk + at) =
          pack_bf16(__fmul_rn(dk_acc[jj][2 * h], scale),
                    __fmul_rn(dk_acc[jj][2 * h + 1], scale));
      *reinterpret_cast<uint32_t*>(dv + at) =
          pack_bf16(dv_acc[jj][2 * h], dv_acc[jj][2 * h + 1]);
    }
  }
}

template <int DH>
int launch(const void* q, const void* k, const void* v, const void* out,
           const void* dout, const float* lse, float* delta, void* dq,
           void* dk, void* dv, int bh, int sq, int sk, int group, int kv_len,
           int causal, int window, cudaStream_t stream) {
  using S = Shape<DH>;
  auto kq = dq_kernel<DH>;
  auto kkv = dkdv_kernel<DH>;
  cudaError_t e = cudaFuncSetAttribute(
      kq, cudaFuncAttributeMaxDynamicSharedMemorySize, S::kSmemDQ);
  if (e == cudaSuccess)
    e = cudaFuncSetAttribute(kkv, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             S::kSmemKV);
  if (e != cudaSuccess) return static_cast<int>(e);
  const float scale = static_cast<float>(1.0 / sqrt(static_cast<double>(DH)));
  const bf16* qb = static_cast<const bf16*>(q);
  const bf16* kb = static_cast<const bf16*>(k);
  const bf16* vb = static_cast<const bf16*>(v);
  const bf16* ob = static_cast<const bf16*>(out);
  const bf16* gb = static_cast<const bf16*>(dout);
  // dq_kernel writes D, which dkdv_kernel reads: the stream orders them
  kq<<<bh * (sq / kTile), kThreads, S::kSmemDQ, stream>>>(
      qb, kb, vb, ob, gb, lse, delta, static_cast<bf16*>(dq), bh, sq, sk,
      group, kv_len, causal, window, scale);
  e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  const int n_kv = bh / group;
  kkv<<<n_kv * (sk / kTile), kThreads, S::kSmemKV, stream>>>(
      qb, kb, vb, gb, lse, delta, static_cast<bf16*>(dk),
      static_cast<bf16*>(dv), n_kv, sq, sk, group, kv_len, causal, window,
      scale);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// q, out, dout, dq (bh, sq, dh); k, v, dk, dv (bh / group, sk, dh): bf16,
// row-major, contiguous and 16-byte aligned; lse (bh, sq) f32 from the
// forward; delta (bh, sq) f32 scratch (receives D).  dh is 16, 32, 64 or
// 128; sq and sk are multiples of 64; kv_len <= sk is the true kv length;
// window 0 means no window.  The wrapper checks all of this.  Returns 0 or
// the cudaError_t of a launch.
extern "C" int flash_attn_bwd_launch(const void* q, const void* k,
                                     const void* v, const void* out,
                                     const void* dout, const void* lse,
                                     void* delta, void* dq, void* dk,
                                     void* dv, int bh, int sq, int sk, int dh,
                                     int group, int kv_len, int causal,
                                     int window, void* stream) {
  if (bh <= 0 || sq <= 0 || sk <= 0) return 0;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* l = static_cast<const float*>(lse);
  float* d = static_cast<float*>(delta);
  switch (dh) {
    case 16:
      return launch<16>(q, k, v, out, dout, l, d, dq, dk, dv, bh, sq, sk,
                        group, kv_len, causal, window, s);
    case 32:
      return launch<32>(q, k, v, out, dout, l, d, dq, dk, dv, bh, sq, sk,
                        group, kv_len, causal, window, s);
    case 64:
      return launch<64>(q, k, v, out, dout, l, d, dq, dk, dv, bh, sq, sk,
                        group, kv_len, causal, window, s);
    case 128:
      return launch<128>(q, k, v, out, dout, l, d, dq, dk, dv, bh, sq, sk,
                         group, kv_len, causal, window, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
