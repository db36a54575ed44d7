// Forward flash attention for Hopper (sm_90a), bf16: causal, sliding-window
// and kv-length masks, grouped-query heads, both products on the tensor
// cores (wgmma), K and V fed by TMA.
//
// Replaces: src/repro/kernels/flash_attn/kernel.py, flash_attention_call
// (body _kernel) for bf16 inputs — the TPU kernel whose grid (B*Hq, q
// blocks, kv blocks) walks the kv blocks in order for each q block,
// carrying the running max m, the running sum l and the f32 accumulator
// acc in VMEM scratch, skipping kv blocks that the causal or window rule
// masks for the whole q block, and reading kv head bh // group for query
// head bh.  It does both products on the MXU, bf16 in and f32 out
// (kernel.py:58-59); wgmma bf16 x bf16 -> f32 is the counterpart here.
// float32 inputs go to the scalar kernel of flash_attn.cu.
//
// What bounds it on an H100.  The products: a causal launch at the LM
// serving shape (B 8, Hq 32, dh 64, S 2,048) does 4*B*Hq*dh*S(S+1)/2 =
// 1.375e11 FLOP against ~151 MB of q, k, v and out: 0.139 ms at the bf16
// tensor-core peak, 0.045 ms at 3.35 TB/s.  In practice the softmax: the
// numerics of the plain version (one rounded scale multiply, s - m, the
// accurate expf of 8 instructions, no exp2 trick) cost ~15 instructions a
// score on the FMA and MUFU units, issued from two warps a scheduler, and
// at dh 64 that takes as long as the products (PERF.md, section 6).
//
// Design.  Persistent: one block an SM walks work items (bh, q tile of 128
// rows), every head's longest q tile first (the causal diagonal's last
// tiles carry the most kv tiles), and for each walks the kv tiles that the
// causal or window rule does not mask for the whole q tile, in order (the
// TPU's sequential kv grid axis).  Its 384 threads are two consumer
// warpgroups of 64 q rows each (wgmma M = 64) and a producer warpgroup
// that hands its registers to them (setmaxnreg 24 / 240); one producer
// thread issues every TMA copy: the q tile into one of two buffers (the
// next item's while the consumers finish this one), and K and V into a
// ring of kStages stages, with an mbarrier per buffer and stage for
// arrival (the TMA's byte count) and one for release (one arrival per
// consumer warp).  Rows of dh bf16 values land in panels of at most 64
// columns with the matching swizzle (128 B at dh 64 and 128, 64 B at dh
// 32, 32 B at dh 16), which the wgmma descriptors name.  Each consumer
// warpgroup, per kv tile:
//   S = Q K^T  wgmma m64nBKk16, Q and K both K-major from shared memory;
//   s * scale (one rounded multiply), the masks only on tiles that cross
//   the diagonal, the window edge or kv_len; row max and row sum over the
//   quad of lanes that holds a row of the accumulator fragment;
//   p = expf(s - m_new), rounded to bf16 in registers: the f32 accumulator
//   fragment of the first product is the register A operand of the second,
//   so P never goes through shared memory;
//   O = P V    wgmma m64nDHk16 into a fresh accumulator, V from shared
//   memory in its row-major (MN-major, transposed B) layout;
//   acc = acc * corr + O with explicitly rounded operations, the plain
//   version's order (ref.py:105).
// Overlap: a warpgroup issues S of tile n and P V of tile n - 1 together
// and takes the softmax of tile n while P V runs; the two warpgroups take
// turns to issue (named barriers), so one's softmax runs under the other's
// products.  kv tiles are 128 rows at dh <= 64 and 64 rows at dh 128,
// where a fresh 64 x 128 f32 O beside acc leaves no registers for a
// 64 x 128 S.
//
// Numerics, as the reference: scores are f32 sums of exact bf16 products
// (the tensor core adds them in its own order) times 1/sqrt(dh); masked
// entries are -1e30, never -inf: a row whose first visited tile is fully
// masked sums exp(0) terms, and the next real key wipes them with
// corr = exp(-1e30 - m) = 0, where -inf would give NaN; l sums the
// unrounded p; p is rounded to bf16 before P V; l and acc are rescaled
// with explicitly rounded multiplies and adds; the output is
// acc / max(l, 1e-30) with IEEE division, rounded to bf16.  Built without
// fast math: expf is the accurate one.  No atomics: a launch and its repeat
// give the same bits.
//
// Training: with a non-null lse pointer the kernel also writes each row's
// log-sum-exp, m + log(max(l, 1e-30)) of its final running max and sum
// (-1e30 for a row of no kept key: f32 cannot hold -1e30 + log(l)), which
// the backward kernel (flash_attn_bwd.cu) recomputes P from.  It is written
// after the output and changes none of its bits.
//
// The tensor maps are encoded on the host for each call, through the
// driver's cuTensorMapEncodeTiled fetched with cudaGetDriverEntryPoint, so
// the library needs no -lcuda; they reach the kernel as __grid_constant__
// parameters.

#include <cuda.h>  // CUtensorMap and its enums (types only)
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cmath>
#include <cstdint>

#include "sm90_wgmma.cuh"  // mbarriers, TMA, wgmma, tensor maps

namespace {

constexpr int kBlockQ = 128;               // q rows a block owns
constexpr int kConsumers = 2;              // warpgroups of 64 q rows
constexpr int kThreads = (kConsumers + 1) * 128;  // + the producer's
constexpr int kStages = 3;                 // K/V ring in shared memory
// setmaxnreg budgets: 128 x 24 + 256 x 240 = 384 x 168, the registers the
// launch gives a block of 384 threads at one block an SM
constexpr int kProducerRegs = 24;
constexpr int kConsumerRegs = 240;
constexpr float kNegInf = -1e30f;

template <int DH>
struct Tiles : Panels<DH> {
  static constexpr int kBlockK = DH <= 64 ? 128 : 64;
  static constexpr int kQPanel = kBlockQ * Panels<DH>::kRowBytes;
  static constexpr int kKVPanel = kBlockK * Panels<DH>::kRowBytes;
  static constexpr int kQBytes = kQPanel * Panels<DH>::kPanels;
  static constexpr int kKVBytes = kKVPanel * Panels<DH>::kPanels;
  static constexpr int kSmem =
      2 * kQBytes + 2 * kStages * kKVBytes + 8 * (4 + 2 * kStages) + 1024;
};

// Whether kv tile [k_lo, k_lo + bk) has any unmasked pair for q tile
// [q_lo, q_lo + kBlockQ) (ref.block_runs, kernel.py:47-52).  The tiles
// that run form one range: the causal rule cuts a suffix, the window a
// prefix.
__device__ __forceinline__ bool tile_runs(int q_lo, int k_lo, int bk,
                                          int causal, int window) {
  bool run = true;
  if (causal) run = k_lo <= q_lo + kBlockQ - 1;
  if (window) run = run && (k_lo + bk - 1 > q_lo - window);
  return run;
}

// Where the q tile's consumers and producer agree the kv tiles start and
// end: [first, last], empty when last < first.
__device__ __forceinline__ void tile_range(int q_lo, int n_k, int bk,
                                           int causal, int window, int& first,
                                           int& last) {
  first = n_k;
  last = -1;
  for (int ik = 0; ik < n_k; ++ik) {
    if (!tile_runs(q_lo, ik * bk, bk, causal, window)) continue;
    first = min(first, ik);
    last = ik;
  }
}

// The softmax step of one kv tile on this thread's part of the scores
// (the m64nBK accumulator fragment: index 4 j + 2 h + e holds row
// row + 8 h, column k_lo + 8 j + 2 t + e): scale, masks where the tile
// crosses the diagonal, the window edge or kv_len, the new running max
// over the quad that shares a row, corr = exp(m - m_new), p = exp(s -
// m_new) in place of s, l = l corr + sum p (unrounded).
template <int BK>
__device__ __forceinline__ void softmax_tile(
    float (&s)[BK / 2], float (&m)[2], float (&l)[2], float (&corr)[2],
    float* scores, size_t score_row, int sk, int row,
    int r_lo, int k_lo, int t, int kv_len, int causal, int window,
    float scale) {
#pragma unroll
  for (int i = 0; i < BK / 2; ++i) s[i] = __fmul_rn(s[i], scale);
  if (scores != nullptr) {  // the check's copy of this tile's scores
#pragma unroll
    for (int i = 0; i < BK / 2; i += 2)
      *reinterpret_cast<float2*>(scores +
                                 (score_row + 8 * ((i / 2) % 2)) * sk + k_lo +
                                 8 * (i / 4) + 2 * t) =
          make_float2(s[i], s[i + 1]);
  }
  const bool edge = k_lo + BK > kv_len || (causal && k_lo + BK - 1 > r_lo) ||
                    (window && k_lo <= r_lo + 63 - window);
  if (edge) {
#pragma unroll
    for (int i = 0; i < BK / 2; ++i) {
      const int q_pos = row + 8 * ((i / 2) % 2);
      const int k_pos = k_lo + 8 * (i / 4) + 2 * t + i % 2;
      bool keep = k_pos < kv_len;
      if (causal) keep = keep && k_pos <= q_pos;
      if (window) keep = keep && k_pos > q_pos - window;
      if (!keep) s[i] = kNegInf;
    }
  }
  // Four partial maxima and sums a row, combined in a tree: short
  // dependency chains (l's order of summation is free; the max is exact).
  float m_new[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    float mx[4] = {m[h], kNegInf, kNegInf, kNegInf};
#pragma unroll
    for (int j = 0; j < BK / 8; ++j)
      mx[j % 4] =
          fmaxf(mx[j % 4], fmaxf(s[4 * j + 2 * h], s[4 * j + 2 * h + 1]));
    float x = fmaxf(fmaxf(mx[0], mx[1]), fmaxf(mx[2], mx[3]));
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
    m_new[h] = x;
    corr[h] = expf(m[h] - x);
  }
  float sum[2][4] = {};
#pragma unroll
  for (int i = 0; i < BK / 2; i += 2) {
    const int h = (i / 2) % 2, part = (i / 4) % 4;
    s[i] = expf(s[i] - m_new[h]);
    s[i + 1] = expf(s[i + 1] - m_new[h]);
    sum[h][part] = __fadd_rn(sum[h][part], __fadd_rn(s[i], s[i + 1]));
  }
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    float x = __fadd_rn(__fadd_rn(sum[h][0], sum[h][1]),
                        __fadd_rn(sum[h][2], sum[h][3]));
    x = __fadd_rn(x, __shfl_xor_sync(0xffffffffu, x, 1));
    x = __fadd_rn(x, __shfl_xor_sync(0xffffffffu, x, 2));
    l[h] = __fadd_rn(__fmul_rn(l[h], corr[h]), x);
    m[h] = m_new[h];
  }
}

template <int DH>
__global__ void __launch_bounds__(kThreads, 1)
flash_attn_kernel_sm90(const __grid_constant__ CUtensorMap q_map,
                       const __grid_constant__ CUtensorMap k_map,
                       const __grid_constant__ CUtensorMap v_map,
                       __nv_bfloat16* __restrict__ out,
                       float* __restrict__ scores, float* __restrict__ lse,
                       int n_heads, int sq, int sk,
                       int group, int kv_len, int causal, int window,
                       float scale) {
  using T = Tiles<DH>;
  constexpr int BK = T::kBlockK;
  extern __shared__ __align__(16) uint8_t smem_raw[];
  const uint32_t base = (smem_addr(smem_raw) + 1023u) & ~1023u;
  const uint32_t q_s = base;                        // [2][panel][128][row]
  const uint32_t k_s = q_s + 2 * T::kQBytes;        // [stage][panel][BK][row]
  const uint32_t v_s = k_s + kStages * T::kKVBytes; // [stage][panel][BK][row]
  const uint32_t q_full = v_s + kStages * T::kKVBytes;  // [2]
  const uint32_t q_empty = q_full + 16;                 // [2]
  const uint32_t full_bar = q_empty + 16;               // [stage]
  const uint32_t empty_bar = full_bar + 8 * kStages;    // [stage]

  // Work items (head, q tile), the longest q tiles of every head first; a
  // block takes items blockIdx.x, + gridDim.x, ...  Item `it` of a block
  // uses q buffer it % 2.
  const int n_q = sq / kBlockQ, n_k = sk / BK;
  const int n_items = n_heads * n_q;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;

  if (threadIdx.x == 0) {
    for (int b = 0; b < 2; ++b) {
      mbar_init(q_full + 8 * b, 1);
      mbar_init(q_empty + 8 * b, kConsumers * 4);
    }
    for (int s = 0; s < kStages; ++s) {
      mbar_init(full_bar + 8 * s, 1);
      mbar_init(empty_bar + 8 * s, kConsumers * 4);  // one arrival a warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (warp >= kConsumers * 4) {
    // The producer warpgroup: gives its registers to the consumers; one
    // thread issues every copy.
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;" ::"n"(kProducerRegs));
    if (threadIdx.x == kConsumers * 128) {
      int stage = 0;
      uint32_t phase = 0;
      for (int item = blockIdx.x, it = 0; item < n_items;
           item += gridDim.x, ++it) {
        const int bh = item % n_heads;
        const int q_lo = (n_q - 1 - item / n_heads) * kBlockQ;
        int first, last;
        tile_range(q_lo, n_k, BK, causal, window, first, last);
        const int qb = it % 2;
        mbar_wait(q_empty + 8 * qb, ((it / 2) % 2) ^ 1);
        mbar_expect_tx(q_full + 8 * qb, T::kQBytes);
#pragma unroll
        for (int p = 0; p < T::kPanels; ++p)
          tma_load(q_s + qb * T::kQBytes + p * T::kQPanel, &q_map,
                   q_full + 8 * qb, p * T::kPanel, bh * sq + q_lo);
        const int kv_row = (bh / group) * sk;
        for (int ik = first; ik <= last; ++ik) {
          // passes on the first lap
          mbar_wait(empty_bar + 8 * stage, phase ^ 1);
          const uint32_t bar = full_bar + 8 * stage;
          mbar_expect_tx(bar, 2 * T::kKVBytes);
#pragma unroll
          for (int p = 0; p < T::kPanels; ++p) {
            const uint32_t off = stage * T::kKVBytes + p * T::kKVPanel;
            tma_load(k_s + off, &k_map, bar, p * T::kPanel, kv_row + ik * BK);
            tma_load(v_s + off, &v_map, bar, p * T::kPanel, kv_row + ik * BK);
          }
          if (++stage == kStages) {
            stage = 0;
            phase ^= 1;
          }
        }
      }
    }
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;" ::"n"(kConsumerRegs));
    // Consumer warpgroup wg owns q rows [q_lo + 64 wg, + 64); thread (warp
    // w, lane 4 g + t) holds rows 16 w + g and 16 w + g + 8 of them.
    const int wg = warp / 4;
    const int g = lane / 4, t = lane % 4;
    // of the current item: q rows row and row + 8, the first of this
    // warpgroup's, the output's row, this warpgroup's q in shared memory
    int row = 0, r_lo = 0;
    size_t out_row = 0;
    uint32_t q_wg = 0;

    float acc[DH / 2], o[DH / 2], s[BK / 2];
    uint32_t pa[BK / 4];                   // P of the last tile, in bf16
#pragma unroll
    for (int i = 0; i < DH / 2; ++i) acc[i] = o[i] = 0.0f;
#pragma unroll
    for (int i = 0; i < BK / 2; ++i) s[i] = 0.0f;
    float m[2], l[2], corr_last[2], corr[2];

    // S = Q K^T of the tile in `stage`, over dh in steps of 16 (32 bytes of
    // a swizzled row); O = P V of the tile in `st` over its keys in steps
    // of 16 rows of V.
    auto issue_s = [&](int st) {
      const uint32_t k_st = k_s + st * T::kKVBytes;
#pragma unroll
      for (int kk = 0; kk < DH / 16; ++kk)
        wgmma_ss<BK>(s, T::k_major(q_wg, T::kQPanel, kk),
                     T::k_major(k_st, T::kKVPanel, kk), kk > 0);
      wg_commit();
    };
    auto issue_pv = [&](int st) {
      const uint32_t v_st = v_s + st * T::kKVBytes;
#pragma unroll
      for (int c = 0; c < BK / 16; ++c)
        wgmma_rs<DH>(o, pa + 4 * c, T::mn_major(v_st, T::kKVPanel, c),
                     c > 0);
      wg_commit();
    };
    // the last tile's P V is in o: free its stage, acc = acc corr + o
    auto retire = [&](int st) {
      pin(o);
      pin(pa);
      __syncwarp();
      if (lane == 0) mbar_arrive(empty_bar + 8 * st);
#pragma unroll
      for (int i = 0; i < DH / 2; ++i)
        acc[i] = __fadd_rn(__fmul_rn(acc[i], corr_last[(i / 2) % 2]), o[i]);
    };

    // the tile's softmax, p left in s
    auto softmax = [&](int ik) {
      pin(s);
      softmax_tile<BK>(s, m, l, corr, scores, out_row, sk, row, r_lo, ik * BK,
                       t, kv_len, causal, window, scale);
    };
    // once no product is in flight: p rounded to bf16 into the A-operand
    // fragment (the accumulator fragment of S is its register layout)
    auto shift = [&]() {
#pragma unroll
      for (int i = 0; i < BK / 2; i += 2) {
        const __nv_bfloat162 pb = __floats2bfloat162_rn(s[i], s[i + 1]);
        pa[i / 2] = *reinterpret_cast<const uint32_t*>(&pb);
      }
      corr_last[0] = corr[0];
      corr_last[1] = corr[1];
    };

    // Ping-pong: the warpgroups take turns to issue their products (named
    // barrier 1 + wg is "wg's turn"), so that one's softmax runs while the
    // tensor cores work through the other's products.  Warpgroup 0 starts.
    auto my_turn = [&]() {
      asm volatile("bar.sync %0, 256;" ::"r"(1 + wg) : "memory");
    };
    auto pass_turn = [&]() {
      asm volatile("bar.arrive %0, 256;" ::"r"(2 - wg) : "memory");
    };
    if (wg == 1) pass_turn();

    int stage = 0, last_stage = 0;
    uint32_t phase = 0;
    auto advance = [&]() {
      last_stage = stage;
      if (++stage == kStages) {
        stage = 0;
        phase ^= 1;
      }
    };
    for (int item = blockIdx.x, it = 0; item < n_items;
         item += gridDim.x, ++it) {
      const int bh = item % n_heads;
      const int q_lo = (n_q - 1 - item / n_heads) * kBlockQ;
      int first, last;
      tile_range(q_lo, n_k, BK, causal, window, first, last);
      const int qb = it % 2;
      row = q_lo + wg * 64 + (warp % 4) * 16 + g;
      r_lo = q_lo + wg * 64;
      out_row = static_cast<size_t>(bh) * sq + row;
      q_wg = q_s + qb * T::kQBytes + wg * 64 * T::kRowBytes;
#pragma unroll
      for (int i = 0; i < DH / 2; ++i) acc[i] = 0.0f;
      m[0] = m[1] = kNegInf;
      l[0] = l[1] = 0.0f;
      mbar_wait(q_full + 8 * qb, (it / 2) % 2);
      if (first <= last) {
        mbar_wait(full_bar + 8 * stage, phase);
        my_turn();
        wg_fence();
        issue_s(stage);
        pass_turn();
        wg_wait<0>();
        softmax(first);
        shift();
        advance();
        for (int ik = first + 1; ik <= last; ++ik) {
          mbar_wait(full_bar + 8 * stage, phase);
          // S of this tile, then the last tile's P V behind it: the tensor
          // cores run P V while this warpgroup takes the softmax of S.
          my_turn();
          wg_fence();
          issue_s(stage);
          issue_pv(last_stage);
          pass_turn();
          wg_wait<1>();
          softmax(ik);
          // the softmax's results before the wait: without this the compiler
          // sinks the whole softmax below it, and nothing overlaps P V
          pin(s);
          pin(l);
          pin(corr);
          wg_wait<0>();
          retire(last_stage);
          shift();
          advance();
        }
        my_turn();
        wg_fence();
        issue_pv(last_stage);
        pass_turn();
        wg_wait<0>();
        retire(last_stage);
      }
      __syncwarp();
      if (lane == 0) mbar_arrive(q_empty + 8 * qb);  // S is done with this q

#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const float denom = fmaxf(l[h], 1e-30f);
        __nv_bfloat16* dst = out + (out_row + 8 * h) * DH + 2 * t;
#pragma unroll
        for (int j = 0; j < DH / 8; ++j)
          *reinterpret_cast<__nv_bfloat162*>(dst + 8 * j) =
              __floats2bfloat162_rn(__fdiv_rn(acc[4 * j + 2 * h], denom),
                                    __fdiv_rn(acc[4 * j + 2 * h + 1], denom));
        // every lane of the quad holds the row's m and l: lane t = 0 writes
        if (lse != nullptr && t == 0)
          lse[out_row + 8 * h] = __fadd_rn(m[h], logf(denom));
      }
    }
    if (wg == 0) my_turn();  // the last turn warpgroup 1 passed
  }
}

template <int DH>
int launch(const void* q, const void* k, const void* v, void* out,
           float* scores, float* lse, int bh, int sq, int sk, int group,
           int kv_len, int causal, int window, cudaStream_t stream) {
  using T = Tiles<DH>;
  CUtensorMap q_map, k_map, v_map;
  int e = make_map(&q_map, q, bh * sq, DH, T::kPanel, kBlockQ);
  if (!e) e = make_map(&k_map, k, bh / group * sk, DH, T::kPanel, T::kBlockK);
  if (!e) e = make_map(&v_map, v, bh / group * sk, DH, T::kPanel, T::kBlockK);
  if (e) return e;
  auto kern = flash_attn_kernel_sm90<DH>;
  cudaError_t a = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, T::kSmem);
  int device = 0, sms = 0;
  if (a == cudaSuccess) a = cudaGetDevice(&device);
  if (a == cudaSuccess)
    a = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (a != cudaSuccess) return static_cast<int>(a);
  const int n_items = bh * (sq / kBlockQ);  // one block an SM walks them
  const float scale =
      static_cast<float>(1.0 / std::sqrt(static_cast<double>(DH)));
  kern<<<n_items < sms ? n_items : sms, kThreads, T::kSmem, stream>>>(
      q_map, k_map, v_map, static_cast<__nv_bfloat16*>(out), scores, lse,
      bh, sq, sk, group, kv_len, causal, window, scale);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// q (bh, sq, dh), k and v (bh / group, sk, dh), out (bh, sq, dh), bf16,
// row-major, contiguous and 16-byte aligned.  dh is 16, 32, 64 or 128; sq
// is a multiple of 128 and sk of the kv tile (128 at dh <= 64, 64 at dh
// 128); kv_len <= sk is the true kv length; window 0 means no window.
// scores, when not null, is an f32 (bh, sq, sk) tensor that receives the
// scaled scores s / sqrt(dh) of every tile the kernel runs, before the
// masks: the check that holds the kernel against its plain version feeds
// them to the plain version (the tensor core sums q k^T in its own order,
// and a score one f32 ulp off can round its p to the neighbouring bf16
// value).  Null on the serving path.  lse, when not null, is an f32 (bh,
// sq) tensor that receives each row's log-sum-exp (training; null on the
// serving path).  The wrapper checks all of this.
// Returns 0, a cudaError_t after the launch, or kNoEntryPoint /
// kEncodeFailed + CUresult when a tensor map could not be made.
extern "C" int flash_attn_sm90_launch(const void* q, const void* k,
                                      const void* v, void* out, void* scores,
                                      void* lse, int bh, int sq, int sk, int dh,
                                      int group, int kv_len, int causal,
                                      int window, void* stream) {
  if (bh <= 0 || sq <= 0) return 0;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* sc = static_cast<float*>(scores);
  float* ls = static_cast<float*>(lse);
  switch (dh) {
    case 16:
      return launch<16>(q, k, v, out, sc, ls, bh, sq, sk, group, kv_len, causal,
                        window, s);
    case 32:
      return launch<32>(q, k, v, out, sc, ls, bh, sq, sk, group, kv_len, causal,
                        window, s);
    case 64:
      return launch<64>(q, k, v, out, sc, ls, bh, sq, sk, group, kv_len, causal,
                        window, s);
    case 128:
      return launch<128>(q, k, v, out, sc, ls, bh, sq, sk, group, kv_len, causal,
                         window, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
