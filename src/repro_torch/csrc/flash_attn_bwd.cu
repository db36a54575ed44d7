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
// same formulas; it runs on the CPU and holds this kernel on the card.
//
// What bounds it on an H100: the products.  A causal launch at tinyllama's
// training shape (B 8, Hq 32, dh 64, S 2,048) needs 5 products of
// 2*dh flops a kept pair (S, dP, dV, dK, dQ): 10*B*Hq*dh*S(S+1)/2 = 3.44e11
// FLOP, 0.35 ms at the bf16 tensor-core peak, against ~235 MB of inputs and
// outputs (0.07 ms at 3.35 TB/s).  This design recomputes S and dP in each
// of its two kernels, 7 products a pair: 0.49 ms at the peak.  Beside the
// products, each kernel takes an exp and ~12 other f32 instructions a
// pair on the FMA and MUFU units (the plain version's numerics: a rounded
// scale multiply, the accurate expf, no exp2 trick).
//
// Design: two kernels on the caller's stream, each with a fixed order of
// sums and no atomics, so a launch and its repeat give the same bits, and
// each output row belongs to one work item.  Both have B6's skeleton: one
// persistent block an SM walks work items; its 384 threads are two
// consumer warpgroups of 64 rows (wgmma M = 64) and a producer warpgroup
// that hands its registers to them (setmaxnreg 24 / 240), one thread of
// which issues every TMA copy into shared memory, with a full and an empty
// mbarrier per buffer.  Items go to blocks in a snake order (round r: block
// b takes item r * grid + b, or r * grid + grid - 1 - b on odd rounds),
// the longest items first.  Tiles are stored as TMA writes them, panels of
// at most 64 columns with the matching swizzle (sm90_wgmma.cuh), and each
// tile that one product reads along its columns and another along its rows
// is read through a K-major and an MN-major descriptor of the same bytes:
// no transposed copy is staged anywhere.
//   flash_attn_bwd_dq_kernel: an item is (q head, q tile of 128 rows), the
//     causal diagonal's last tiles first.  The producer loads the tile's Q
//     and dO (two buffers, the next item's while this one runs) and a ring
//     of kStages K and V tiles of BK rows (128, 64 at dh 128) over the kv
//     tiles that the masks do not drop for the whole q tile, in order.  A
//     consumer computes D for its 64 rows from out and dout in device
//     memory (a fixed tree over the lanes; the loads in flight under its
//     first products) and writes it for the second kernel.  Per kv tile:
//     S = Q K^T and dP = dO V^T (all four operands K-major in shared
//     memory), P and dS in registers, and dQ += dS K with dS rounded to
//     bf16 from the accumulator fragment as the register A operand and K
//     read MN-major; dQ scaled once at the end.  A consumer issues the last
//     tile's dQ product and this tile's S and dP in one turn, then takes
//     this tile's dS while the other consumer's turn runs.
//   flash_attn_bwd_dkdv_kernel: an item is (kv head, kv tile of 128 rows,
//     64 a consumer), the first kv tiles first (under a causal mask they see
//     the most q tiles).  K and V are loaded once an item (3-d tensor maps:
//     at dh 128 a length that is a multiple of 64 leaves the last tile half
//     past the head's rows, which TMA fills with zeros, the masks drop and
//     no store writes); the producer rings Q and dO tiles of kBq rows (128,
//     64 at dh 128), with each tile's lse and D (bulk copies), over every q
//     head of the group and then every q tile that the masks keep, in that
//     order.  Per q tile: S^T = K Q^T and dP^T = V dO^T (K-major operands),
//     P^T and dS^T in registers, dV += P^T dO and dK += dS^T Q from the
//     fragments with dO and Q read MN-major, in two turns (the score
//     products, then the gradient products).  At dh 128 the two 64 x 128
//     f32 accumulators take 128 registers a thread: q tiles of 64 rows
//     leave room for the score tiles and the operands.
// Ping-pong: the two consumer warpgroups take turns to issue their products
// (named barriers), so that one's element-wise step runs while the tensor
// cores work through the other's products.  The element-wise step packs P
// and dS to bf16 as it goes, and applies the masks (a band of q - k and
// kv_len) only on tiles that cross the diagonal, the window edge or kv_len,
// in a compiled version of its own.
//
// Numerics.  Rows of no kept key: the forward writes lse = m + log(max(l,
// 1e-30)), which is -1e30 there (f32 cannot hold -1e30 + log(l)), and
// exp(s - lse) would be +inf; every pair of such a row is masked, and a
// tile holding a masked pair takes the masks, which set P and dS to 0
// (not P times something, which could be inf times 0), so the row has no
// gradient (a padded row, whose dout is 0, has none either way).
// Built without fast math: expf is the accurate one.

#include <cuda.h>  // CUtensorMap and its enums (types only)
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cmath>
#include <cstdint>
#include <type_traits>

#include "sm90_wgmma.cuh"  // mbarriers, TMA, wgmma, tensor maps

namespace {

using bf16 = __nv_bfloat16;

constexpr int kConsumers = 2;                     // warpgroups of 64 rows
constexpr int kThreads = (kConsumers + 1) * 128;  // + the producer's
// setmaxnreg budgets: 128 x 24 + 256 x 240 = 384 x 168, the registers the
// launch gives a block of 384 threads at one block an SM
constexpr int kProducerRegs = 24;
constexpr int kConsumerRegs = 240;
constexpr int kBlockQ = 128;   // dq kernel: q rows an item
constexpr int kBlockKV = 128;  // dkdv kernel: kv rows an item

template <int DH>
struct DqTiles : Panels<DH> {
  static constexpr int kBlockK = DH <= 64 ? 128 : 64;  // = kernel.bf16_tiles
  static constexpr int kStages = 3;                    // K/V ring
  static constexpr int kQPanel = kBlockQ * Panels<DH>::kRowBytes;
  static constexpr int kKVPanel = kBlockK * Panels<DH>::kRowBytes;
  static constexpr int kQBytes = kQPanel * Panels<DH>::kPanels;
  static constexpr int kKVBytes = kKVPanel * Panels<DH>::kPanels;
  // Q and dO [2] each, K and V [kStages] each, then the barriers
  static constexpr int kSmem = 4 * kQBytes + 2 * kStages * kKVBytes +
                               8 * (4 + 2 * kStages) + 1024;
  static_assert(kSmem <= 232448, "dq kernel: shared memory");
};

template <int DH>
struct KvTiles : Panels<DH> {
  // q rows a ring stage: at dh 128 the two 64 x 128 f32 accumulators take
  // 128 registers a thread, and score tiles of 64 x 64 leave room for the
  // operands
  static constexpr int kBq = DH <= 64 ? 128 : 64;
  static constexpr int kStages = 4;  // Q/dO ring
  static constexpr int kKVPanel = kBlockKV * Panels<DH>::kRowBytes;
  static constexpr int kQPanel = kBq * Panels<DH>::kRowBytes;
  static constexpr int kKVBytes = kKVPanel * Panels<DH>::kPanels;
  static constexpr int kQBytes = kQPanel * Panels<DH>::kPanels;
  static constexpr int kVecBytes = kBq * 4;  // a stage's lse or D, f32
  // K and V, Q and dO [kStages] each, lse and D [kStages] each, barriers
  static constexpr int kSmem = 2 * kKVBytes + 2 * kStages * kQBytes +
                               2 * kStages * kVecBytes +
                               8 * (2 + 2 * kStages) + 1024;
  static_assert(kSmem <= 232448, "dkdv kernel: shared memory");
};

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// Whether kv rows [k_lo, k_lo + bk) and q rows [q_lo, q_lo + bq) hold any
// pair the masks keep (the forward's tile rule, ref.block_runs, plus
// kv_len).  The tiles that run form one range along either axis.
__device__ __forceinline__ bool tile_runs(int q_lo, int bq, int k_lo, int bk,
                                          int kv_len, int causal, int window) {
  bool run = k_lo < kv_len;
  if (causal) run = run && k_lo <= q_lo + bq - 1;
  if (window) run = run && k_lo + bk - 1 > q_lo - window;
  return run;
}

// The masks on one thread's part of a tile as a band of q - k: with q - k
// = base + off for an element (off a constant of the unrolled loop), the
// causal and window rules keep it iff lo <= off <= hi (q - k >= 0 causal,
// q - k < window).
struct Band {
  int lo, hi;
  __device__ __forceinline__ Band(int base, int causal, int window)
      : lo(causal ? -base : -(1 << 30)),
        hi(window ? window - 1 - base : 1 << 30) {}
  __device__ __forceinline__ bool keeps(int off) const {
    return off >= lo && off <= hi;
  }
};

// Item of round r for this block, in the snake order (see above).
__device__ __forceinline__ int snake_item(int r) {
  const int b = static_cast<int>(blockIdx.x), n = static_cast<int>(gridDim.x);
  return r * n + ((r & 1) ? n - 1 - b : b);
}

// D = rowsum(dout * out) of the 16 rows [row0, row0 + 16) (global row
// indices) for one warp, in two steps so that the device-memory loads are
// in flight while the warp issues its first products: load() brings each
// lane's 16-byte vectors of out and dout (lanes over a row's vectors),
// reduce() sums them in a fixed tree over the lanes of a row, writes D to
// delta and returns this thread's rows g and g + 8 of the 16.
template <int DH>
struct RowDeltas {
  static constexpr int kVecs = DH / 8;      // 16-byte vectors a row
  static constexpr int kRows = 32 / kVecs;  // rows a pass
  static constexpr int kPasses = 16 / kRows;
  uint4 a[kPasses], b[kPasses];

  __device__ __forceinline__ void load(const bf16* __restrict__ out,
                                       const bf16* __restrict__ dout,
                                       size_t row0, int lane) {
#pragma unroll
    for (int p = 0; p < kPasses; ++p) {
      const size_t at =
          (row0 + p * kRows + lane / kVecs) * DH + (lane % kVecs) * 8;
      a[p] = __ldg(reinterpret_cast<const uint4*>(out + at));
      b[p] = __ldg(reinterpret_cast<const uint4*>(dout + at));
    }
  }

  __device__ __forceinline__ void reduce(float* __restrict__ delta,
                                         size_t row0, int lane, int g,
                                         float (&d)[2]) const {
    float part[kPasses];
#pragma unroll
    for (int p = 0; p < kPasses; ++p) {
      const bf16* x = reinterpret_cast<const bf16*>(&a[p]);
      const bf16* y = reinterpret_cast<const bf16*>(&b[p]);
      float s = 0.0f;
#pragma unroll
      for (int i = 0; i < 8; ++i)
        s = __fmaf_rn(__bfloat162float(y[i]), __bfloat162float(x[i]), s);
#pragma unroll
      for (int off = kVecs / 2; off > 0; off /= 2)
        s = __fadd_rn(s, __shfl_xor_sync(0xffffffffu, s, off));
      part[p] = s;
      if (lane % kVecs == 0) delta[row0 + p * kRows + lane / kVecs] = s;
    }
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = g + 8 * h;
#pragma unroll
      for (int p = 0; p < kPasses; ++p) {
        const float x =
            __shfl_sync(0xffffffffu, part[p], (r % kRows) * kVecs);
        if (r / kRows == p) d[h] = x;
      }
    }
  }
};

template <int DH>
__global__ void __launch_bounds__(kThreads, 1)
flash_attn_bwd_dq_kernel(const __grid_constant__ CUtensorMap q_map,
                         const __grid_constant__ CUtensorMap do_map,
                         const __grid_constant__ CUtensorMap k_map,
                         const __grid_constant__ CUtensorMap v_map,
                         const bf16* __restrict__ out,
                         const bf16* __restrict__ dout,
                         const float* __restrict__ lse,
                         float* __restrict__ delta, bf16* __restrict__ dq,
                         int n_heads, int sq, int sk, int group, int kv_len,
                         int causal, int window, float scale) {
  using T = DqTiles<DH>;
  constexpr int BK = T::kBlockK;
  constexpr int kStages = T::kStages;
  extern __shared__ __align__(16) uint8_t smem_raw[];
  const uint32_t base = (smem_addr(smem_raw) + 1023u) & ~1023u;
  const uint32_t q_s = base;                          // [2][panel][128][row]
  const uint32_t do_s = q_s + 2 * T::kQBytes;         // [2][panel][128][row]
  const uint32_t k_s = do_s + 2 * T::kQBytes;         // [stage][panel][BK][row]
  const uint32_t v_s = k_s + kStages * T::kKVBytes;   // [stage][panel][BK][row]
  const uint32_t q_full = v_s + kStages * T::kKVBytes;  // [2]
  const uint32_t q_empty = q_full + 16;                 // [2]
  const uint32_t full_bar = q_empty + 16;               // [stage]
  const uint32_t empty_bar = full_bar + 8 * kStages;    // [stage]

  const int n_q = sq / kBlockQ, n_k = sk / BK;
  const int n_items = n_heads * n_q;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;

  if (threadIdx.x == 0) {
    for (int b = 0; b < 2; ++b) {
      mbar_init(q_full + 8 * b, 1);
      mbar_init(q_empty + 8 * b, kConsumers * 4);  // one arrival a warp
    }
    for (int s = 0; s < kStages; ++s) {
      mbar_init(full_bar + 8 * s, 1);
      mbar_init(empty_bar + 8 * s, kConsumers * 4);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  // item -> (head, q tile): every head's last q tile first; item `it` of a
  // block uses Q/dO buffer it % 2
  auto item_at = [&](int item, int& bh, int& q_lo) {
    bh = item % n_heads;
    q_lo = (n_q - 1 - item / n_heads) * kBlockQ;
  };
  // the kv tiles that run for q tile q_lo: [first, last]
  auto kv_range = [&](int q_lo, int& first, int& last) {
    first = n_k;
    last = -1;
    for (int ik = 0; ik < n_k; ++ik) {
      if (!tile_runs(q_lo, kBlockQ, ik * BK, BK, kv_len, causal, window))
        continue;
      first = min(first, ik);
      last = ik;
    }
  };

  if (warp >= kConsumers * 4) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;" ::"n"(kProducerRegs));
    if (threadIdx.x == kConsumers * 128) {
      int stage = 0;
      uint32_t phase = 0;
      for (int it = 0;; ++it) {
        const int item = snake_item(it);
        if (item >= n_items) break;
        int bh, q_lo, first, last;
        item_at(item, bh, q_lo);
        kv_range(q_lo, first, last);
        const int qb = it % 2;
        mbar_wait(q_empty + 8 * qb, ((it / 2) % 2) ^ 1);
        mbar_expect_tx(q_full + 8 * qb, 2 * T::kQBytes);
#pragma unroll
        for (int p = 0; p < T::kPanels; ++p) {
          const uint32_t off = qb * T::kQBytes + p * T::kQPanel;
          tma_load(q_s + off, &q_map, q_full + 8 * qb, p * T::kPanel,
                   bh * sq + q_lo);
          tma_load(do_s + off, &do_map, q_full + 8 * qb, p * T::kPanel,
                   bh * sq + q_lo);
        }
        const int kv_row = (bh / group) * sk;
        for (int ik = first; ik <= last; ++ik) {
          mbar_wait(empty_bar + 8 * stage, phase ^ 1);  // passes on lap 1
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
    // w of the group, lane 4 g + t) holds rows 16 w + g and 16 w + g + 8 of
    // them: accumulator index 4 j + 2 h + e is row + 8 h, column 8 j + 2 t + e
    const int wg = warp / 4, wl = warp % 4;
    const int g = lane / 4, t = lane % 4;
    float acc[DH / 2], s[BK / 2], dp[BK / 2];
    uint32_t pa[BK / 4];  // dS in bf16, the A operand of dQ += dS K
#pragma unroll
    for (int i = 0; i < BK / 2; ++i) s[i] = dp[i] = 0.0f;
    int stage = 0, last_stage = 0;
    uint32_t phase = 0;
    auto advance = [&]() {
      last_stage = stage;
      if (++stage == kStages) {
        stage = 0;
        phase ^= 1;
      }
    };
    // Ping-pong: the warpgroups take turns to issue their products (named
    // barrier 1 + wg is "wg's turn"), so that one's element-wise step runs
    // while the tensor cores work through the other's products.  Warpgroup
    // 0 starts.
    auto my_turn = [&]() {
      asm volatile("bar.sync %0, 256;" ::"r"(1 + wg) : "memory");
    };
    auto pass_turn = [&]() {
      asm volatile("bar.arrive %0, 256;" ::"r"(2 - wg) : "memory");
    };
    if (wg == 1) pass_turn();
    for (int it = 0;; ++it) {
      const int item = snake_item(it);
      if (item >= n_items) break;
      int bh, q_lo, first, last;
      item_at(item, bh, q_lo);
      kv_range(q_lo, first, last);
      const int qb = it % 2;
      const int r_lo = q_lo + wg * 64;     // this warpgroup's first row
      const int row = r_lo + wl * 16 + g;  // this thread's rows: row, row + 8
      const size_t grow = static_cast<size_t>(bh) * sq + row;
      float d_r[2], lse_r[2];
      RowDeltas<DH> deltas;
      deltas.load(out, dout, grow - g, lane);
      lse_r[0] = lse[grow];
      lse_r[1] = lse[grow + 8];
      const uint32_t q_wg = q_s + qb * T::kQBytes + wg * 64 * T::kRowBytes;
      const uint32_t do_wg = do_s + qb * T::kQBytes + wg * 64 * T::kRowBytes;
#pragma unroll
      for (int i = 0; i < DH / 2; ++i) acc[i] = 0.0f;
      mbar_wait(q_full + 8 * qb, (it / 2) % 2);
      // S = Q K^T and dP = dO V^T of the tile in stage st
      auto issue_sdp = [&](int st) {
        const uint32_t k_st = k_s + st * T::kKVBytes;
        const uint32_t v_st = v_s + st * T::kKVBytes;
#pragma unroll
        for (int kk = 0; kk < DH / 16; ++kk)
          wgmma_ss<BK>(s, T::k_major(q_wg, T::kQPanel, kk),
                       T::k_major(k_st, T::kKVPanel, kk), kk > 0);
#pragma unroll
        for (int kk = 0; kk < DH / 16; ++kk)
          wgmma_ss<BK>(dp, T::k_major(do_wg, T::kQPanel, kk),
                       T::k_major(v_st, T::kKVPanel, kk), kk > 0);
      };
      // dQ += dS K of the tile in stage st, dS in pa
      auto issue_dq = [&](int st) {
#pragma unroll
        for (int c = 0; c < BK / 16; ++c)
          wgmma_rs<DH>(acc, pa + 4 * c,
                       T::mn_major(k_s + st * T::kKVBytes, T::kKVPanel, c), 1);
      };
      // dS of the tile at k_lo from s and dp (masked on edge tiles only, a
      // compiled version of its own), rounded to bf16 into pa (the
      // accumulator fragment of S is the A operand's register layout)
      auto ds_tile = [&](int k_lo) {
        pin(s);
        pin(dp);
        pin(acc);
        pin(pa);
        const bool edge = k_lo + BK > kv_len ||
                          (causal && k_lo + BK - 1 > r_lo) ||
                          (window && k_lo <= r_lo + 63 - window);
        auto ds_step = [&](auto masked) {
          const Band band(row - k_lo - 2 * t, causal, window);
          const int k_lim = kv_len - k_lo - 2 * t;
#pragma unroll
          for (int i = 0; i < BK / 2; i += 2) {
            const int h = (i / 2) % 2, j = i / 4;
            float ds[2];
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              const float p =
                  expf(__fsub_rn(__fmul_rn(s[i + e], scale), lse_r[h]));
              ds[e] = __fmul_rn(p, __fsub_rn(dp[i + e], d_r[h]));
              // row + 8 h against column k_lo + 8 j + 2 t + e
              if (decltype(masked)::value &&
                  (!band.keeps(8 * h - 8 * j - e) || 8 * j + e >= k_lim))
                ds[e] = 0.0f;
            }
            pa[i / 2] = pack_bf16(ds[0], ds[1]);
          }
        };
        if (edge)
          ds_step(std::true_type{});
        else
          ds_step(std::false_type{});
      };
      // the last tile's dQ product is done: free its stage
      auto release = [&](int st) {
        __syncwarp();
        if (lane == 0) mbar_arrive(empty_bar + 8 * st);
      };
      // One turn a tile: the last tile's dQ product and this tile's S and
      // dP issued together; the element-wise step runs under the other
      // warpgroup's turn.
      if (first <= last) {
        mbar_wait(full_bar + 8 * stage, phase);
        my_turn();
        wg_fence();
        issue_sdp(stage);
        wg_commit();
        pass_turn();
        deltas.reduce(delta, grow - g, lane, g, d_r);
        wg_wait<0>();
        ds_tile(first * BK);
        advance();
        for (int ik = first + 1; ik <= last; ++ik) {
          mbar_wait(full_bar + 8 * stage, phase);
          my_turn();
          wg_fence();
          issue_dq(last_stage);
          issue_sdp(stage);
          wg_commit();
          pass_turn();
          wg_wait<0>();
          ds_tile(ik * BK);
          release(last_stage);
          advance();
        }
        my_turn();
        wg_fence();
        issue_dq(last_stage);
        wg_commit();
        pass_turn();
        wg_wait<0>();
        pin(acc);
        pin(pa);
        release(last_stage);
      }
      if (first > last) deltas.reduce(delta, grow - g, lane, g, d_r);
      __syncwarp();
      if (lane == 0) mbar_arrive(q_empty + 8 * qb);
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        bf16* dst = dq + (grow + 8 * h) * DH + 2 * t;
#pragma unroll
        for (int j = 0; j < DH / 8; ++j)
          *reinterpret_cast<uint32_t*>(dst + 8 * j) =
              pack_bf16(__fmul_rn(acc[4 * j + 2 * h], scale),
                        __fmul_rn(acc[4 * j + 2 * h + 1], scale));
      }
    }
    if (wg == 0) my_turn();  // the last turn warpgroup 1 passed
  }
}

template <int DH>
__global__ void __launch_bounds__(kThreads, 1)
flash_attn_bwd_dkdv_kernel(const __grid_constant__ CUtensorMap q_map,
                           const __grid_constant__ CUtensorMap do_map,
                           const __grid_constant__ CUtensorMap k_map,
                           const __grid_constant__ CUtensorMap v_map,
                           const float* __restrict__ lse,
                           const float* __restrict__ delta,
                           bf16* __restrict__ dk, bf16* __restrict__ dv,
                           int n_kv_heads, int sq, int sk, int group,
                           int kv_len, int causal, int window, float scale) {
  using T = KvTiles<DH>;
  constexpr int kStages = T::kStages;
  constexpr int kBq = T::kBq;
  extern __shared__ __align__(16) uint8_t smem_raw[];
  const uint32_t base = (smem_addr(smem_raw) + 1023u) & ~1023u;
  const uint32_t k_s = base;                          // [panel][128][row]
  const uint32_t v_s = k_s + T::kKVBytes;             // [panel][128][row]
  const uint32_t q_s = v_s + T::kKVBytes;             // [stage][panel][64][row]
  const uint32_t do_s = q_s + kStages * T::kQBytes;   // [stage][panel][64][row]
  const uint32_t lse_s = do_s + kStages * T::kQBytes;         // [stage][64]
  const uint32_t d_s = lse_s + kStages * T::kVecBytes;        // [stage][64]
  const uint32_t kv_full = d_s + kStages * T::kVecBytes;
  const uint32_t kv_empty = kv_full + 8;
  const uint32_t full_bar = kv_empty + 8;               // [stage]
  const uint32_t empty_bar = full_bar + 8 * kStages;    // [stage]
  // generic pointers to the staged lse and D, for the consumers' loads
  const float* lse_g =
      reinterpret_cast<const float*>(smem_raw + (lse_s - smem_addr(smem_raw)));
  const float* d_g =
      reinterpret_cast<const float*>(smem_raw + (d_s - smem_addr(smem_raw)));

  const int n_kt = (sk + kBlockKV - 1) / kBlockKV, n_q = sq / kBq;
  const int n_items = n_kv_heads * n_kt;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;

  if (threadIdx.x == 0) {
    mbar_init(kv_full, 1);
    mbar_init(kv_empty, kConsumers * 4);  // one arrival a warp
    for (int s = 0; s < kStages; ++s) {
      mbar_init(full_bar + 8 * s, 1);
      mbar_init(empty_bar + 8 * s, kConsumers * 4);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  // item -> (kv head, kv tile): the first kv tiles of every head first
  auto item_at = [&](int item, int& hk, int& k_lo) {
    hk = item % n_kv_heads;
    k_lo = item / n_kv_heads * kBlockKV;
  };
  // the q tiles that run for kv tile k_lo: [first, last]
  auto q_range = [&](int k_lo, int& first, int& last) {
    first = n_q;
    last = -1;
    for (int iq = 0; iq < n_q; ++iq) {
      if (!tile_runs(iq * kBq, kBq, k_lo, kBlockKV, kv_len, causal, window))
        continue;
      first = min(first, iq);
      last = iq;
    }
  };

  if (warp >= kConsumers * 4) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;" ::"n"(kProducerRegs));
    if (threadIdx.x == kConsumers * 128) {
      int stage = 0;
      uint32_t phase = 0;
      for (int it = 0;; ++it) {
        const int item = snake_item(it);
        if (item >= n_items) break;
        int hk, k_lo, first, last;
        item_at(item, hk, k_lo);
        q_range(k_lo, first, last);
        mbar_wait(kv_empty, (it & 1) ^ 1);  // passes on the first item
        mbar_expect_tx(kv_full, 2 * T::kKVBytes);
#pragma unroll
        for (int p = 0; p < T::kPanels; ++p) {
          tma_load_3d(k_s + p * T::kKVPanel, &k_map, kv_full, p * T::kPanel,
                      k_lo, hk);
          tma_load_3d(v_s + p * T::kKVPanel, &v_map, kv_full, p * T::kPanel,
                      k_lo, hk);
        }
        for (int j = 0; j < group; ++j) {
          const int bh = hk * group + j;
          for (int iq = first; iq <= last; ++iq) {
            const int row = bh * sq + iq * kBq;
            mbar_wait(empty_bar + 8 * stage, phase ^ 1);  // passes on lap 1
            const uint32_t bar = full_bar + 8 * stage;
            mbar_expect_tx(bar, 2 * T::kQBytes + 2 * T::kVecBytes);
#pragma unroll
            for (int p = 0; p < T::kPanels; ++p) {
              const uint32_t off = stage * T::kQBytes + p * T::kQPanel;
              tma_load(q_s + off, &q_map, bar, p * T::kPanel, row);
              tma_load(do_s + off, &do_map, bar, p * T::kPanel, row);
            }
            bulk_load(lse_s + stage * T::kVecBytes, lse + row, T::kVecBytes,
                      bar);
            bulk_load(d_s + stage * T::kVecBytes, delta + row, T::kVecBytes,
                      bar);
            if (++stage == kStages) {
              stage = 0;
              phase ^= 1;
            }
          }
        }
      }
    }
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;" ::"n"(kConsumerRegs));
    // Consumer warpgroup wg owns kv rows [k_lo + 64 wg, + 64); thread (warp
    // w of the group, lane 4 g + t) holds kv rows 16 w + g and + 8 of them
    // and, of S^T's fragment, index 4 j + 2 h + e: kv row + 8 h, q column
    // 8 j + 2 t + e of the q tile
    const int wg = warp / 4, wl = warp % 4;
    const int g = lane / 4, t = lane % 4;
    float dk_acc[DH / 2], dv_acc[DH / 2], s[kBq / 2], dp[kBq / 2];
    uint32_t pa[kBq / 4], pb[kBq / 4];  // P^T and dS^T in bf16
#pragma unroll
    for (int i = 0; i < kBq / 2; ++i) s[i] = dp[i] = 0.0f;
    int stage = 0;
    uint32_t phase = 0;
    // Ping-pong: the warpgroups take turns to issue their products (named
    // barrier 1 + wg is "wg's turn"), so that one's element-wise step runs
    // while the tensor cores work through the other's products.  Warpgroup
    // 0 starts.
    auto my_turn = [&]() {
      asm volatile("bar.sync %0, 256;" ::"r"(1 + wg) : "memory");
    };
    auto pass_turn = [&]() {
      asm volatile("bar.arrive %0, 256;" ::"r"(2 - wg) : "memory");
    };
    if (wg == 1) pass_turn();
    for (int it = 0;; ++it) {
      const int item = snake_item(it);
      if (item >= n_items) break;
      int hk, k_lo, first, last;
      item_at(item, hk, k_lo);
      q_range(k_lo, first, last);
      const int c_lo = k_lo + wg * 64;      // this warpgroup's first kv row
      const int k_pos = c_lo + wl * 16 + g;  // this thread's: k_pos, + 8
      const uint32_t k_wg = k_s + wg * 64 * T::kRowBytes;
      const uint32_t v_wg = v_s + wg * 64 * T::kRowBytes;
#pragma unroll
      for (int i = 0; i < DH / 2; ++i) dk_acc[i] = dv_acc[i] = 0.0f;
      mbar_wait(kv_full, it & 1);
      for (int j = 0; j < group; ++j) {
        for (int iq = first; iq <= last; ++iq) {
          const int q_lo = iq * kBq;
          const uint32_t q_st = q_s + stage * T::kQBytes;
          const uint32_t do_st = do_s + stage * T::kQBytes;
          mbar_wait(full_bar + 8 * stage, phase);
          my_turn();
          wg_fence();
#pragma unroll
          for (int kk = 0; kk < DH / 16; ++kk)
            wgmma_ss<kBq>(s, T::k_major(k_wg, T::kKVPanel, kk),
                          T::k_major(q_st, T::kQPanel, kk), kk > 0);
#pragma unroll
          for (int kk = 0; kk < DH / 16; ++kk)
            wgmma_ss<kBq>(dp, T::k_major(v_wg, T::kKVPanel, kk),
                          T::k_major(do_st, T::kQPanel, kk), kk > 0);
          wg_commit();
          pass_turn();
          wg_wait<0>();
          pin(s);
          pin(dp);
          const bool edge = c_lo + 64 > kv_len ||
                            (causal && c_lo + 63 > q_lo) ||
                            (window && c_lo <= q_lo + kBq - 1 - window);
          const float* lse_t = lse_g + stage * kBq;
          const float* d_t = d_g + stage * kBq;
          // P^T and dS^T of each pair of q columns, masked on edge tiles
          // only (a compiled version of its own), rounded to bf16 into the
          // A-operand fragments
          auto ds_step = [&](auto masked) {
            const Band band(q_lo + 2 * t - k_pos, causal, window);
            const bool kv_ok[2] = {k_pos < kv_len, k_pos + 8 < kv_len};
#pragma unroll
            for (int jj = 0; jj < kBq / 8; ++jj) {
              const int col = 8 * jj + 2 * t;  // q columns col, col + 1
              const float2 l2 = *reinterpret_cast<const float2*>(lse_t + col);
              const float2 d2 = *reinterpret_cast<const float2*>(d_t + col);
#pragma unroll
              for (int h = 0; h < 2; ++h) {
                float p[2], ds[2];
#pragma unroll
                for (int e = 0; e < 2; ++e) {
                  const int i = 4 * jj + 2 * h + e;
                  p[e] = expf(
                      __fsub_rn(__fmul_rn(s[i], scale), e ? l2.y : l2.x));
                  ds[e] = __fmul_rn(p[e], __fsub_rn(dp[i], e ? d2.y : d2.x));
                  // kv row k_pos + 8 h against q column q_lo + col + e
                  if (decltype(masked)::value &&
                      (!band.keeps(8 * jj + e - 8 * h) || !kv_ok[h]))
                    p[e] = ds[e] = 0.0f;
                }
                pa[2 * jj + h] = pack_bf16(p[0], p[1]);
                pb[2 * jj + h] = pack_bf16(ds[0], ds[1]);
              }
            }
          };
          if (edge)
            ds_step(std::true_type{});
          else
            ds_step(std::false_type{});
          my_turn();
          wg_fence();
#pragma unroll
          for (int c = 0; c < kBq / 16; ++c)
            wgmma_rs<DH>(dv_acc, pa + 4 * c, T::mn_major(do_st, T::kQPanel, c),
                         1);
#pragma unroll
          for (int c = 0; c < kBq / 16; ++c)
            wgmma_rs<DH>(dk_acc, pb + 4 * c, T::mn_major(q_st, T::kQPanel, c),
                         1);
          wg_commit();
          pass_turn();
          wg_wait<0>();
          pin(dv_acc);
          pin(dk_acc);
          pin(pa);
          pin(pb);
          __syncwarp();
          if (lane == 0) mbar_arrive(empty_bar + 8 * stage);
          if (++stage == kStages) {
            stage = 0;
            phase ^= 1;
          }
        }
      }
      __syncwarp();
      if (lane == 0) mbar_arrive(kv_empty);
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        if (k_pos + 8 * h >= sk) continue;  // past the head's rows (dh 128)
        const size_t at =
            (static_cast<size_t>(hk) * sk + k_pos + 8 * h) * DH + 2 * t;
#pragma unroll
        for (int jj = 0; jj < DH / 8; ++jj) {
          *reinterpret_cast<uint32_t*>(dk + at + 8 * jj) =
              pack_bf16(__fmul_rn(dk_acc[4 * jj + 2 * h], scale),
                        __fmul_rn(dk_acc[4 * jj + 2 * h + 1], scale));
          *reinterpret_cast<uint32_t*>(dv + at + 8 * jj) =
              pack_bf16(dv_acc[4 * jj + 2 * h], dv_acc[4 * jj + 2 * h + 1]);
        }
      }
    }
    if (wg == 0) my_turn();  // the last turn warpgroup 1 passed
  }
}

template <int DH>
int launch(const void* q, const void* k, const void* v, const void* out,
           const void* dout, const float* lse, float* delta, void* dq,
           void* dk, void* dv, int bh, int sq, int sk, int group, int kv_len,
           int causal, int window, cudaStream_t stream) {
  using TQ = DqTiles<DH>;
  using TK = KvTiles<DH>;
  const int n_kv = bh / group;
  CUtensorMap q128, do128, k_bk, v_bk, q_bq, do_bq, k3, v3;
  int e = make_map(&q128, q, bh * sq, DH, TQ::kPanel, kBlockQ);
  if (!e) e = make_map(&do128, dout, bh * sq, DH, TQ::kPanel, kBlockQ);
  if (!e) e = make_map(&k_bk, k, n_kv * sk, DH, TQ::kPanel, TQ::kBlockK);
  if (!e) e = make_map(&v_bk, v, n_kv * sk, DH, TQ::kPanel, TQ::kBlockK);
  if (!e) e = make_map(&q_bq, q, bh * sq, DH, TK::kPanel, TK::kBq);
  if (!e) e = make_map(&do_bq, dout, bh * sq, DH, TK::kPanel, TK::kBq);
  if (!e) e = make_map(&k3, k, sk, DH, TK::kPanel, kBlockKV, n_kv);
  if (!e) e = make_map(&v3, v, sk, DH, TK::kPanel, kBlockKV, n_kv);
  if (e) return e;
  auto kq = flash_attn_bwd_dq_kernel<DH>;
  auto kkv = flash_attn_bwd_dkdv_kernel<DH>;
  cudaError_t a = cudaFuncSetAttribute(
      kq, cudaFuncAttributeMaxDynamicSharedMemorySize, TQ::kSmem);
  if (a == cudaSuccess)
    a = cudaFuncSetAttribute(kkv, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             TK::kSmem);
  int device = 0, sms = 0;
  if (a == cudaSuccess) a = cudaGetDevice(&device);
  if (a == cudaSuccess)
    a = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (a != cudaSuccess) return static_cast<int>(a);
  const float scale = static_cast<float>(1.0 / sqrt(static_cast<double>(DH)));
  // the dq kernel writes D, which the dkdv kernel reads: the stream orders
  // them
  const int n_q_items = bh * (sq / kBlockQ);
  kq<<<n_q_items < sms ? n_q_items : sms, kThreads, TQ::kSmem, stream>>>(
      q128, do128, k_bk, v_bk, static_cast<const bf16*>(out),
      static_cast<const bf16*>(dout), lse, delta, static_cast<bf16*>(dq), bh,
      sq, sk, group, kv_len, causal, window, scale);
  a = cudaGetLastError();
  if (a != cudaSuccess) return static_cast<int>(a);
  const int n_kv_items = n_kv * ((sk + kBlockKV - 1) / kBlockKV);
  kkv<<<n_kv_items < sms ? n_kv_items : sms, kThreads, TK::kSmem, stream>>>(
      q_bq, do_bq, k3, v3, lse, delta, static_cast<bf16*>(dk),
      static_cast<bf16*>(dv), n_kv, sq, sk, group, kv_len, causal, window,
      scale);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// q, out, dout, dq (bh, sq, dh); k, v, dk, dv (bh / group, sk, dh): bf16,
// row-major, contiguous and 16-byte aligned; lse (bh, sq) f32 from the
// forward; delta (bh, sq) f32 scratch (receives D).  dh is 16, 32, 64 or
// 128; sq is a multiple of 128 and sk of the forward's kv tile (128 at dh
// <= 64, 64 at dh 128); kv_len <= sk is the true kv length; window 0 means
// no window.  The wrapper checks all of this.  Returns 0, a cudaError_t of
// a launch, or kNoEntryPoint / kEncodeFailed + CUresult when a tensor map
// could not be made.
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
