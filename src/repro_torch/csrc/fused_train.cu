// Whole-network fused training of the MRF net: per batch tile, the forward
// pass, the masked MSE loss, the hand-derived backward pass and an in-place
// SGD or Adam update, over every tile of K steps in one launch, on one
// thread-block cluster.
//
// Replaces: src/repro/kernels/fused_train/kernel.py:145 (fused_train_call,
// body _kernel, the shared train_tile and _sgd_update) and
// src/repro/kernels/fused_train/multistep.py:58 (fused_train_multistep_call)
// and :172 (fused_train_adam_call, body _adam_kernel).  On the TPU the
// weights (and Adam's two moment stacks) sit in VMEM for a whole launch
// while a sequential grid walks the K*B/tile batch tiles; tile k*n_tiles + j
// sees the weights as every earlier tile left them.  The three TPU entry
// points are one kernel here: the single step is K = 1, Adam differs only in
// its update rule, and the int8 weight fake-quant of QAT is a runtime flag.
// Layer count, widths, the tile and the buffer layout are runtime values
// (the wrapper's plan, kernels/fused_train/kernel.py), so one binary trains
// every net.  A second kernel, fused_train_kernel_per_sample (the end of
// this file), takes the per-sample stream: tile 1, SGD, no QAT.
//
// What bounds it on an H100: the chain of dependent tiles.  Every tile
// needs the weights the previous tile wrote, so the tiles run one after the
// other.  Inside a tile the rows are independent through the forward pass
// and through dh; only the sums over rows in dW/db, and the update after
// them, join them.  So a cluster of C blocks on C neighbouring SMs owns the
// net for the whole launch, and the floor is C SMs' fp32 rate (a sample of
// mrf-fpga costs 59,584 FLOP).  What sets the pace above it is latency: a
// tile is ~2L dependent phases (a layer's forward, a layer's dh and
// partials), each a few register tiles and a shuffle tree deep and ending
// in a block barrier, plus two exchanges across the cluster.
//
// Design:
// - Each block holds a full replica of the weights and biases in shared
//   memory (rows padded to 4 floats for 16-byte loads, pads zero) and takes
//   a contiguous share of each tile's rows (as even as possible; a block may
//   take none).  The forward pass, the loss's per-row terms, dh and the
//   block's partial dW/db run on its own rows with block barriers only.  dh
//   for every layer is taken through the weights before any update
//   (ref.py's train_tile_plain): the whole backward precedes the update.
// - The block's rows live on chip: the x and y rows (double-buffered,
//   prefetched with cp.async during the previous tile), every layer's
//   activations and the two delta buffers are in shared memory; so are the
//   QAT fake-quantized weights where they fit (else the block's own region
//   of a global workspace).  Each block fake-quantizes a share of the
//   entries and stores them into every replica (or, with wq in global
//   memory, all of its own), so every block holds the same bits.
// - dW and db are reduced across the cluster in a fixed order by owners:
//   block r owns a contiguous range of every layer's W/b, one thread an
//   entry chunk, the same every tile.  Where every partial and the owners'
//   receive buffers fit in shared memory (the bulk exchange; mrf-fpga),
//   each block sends each owner its range of its partials by a bulk copy
//   into the owner's shared memory (cp.async.bulk shared::cluster,
//   completing on the owner's mbarrier); the owner adds the C partials in
//   block order, applies SGD or Adam (its moments in global memory,
//   touched by the owner only) and sends the new range to every replica the
//   same way.  The mbarriers take the place of cluster barriers, so a tile
//   has none (with QAT, one after the fake-quant).  Otherwise
//   (mrf-original) the owner reads the partials where they lie (other
//   blocks' shared memory through DSMEM, or their global regions, for
//   layers too large for what is left, read past L1) after a cluster
//   barrier, stores into every replica through DSMEM, and a cluster barrier
//   ends the tile.  The loss's sum over the tile is reduced the same
//   way, by block 0.
// - Register tiles: a thread computes 2 rows x 4 columns (1 x 4 at one row a
//   block) from float4 loads, rows 4 banks apart; where a phase has fewer
//   such tiles than threads, each sum (a dot product, or dW's sum over the
//   rows) is split over 2-32 lanes of a warp and joined by a fixed
//   xor-shuffle tree, so a phase is not one long FMA chain.  At tile 1 (the
//   per-sample stream) the wrapper launches the per-sample kernel at the
//   end of this file instead, where it can: SGD, no QAT, a net within its
//   register budget (kernel.py: takes_per_sample_path).
//
// Determinism: no atomics.  Every sum (each dot's K loop and its shuffle
// tree, dW's and db's sum over the block's rows and its tree, the
// block-ordered sum of the partials, the loss) is taken in a fixed order, so
// for one cluster size a K-step launch equals K single-step launches bit for
// bit, and two identical launches give identical bits.  Another cluster
// size sums in another order.
//
// Numerics: built without fast math; no tensor cores (TF32 would not keep
// atol 1e-5).  The fake-quant divides with __fdiv_rn and rounds with rintf
// (half to even): s = max_k |w[k,n]| / 127 + 1e-12, clamp(rint(w / s), -127,
// 127) * s.  The update rules use explicitly rounded operations (no
// contraction), in the order of src/repro/kernels/fused_train/
// multistep.py:135-152: t = step0 + tile + 1 as a float, powf(b1, t),
// __fsqrt_rn, and + eps outside the square root.

#include <cooperative_groups.h>
#include <cstdint>
#include <cstring>
#include <cuda_runtime.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 256;
constexpr int kMaxLayers = 16;
constexpr int kMaxCluster = 16;
constexpr int kSmemLimit = 232448;  // bytes a block may use on sm_90

// Offsets in floats.  Shared-memory offsets are from the start of the
// dynamic shared memory; "global" offsets are inside the block's region of
// the workspace (gws + rank * gws_stride).  The wrapper builds the plan
// (kernel.py: train_plan) and passes it as ints in this order.
struct LayerPlan {
  int k, n;         // true widths, in and out
  int pk, pn;       // padded to 4
  int w, b;         // W (pk x pn) then b (pn), contiguous: b = w + pk * pn
  int wq;           // fake-quantized W: shared memory, or global (wq_global)
  int qs;           // the per-column fake-quant scales (pn)
  int act;          // the layer's output rows (rpad x act_stride); last: -1
  int act_stride;
  int part;         // partial dW/db (pk x pn, then pn): shared memory, or
  int part_global;  //   global when part_global is 1
  int recv;         // bulk: the owner's receive buffer, one slot a block
  int slot;         //   of `slot` floats (the largest owned range)
  int pw, pb;       // packed offsets of W and b (params and moments)
};
constexpr int kLayerInts = sizeof(LayerPlan) / sizeof(int);

struct Plan {
  int n_layers, cluster, tile, rpad, mt, smem_floats, gws_stride, wq_global;
  int bulk;         // the exchange by bulk copies (else read in place)
  int recv_loss;    // bulk: rank 0 receives the blocks' loss terms here
  int x[2], sx, y[2], sy, dz[2], sd, sq, misc;
  LayerPlan layer[kMaxLayers];
};
constexpr int kHeaderInts = (sizeof(Plan) - sizeof(LayerPlan) * kMaxLayers) /
                            sizeof(int);
// The kernel copies the plan to the start of its shared memory (the
// wrapper's layout leaves these floats free): read there, its fields are
// shared-memory loads at any index.  The two mbarriers of the bulk
// exchange sit at the end of the region.
constexpr int kPlanFloats = 288;
constexpr int kBarFloat = 280;  // two 8-byte mbarriers: partials, weights
static_assert(sizeof(Plan) <= kBarFloat * sizeof(float), "plan region");

struct AdamRule {
  float b1, b2, one_minus_b1, one_minus_b2, eps, weight_decay;
};

// One Adam update of p; the moments m, v updated in place.
__device__ __forceinline__ float adam_update(float p, float* m, float* v,
                                             float g, float lr,
                                             const AdamRule& a, float c1,
                                             float c2) {
  const float mn = __fadd_rn(__fmul_rn(a.b1, *m), __fmul_rn(a.one_minus_b1, g));
  const float vn = __fadd_rn(__fmul_rn(a.b2, *v),
                             __fmul_rn(a.one_minus_b2, __fmul_rn(g, g)));
  // A zero moment (every parameter whose gradient has been 0 so far) is its
  // own quotient and root, sign included; taken directly, it skips the
  // slow paths that __fdiv_rn and __fsqrt_rn branch to for a zero operand.
  const float mhat = mn == 0.0f ? mn : __fdiv_rn(mn, c1);
  const float vhat = vn == 0.0f ? vn : __fdiv_rn(vn, c2);
  const float root = vhat == 0.0f ? vhat : __fsqrt_rn(vhat);
  const float ratio =
      mhat == 0.0f ? mhat : __fdiv_rn(mhat, __fadd_rn(root, a.eps));
  const float step = __fmul_rn(
      lr, __fadd_rn(ratio, __fmul_rn(a.weight_decay, p)));
  *m = mn;
  *v = vn;
  return __fsub_rn(p, step);
}

__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

__device__ __forceinline__ void st4(float* p, float4 v) {
  *reinterpret_cast<float4*>(p) = v;
}

__device__ __forceinline__ float lane_of(const float4& v, int j) {
  return j == 0 ? v.x : j == 1 ? v.y : j == 2 ? v.z : v.w;
}

// a / b for 0 <= a < 2^20 and 0 < b <= 4096, without the integer division
// sequence: a float quotient from b's reciprocal, corrected by one step.
struct Divisor {
  int b;
  float inv;
  __device__ __forceinline__ explicit Divisor(int d)
      : b(d), inv(1.0f / static_cast<float>(d)) {}
  __device__ __forceinline__ int div(int a) const {
    int q = __float2int_rz((static_cast<float>(a) + 0.5f) * inv);
    const int r = a - q * b;
    if (r < 0) --q;
    else if (r >= b) ++q;
    return q;
  }
};

__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s), "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// --- the bulk exchange: mbarriers and shared::cluster bulk copies ---------
__device__ __forceinline__ unsigned cta_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// The address of this CTA's shared-memory location `a` in block `rank`.
__device__ __forceinline__ unsigned cluster_addr(unsigned a, int rank) {
  unsigned r;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n"
               : "=r"(r) : "r"(a), "r"(rank));
  return r;
}

__device__ __forceinline__ void mbar_init(unsigned bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(bar)
               : "memory");
}

// The one arrival of a phase, with the bytes the phase still expects.
__device__ __forceinline__ void mbar_expect(unsigned bar, unsigned bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               ::"r"(bar), "r"(bytes) : "memory");
}

__device__ __forceinline__ void mbar_wait(unsigned bar, unsigned parity) {
  asm volatile(
      "{\n .reg .pred done;\n"
      "WAIT_%=:\n"
      " mbarrier.try_wait.parity.shared::cta.b64 done, [%0], %1;\n"
      " @!done bra WAIT_%=;\n}\n" ::"r"(bar), "r"(parity) : "memory");
}

// Generic-proxy writes to shared memory made visible to bulk copies.
__device__ __forceinline__ void fence_to_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// bytes (a multiple of 16) from this block's shared memory at src to
// another block's at dst (a shared::cluster address), completing on that
// block's mbarrier bar (shared::cluster).
__device__ __forceinline__ void bulk_copy(unsigned dst, const void* src,
                                          unsigned bytes, unsigned bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.shared::cta.mbarrier::complete_tx::bytes"
      " [%0], [%1], %2, [%3];\n" ::"r"(dst), "r"(cta_addr(src)), "r"(bytes),
      "r"(bar) : "memory");
}

// The mask of the g consecutive lanes (g a power of two) holding this one.
__device__ __forceinline__ unsigned group_mask(int g) {
  const int lane = threadIdx.x & 31;
  return g == 32 ? 0xffffffffu : ((1u << g) - 1u) << (lane & ~(g - 1));
}

// Work of a phase: `items` register tiles, each a sum over `chunks` 4-wide
// chunks split over g lanes, g the largest power of two (<= 32) that keeps
// every (item, lane) pair within one pass of the block and gives each lane
// at least one chunk.  A warp takes 32 / g items at a time, lane
// gi = lane % (32 / g) the item and sub = lane / (32 / g) its chunks sub,
// sub + g, ...; so the lanes of one 8-lane phase of a 16-byte load hold
// different items.  The loop is warp-uniform (a lane past the last item
// works on a copy and stores nothing), so the xor tree over sub runs on
// full warps: every lane of an item ends with the same bits.
struct Split {
  int g, per_warp, gi, sub, base0, step;
  __device__ __forceinline__ Split(int items, int chunks) {
    int lg = 0;
    while (lg < 5 && items << (lg + 1) <= kThreads && 2 << lg <= chunks) ++lg;
    g = 1 << lg;
    per_warp = 32 >> lg;
    const int lane = threadIdx.x & 31;
    gi = lane & (per_warp - 1);
    sub = lane >> (5 - lg);
    base0 = (threadIdx.x >> 5) * per_warp;
    step = kThreads >> lg;
  }
};

template <int MT>
__device__ __forceinline__ void group_sum(float (&acc)[MT][4], int per_warp) {
  for (int off = 16; off >= per_warp; off >>= 1)
#pragma unroll
    for (int m = 0; m < MT; ++m)
#pragma unroll
      for (int j = 0; j < 4; ++j)
        acc[m][j] = __fadd_rn(acc[m][j],
                              __shfl_xor_sync(0xffffffffu, acc[m][j], off));
}

// Forward of one layer on the block's rows: z = h . W + b (h rpad x pk,
// stride sh; W pk x pn), ReLU into out (stride so) for a hidden layer; for
// the last layer the loss terms instead: dz = 2 (z - y) / denom and
// sq = (z - y)^2 on the n_out true columns, 0 on the pads.  A tile: MT
// rows nrg apart (rows 4 banks apart) by 4 columns; items run columns
// first.
template <int MT>
__device__ __forceinline__ void dense_forward(
    const float* h, int sh, const float* w, const float* bias, int pk, int pn,
    int rpad, float* out, int so, bool last, const float* yb, int sy,
    float* dz, int sd, float* sq, int n_out, float denom) {
  const int ng = pn / 4, chunks = pk / 4, nrg = rpad / MT;
  const int items = nrg * ng;
  const Split sp(items, chunks);
  const Divisor by_ng(ng);
  for (int base = sp.base0; base < items; base += sp.step) {
    const int item = base + sp.gi < items ? base + sp.gi : base;
    const bool store = base + sp.gi < items && sp.sub == 0;
    const int rg = by_ng.div(item), n0 = (item - rg * ng) * 4;
    float acc[MT][4];
#pragma unroll
    for (int m = 0; m < MT; ++m)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[m][j] = 0.0f;
    for (int c = sp.sub; c < chunks; c += sp.g) {
      const int k0 = c * 4;
      float4 a[MT];
#pragma unroll
      for (int m = 0; m < MT; ++m) a[m] = ld4(h + (rg + m * nrg) * sh + k0);
      const float4 b0 = ld4(w + (k0 + 0) * pn + n0);
      const float4 b1 = ld4(w + (k0 + 1) * pn + n0);
      const float4 b2 = ld4(w + (k0 + 2) * pn + n0);
      const float4 b3 = ld4(w + (k0 + 3) * pn + n0);
#pragma unroll
      for (int m = 0; m < MT; ++m) {
        acc[m][0] = fmaf(a[m].x, b0.x, acc[m][0]);
        acc[m][1] = fmaf(a[m].x, b0.y, acc[m][1]);
        acc[m][2] = fmaf(a[m].x, b0.z, acc[m][2]);
        acc[m][3] = fmaf(a[m].x, b0.w, acc[m][3]);
        acc[m][0] = fmaf(a[m].y, b1.x, acc[m][0]);
        acc[m][1] = fmaf(a[m].y, b1.y, acc[m][1]);
        acc[m][2] = fmaf(a[m].y, b1.z, acc[m][2]);
        acc[m][3] = fmaf(a[m].y, b1.w, acc[m][3]);
        acc[m][0] = fmaf(a[m].z, b2.x, acc[m][0]);
        acc[m][1] = fmaf(a[m].z, b2.y, acc[m][1]);
        acc[m][2] = fmaf(a[m].z, b2.z, acc[m][2]);
        acc[m][3] = fmaf(a[m].z, b2.w, acc[m][3]);
        acc[m][0] = fmaf(a[m].w, b3.x, acc[m][0]);
        acc[m][1] = fmaf(a[m].w, b3.y, acc[m][1]);
        acc[m][2] = fmaf(a[m].w, b3.z, acc[m][2]);
        acc[m][3] = fmaf(a[m].w, b3.w, acc[m][3]);
      }
    }
    group_sum<MT>(acc, sp.per_warp);
    if (!store) continue;
    const float4 bv = ld4(bias + n0);
#pragma unroll
    for (int m = 0; m < MT; ++m) {
      const int r = rg + m * nrg;
      float z[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) z[j] = __fadd_rn(acc[m][j], lane_of(bv, j));
      if (!last) {
        st4(out + r * so + n0, make_float4(fmaxf(z[0], 0.0f), fmaxf(z[1], 0.0f),
                                           fmaxf(z[2], 0.0f), fmaxf(z[3], 0.0f)));
      } else {
        float d[4], q[4];
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          d[j] = 0.0f;
          q[j] = 0.0f;
          if (n0 + j < n_out) {
            const float diff = __fsub_rn(z[j], yb[r * sy + n0 + j]);
            d[j] = __fdiv_rn(__fmul_rn(2.0f, diff), denom);
            q[j] = __fmul_rn(diff, diff);
          }
        }
        st4(dz + r * sd + n0, make_float4(d[0], d[1], d[2], d[3]));
        st4(sq + r * sy + n0, make_float4(q[0], q[1], q[2], q[3]));
      }
    }
  }
}

// dh = dz . W^T on the block's rows (dz rpad x pn, stride sd; W pk x pn),
// masked by the ReLU of the layer's input (hprev, stride sh), into dh
// (stride sd).  A tile: MT rows nrg apart by 4 k's; items run rows first,
// so the lanes of a load phase read dz rows 4 banks apart and one W row.
template <int MT>
__device__ __forceinline__ void dense_delta(const float* dz, int sd,
                                            const float* w, int pk, int pn,
                                            int rpad, const float* hprev,
                                            int sh, float* dh) {
  const int kg = pk / 4, chunks = pn / 4, nrg = rpad / MT;
  const int items = nrg * kg;
  const Split sp(items, chunks);
  const Divisor by_nrg(nrg);
  for (int base = sp.base0; base < items; base += sp.step) {
    const int item = base + sp.gi < items ? base + sp.gi : base;
    const bool store = base + sp.gi < items && sp.sub == 0;
    const int kq = by_nrg.div(item), rg = item - kq * nrg, k0 = kq * 4;
    float acc[MT][4];
#pragma unroll
    for (int m = 0; m < MT; ++m)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[m][j] = 0.0f;
    for (int c = sp.sub; c < chunks; c += sp.g) {
      const int n0 = c * 4;
      float4 a[MT];
#pragma unroll
      for (int m = 0; m < MT; ++m) a[m] = ld4(dz + (rg + m * nrg) * sd + n0);
      float4 b[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) b[j] = ld4(w + (k0 + j) * pn + n0);
#pragma unroll
      for (int m = 0; m < MT; ++m)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          acc[m][j] = fmaf(a[m].x, b[j].x, acc[m][j]);
          acc[m][j] = fmaf(a[m].y, b[j].y, acc[m][j]);
          acc[m][j] = fmaf(a[m].z, b[j].z, acc[m][j]);
          acc[m][j] = fmaf(a[m].w, b[j].w, acc[m][j]);
        }
    }
    group_sum<MT>(acc, sp.per_warp);
    if (!store) continue;
#pragma unroll
    for (int m = 0; m < MT; ++m) {
      const int r = rg + m * nrg;
      const float4 hv = ld4(hprev + r * sh + k0);
      float o[4];
#pragma unroll
      for (int j = 0; j < 4; ++j)
        o[j] = __fmul_rn(acc[m][j], lane_of(hv, j) > 0.0f ? 1.0f : 0.0f);
      st4(dh + r * sd + k0, make_float4(o[0], o[1], o[2], o[3]));
    }
  }
}

// The block's partial dW = h^T . dz and db = sum of dz over its own rows
// (h stride sh, dz stride sd) into part (pk x pn, then pn); global partials
// are stored past L1 (another SM reads them).  An item is a 4 x 4 tile of
// dW or 4 entries of db; its sum over the rows is split over lanes (rows
// sub, sub + g, ...) and joined by the xor tree.
template <bool kGlobal>
__device__ __forceinline__ void partial_grads(const float* h, int sh,
                                              const float* dz, int sd,
                                              int pk, int pn, int rows,
                                              float* part) {
  const int ng = pn / 4;
  const int items_w = (pk / 4) * ng, items = items_w + ng;
  const Split sp(items, rows);
  const Divisor by_ng(ng);
  for (int base = sp.base0; base < items; base += sp.step) {
    const int item = base + sp.gi < items ? base + sp.gi : base;
    const bool store = base + sp.gi < items && sp.sub == 0;
    float acc[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = 0.0f;
    const bool is_w = item < items_w;
    const int kq = is_w ? by_ng.div(item) : 0;
    const int k0 = kq * 4, n0 = is_w ? (item - kq * ng) * 4
                                     : (item - items_w) * 4;
    if (is_w) {
      for (int r = sp.sub; r < rows; r += sp.g) {
        const float4 a = ld4(h + r * sh + k0);
        const float4 b = ld4(dz + r * sd + n0);
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j)
            acc[i][j] = fmaf(lane_of(a, i), lane_of(b, j), acc[i][j]);
      }
    } else {
      for (int r = sp.sub; r < rows; r += sp.g) {
        const float4 b = ld4(dz + r * sd + n0);
#pragma unroll
        for (int j = 0; j < 4; ++j)
          acc[0][j] = __fadd_rn(acc[0][j], lane_of(b, j));
      }
    }
    group_sum<4>(acc, sp.per_warp);
    if (!store) continue;
    float* dst = is_w ? part + k0 * pn + n0 : part + pk * pn + n0;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      if (i > 0 && !is_w) break;
      const float4 v = make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]);
      float4* d = reinterpret_cast<float4*>(dst + i * pn);
      if constexpr (kGlobal)
        __stcg(d, v);
      else
        *d = v;
    }
  }
}

// Chunk q (entries 4q..4q+3) of a layer's padded W/b buffer: where its
// entries sit in the packed layout (at + j), and how many of them, from the
// first, are true parameters (the rest are pads).
__device__ __forceinline__ int packed_chunk(const LayerPlan& L, int q,
                                            int* at) {
  const int e = 4 * q, wsize = L.pk * L.pn;
  if (e < wsize) {
    const int k = Divisor(L.pn).div(e), n0 = e - k * L.pn;
    *at = L.pw + k * L.n + n0;
    return k < L.k ? min(4, max(0, L.n - n0)) : 0;
  }
  const int n0 = e - wsize;
  *at = L.pb + n0;
  return min(4, max(0, L.n - n0));
}

// The 4-entry chunks of a layer's padded W/b buffer (count of them) that
// block `rank` owns: one contiguous range a block, as even as possible, the
// same every tile.  (C is a power of two.)
__device__ __forceinline__ int range_lo(int count, int rank, int n_blocks) {
  return count * rank / n_blocks;
}

__device__ __forceinline__ int layer_chunks(const LayerPlan& L) {
  return (L.pk * L.pn + L.pn) / 4;
}

// f(L, q, lo) for every chunk q this thread owns, lo the first chunk of
// its block's range in the layer of plan L: the block's ranges of all the
// layers are numbered one after the other and thread tid takes numbers tid,
// tid + kThreads, ..., so no thread walks every layer.
template <typename F>
__device__ __forceinline__ void for_owned_chunks(const Plan& P, int rank,
                                                 int n_blocks, F&& f) {
  int l = 0, first = 0;
  LayerPlan L = P.layer[0];
  int lo = range_lo(layer_chunks(L), rank, n_blocks);
  int size = range_lo(layer_chunks(L), rank + 1, n_blocks) - lo;
  for (int i = threadIdx.x;; i += kThreads) {
    while (i >= first + size) {
      first += size;
      if (++l == P.n_layers) return;
      L = P.layer[l];
      const int count = layer_chunks(L);
      lo = range_lo(count, rank, n_blocks);
      size = range_lo(count, rank + 1, n_blocks) - lo;
    }
    f(L, lo + i - first, lo);
  }
}

// The owner's update of one chunk q of layer L: the C partials (all loaded
// first, then summed in block order), the rule applied.  With the bulk
// exchange the other blocks' partials are in this block's receive buffer
// and the new values go to its own replica only (the all-gather sends
// them); else they are read where they lie (another block's shared memory
// or its global region) and stored into every replica.  An owner has the
// same chunks every tile, so Adam's moments need no other synchronisation.
// SGD leaves a pad as it is (its gradient is 0).
template <int C, bool kBulk>
__device__ __forceinline__ void owner_update(
    cg::cluster_group& cluster, const LayerPlan& L, int q, int lo,
    float* smem, const float* gws, int gws_stride, int rank, float lr,
    float* mu, float* nu, const AdamRule& adam, float c1, float c2) {
  float* wl = smem + L.w;
  float4 v[C];
  if (C == 1) {
    v[0] = L.part_global ? __ldcg(reinterpret_cast<const float4*>(
                                      gws + L.part) + q)
                         : ld4(smem + L.part + 4 * q);
  } else if (kBulk) {
#pragma unroll
    for (int r = 0; r < C; ++r)
      v[r] = r == rank ? ld4(smem + L.part + 4 * q)
                       : ld4(smem + L.recv + r * L.slot + 4 * (q - lo));
  } else if (L.part_global) {
#pragma unroll
    for (int r = 0; r < C; ++r)
      v[r] = __ldcg(reinterpret_cast<const float4*>(
                        gws + static_cast<size_t>(r) * gws_stride + L.part) +
                    q);
  } else {
#pragma unroll
    for (int r = 0; r < C; ++r)
      v[r] = reinterpret_cast<const float4*>(
          cluster.map_shared_rank(smem + L.part, r))[q];
  }
  const float4 pv = ld4(wl + 4 * q);
  float g[4] = {0.0f, 0.0f, 0.0f, 0.0f};
#pragma unroll
  for (int r = 0; r < C; ++r)
#pragma unroll
    for (int j = 0; j < 4; ++j) g[j] = __fadd_rn(g[j], lane_of(v[r], j));
  float p[4] = {pv.x, pv.y, pv.z, pv.w};
  if (mu == nullptr) {
#pragma unroll
    for (int j = 0; j < 4; ++j) p[j] = __fsub_rn(p[j], __fmul_rn(lr, g[j]));
  } else {
    int at;
    const int real = packed_chunk(L, q, &at);
#pragma unroll
    for (int j = 0; j < 4; ++j)
      if (j < real)
        p[j] = adam_update(p[j], mu + at + j, nu + at + j, g[j], lr, adam, c1,
                           c2);
  }
  const float4 nv = make_float4(p[0], p[1], p[2], p[3]);
  if (C == 1 || kBulk) {
    st4(wl + 4 * q, nv);
  } else {
#pragma unroll
    for (int r = 0; r < C; ++r)
      reinterpret_cast<float4*>(cluster.map_shared_rank(wl, r))[q] = nv;
  }
}

template <int C>
__device__ __forceinline__ void owner_pass(cg::cluster_group& cluster,
                                           const Plan& P, float* smem,
                                           const float* gws, int rank,
                                           float lr, float* mu, float* nu,
                                           const AdamRule& adam, float c1,
                                           float c2) {
  const int gws_stride = P.gws_stride;
  if (P.bulk)
    for_owned_chunks(P, rank, C, [&](const LayerPlan& L, int q, int lo) {
      owner_update<C, true>(cluster, L, q, lo, smem, gws, gws_stride, rank,
                            lr, mu, nu, adam, c1, c2);
    });
  else
    for_owned_chunks(P, rank, C, [&](const LayerPlan& L, int q, int lo) {
      owner_update<C, false>(cluster, L, q, lo, smem, gws, gws_stride, rank,
                             lr, mu, nu, adam, c1, c2);
    });
}

// The bulk reduce-scatter: this block's partial of every layer, each
// owner's range to that owner's receive buffer (slot `rank`), and its loss
// term to block 0; one copy a thread.  After a block barrier.
__device__ __forceinline__ void send_partials(const Plan& P, float* smem,
                                              int rank, int n_blocks,
                                              unsigned pbar) {
  fence_to_async();
  const int per_layer = n_blocks - 1;
  for (int i = threadIdx.x; i <= P.n_layers * per_layer; i += kThreads) {
    if (i == P.n_layers * per_layer) {
      if (rank != 0)
        bulk_copy(cluster_addr(cta_addr(smem + P.recv_loss + 4 * rank), 0),
                  smem + P.misc, 16, cluster_addr(pbar, 0));
      continue;
    }
    const LayerPlan L = P.layer[i / per_layer];
    const int j = i % per_layer, to = j < rank ? j : j + 1;
    const int count = layer_chunks(L);
    const int lo = range_lo(count, to, n_blocks);
    const int hi = range_lo(count, to + 1, n_blocks);
    if (hi > lo)
      bulk_copy(cluster_addr(cta_addr(smem + L.recv + rank * L.slot), to),
                smem + L.part + 4 * lo, 16 * (hi - lo), cluster_addr(pbar, to));
  }
}

// The bulk all-gather: this block's owned range of every layer's W/b to
// every other replica; one copy a thread.  After a block barrier.
__device__ __forceinline__ void send_weights(const Plan& P, float* smem,
                                             int rank, int n_blocks,
                                             unsigned wbar) {
  fence_to_async();
  const int per_layer = n_blocks - 1;
  for (int i = threadIdx.x; i < P.n_layers * per_layer; i += kThreads) {
    const LayerPlan L = P.layer[i / per_layer];
    const int j = i % per_layer, to = j < rank ? j : j + 1;
    const int count = layer_chunks(L);
    const int lo = range_lo(count, rank, n_blocks);
    const int hi = range_lo(count, rank + 1, n_blocks);
    if (hi > lo)
      bulk_copy(cluster_addr(cta_addr(smem + L.w + 4 * lo), to),
                smem + L.w + 4 * lo, 16 * (hi - lo), cluster_addr(wbar, to));
  }
}

// One barrier for the whole cluster (a block barrier when it is one block).
__device__ __forceinline__ void cluster_barrier(cg::cluster_group& cluster,
                                                int n_blocks) {
  if (n_blocks == 1)
    __syncthreads();
  else
    cluster.sync();
}

template <int MT>
__device__ __forceinline__ void forward_layer(const Plan& P, int l,
                                              float* smem, const float* gwq,
                                              bool qat, const float* h,
                                              int sh, const float* yb,
                                              float* dz, float denom) {
  const LayerPlan L = P.layer[l];
  const bool last = l == P.n_layers - 1;
  float* out = last ? nullptr : smem + L.act;
  const int so = last ? 0 : L.act_stride;
  const int n_out = P.layer[P.n_layers - 1].n;
  if (qat && P.wq_global)
    dense_forward<MT>(h, sh, gwq + L.wq, smem + L.b, L.pk, L.pn, P.rpad, out,
                      so, last, yb, P.sy, dz, P.sd, smem + P.sq, n_out, denom);
  else
    dense_forward<MT>(h, sh, smem + (qat ? L.wq : L.w), smem + L.b, L.pk, L.pn,
                      P.rpad, out, so, last, yb, P.sy, dz, P.sd, smem + P.sq,
                      n_out, denom);
}

template <int MT>
__device__ __forceinline__ void delta_layer(const Plan& P, int l, float* smem,
                                            const float* gwq, bool qat,
                                            const float* dz, const float* hprev,
                                            int sh, float* dh) {
  const LayerPlan L = P.layer[l];
  if (qat && P.wq_global)
    dense_delta<MT>(dz, P.sd, gwq + L.wq, L.pk, L.pn, P.rpad, hprev, sh, dh);
  else
    dense_delta<MT>(dz, P.sd, smem + (qat ? L.wq : L.w), L.pk, L.pn, P.rpad,
                    hprev, sh, dh);
}

// The block's rows of tile t into the x/y buffers t & 1, by cp.async.
__device__ __forceinline__ void stage_rows(const Plan& P, int t,
                                           const float* x, const float* y,
                                           float* smem, int rows, int row0,
                                           int d_in, int d_out) {
  float* xb = smem + P.x[t & 1];
  float* yb = smem + P.y[t & 1];
  const size_t r_at = static_cast<size_t>(t) * P.tile + row0;
  const Divisor by_in(d_in), by_out(d_out);
  for (int i = threadIdx.x; i < rows * d_in; i += kThreads) {
    const int r = by_in.div(i);
    cp_async4(xb + r * P.sx + i - r * d_in, x + r_at * d_in + i);
  }
  for (int i = threadIdx.x; i < rows * d_out; i += kThreads) {
    const int r = by_out.div(i);
    cp_async4(yb + r * P.sy + i - r * d_out, y + r_at * d_out + i);
  }
  cp_async_commit();
}

// The per-column int8 fake-quant of the replica into wq: the scales from
// this block's replica (a max is exact in any order), the quantized values
// for the chunks q = rank (mod n_blocks) of each layer, stored into every
// replica's wq (when wq is in the block's global region, this block does
// every chunk of its own).  A barrier of the caller follows.
__device__ __forceinline__ void fake_quantize(cg::cluster_group& cluster,
                                              const Plan& P, float* smem,
                                              float* gblock, int rank,
                                              int n_blocks) {
  const int sub = threadIdx.x & 7;
  const unsigned mask = group_mask(8);
  for (int l = 0; l < P.n_layers; ++l) {
    const LayerPlan L = P.layer[l];
    const float* w = smem + L.w;
    for (int n = threadIdx.x / 8; n < L.n; n += kThreads / 8) {
      float m = 0.0f;
      for (int k = sub; k < L.k; k += 8) m = fmaxf(m, fabsf(w[k * L.pn + n]));
      for (int off = 4; off > 0; off >>= 1)
        m = fmaxf(m, __shfl_xor_sync(mask, m, off));
      if (sub == 0) smem[L.qs + n] = __fadd_rn(__fdiv_rn(m, 127.0f), 1e-12f);
    }
  }
  __syncthreads();
  const bool local = P.wq_global != 0;
  const int first = local ? 0 : rank, step = local ? 1 : n_blocks;
  for (int l = 0; l < P.n_layers; ++l) {
    const LayerPlan L = P.layer[l];
    const float* w = smem + L.w;
    float* wq = local ? gblock + L.wq : smem + L.wq;
    const int chunks = L.pk * L.pn / 4;
    const Divisor by_pn(L.pn);
    for (int q = first + step * threadIdx.x; q < chunks; q += step * kThreads) {
      const int k = by_pn.div(4 * q), n0 = 4 * q - k * L.pn;
      const float4 wv = ld4(w + 4 * q);
      float o[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        o[j] = 0.0f;
        if (k < L.k && n0 + j < L.n) {
          const float s = smem[L.qs + n0 + j];
          const float r = rintf(__fdiv_rn(lane_of(wv, j), s));
          o[j] = __fmul_rn(fminf(fmaxf(r, -127.0f), 127.0f), s);
        }
      }
      const float4 ov = make_float4(o[0], o[1], o[2], o[3]);
      st4(wq + 4 * q, ov);
      if (!local)
        for (int r = 0; r < n_blocks; ++r)
          if (r != rank)
            reinterpret_cast<float4*>(cluster.map_shared_rank(wq, r))[q] = ov;
    }
  }
}

// x (n_tiles * tile, d_in), y (n_tiles * tile, d_out); p_in/p_out the packed
// net; mu/nu the packed moments (null for SGD: then mu_in, nu_in and step0
// are unused); losses (n_tiles,); gws the global workspace, gws_stride
// floats a block (the plan's wq when wq_global, and the partials of layers
// with part_global).
//
// A tile: [QAT: fake-quant, cluster barrier]; the forward, one block
// barrier a layer; the backward from the last layer down, dh (through the
// weights before any update) and the block's partial dW/db of a layer in
// one phase, one block barrier a layer, every layer's partials kept; the
// partials to their owners (bulk: copies and the partial mbarrier; else a
// cluster barrier); the owners update every layer; the new weights to every
// replica (bulk: copies and the weight mbarrier; else a cluster barrier).
// The mbarriers' phase t of tile t is armed by thread 0 at the tile's start
// with the bytes it brings; a phase cannot receive bytes of the next tile
// before it completes, since every block sends those only after it has
// received this tile's weights (or partials) from every other.
__global__ void __launch_bounds__(kThreads)
fused_train_kernel(const float* __restrict__ x, const float* __restrict__ y,
                   int n_tiles, const __grid_constant__ Plan plan,
                   const float* __restrict__ p_in,
                   float* __restrict__ p_out, const float* __restrict__ mu_in,
                   const float* __restrict__ nu_in, float* mu, float* nu,
                   const int* __restrict__ step0, float* __restrict__ losses,
                   float* gws, float lr, AdamRule adam, int qat) {
  extern __shared__ __align__(16) float smem[];
  cg::cluster_group cluster = cg::this_cluster();
  const int tid = threadIdx.x;
  // zero everything (the pads stay zero) but the plan's region, copy the
  // plan there; read it from there on
  for (int i = kPlanFloats + tid; i < plan.smem_floats; i += kThreads)
    smem[i] = 0.0f;
  for (int i = tid; i < static_cast<int>(sizeof(Plan) / sizeof(int));
       i += kThreads)
    reinterpret_cast<int*>(smem)[i] = reinterpret_cast<const int*>(&plan)[i];
  __syncthreads();
  const Plan& P = *reinterpret_cast<const Plan*>(smem);
  const int rank = static_cast<int>(cluster.block_rank());
  const int n_blocks = P.cluster;
  const int n_layers = P.n_layers;
  const int d_in = P.layer[0].k;
  const int d_out = P.layer[n_layers - 1].n;
  const int base = P.tile / n_blocks, rem = P.tile % n_blocks;
  const int rows = base + (rank < rem ? 1 : 0);
  const int row0 = rank * base + (rank < rem ? rank : rem);
  float* gblock = gws == nullptr
                      ? nullptr
                      : gws + static_cast<size_t>(rank) * P.gws_stride;
  const float* gwq = gblock;

  if (qat && P.wq_global)
    for (int l = 0; l < n_layers; ++l) {
      const LayerPlan L = P.layer[l];
      for (int i = tid; i < L.pk * L.pn; i += kThreads) gblock[L.wq + i] = 0.0f;
    }
  // the net into the replica
  for (int l = 0; l < n_layers; ++l) {
    const LayerPlan L = P.layer[l];
    for (int i = tid; i < L.k * L.n; i += kThreads)
      smem[L.w + (i / L.n) * L.pn + i % L.n] = p_in[L.pw + i];
    for (int n = tid; n < L.n; n += kThreads) smem[L.b + n] = p_in[L.pb + n];
  }
  // the owner's moments to the outputs, once
  if (mu != nullptr)
    for_owned_chunks(P, rank, n_blocks, [&](const LayerPlan& L, int q, int) {
      int at;
      const int real = packed_chunk(L, q, &at);
      for (int j = 0; j < real; ++j) {
        mu[at + j] = mu_in[at + j];
        nu[at + j] = nu_in[at + j];
      }
    });
  const int s0 = mu != nullptr ? *step0 : 0;
  const float denom = static_cast<float>(P.tile * d_out);

  // the bulk exchange: the bytes each tile brings this block (the other
  // blocks' partials of its ranges and their loss terms; the new weights of
  // the other ranges), and its two mbarriers
  const unsigned pbar = cta_addr(smem + kBarFloat);
  const unsigned wbar = cta_addr(smem + kBarFloat + 2);
  unsigned pbytes = 0, wbytes = 0;
  for (int l = 0; l < n_layers; ++l) {
    const int count = layer_chunks(P.layer[l]);
    const int mine = range_lo(count, rank + 1, n_blocks) -
                     range_lo(count, rank, n_blocks);
    pbytes += 16u * (n_blocks - 1) * mine;
    wbytes += 16u * (count - mine);
  }
  if (rank == 0) pbytes += 16u * (n_blocks - 1);
  if (P.bulk && tid == 0) {
    mbar_init(pbar);
    mbar_init(wbar);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }

  if (n_tiles > 0) stage_rows(P, 0, x, y, smem, rows, row0, d_in, d_out);
  cp_async_wait_all();
  cluster.sync();  // every block started and initialised: DSMEM is live

  for (int t = 0; t < n_tiles; ++t) {
    if (t + 1 < n_tiles)
      stage_rows(P, t + 1, x, y, smem, rows, row0, d_in, d_out);
    const float* xb = smem + P.x[t & 1];
    const float* yb = smem + P.y[t & 1];
    const unsigned parity = t & 1;
    if (P.bulk && tid == 0) {  // this tile's phase of both mbarriers
      mbar_expect(pbar, pbytes);
      mbar_expect(wbar, wbytes);
    }

    // --- per-column int8 fake-quant of the replica ------------------------
    if (qat) {
      fake_quantize(cluster, P, smem, gblock, rank, n_blocks);
      if (P.wq_global)
        __syncthreads();
      else
        cluster_barrier(cluster, n_blocks);
    }

    // --- forward, the last layer's epilogue the loss terms ----------------
    float* cur = smem + P.dz[0];
    float* nxt = smem + P.dz[1];
    for (int l = 0; l < n_layers; ++l) {
      const float* h = l == 0 ? xb : smem + P.layer[l - 1].act;
      const int sh = l == 0 ? P.sx : P.layer[l - 1].act_stride;
      if (P.mt == 1)
        forward_layer<1>(P, l, smem, gwq, qat, h, sh, yb, cur, denom);
      else
        forward_layer<2>(P, l, smem, gwq, qat, h, sh, yb, cur, denom);
      __syncthreads();
    }

    // --- backward: dh and the block's partials, layer by layer ------------
    for (int l = n_layers - 1; l >= 0; --l) {
      const LayerPlan L = P.layer[l];
      const float* hprev = l == 0 ? xb : smem + P.layer[l - 1].act;
      const int sh = l == 0 ? P.sx : P.layer[l - 1].act_stride;
      if (l == n_layers - 1 && tid < 32) {
        // the block's share of the tile's loss: warp 0, fixed tree
        float acc = 0.0f;
        const Divisor by_out(d_out);
        for (int i = tid; i < rows * d_out; i += 32) {
          const int r = by_out.div(i);
          acc = __fadd_rn(acc, smem[P.sq + r * P.sy + i - r * d_out]);
        }
        for (int off = 16; off > 0; off >>= 1)
          acc = __fadd_rn(acc, __shfl_down_sync(0xffffffffu, acc, off));
        if (tid == 0) smem[P.misc] = acc;
      }
      if (l > 0) {
        // dh through W_l: no layer is updated before the whole backward
        if (P.mt == 1)
          delta_layer<1>(P, l, smem, gwq, qat, cur, hprev, sh, nxt);
        else
          delta_layer<2>(P, l, smem, gwq, qat, cur, hprev, sh, nxt);
      }
      if (L.part_global)
        partial_grads<true>(hprev, sh, cur, P.sd, L.pk, L.pn, rows,
                            gblock + L.part);
      else
        partial_grads<false>(hprev, sh, cur, P.sd, L.pk, L.pn, rows,
                             smem + L.part);
      if (l > 0) __syncthreads();
      float* tmp = cur;
      cur = nxt;
      nxt = tmp;
    }
    if (P.bulk) {  // every block's partials of this block's ranges are in
      __syncthreads();
      if (n_blocks > 1) send_partials(P, smem, rank, n_blocks, pbar);
      mbar_wait(pbar, parity);
    } else {
      cluster_barrier(cluster, n_blocks);
    }

    // --- the loss, and the owners' update of every layer ------------------
    if (rank == 0 && tid == 0) {
      float acc = 0.0f;
      for (int r = 0; r < n_blocks; ++r)
        acc = __fadd_rn(
            acc, r == 0 ? smem[P.misc]
                 : P.bulk ? smem[P.recv_loss + 4 * r]
                          : *cluster.map_shared_rank(smem + P.misc, r));
      losses[t] = __fdiv_rn(acc, denom);
    }
    float c1 = 1.0f, c2 = 1.0f;
    if (mu != nullptr) {
      const float step = static_cast<float>(s0 + t + 1);
      c1 = __fsub_rn(1.0f, powf(adam.b1, step));
      c2 = __fsub_rn(1.0f, powf(adam.b2, step));
    }
    switch (n_blocks) {
      case 1: owner_pass<1>(cluster, P, smem, gws, rank, lr, mu, nu, adam, c1,
                            c2); break;
      case 2: owner_pass<2>(cluster, P, smem, gws, rank, lr, mu, nu, adam, c1,
                            c2); break;
      case 4: owner_pass<4>(cluster, P, smem, gws, rank, lr, mu, nu, adam, c1,
                            c2); break;
      case 8: owner_pass<8>(cluster, P, smem, gws, rank, lr, mu, nu, adam, c1,
                            c2); break;
      default: owner_pass<16>(cluster, P, smem, gws, rank, lr, mu, nu, adam,
                              c1, c2);
    }
    cp_async_wait_all();
    if (P.bulk) {  // every replica updated, the next rows in
      __syncthreads();
      if (n_blocks > 1) {
        send_weights(P, smem, rank, n_blocks, wbar);
        mbar_wait(wbar, parity);
      }
      __syncthreads();
    } else {
      cluster_barrier(cluster, n_blocks);
    }
  }

  // the trained net back to device memory: each owner its own entries
  for_owned_chunks(P, rank, n_blocks, [&](const LayerPlan& L, int q, int) {
    int at;
    const int real = packed_chunk(L, q, &at);
    for (int j = 0; j < real; ++j) p_out[at + j] = smem[L.w + 4 * q + j];
  });
  // no block leaves while a bulk copy may still read its shared memory
  if (P.bulk && n_blocks > 1) cluster.sync();
}

}  // namespace

// plan: kHeaderInts + kLayerInts * n_layers ints in the order of struct Plan
// (kernel.py: train_plan).  n_rows must be a multiple of the plan's tile.
// mu_in/nu_in/mu_out/nu_out/step0: all null for SGD, all set for Adam.  gws:
// cluster * gws_stride floats (null when the stride is 0).  Returns the
// first CUDA error (0 on success; cudaErrorInvalidValue for a plan the
// kernel does not take, cudaErrorInvalidConfiguration for a cluster the
// card cannot place).
extern "C" int fused_train_launch(
    const void* x, const void* y, int n_rows, const int* plan, int plan_len,
    const void* p_in, void* p_out, const void* mu_in, const void* nu_in,
    void* mu_out, void* nu_out, const void* step0, void* losses, void* gws,
    float lr, float b1, float b2, float one_minus_b1, float one_minus_b2,
    float eps, float weight_decay, int qat, void* stream) {
  if (plan == nullptr || plan_len < kHeaderInts)
    return static_cast<int>(cudaErrorInvalidValue);
  const int n_layers = plan[0];
  if (n_layers < 1 || n_layers > kMaxLayers ||
      plan_len != kHeaderInts + kLayerInts * n_layers)
    return static_cast<int>(cudaErrorInvalidValue);
  Plan P{};
  std::memcpy(&P, plan, sizeof(int) * plan_len);
  if (P.cluster < 1 || P.cluster > kMaxCluster ||
      (P.cluster & (P.cluster - 1)) != 0 || P.tile < 1 ||
      P.rpad < 1 || (P.mt != 1 && P.mt != 2) || P.rpad % P.mt != 0 ||
      P.smem_floats < kPlanFloats ||
      static_cast<size_t>(P.smem_floats) * sizeof(float) > kSmemLimit ||
      n_rows < 0 || n_rows % P.tile != 0 || P.gws_stride < 0 ||
      (P.gws_stride > 0) != (gws != nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  for (int l = 0; l < n_layers; ++l) {
    const LayerPlan L = P.layer[l];
    if (L.k < 1 || L.n < 1 || L.pk < L.k || L.pn < L.n || L.pk % 4 ||
        L.pn % 4 || L.b != L.w + L.pk * L.pn ||
        (l > 0 && L.k != P.layer[l - 1].n))
      return static_cast<int>(cudaErrorInvalidValue);
  }
  const bool adam = mu_out != nullptr;
  if (adam != (nu_out != nullptr) || adam != (mu_in != nullptr) ||
      adam != (nu_in != nullptr) || adam != (step0 != nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  if (n_rows == 0) return 0;

  const size_t smem = static_cast<size_t>(P.smem_floats) * sizeof(float);
  // Above the default 48 KB a launch needs the attribute raised first, and a
  // cluster above 8 blocks the non-portable size allowed; each is set once
  // per process.  (One process, one card: not tracked per device.)
  static size_t granted = 48 * 1024;
  if (smem > granted) {
    const cudaError_t err = cudaFuncSetAttribute(
        fused_train_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
    granted = smem;
  }
  static bool non_portable = false;
  if (P.cluster > 8 && !non_portable) {
    const cudaError_t err = cudaFuncSetAttribute(
        fused_train_kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (err != cudaSuccess) return static_cast<int>(err);
    non_portable = true;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(P.cluster, 1, 1);
  cfg.blockDim = dim3(kThreads, 1, 1);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = static_cast<cudaStream_t>(stream);
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = P.cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  int placeable = 0;
  cudaError_t err =
      cudaOccupancyMaxActiveClusters(&placeable, fused_train_kernel, &cfg);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (placeable < 1) return static_cast<int>(cudaErrorInvalidConfiguration);
  const AdamRule rule{b1, b2, one_minus_b1, one_minus_b2, eps, weight_decay};
  err = cudaLaunchKernelEx(
      &cfg, fused_train_kernel, static_cast<const float*>(x),
      static_cast<const float*>(y), n_rows / P.tile, P,
      static_cast<const float*>(p_in), static_cast<float*>(p_out),
      static_cast<const float*>(mu_in), static_cast<const float*>(nu_in),
      static_cast<float*>(mu_out), static_cast<float*>(nu_out),
      static_cast<const int*>(step0), static_cast<float*>(losses),
      static_cast<float*>(gws), lr, rule, qat);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

// ===========================================================================
// The per-sample path: tile 1, SGD, no QAT (the paper's Eq. 3 stream).
//
// A second kernel, sharing no phase code with the cluster kernel above: the
// cluster kernel spreads a tile's rows over blocks and reduces dW/db across
// them; at one row a tile that machinery is pure overhead.  Here one block
// of kPsThreads threads trains the net one sample after the other, and
// what bounds it is the chain of 2L dependent phases inside a sample (each
// layer's forward, then each layer's backward), not arithmetic: mrf-fpga's
// 59,584 FLOP a sample are ~470 cycles of one SM's fp32 rate.  So the design
// takes latency out of each phase:
//
// - A schedule built once a launch (kernel.py: per_sample_schedule).  Each
//   layer's padded W is cut into 4 x 4 tiles, one a lane, over a few warps:
//   a warp holds a block of gk x gn tiles (lane = kl + gk * nl), kq = (warp
//   row) * gk + kl, nq = (warp column) * gn + nl.  A thread keeps its tile
//   of layer l in register slot l.  The layers are unrolled at compile time
//   (up to kPsMaxLayers), so every phase knows its slot, whether it reads x
//   and whether it has a dh: no dispatch, few branches a phase.  The table
//   (every phase's buffers, lane groups and barrier) sits in shared memory;
//   each thread's descriptors are loaded once, before the sample loop.
// - Weights stationary in registers: a thread's tiles and the biases it
//   owns (the kq == 0 tile of a column chunk owns its 4 biases) are loaded
//   from p_in once and stored to p_out at the end.  The one row's
//   activations and deltas pass between phases through shared memory.
// - Forward of layer l: each tile's 4 partial sums of z (the bias owner
//   starts from its bias), joined over the gk lanes of its column chunk by
//   a straight-line xor-shuffle tree; one partial row per warp row goes to
//   shared memory.  The next layer's threads load the (at most 4) rows at
//   once, add them in a fixed pairwise order, take the ReLU, and its nq ==
//   0 tiles keep h for the backward.
// - Backward of layer l, in this order: dz (the partial rows of dh of the
//   layer above, masked by h > 0; for the last layer 2 (z - y) / d_out on
//   the true columns, and the loss), dh = dz . W^T through the old W
//   (joined over the gn lanes of its row chunk, one partial row per warp
//   column), then the update of the thread's own W and b in registers,
//   which fills the join's latency.  This keeps ref.py's train_tile_plain
//   order: no W_l is read again in the sample.  There are no partial dW/db
//   buffers and no owner pass.
// - Barriers as narrow as the phases: the barrier after a phase takes the
//   warps of that phase and of the next; one warp syncs with __syncwarp,
//   any other set with bar.sync (all warps: id 0; else one id a phase).
//   The tail of mrf-fpga (32-16-16-16-2) sits in one warp.  One
//   __syncthreads ends each sample, after the x/y row of the next sample,
//   prefetched by cp.async one sample ahead, has landed.
//
// Invariants as above: float32, no tensor cores, no fast math, no atomics;
// every sum in a fixed order (a tile's 4-term FMA chains, the shuffle
// trees, the pairwise sum of partial rows), so a K-step launch equals K
// single-step launches bit for bit.  The update is the cluster kernel's at tile 1: g = h * dz (for
// b, g = dz), p = p - lr * g, each operation rounded, no contraction.  The
// forward and dh sums take another order than the cluster kernel's, so the
// two kernels' bits differ.
//
// The benchmark finds the training kernels' device time by the name
// fused_train_kernel, so this kernel's name begins with it.

namespace {

constexpr int kPsThreads = 256;
constexpr int kPsWarps = kPsThreads / 32;
constexpr int kPsMaxLayers = 7;  // = the register slots: a 4 x 4 tile each
constexpr int kPsMaxRows = 4;    // partial rows a sum reads
constexpr int kPsMaxGroup = 8;   // lanes a join spans, each way
// per-slot descriptor: kq (bits 0-5), nq (6-11), its forward partial row
// (12-14), its backward partial row (15-17), flags (18-23); an empty slot
// has none of the flags
constexpr int kPsValid = 1, kPsFwdWriter = 2, kPsBwdWriter = 4,
              kPsBiasOwner = 8, kPsActWriter = 16, kPsLossOwner = 32;

struct PsHeader {
  int n_layers, n_phases, smem_floats, x[2], y[2], d_in, d_out, out_chunks;
  int pad[6];
};
struct PsLayer {
  int k, n, pw, pb;  // true widths, packed offsets of W and b
  int pad[4];
};
// One phase: the forward of layer l (phases 0..L-1) or its backward
// (phases L..2L-1, from the last layer down).  Offsets are floats of the
// dynamic shared memory; -1 where a phase has no such buffer.
struct __align__(16) PsPhase {
  int warps;        // the warps that hold the layer's tiles
  // forward: the previous layer's partial rows of z (layer 0: the x row);
  // backward: the partial rows of dh of the layer above, or for the last
  // layer its own rows of z
  int in, in_rows, in_stride;
  int act;          // forward: where h of the input is kept; backward: h of
                    // the layer's output (the ReLU mask; -1: last layer)
  int hin;          // backward: h of the layer's input (layer 0: x)
  int out, out_stride;  // this phase's partial rows (-1: none)
  int gk, gn;       // lane groups: forward joins lanes ^ 1, 2, 4 below gk,
                    // backward lanes ^ gk, 2 gk, 4 gk below gk * gn
  // the barrier after the phase: its warps, id and threads (one warp:
  // __syncwarp; all: id 0)
  int bar_warps, bar_id, bar_count;
  int pad[3];
};
struct PsTable {
  PsHeader h;
  PsLayer layer[kPsMaxLayers];
  PsPhase phase[2 * kPsMaxLayers];
};
constexpr int kPsTableInts = sizeof(PsTable) / sizeof(int);
static_assert(kPsTableInts % 4 == 0, "table rows 16-byte aligned");

__device__ __forceinline__ float4 add4(float4 a, float4 b) {
  return make_float4(__fadd_rn(a.x, b.x), __fadd_rn(a.y, b.y),
                     __fadd_rn(a.z, b.z), __fadd_rn(a.w, b.w));
}

// The sum of `rows` (<= kPsMaxRows) partial rows, stride floats apart, at
// p: all loaded first (an absent row reads as 0), then added in one fixed
// order, (r0 + r1) + (r2 + r3).
__device__ __forceinline__ float4 sum_rows(const float* p, int rows,
                                           int stride) {
  float4 v[kPsMaxRows];
#pragma unroll
  for (int r = 0; r < kPsMaxRows; ++r)
    v[r] = r < rows ? ld4(p + r * stride) : make_float4(0.f, 0.f, 0.f, 0.f);
  return add4(add4(v[0], v[1]), add4(v[2], v[3]));
}
static_assert(kPsMaxRows == 4, "sum_rows adds four rows");

// acc summed over the lanes lane ^ (lo << i), i = 0, 1, 2, for each i with
// lo << i < hi: a lane group of up to kPsMaxGroup lanes.  Straight-line
// code, a level past the group shuffling with itself and adding nothing,
// so no branch sits between the shuffles and the update can fill their
// latency.  Every lane of a group ends with the same bits.
__device__ __forceinline__ void xor_join(float (&acc)[4], int lo, int hi) {
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    const int off = lo << i;
    const bool on = off < hi;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const float v = __shfl_xor_sync(0xffffffffu, acc[j], on ? off : 0);
      acc[j] = on ? __fadd_rn(acc[j], v) : acc[j];
    }
  }
}
static_assert(kPsMaxGroup == 8, "xor_join takes three levels");

// A thread's registers: its tile of each layer (slot l), the biases it
// owns, its descriptors.
struct PsRegs {
  float w[kPsMaxLayers][16];  // W[4 kq + i][4 nq + j] at 4 i + j
  float b[kPsMaxLayers][4];
  int d[kPsMaxLayers];
};

__device__ __forceinline__ int ps_kq(int d) { return d & 63; }
__device__ __forceinline__ int ps_nq(int d) { return (d >> 6) & 63; }
__device__ __forceinline__ int ps_frow(int d) { return (d >> 12) & 7; }
__device__ __forceinline__ int ps_brow(int d) { return (d >> 15) & 7; }
__device__ __forceinline__ int ps_flags(int d) { return (d >> 18) & 63; }

template <int L>
__device__ __forceinline__ void ps_forward(const PsPhase& ph, PsRegs& R,
                                           float* smem, const float* xb) {
  const int d = R.d[L], fl = ps_flags(d);
  const int kq = ps_kq(d), nq = ps_nq(d);
  float4 h;
  if (L == 0) {
    h = ld4(xb + 4 * kq);
  } else {
    h = sum_rows(smem + ph.in + 4 * kq, ph.in_rows, ph.in_stride);
    h = make_float4(fmaxf(h.x, 0.0f), fmaxf(h.y, 0.0f), fmaxf(h.z, 0.0f),
                    fmaxf(h.w, 0.0f));
    if (fl & kPsActWriter) st4(smem + ph.act + 4 * kq, h);
  }
  const bool own_b = (fl & kPsBiasOwner) != 0;
  float acc[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) acc[j] = own_b ? R.b[L][j] : 0.0f;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float hi = lane_of(h, i);
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[j] = fmaf(hi, R.w[L][4 * i + j], acc[j]);
  }
  xor_join(acc, 1, ph.gk);
  if (fl & kPsFwdWriter)
    st4(smem + ph.out + ps_frow(d) * ph.out_stride + 4 * nq,
        make_float4(acc[0], acc[1], acc[2], acc[3]));
}

// The last layer's dz = 2 (z - y) / d_out on the true columns (its z the
// rows at zr), and, by the loss owner, the sample's loss over its columns
// in order.
__device__ __forceinline__ void ps_output_delta(int d, const float* zr,
                                                int rows, int stride,
                                                const float* yb, int d_out,
                                                int out_chunks,
                                                float (&dz)[4],
                                                float* loss_out) {
  const float denom = static_cast<float>(d_out);
  const int n4 = 4 * ps_nq(d);
  const float4 z = sum_rows(zr + n4, rows, stride);
  const float4 yv = ld4(yb + n4);
  float diff[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    diff[j] = __fsub_rn(lane_of(z, j), lane_of(yv, j));
    dz[j] = n4 + j < d_out ? __fdiv_rn(__fmul_rn(2.0f, diff[j]), denom)
                           : 0.0f;
  }
  if (!(ps_flags(d) & kPsLossOwner)) return;
  // the loss owner holds chunk 0; the other chunks' columns are read again
  float acc = 0.0f;
#pragma unroll
  for (int j = 0; j < 4; ++j)
    if (j < d_out) acc = __fadd_rn(acc, __fmul_rn(diff[j], diff[j]));
  for (int c = 1; c < out_chunks; ++c) {
    const float4 zc = sum_rows(zr + 4 * c, rows, stride);
    const float4 yc = ld4(yb + 4 * c);
#pragma unroll
    for (int j = 0; j < 4; ++j)
      if (4 * c + j < d_out) {
        const float e = __fsub_rn(lane_of(zc, j), lane_of(yc, j));
        acc = __fadd_rn(acc, __fmul_rn(e, e));
      }
  }
  *loss_out = __fdiv_rn(acc, denom);
}

template <int L>
__device__ __forceinline__ void ps_backward(const PsPhase& ph, bool last,
                                            PsRegs& R, float* smem,
                                            const float* xb, const float* yb,
                                            float lr, int d_out,
                                            int out_chunks,
                                            float* loss_out) {
  const int d = R.d[L], fl = ps_flags(d);
  const int kq = ps_kq(d), nq = ps_nq(d);
  float dz[4];
  if (last) {  // its in rows are z
    ps_output_delta(d, smem + ph.in, ph.in_rows, ph.in_stride, yb, d_out,
                    out_chunks, dz, loss_out);
  } else {
    const float4 s = sum_rows(smem + ph.in + 4 * nq, ph.in_rows,
                              ph.in_stride);
    const float4 hv = ld4(smem + ph.act + 4 * nq);
#pragma unroll
    for (int j = 0; j < 4; ++j)
      dz[j] = __fmul_rn(lane_of(s, j), lane_of(hv, j) > 0.0f ? 1.0f : 0.0f);
  }
  const float4 h = ld4((L == 0 ? xb : smem + ph.hin) + 4 * kq);
  if (L > 0) {  // dh through the old W, joined over the gn lanes
    float acc[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      acc[i] = 0.0f;
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i] = fmaf(dz[j], R.w[L][4 * i + j], acc[i]);
    }
    xor_join(acc, ph.gk, ph.gk * ph.gn);
    if (fl & kPsBwdWriter)
      st4(smem + ph.out + ps_brow(d) * ph.out_stride + 4 * kq,
          make_float4(acc[0], acc[1], acc[2], acc[3]));
  }
  // the update, unconditional: a lane past the layer's tiles, or a bias it
  // does not own, steps by 0 * g
  const float lr_w = (fl & kPsValid) ? lr : 0.0f;
  const float lr_b = (fl & kPsBiasOwner) ? lr : 0.0f;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float hi = lane_of(h, i);
#pragma unroll
    for (int j = 0; j < 4; ++j)
      R.w[L][4 * i + j] = __fsub_rn(R.w[L][4 * i + j],
                                    __fmul_rn(lr_w, __fmul_rn(hi, dz[j])));
  }
#pragma unroll
  for (int j = 0; j < 4; ++j)
    R.b[L][j] = __fsub_rn(R.b[L][j], __fmul_rn(lr_b, dz[j]));
}

__device__ __forceinline__ void ps_barrier(const PsPhase& ph, int warp_bit) {
  if (!(ph.bar_warps & warp_bit)) return;
  if (ph.bar_count == 32)
    __syncwarp();
  else
    asm volatile("bar.sync %0, %1;\n" ::"r"(ph.bar_id), "r"(ph.bar_count)
                 : "memory");
}

// The x and y rows of sample t into their buffers t & 1, by cp.async.
__device__ __forceinline__ void ps_stage(const PsHeader& H, int t,
                                         const float* x, const float* y,
                                         float* smem) {
  const size_t at = static_cast<size_t>(t);
  for (int i = threadIdx.x; i < H.d_in; i += kPsThreads)
    cp_async4(smem + H.x[t & 1] + i, x + at * H.d_in + i);
  for (int i = threadIdx.x; i < H.d_out; i += kPsThreads)
    cp_async4(smem + H.y[t & 1] + i, y + at * H.d_out + i);
  cp_async_commit();
}

// x (n, d_in), y (n, d_out): one SGD update a row, in order.  slots: the
// schedule's kPsMaxLayers descriptors of each thread; losses (n,).
__global__ void __launch_bounds__(kPsThreads, 1)
fused_train_kernel_per_sample(const float* __restrict__ x,
                              const float* __restrict__ y, int n,
                              const __grid_constant__ PsTable table,
                              const int* __restrict__ slots,
                              const float* __restrict__ p_in,
                              float* __restrict__ p_out,
                              float* __restrict__ losses, float lr) {
  extern __shared__ __align__(16) float smem[];
  const int tid = threadIdx.x, warp_bit = 1 << (tid >> 5);
  // zero the buffers (pads stay zero), the table in front of them
  for (int i = kPsTableInts + tid; i < table.h.smem_floats; i += kPsThreads)
    smem[i] = 0.0f;
  for (int i = tid; i < kPsTableInts; i += kPsThreads)
    reinterpret_cast<int*>(smem)[i] = reinterpret_cast<const int*>(&table)[i];
  PsRegs R;
#pragma unroll
  for (int l = 0; l < kPsMaxLayers; ++l) {
    const int d = slots[tid * kPsMaxLayers + l], fl = ps_flags(d);
    R.d[l] = d;
    const bool valid = l < table.h.n_layers && (fl & kPsValid);
    const PsLayer L = valid ? table.layer[l] : PsLayer{};
    const int k0 = 4 * ps_kq(d), n0 = 4 * ps_nq(d);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j)
        R.w[l][4 * i + j] = valid && k0 + i < L.k && n0 + j < L.n
                                ? p_in[L.pw + (k0 + i) * L.n + n0 + j]
                                : 0.0f;
#pragma unroll
    for (int j = 0; j < 4; ++j)
      R.b[l][j] = valid && (fl & kPsBiasOwner) && n0 + j < L.n
                      ? p_in[L.pb + n0 + j]
                      : 0.0f;
  }
  __syncthreads();
  const PsTable& T = *reinterpret_cast<const PsTable*>(smem);
  const int n_layers = T.h.n_layers, n_phases = T.h.n_phases;
  const int d_out = T.h.d_out, out_chunks = T.h.out_chunks;
  if (n > 0) ps_stage(T.h, 0, x, y, smem);
  cp_async_wait_all();
  __syncthreads();

  for (int t = 0; t < n; ++t) {
    if (t + 1 < n) ps_stage(T.h, t + 1, x, y, smem);
    const float* xb = smem + T.h.x[t & 1];
    const float* yb = smem + T.h.y[t & 1];
    // each phase: its work, the next phase's row of the table (read before
    // the barrier), the barrier
    PsPhase ph = T.phase[0];
#define PS_FORWARD(L)                                                   \
    if (L < n_layers) {                                                 \
      const int p = L;                                                  \
      if (ph.warps & warp_bit) ps_forward<L>(ph, R, smem, xb);          \
      const PsPhase next = T.phase[p + 1];                              \
      ps_barrier(ph, warp_bit);                                         \
      ph = next;                                                        \
    }
#define PS_BACKWARD(L)                                                  \
    if (L < n_layers) {                                                 \
      const int p = n_phases - 1 - L;                                   \
      if (ph.warps & warp_bit)                                          \
        ps_backward<L>(ph, L == n_layers - 1, R, smem, xb, yb, lr,      \
                       d_out, out_chunks, losses + t);                  \
      const PsPhase next = T.phase[p + 1 < n_phases ? p + 1 : p];       \
      ps_barrier(ph, warp_bit);                                         \
      ph = next;                                                        \
    }
    PS_FORWARD(0) PS_FORWARD(1) PS_FORWARD(2) PS_FORWARD(3) PS_FORWARD(4)
    PS_FORWARD(5) PS_FORWARD(6)
    PS_BACKWARD(6) PS_BACKWARD(5) PS_BACKWARD(4) PS_BACKWARD(3)
    PS_BACKWARD(2) PS_BACKWARD(1) PS_BACKWARD(0)
#undef PS_FORWARD
#undef PS_BACKWARD
    cp_async_wait_all();  // the next sample's rows in, every phase done
    __syncthreads();
  }

  // the trained net back to device memory: each thread its own entries
#pragma unroll
  for (int l = 0; l < kPsMaxLayers; ++l) {
    const int d = R.d[l], fl = ps_flags(d);
    if (l >= n_layers || !(fl & kPsValid)) continue;
    const PsLayer L = T.layer[l];
    const int k0 = 4 * ps_kq(d), n0 = 4 * ps_nq(d);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j)
        if (k0 + i < L.k && n0 + j < L.n)
          p_out[L.pw + (k0 + i) * L.n + n0 + j] = R.w[l][4 * i + j];
    if (fl & kPsBiasOwner)
#pragma unroll
      for (int j = 0; j < 4; ++j)
        if (n0 + j < L.n) p_out[L.pb + n0 + j] = R.b[l][j];
  }
}
static_assert(kPsMaxLayers == 7, "the sample loop names every layer");

}  // namespace

// table: kPsTableInts ints in the order of struct PsTable (kernel.py:
// per_sample_schedule); slots: kPsThreads * kPsMaxLayers descriptors on the
// device.  n_rows samples, one update each.  Returns the first CUDA error
// (cudaErrorInvalidValue for a table the kernel does not take).
extern "C" int fused_train_per_sample_launch(
    const void* x, const void* y, int n_rows, const int* table, int table_len,
    const void* slots, const void* p_in, void* p_out, void* losses, float lr,
    void* stream) {
  if (table == nullptr || table_len != kPsTableInts || slots == nullptr ||
      n_rows < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  PsTable T{};
  std::memcpy(&T, table, sizeof(PsTable));
  const PsHeader& H = T.h;
  if (H.n_layers < 1 || H.n_layers > kPsMaxLayers ||
      H.n_phases != 2 * H.n_layers || H.smem_floats < kPsTableInts ||
      static_cast<size_t>(H.smem_floats) * sizeof(float) > kSmemLimit ||
      H.d_in < 1 || H.d_out < 1 || H.out_chunks * 4 < H.d_out ||
      H.d_in != T.layer[0].k || H.d_out != T.layer[H.n_layers - 1].n)
    return static_cast<int>(cudaErrorInvalidValue);
  for (int p = 0; p < H.n_phases; ++p) {
    const PsPhase& ph = T.phase[p];
    if (ph.in_rows < 1 || ph.in_rows > kPsMaxRows || ph.warps <= 0 ||
        ph.gk < 1 || ph.gn < 1 || ph.gk > kPsMaxGroup ||
        ph.gn > kPsMaxGroup || (ph.gk & (ph.gk - 1)) ||
        (ph.gn & (ph.gn - 1)) ||
        ph.warps >= (1 << kPsWarps) || ph.bar_warps < 0 ||
        ph.bar_warps >= (1 << kPsWarps) || ph.bar_id < 0 ||
        ph.bar_id > 15 || ph.bar_count != 32 * __builtin_popcount(
                                               ph.bar_warps))
      return static_cast<int>(cudaErrorInvalidValue);
  }
  if (n_rows == 0) return 0;
  const size_t smem = static_cast<size_t>(H.smem_floats) * sizeof(float);
  static size_t granted = 48 * 1024;
  if (smem > granted) {
    const cudaError_t err = cudaFuncSetAttribute(
        fused_train_kernel_per_sample,
        cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
    granted = smem;
  }
  fused_train_kernel_per_sample<<<1, kPsThreads, smem,
                                  static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<const float*>(y), n_rows, T,
      static_cast<const int*>(slots), static_cast<const float*>(p_in),
      static_cast<float*>(p_out), static_cast<float*>(losses), lr);
  return static_cast<int>(cudaGetLastError());
}
