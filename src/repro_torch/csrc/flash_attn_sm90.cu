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
struct Tiles {
  static constexpr int kBlockK = DH <= 64 ? 128 : 64;
  static constexpr int kPanel = DH < 64 ? DH : 64;     // columns a panel holds
  static constexpr int kPanels = DH / kPanel;
  static constexpr int kRowBytes = kPanel * 2;         // = the swizzle span
  static constexpr int kQPanel = kBlockQ * kRowBytes;
  static constexpr int kKVPanel = kBlockK * kRowBytes;
  static constexpr int kQBytes = kQPanel * kPanels;
  static constexpr int kKVBytes = kKVPanel * kPanels;
  // wgmma descriptor layout type: 1 = 128 B swizzle, 2 = 64 B, 3 = 32 B
  static constexpr int kLayout = kRowBytes == 128 ? 1 : kRowBytes == 64 ? 2 : 3;
  static constexpr int kSmem =
      2 * kQBytes + 2 * kStages * kKVBytes + 8 * (4 + 2 * kStages) + 1024;
};

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(bar),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(
                   bar),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(bar)
               : "memory");
}

// Returns once the barrier's phase of this parity has completed.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  } while (!done);
}

// One 2-d TMA box, {column c0, row c1} of the map, into shared memory;
// completion is counted in bytes on the barrier.
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         uint32_t bar, int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::"
      "bytes [%0], [%1, {%3, %4}], [%2];" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1)
      : "memory");
}

// wgmma shared-memory matrix descriptor: start address, leading and stride
// byte offsets (16 B units), swizzle layout type.  Tiles sit on 1024-byte
// boundaries, so the base offset field stays 0.
__device__ __forceinline__ uint64_t wg_desc(uint32_t addr, uint32_t lbo,
                                            uint32_t sbo, int layout) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(lbo >> 4) << 16) |
         (static_cast<uint64_t>(sbo >> 4) << 32) |
         (static_cast<uint64_t>(layout) << 62);
}

__device__ __forceinline__ void wg_fence() {
  asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}
// Returns once at most N committed groups of this warpgroup are in flight.
template <int N>
__device__ __forceinline__ void wg_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;" ::"n"(N) : "memory");
}

// Pins registers that an asynchronous wgmma reads or writes to this point of
// the instruction stream, so that the compiler neither reads an accumulator
// before wg_wait nor reuses an operand register while the product runs.
template <int N>
__device__ __forceinline__ void pin(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}
template <int N>
__device__ __forceinline__ void pin(uint32_t (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(r[i])::"memory");
}

// D(64 x N, f32) (+)= A(64 x 16) B(16 x N): A and B K-major bf16 in shared
// memory.  acc = 0 ignores D's old value.
template <int N>
__device__ void wgmma_ss(float (&d)[N / 2], uint64_t a, uint64_t b, int acc);
// The same with A in registers (the accumulator fragment layout, 4 x 2 bf16
// a thread) and B MN-major (transposed) in shared memory.
template <int N>
__device__ void wgmma_rs(float (&d)[N / 2], const uint32_t* a, uint64_t b,
                         int acc);

template <>
__device__ __forceinline__ void wgmma_ss<64>(float (&d)[32], uint64_t a,
                                             uint64_t b, int acc) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7,"
      "%8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23,"
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(a), "l"(b), "r"(acc));
}

template <>
__device__ __forceinline__ void wgmma_ss<128>(float (&d)[64], uint64_t a,
                                             uint64_t b, int acc) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7,"
      "%8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23,"
      "%24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39,"
      "%40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55,"
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(a), "l"(b), "r"(acc));
}

template <>
__device__ __forceinline__ void wgmma_rs<16>(float (&d)[8], const uint32_t* a,
                                             uint64_t b, int acc) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %13, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7"
      "}, {%8, %9, %10, %11}, %12, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(acc));
}

template <>
__device__ __forceinline__ void wgmma_rs<32>(float (&d)[16], const uint32_t* a,
                                             uint64_t b, int acc) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7,"
      "%8, %9, %10, %11, %12, %13, %14, %15"
      "}, {%16, %17, %18, %19}, %20, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(acc));
}

template <>
__device__ __forceinline__ void wgmma_rs<64>(float (&d)[32], const uint32_t* a,
                                             uint64_t b, int acc) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7,"
      "%8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23,"
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(acc));
}

template <>
__device__ __forceinline__ void wgmma_rs<128>(float (&d)[64], const uint32_t* a,
                                             uint64_t b, int acc) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7,"
      "%8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23,"
      "%24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39,"
      "%40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55,"
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(acc));
}

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
    constexpr uint32_t kSbo = 8 * T::kRowBytes;  // 8 rows of a swizzle atom
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
      for (int kk = 0; kk < DH / 16; ++kk) {
        const int panel = kk * 16 / T::kPanel;
        const uint32_t off = (kk * 16 % T::kPanel) * 2;
        wgmma_ss<BK>(
            s, wg_desc(q_wg + panel * T::kQPanel + off, 16, kSbo, T::kLayout),
            wg_desc(k_st + panel * T::kKVPanel + off, 16, kSbo, T::kLayout),
            kk > 0);
      }
      wg_commit();
    };
    auto issue_pv = [&](int st) {
      const uint32_t v_st = v_s + st * T::kKVBytes;
#pragma unroll
      for (int c = 0; c < BK / 16; ++c)
        wgmma_rs<DH>(o, pa + 4 * c,
                     wg_desc(v_st + c * 16 * T::kRowBytes, T::kKVPanel, kSbo,
                             T::kLayout),
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

// cuTensorMapEncodeTiled's signature (CUDA 12 driver API)
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                 void*, const cuuint64_t*, const cuuint64_t*,
                                 const cuuint32_t*, const cuuint32_t*,
                                 CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

EncodeTiled encode_tiled() {
  static EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t e = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t e = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    return e == cudaSuccess && found == cudaDriverEntryPointSuccess
               ? reinterpret_cast<EncodeTiled>(p)
               : nullptr;
  }();
  return fn;
}

// Error codes beside cudaError_t's: no driver entry point, or the driver
// refused a tensor map (kEncodeFailed + its CUresult).
constexpr int kNoEntryPoint = 10000;
constexpr int kEncodeFailed = 20000;

// A (rows, dh) row-major bf16 matrix as boxes of box_rows x panel columns.
int make_map(CUtensorMap* map, const void* ptr, int rows, int dh, int panel,
             int box_rows) {
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return kNoEntryPoint;
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(dh),
                              static_cast<cuuint64_t>(rows)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(dh) * 2};
  const cuuint32_t box[2] = {static_cast<cuuint32_t>(panel),
                             static_cast<cuuint32_t>(box_rows)};
  const cuuint32_t elem_strides[2] = {1, 1};
  const CUtensorMapSwizzle swizzle =
      panel * 2 == 128  ? CU_TENSOR_MAP_SWIZZLE_128B
      : panel * 2 == 64 ? CU_TENSOR_MAP_SWIZZLE_64B
                        : CU_TENSOR_MAP_SWIZZLE_32B;
  const CUresult r = encode(
      map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, const_cast<void*>(ptr), dims,
      strides, box, elem_strides, CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle,
      CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : kEncodeFailed + static_cast<int>(r);
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
