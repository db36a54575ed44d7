// Whole-network int8 forward of the MRF net on Hopper's int8 tensor cores:
// one launch per voxel tile.
//
// Replaces: src/repro/kernels/qat_dense/fused.py, fused_forward_call (body
// _fused_kernel) — on the TPU, one pallas_call per voxel tile with every
// layer's weights resident in VMEM: quantize the fp32 features
// (x / s_in, round half to even, clamp to [-128, 127]); per layer an
// int8 x int8 -> int32 dot, + int32 bias, x fp32 scale; hidden layers
// round and clamp to [0, 127] (ReLU fused); float head; optional
// denormalize row multiplied after the head scale.
//
// What bounds it on an H100: bytes, in principle.  A voxel moves 264 B (64
// fp32 features in, 2 fp32 maps out) against about 22.6 k int ops for
// mrf-fpga, so a 1024-voxel tile's floor is about 0.08 us and a whole
// wave's (281,600 voxels) about 22 us at 3.35 TB/s.  In practice a served
// tile is bound by latency — 7 dependent layers of ~700 SM cycles each
// (shared loads, two dependent IMMAs, the epilogue, a barrier) — and a
// wave reads ~4x its bytes bound, the per-output epilogue the oracle fixes
// (int -> float, multiply, round, clamp, convert) and 64 IEEE divisions a
// voxel being most of its instructions (scripts/fused_forward_phases.py
// reads the cycles of each layer).
// Design (int8_mma.cuh holds the fragments and the k maps):
// - what the TPU kernel keeps out of device memory stays out of it: the
//   net lives in shared memory as one packed image (fused.pack_image: a
//   header of per-layer offsets, each layer's weights as int8 B fragments
//   in fragment order, K padded to 32 and N to 8 with zero weights, then
//   its int32 biases and fp32 scales), brought in ONCE per block by one
//   cp.async.bulk on an mbarrier while the block's first voxel tiles load
//   and quantize;
// - a persistent grid (at most 2 blocks of 8 warps an SM) walks the voxel
//   tiles, so at a whole wave the image is read once per block, not once
//   per tile;
// - a group of W warps (W = 1, 2, 4 or 8, picked at launch so that the
//   tiles fill the SMs' 4 sub-partitions: 8 at a served tile of <= 1,024
//   voxels, 1 at a whole wave) carries 16 voxels through ALL layers.  Each
//   layer's products run on mma.sync m16n8k32 s8 (IMMA); a group's warp
//   takes every W-th n8 tile, four at a time as straight-line code so that
//   their products and epilogues interleave.  The requantized bytes of a
//   D fragment go to a group buffer at (tile, lane), so that the bytes of
//   four n8 tiles are, lane for lane, the next layer's A registers of one
//   32-wide chunk (the kChain k map: the image orders each hidden layer's
//   weight rows to match) — no shuffle, no transpose, one named barrier
//   a layer (a warp sync at W = 1).  The W warps split the features'
//   quantization the same way;
// - the features' A registers come from float4 loads (the kInput k map),
//   a warp's share issued before any of it is quantized;
// - one body serves every W, with tile groups of 4, 2 and 1.
// Layer count and widths are runtime values read from the image's header;
// the widest activation (2, 4 or 8 chunks of 32) picks one of three
// instantiations, so one library serves every net whose image fits a
// block's shared memory; the launch raises the dynamic shared-memory limit
// when an image needs more than 48 KB.
//
// Bit-exactness: int8 products summed in int32 are exact in any order; the
// quotient is __fdiv_rn (a true IEEE division — never a multiply by
// 1/s_in), rounding is rintf (half to even — never roundf), clamps happen
// in float before the conversion, and the fp32 multiplies keep the
// oracle's order: (float)acc * scale, then * drow.

#include <cstdint>
#include <cuda_runtime.h>

#include "int8_mma.cuh"

namespace {

using int8mma::frag_word;

constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;
constexpr int kBlocksPerSm = 2;  // the persistent grid's cap

// Image header, per layer: {k_chunks, n_tiles, frag_offset, bs_offset},
// offsets in 32-bit words from the image start (even: 8-byte loads).
// Weights: k_chunks * n_tiles * 64 words of B fragments; then 8 n_tiles
// int32 biases followed by 8 n_tiles fp32 scales.
constexpr int kHeaderInts = 4;

__device__ __forceinline__ unsigned quant(float v, float s_in) {
  const float q = fminf(fmaxf(rintf(__fdiv_rn(v, s_in)), -128.0f), 127.0f);
  return static_cast<unsigned>(int8mma::to_int(q)) & 0xffu;
}

__device__ __forceinline__ unsigned quant4(float4 v, float s_in) {
  return quant(v.x, s_in) | quant(v.y, s_in) << 8 | quant(v.z, s_in) << 16 |
         quant(v.w, s_in) << 24;
}

// Features [c, c + 4) of row `row` of x (m, k0), zero past the edges.
// vec4: rows are 16-byte aligned and k0 is a multiple of 4.
__device__ __forceinline__ float4 load4(const float* __restrict__ x, int row,
                                        int m, int k0, int c, bool vec4) {
  float4 v = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  if (row >= m || c >= k0) return v;
  const float* p = x + static_cast<size_t>(row) * k0 + c;
  if (vec4) return __ldg(reinterpret_cast<const float4*>(p));
  v.x = __ldg(p);
  if (c + 1 < k0) v.y = __ldg(p + 1);
  if (c + 2 < k0) v.z = __ldg(p + 2);
  if (c + 3 < k0) v.w = __ldg(p + 3);
  return v;
}

// A register `i` of a 16-voxel tile's features (kInput map): chunk i / 4,
// register i % 4 (rows g, g + 8, g, g + 8; features 8t .. 8t + 3 for the
// first two, 8t + 4 .. 8t + 7 for the others).
__device__ __forceinline__ int reg_row(int i, int g) { return g + 8 * (i & 1); }
__device__ __forceinline__ int reg_col(int i, int t) {
  return 32 * (i >> 2) + 8 * t + 4 * ((i >> 1) & 1);
}

// A layer as the image's header places it in shared memory.
struct Layer {
  const uint32_t* frag;
  const int* bias;
  const float* scale;
  int kch, nt;
};

// n8 tiles j0, j0 + step, ... (NT of them) of a layer, as straight-line
// code, so the tiles' products and epilogues interleave.  Every one of the
// C chunks of A is multiplied: A is zero past the layer's k_chunks (the
// features' zero padding, and the zero bytes of the previous layer's
// missing tiles), so a chunk past them adds exactly 0, with B read at the
// layer's last chunk.  Hidden layers leave the requantized bytes of rows g
// and g + 8 of each tile in p and q; the head stores its outputs.
template <int C, int NT>
__device__ __forceinline__ void tile_group(
    const uint32_t (&a)[C][4], const Layer& L, int j0, int step, int lane,
    bool last, int r0, int m, const float* __restrict__ drow,
    float* __restrict__ out, int n_out, uint32_t (&p)[4], uint32_t (&q)[4]) {
  const int g = lane >> 2, t = lane & 3;
  int acc[NT][4];
#pragma unroll
  for (int jj = 0; jj < NT; ++jj)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[jj][e] = 0;
#pragma unroll
  for (int kc = 0; kc < C; ++kc) {
    const int kb = min(kc, L.kch - 1);
#pragma unroll
    for (int jj = 0; jj < NT; ++jj)
      int8mma::mma(acc[jj], a[kc],
                   int8mma::lds64(L.frag +
                                  frag_word(kb, j0 + jj * step, L.nt, lane, 0)));
  }
#pragma unroll
  for (int jj = 0; jj < NT; ++jj) {
    const int c = 8 * (j0 + jj * step) + 2 * t;
    const int2 bb = *reinterpret_cast<const int2*>(L.bias + c);
    const float2 ss = *reinterpret_cast<const float2*>(L.scale + c);
    const float y[4] = {int8mma::rescale(acc[jj][0], bb.x, ss.x),
                        int8mma::rescale(acc[jj][1], bb.y, ss.y),
                        int8mma::rescale(acc[jj][2], bb.x, ss.x),
                        int8mma::rescale(acc[jj][3], bb.y, ss.y)};
    if (last) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int row = r0 + g + 8 * (e >> 1), col = c + (e & 1);
        if (row < m && col < n_out)
          out[static_cast<size_t>(row) * n_out + col] =
              drow ? __fmul_rn(y[e], __ldg(drow + col)) : y[e];
      }
    } else {
      p[jj] = static_cast<unsigned>(int8mma::requant(y[0], 0.0f)) |
              static_cast<unsigned>(int8mma::requant(y[1], 0.0f)) << 8;
      q[jj] = static_cast<unsigned>(int8mma::requant(y[2], 0.0f)) |
              static_cast<unsigned>(int8mma::requant(y[3], 0.0f)) << 8;
    }
  }
}

// The W warps of group `id`: a named barrier, or the warp itself.
__device__ __forceinline__ void group_sync(int id, int warps) {
  if (warps == 1)
    __syncwarp();
  else
    asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(32 * warps) : "memory");
}

template <int C>  // the widest activation, in 32-wide chunks
__global__ void __launch_bounds__(kThreads, kBlocksPerSm)
fused_forward_kernel(const float* __restrict__ x, int m, int k0, float s_in,
                     int vec4, const void* __restrict__ image,
                     int image_bytes, int n_layers,
                     const float* __restrict__ drow, float* __restrict__ out,
                     int n_out, int W) {
  extern __shared__ __align__(16) uint32_t smem[];
  __shared__ __align__(8) unsigned long long bar;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int log_w = __ffs(W) - 1;  // W is a power of two
  const int w = warp & (W - 1), group = warp >> log_w, groups = kWarps >> log_w;
  const int stride = gridDim.x * groups * 16;
  int r0 = (blockIdx.x * groups + group) * 16;
  // the group's two buffers of C * 4 n8 tiles x 32 lanes, after the image:
  // word j * 32 + lane holds the requantized bytes of rows g (low half)
  // and g + 8 (high half) of n8 tile j — the kChain map; layer l writes
  // buffer l & 1.  Buffer 1 first holds the features' A registers.
  uint32_t* buf = smem + image_bytes / 4 + group * 2 * C * 128;
  uint32_t* feat = buf + C * 128;
  const int regs = 4 * ((k0 + 31) / 32);
  const bool vec = vec4 != 0;
  const unsigned bar_addr = int8mma::cta_addr(&bar);
  if (threadIdx.x == 0) int8mma::mbar_init(bar_addr);
  __syncthreads();
  if (threadIdx.x == 0)
    int8mma::bulk_load(smem, image, static_cast<unsigned>(image_bytes),
                       bar_addr);

  uint32_t a[C][4];
  bool first = true;
  while (r0 < m) {
    // this warp's share of the features' A registers (w, w + W, ...), eight
    // at a time, every load issued before any is quantized; the first
    // tile's while the image lands
    if (!first) group_sync(1 + group, W);  // the last tile's reads are done
    for (int i0 = w; i0 < regs; i0 += 8 * W) {
      float4 u[8];
#pragma unroll
      for (int ii = 0; ii < 8; ++ii) {
        const int i = i0 + ii * W;
        u[ii] = i < regs ? load4(x, r0 + reg_row(i, g), m, k0, reg_col(i, t),
                                 vec)
                         : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      }
#pragma unroll
      for (int ii = 0; ii < 8; ++ii) {
        const int i = i0 + ii * W;
        if (i < regs) feat[i * 32 + lane] = quant4(u[ii], s_in);
      }
    }
    if (first) int8mma::mbar_wait(bar_addr, 0);
    first = false;
    group_sync(1 + group, W);
#pragma unroll
    for (int i = 0; i < 4 * C; ++i)
      a[i / 4][i % 4] = i < regs ? feat[i * 32 + lane] : 0u;

    // each layer's header is read a layer ahead, off the dependent chain
    uint4 next = *reinterpret_cast<const uint4*>(smem);
    for (int l = 0; l < n_layers; ++l) {
      const uint4 hdr = next;
      if (l + 1 < n_layers)
        next = *reinterpret_cast<const uint4*>(smem + kHeaderInts * (l + 1));
      const int nt = static_cast<int>(hdr.y);
      const Layer L = {smem + hdr.z, reinterpret_cast<const int*>(smem + hdr.w),
                       reinterpret_cast<const float*>(smem + hdr.w + 8 * nt),
                       static_cast<int>(hdr.x), nt};
      const bool last = l == n_layers - 1;
      uint32_t* lbuf = buf + (l & 1) * C * 128;
      // this warp's n8 tiles w, w + W, ...: four at a time, then two, one
      const int mine = nt > w ? (nt - w + W - 1) >> log_w : 0;
      int i0 = 0;
      for (; i0 + 4 <= mine; i0 += 4) {
        uint32_t p[4], q[4];
        const int j0 = w + W * i0;
        tile_group<C, 4>(a, L, j0, W, lane, last, r0, m, drow, out, n_out,
                         p, q);
        if (!last) {
#pragma unroll
          for (int jj = 0; jj < 4; ++jj)
            lbuf[(j0 + W * jj) * 32 + lane] = p[jj] | q[jj] << 16;
        }
      }
      if (i0 + 2 <= mine) {
        uint32_t p[4], q[4];
        const int j0 = w + W * i0;
        tile_group<C, 2>(a, L, j0, W, lane, last, r0, m, drow, out, n_out,
                         p, q);
        if (!last) {
          lbuf[j0 * 32 + lane] = p[0] | q[0] << 16;
          lbuf[(j0 + W) * 32 + lane] = p[1] | q[1] << 16;
        }
        i0 += 2;
      }
      if (i0 < mine) {
        uint32_t p[4], q[4];
        const int j = w + W * i0;
        tile_group<C, 1>(a, L, j, W, lane, last, r0, m, drow, out, n_out, p,
                         q);
        if (!last) lbuf[j * 32 + lane] = p[0] | q[0] << 16;
      }
      if (last) break;
      // the next layer's A registers: chunk oc from n8 tiles 4 oc .. 4 oc + 3
      group_sync(1 + group, W);
#pragma unroll
      for (int oc = 0; oc < C; ++oc) {
        uint32_t v[4];
#pragma unroll
        for (int jj = 0; jj < 4; ++jj)
          v[jj] = 4 * oc + jj < nt ? lbuf[(4 * oc + jj) * 32 + lane] : 0u;
        a[oc][0] = __byte_perm(v[0], v[1], 0x5410);
        a[oc][1] = __byte_perm(v[0], v[1], 0x7632);
        a[oc][2] = __byte_perm(v[2], v[3], 0x5410);
        a[oc][3] = __byte_perm(v[2], v[3], 0x7632);
      }
    }
    r0 += stride;
  }
}

// Warps a tile: the most of 1, 2, 4, 8 that keeps tiles x W within one
// warp for each of the SMs' 4 sub-partitions.
int warps_per_tile(long long tiles, int sms) {
  int W = 1;
  while (W < kWarps && tiles * W * 2 <= 4LL * sms) W *= 2;
  return W;
}

template <int C>
int launch(const float* x, int m, int k0, float s_in, const void* image,
           int image_bytes, int n_layers, const float* drow, float* out,
           int n_out, cudaStream_t stream) {
  auto kernel = fused_forward_kernel<C>;
  // per instantiation: the shared-memory limit granted, the SM count and,
  // for each W, the blocks an SM holds at the last launch's shared memory,
  // so that the common launch makes no extra host call (one process, one
  // card)
  static size_t granted = 48 * 1024;
  static int sms = 0;
  static size_t occ_smem[kWarps + 1] = {};
  static int occ[kWarps + 1] = {};
  if (sms == 0) {
    int dev = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err == cudaSuccess)
      err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const long long tiles = (static_cast<long long>(m) + 15) / 16;
  const int W = warps_per_tile(tiles, sms);
  const int groups = kWarps / W;
  const size_t smem = static_cast<size_t>(image_bytes) +
                      static_cast<size_t>(groups) * 2 * C * 512;
  if (smem > granted) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
    granted = smem;
  }
  if (occ_smem[W] != smem) {
    const cudaError_t err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &occ[W], kernel, kThreads, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    occ_smem[W] = smem;
  }
  const int per_sm =
      occ[W] < kBlocksPerSm ? (occ[W] > 0 ? occ[W] : 1) : kBlocksPerSm;
  const long long need = (tiles + groups - 1) / groups;
  const long long cap = static_cast<long long>(sms) * per_sm;
  const int blocks = static_cast<int>(need < cap ? need : cap);
  const int vec4 = k0 % 4 == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0;
  kernel<<<blocks, kThreads, smem, stream>>>(x, m, k0, s_in, vec4, image,
                                              image_bytes, n_layers, drow, out,
                                              n_out, W);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// x (m, k0) fp32 row-major; image: the packed net (image_bytes a multiple
// of 16, 16-byte aligned); drow (n_out,) fp32 or NULL; out (m, n_out)
// fp32.  act_chunks: the widest layer's in or out width in 32-wide chunks
// (at most 8).  Returns the first CUDA error (0 on success).
extern "C" int fused_forward_launch(const void* x, int m, int k0, float s_in,
                                    const void* image, int image_bytes,
                                    int n_layers, int act_chunks,
                                    const void* drow, void* out, int n_out,
                                    void* stream) {
  if (m <= 0) return 0;
  const auto* xs = static_cast<const float*>(x);
  const auto* d = static_cast<const float*>(drow);
  auto* o = static_cast<float*>(out);
  const auto st = static_cast<cudaStream_t>(stream);
  if (act_chunks <= 2)
    return launch<2>(xs, m, k0, s_in, image, image_bytes, n_layers, d, o,
                     n_out, st);
  if (act_chunks <= 4)
    return launch<4>(xs, m, k0, s_in, image, image_bytes, n_layers, d, o,
                     n_out, st);
  if (act_chunks <= 8)
    return launch<8>(xs, m, k0, s_in, image, image_bytes, n_layers, d, o,
                     n_out, st);
  return static_cast<int>(cudaErrorInvalidValue);
}
