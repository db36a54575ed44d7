// Whole-network int8 forward of the MRF net: one launch per voxel tile.
//
// Replaces: src/repro/kernels/qat_dense/fused.py, fused_forward_call (body
// _fused_kernel) — on the TPU, one pallas_call per voxel tile with every
// layer's weights resident in VMEM: quantize the fp32 features
// (x / s_in, round half to even, clamp to [-128, 127]); per layer an
// int8 x int8 -> int32 dot, + int32 bias, x fp32 scale; hidden layers
// round and clamp to [0, 127] (ReLU fused); float head; optional
// denormalize row multiplied after the head scale.
//
// What bounds it on an H100: bytes.  A voxel moves 264 B (64 fp32 features
// in, 2 fp32 maps out) against about 22.6 k int ops for mrf-fpga, so a
// 1024-voxel tile's floor is about 0.08 us at 3.35 TB/s.  What stands in the
// way at these sizes is latency: a tile is only ~1k voxels, and each
// voxel's layers depend on one another.  Design: what the TPU kernel keeps
// out of device memory stays out of it here too.  Each block copies one
// packed image of ALL layers (a header of per-layer offsets, int8 weights
// transposed to (N, K) rows of 32-bit words, int32 biases, fp32 scales)
// into shared memory once and carries 8 voxels through every layer there,
// 16 threads to a voxel, so a 1024-voxel tile spreads over 128 blocks.  A
// thread computes four output channels (one word of the next layer's
// activations) at a time as four independent __dp4a chains (exact int8
// dot, int32 accumulate) over the shared activation words; a barrier
// separates layers.  Layouts are bank-conflict free: activations are
// [word][voxel], and weight rows are padded by one word so the four
// groups of a warp read four different banks.  Layer count and widths are
// runtime values read from the image's header, so one binary serves every
// net; the launch raises the dynamic shared-memory limit when an image
// needs more than 48 KB.  Tensor-core mma / wgmma is later work.
//
// Bit-exactness: the quotient is __fdiv_rn (a true IEEE division — never a
// multiply by 1/s_in), rounding is rintf (half to even — never roundf),
// clamps happen in float before the conversion, and the fp32 multiplies
// keep the oracle's order: (float)acc * scale, then * drow.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;                // threads per block
constexpr int kVoxels = 8;                   // voxels per block
constexpr int kGroups = kThreads / kVoxels;  // threads per voxel

// Image header, per layer: {k_words, n, w_offset, bs_offset}, offsets in
// 32-bit words from the image start.  Weights: n rows of k_words words,
// k_words + 1 words apart; then n int32 biases followed by n fp32 scales.
constexpr int kHeaderInts = 4;

__device__ __forceinline__ int quantize4(const float* __restrict__ row, int k,
                                         int k0, float s_in) {
  int word = 0;
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    if (k + q < k0) {
      const float v = fminf(fmaxf(rintf(__fdiv_rn(row[k + q], s_in)), -128.0f),
                            127.0f);
      word |= (__float2int_rn(v) & 0xff) << (8 * q);
    }
  }
  return word;
}

__global__ void __launch_bounds__(kThreads)
fused_forward_kernel(const float* __restrict__ x, int m, int k0, float s_in,
                     const int4* __restrict__ image, int image_vecs,
                     int n_layers, int act_words,
                     const float* __restrict__ drow, float* __restrict__ out,
                     int n_out) {
  extern __shared__ __align__(16) int smem[];
  {
    int4* dst = reinterpret_cast<int4*>(smem);
    for (int i = threadIdx.x; i < image_vecs; i += kThreads) dst[i] = image[i];
  }
  int* cur = smem + image_vecs * 4;  // act[word][voxel]
  int* nxt = cur + act_words * kVoxels;

  const int v = threadIdx.x % kVoxels;
  const int g = threadIdx.x / kVoxels;
  const int row = blockIdx.x * kVoxels + v;
  const bool live = row < m;

  // input quantization, four int8 to a word (padding bytes are 0)
  {
    const float* xr = x + static_cast<size_t>(live ? row : 0) * k0;
    const int k_words = (k0 + 3) / 4;
    for (int j = g; j < k_words; j += kGroups)
      cur[j * kVoxels + v] = live ? quantize4(xr, 4 * j, k0, s_in) : 0;
  }
  __syncthreads();

  for (int l = 0; l < n_layers; ++l) {
    const int* hdr = smem + kHeaderInts * l;
    const int k_words = hdr[0], n = hdr[1];
    const int stride = k_words + 1;
    const int* w = smem + hdr[2];
    const int* bias = smem + hdr[3];
    const float* scale = reinterpret_cast<const float*>(smem + hdr[3] + n);
    const bool last = l == n_layers - 1;
    for (int cw = g; cw < n / 4; cw += kGroups) {
      const int* w0 = w + 4 * cw * stride;
      int acc[4] = {0, 0, 0, 0};
#pragma unroll 4
      for (int j = 0; j < k_words; ++j) {
        const int a = cur[j * kVoxels + v];
#pragma unroll
        for (int q = 0; q < 4; ++q) acc[q] = __dp4a(a, w0[q * stride + j], acc[q]);
      }
      int word = 0;
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int c = 4 * cw + q;
        const float scaled = __fmul_rn(__int2float_rn(acc[q] + bias[c]), scale[c]);
        if (last) {
          if (live && c < n_out)
            out[static_cast<size_t>(row) * n_out + c] =
                drow ? __fmul_rn(scaled, drow[c]) : scaled;
        } else {
          const float y = fminf(fmaxf(rintf(scaled), 0.0f), 127.0f);
          word |= __float2int_rn(y) << (8 * q);
        }
      }
      if (!last) nxt[cw * kVoxels + v] = word;
    }
    __syncthreads();
    int* tmp = cur;
    cur = nxt;
    nxt = tmp;
  }
}

}  // namespace

// x (m, k0) fp32 row-major; image: the packed net (image_bytes a multiple
// of 16, 16-byte aligned); drow (n_out,) fp32 or NULL; out (m, n_out)
// fp32.  act_words: the widest layer's in or out width in 32-bit words.
// Returns the first CUDA error (0 on success).
extern "C" int fused_forward_launch(const void* x, int m, int k0, float s_in,
                                    const void* image, int image_bytes,
                                    int n_layers, int act_words,
                                    const void* drow, void* out, int n_out,
                                    void* stream) {
  if (m <= 0) return 0;
  const size_t smem = static_cast<size_t>(image_bytes) +
                      2 * static_cast<size_t>(act_words) * kVoxels * sizeof(int);
  // Above the default 48 KB a launch needs the attribute raised first;
  // raise it only when a launch needs more than any before it, so that the
  // common launch makes no extra host call.  (One process, one card: the
  // attribute is not tracked per device.)
  static size_t granted = 48 * 1024;
  if (smem > granted) {
    const cudaError_t err = cudaFuncSetAttribute(
        fused_forward_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
    granted = smem;
  }
  const dim3 grid((m + kVoxels - 1) / kVoxels);
  fused_forward_kernel<<<grid, kThreads, smem,
                         static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), m, k0, s_in,
      static_cast<const int4*>(image), image_bytes / 16, n_layers, act_words,
      static_cast<const float*>(drow), static_cast<float*>(out), n_out);
  return static_cast<int>(cudaGetLastError());
}
