// Whole-network fused training of the MRF net: per batch tile, the forward
// pass, the masked MSE loss, the hand-derived backward pass and an in-place
// SGD or Adam update, over every tile of K steps in one launch.
//
// Replaces: src/repro/kernels/fused_train/kernel.py (fused_train_call, body
// _kernel, the shared train_tile and _sgd_update) and
// src/repro/kernels/fused_train/multistep.py (fused_train_multistep_call and
// fused_train_adam_call, body _adam_kernel).  On the TPU the weights (and
// Adam's two moment stacks) sit in VMEM for a whole launch while a
// sequential grid walks the K*B/tile batch tiles; tile k*n_tiles + j sees
// the weights as every earlier tile left them.  The three TPU entry points
// are one kernel here: the single step is K = 1, Adam differs only in its
// update rule, and the int8 weight fake-quant of QAT is a runtime flag.
// Layer count, widths and the tile are runtime values, so one binary
// trains every net.
//
// What bounds it on an H100: the chain of dependent steps, not bytes.  A
// sample of mrf-fpga costs 59,584 FLOP (forward, dW, and dh for layers
// 1...) against 264 B of x and y, and every tile depends on the weights the
// previous tile wrote, so the work cannot spread over the card's 132 SMs:
// one block owns the net for the whole launch and walks the tiles in a
// loop (the TPU's sequential grid).  The floor is then one SM's fp32 rate
// (~0.51 TFLOP/s of the card's 67), and at small tiles the latency of ~3L
// barriers and L-long dependent dot products per tile.
//
// Design: the layers keep their true widths (no 128-lane padding): the
// weights and biases are resident in shared memory for the whole launch
// (47 KB for mrf-fpga, 164 KB for mrf-original, with every weight row
// padded by one float so that the transposed reads of the backward pass
// fall in distinct banks).  Activations, deltas, the fake-quantized weights
// and Adam's moments live in a global workspace that only this block
// touches, so they stay in the 50 MB L2; moving them on chip (a cluster's
// distributed shared memory, registers) is later work.  Each phase (a
// layer's forward, its dh, its dW/db + update) spreads its outputs over the
// block's 1,024 threads and ends in a barrier.
//
// Determinism: no atomics.  Every sum (each dot's K loop, dW's and db's sum
// over the tile's rows, the loss) is taken in a fixed order by a fixed
// thread (the loss by warp 0 in a fixed shuffle tree), so a K-step launch
// equals K single-step launches bit for bit, and two identical launches
// give identical bits.
//
// Numerics: built without fast math.  The fake-quant divides with __fdiv_rn
// and rounds with rintf (half to even): s = max_k |w[k,n]| / 127 + 1e-12,
// clamp(rint(w / s), -127, 127) * s.  The update rules use explicitly
// rounded operations (no contraction), in the order of
// src/repro/kernels/fused_train/multistep.py:135-152: t = step0 + tile + 1
// as a float, powf(b1, t), __fsqrt_rn, and + eps outside the square root.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 1024;
constexpr int kMaxLayers = 16;

// Offsets in floats.  The packed buffer holds, per layer, W (K, N) row-major
// in the (in, out) layout and then b (N,); Adam's moments are packed alike.
// In shared memory the rows of W are N + 1 floats apart.
struct NetLayout {
  int n_layers;
  int width[kMaxLayers + 1];  // width[0] = in features ... width[L] = out
  int w_packed[kMaxLayers];
  int b_packed[kMaxLayers];
  int w_shared[kMaxLayers];
  int b_shared[kMaxLayers];
  int act[kMaxLayers];        // layer l's output (tile, width[l + 1])
  int n_packed;
  int n_shared;
  int max_width;
};

struct AdamRule {
  float b1, b2, one_minus_b1, one_minus_b2, eps, weight_decay;
};

__device__ __forceinline__ void adam_update(float* p, float* m, float* v,
                                            float g, float lr,
                                            const AdamRule& a, float c1,
                                            float c2) {
  const float mn = __fadd_rn(__fmul_rn(a.b1, *m), __fmul_rn(a.one_minus_b1, g));
  const float vn = __fadd_rn(__fmul_rn(a.b2, *v),
                             __fmul_rn(a.one_minus_b2, __fmul_rn(g, g)));
  const float mhat = __fdiv_rn(mn, c1);
  const float vhat = __fdiv_rn(vn, c2);
  const float step = __fmul_rn(
      lr, __fadd_rn(__fdiv_rn(mhat, __fadd_rn(__fsqrt_rn(vhat), a.eps)),
                    __fmul_rn(a.weight_decay, *p)));
  *p = __fsub_rn(*p, step);
  *m = mn;
  *v = vn;
}

// x (n_tiles * tb, width[0]), y (n_tiles * tb, width[L]); p_in/p_out the
// packed net; mu/nu the packed moments (null for SGD: then mu_in, nu_in and
// step0 are unused); losses (n_tiles,).  Workspace: act (tb * sum of
// width[1..L]), dz (2 * tb * max_width), wq (n_shared, QAT only).
__global__ void __launch_bounds__(kThreads)
fused_train_kernel(const float* __restrict__ x, const float* __restrict__ y,
                   int n_tiles, int tb, NetLayout net,
                   const float* __restrict__ p_in, float* __restrict__ p_out,
                   const float* __restrict__ mu_in,
                   const float* __restrict__ nu_in, float* mu, float* nu,
                   const int* __restrict__ step0, float* __restrict__ losses,
                   float* act, float* dz, float* wq, float lr, AdamRule adam,
                   int qat) {
  extern __shared__ __align__(16) float smem[];
  const int tid = threadIdx.x;
  const int n_layers = net.n_layers;
  const int d_in = net.width[0];
  const int d_out = net.width[n_layers];

  // the net into shared memory, once for the launch; moments to the outputs
  for (int l = 0; l < n_layers; ++l) {
    const int k_dim = net.width[l], n_dim = net.width[l + 1];
    float* ws = smem + net.w_shared[l];
    const float* wg = p_in + net.w_packed[l];
    for (int i = tid; i < k_dim * n_dim; i += kThreads)
      ws[(i / n_dim) * (n_dim + 1) + i % n_dim] = wg[i];
    for (int n = tid; n < n_dim; n += kThreads)
      smem[net.b_shared[l] + n] = p_in[net.b_packed[l] + n];
  }
  if (mu != nullptr) {
    for (int i = tid; i < net.n_packed; i += kThreads) {
      mu[i] = mu_in[i];
      nu[i] = nu_in[i];
    }
  }
  const int s0 = mu != nullptr ? *step0 : 0;
  const float denom = static_cast<float>(tb * d_out);
  __syncthreads();

  for (int t = 0; t < n_tiles; ++t) {
    const float* xt = x + static_cast<size_t>(t) * tb * d_in;
    const float* yt = y + static_cast<size_t>(t) * tb * d_out;

    // --- forward ----------------------------------------------------------
    for (int l = 0; l < n_layers; ++l) {
      const int k_dim = net.width[l], n_dim = net.width[l + 1];
      const int stride = n_dim + 1;
      const float* w = smem + net.w_shared[l];
      if (qat) {
        // per-column symmetric int8 fake-quant of the live weights; the
        // backward pass reuses it (the layer's weights do not change
        // between its forward and its dh)
        float* q = wq + net.w_shared[l];
        for (int n = tid; n < n_dim; n += kThreads) {
          float m = 0.0f;
          for (int k = 0; k < k_dim; ++k) m = fmaxf(m, fabsf(w[k * stride + n]));
          const float s = __fadd_rn(__fdiv_rn(m, 127.0f), 1e-12f);
          for (int k = 0; k < k_dim; ++k) {
            const float r = rintf(__fdiv_rn(w[k * stride + n], s));
            q[k * stride + n] = __fmul_rn(fminf(fmaxf(r, -127.0f), 127.0f), s);
          }
        }
        __syncthreads();
        w = q;
      }
      const float* bias = smem + net.b_shared[l];
      const float* hin = l == 0 ? xt : act + net.act[l - 1];
      float* hout = act + net.act[l];
      const bool last = l == n_layers - 1;
      for (int i = tid; i < tb * n_dim; i += kThreads) {
        const int r = i / n_dim, n = i % n_dim;
        const float* hr = hin + r * k_dim;
        float acc = 0.0f;
        for (int k = 0; k < k_dim; ++k) acc = fmaf(hr[k], w[k * stride + n], acc);
        const float z = __fadd_rn(acc, bias[n]);
        hout[i] = last ? z : fmaxf(z, 0.0f);
      }
      __syncthreads();
    }

    // --- masked MSE loss and its delta --------------------------------------
    float* cur = dz;
    float* nxt = dz + tb * net.max_width;
    {
      const float* pred = act + net.act[n_layers - 1];
      for (int i = tid; i < tb * d_out; i += kThreads)
        cur[i] = __fdiv_rn(__fmul_rn(2.0f, __fsub_rn(pred[i], yt[i])), denom);
      if (tid < 32) {
        float acc = 0.0f;
        for (int i = tid; i < tb * d_out; i += 32) {
          const float diff = __fsub_rn(pred[i], yt[i]);
          acc = __fadd_rn(acc, __fmul_rn(diff, diff));
        }
        for (int off = 16; off > 0; off >>= 1)
          acc = __fadd_rn(acc, __shfl_down_sync(0xffffffffu, acc, off));
        if (tid == 0) losses[t] = __fdiv_rn(acc, denom);
      }
      __syncthreads();
    }

    // --- backward, with the update in place --------------------------------
    float c1 = 1.0f, c2 = 1.0f;
    if (mu != nullptr) {
      const float step = static_cast<float>(s0 + t + 1);
      c1 = __fsub_rn(1.0f, powf(adam.b1, step));
      c2 = __fsub_rn(1.0f, powf(adam.b2, step));
    }
    for (int l = n_layers - 1; l >= 0; --l) {
      const int k_dim = net.width[l], n_dim = net.width[l + 1];
      const int stride = n_dim + 1;
      float* w = smem + net.w_shared[l];
      float* bias = smem + net.b_shared[l];
      const float* wf = qat ? wq + net.w_shared[l] : w;
      const float* hprev = l == 0 ? xt : act + net.act[l - 1];
      if (l > 0) {
        // dh = dz . W^T through the weights BEFORE their update, masked by
        // the ReLU of the layer's input
        for (int i = tid; i < tb * k_dim; i += kThreads) {
          const int r = i / k_dim, k = i % k_dim;
          const float* dr = cur + r * n_dim;
          const float* wr = wf + k * stride;
          float acc = 0.0f;
          for (int n = 0; n < n_dim; ++n) acc = fmaf(dr[n], wr[n], acc);
          nxt[i] = __fmul_rn(acc, hprev[i] > 0.0f ? 1.0f : 0.0f);
        }
        __syncthreads();
      }
      // dW = h_prev^T . dz and db = sum of dz over the tile's rows, each
      // entry by one thread, then the update of that entry
      for (int i = tid; i < k_dim * n_dim + n_dim; i += kThreads) {
        float g = 0.0f;
        float* p;
        int at;
        if (i < k_dim * n_dim) {
          const int k = i / n_dim, n = i % n_dim;
          for (int r = 0; r < tb; ++r)
            g = fmaf(hprev[r * k_dim + k], cur[r * n_dim + n], g);
          p = w + k * stride + n;
          at = net.w_packed[l] + i;
        } else {
          const int n = i - k_dim * n_dim;
          for (int r = 0; r < tb; ++r) g = __fadd_rn(g, cur[r * n_dim + n]);
          p = bias + n;
          at = net.b_packed[l] + n;
        }
        if (mu != nullptr)
          adam_update(p, mu + at, nu + at, g, lr, adam, c1, c2);
        else
          *p = __fsub_rn(*p, __fmul_rn(lr, g));
      }
      __syncthreads();
      float* tmp = cur;
      cur = nxt;
      nxt = tmp;
    }
  }

  // the trained net back to device memory, once
  for (int l = 0; l < n_layers; ++l) {
    const int k_dim = net.width[l], n_dim = net.width[l + 1];
    const float* ws = smem + net.w_shared[l];
    float* wg = p_out + net.w_packed[l];
    for (int i = tid; i < k_dim * n_dim; i += kThreads)
      wg[i] = ws[(i / n_dim) * (n_dim + 1) + i % n_dim];
    for (int n = tid; n < n_dim; n += kThreads)
      p_out[net.b_packed[l] + n] = smem[net.b_shared[l] + n];
  }
}

}  // namespace

// widths: n_layers + 1 ints on the host.  n_rows must be a multiple of tile.
// mu_in/nu_in/mu_out/nu_out/step0: all null for SGD, all set for Adam.  The
// workspace sizes are those of the kernel's comment above.  Returns the
// first CUDA error (0 on success; cudaErrorInvalidValue for a layout the
// kernel does not take).
extern "C" int fused_train_launch(
    const void* x, const void* y, int n_rows, int tile, const int* widths,
    int n_layers, const void* p_in, void* p_out, const void* mu_in,
    const void* nu_in, void* mu_out, void* nu_out, const void* step0,
    void* losses, void* act, void* dz, void* wq, float lr, float b1, float b2,
    float one_minus_b1, float one_minus_b2, float eps, float weight_decay,
    int qat, void* stream) {
  if (n_layers < 1 || n_layers > kMaxLayers || tile < 1 || n_rows < 0 ||
      n_rows % tile != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (n_rows == 0) return 0;
  NetLayout net{};
  net.n_layers = n_layers;
  int packed = 0, shared = 0, act_at = 0;
  net.max_width = 0;
  for (int l = 0; l <= n_layers; ++l) {
    if (widths[l] < 1) return static_cast<int>(cudaErrorInvalidValue);
    net.width[l] = widths[l];
    if (widths[l] > net.max_width) net.max_width = widths[l];
  }
  for (int l = 0; l < n_layers; ++l) {
    const int k_dim = widths[l], n_dim = widths[l + 1];
    net.w_packed[l] = packed;
    net.b_packed[l] = packed + k_dim * n_dim;
    packed += k_dim * n_dim + n_dim;
    net.w_shared[l] = shared;
    net.b_shared[l] = shared + k_dim * (n_dim + 1);
    shared += k_dim * (n_dim + 1) + n_dim;
    net.act[l] = act_at;
    act_at += tile * n_dim;
  }
  net.n_packed = packed;
  net.n_shared = shared;
  const bool adam = mu_out != nullptr;
  if (adam != (nu_out != nullptr) || adam != (mu_in != nullptr) ||
      adam != (nu_in != nullptr) || adam != (step0 != nullptr) ||
      (qat != 0) != (wq != nullptr))
    return static_cast<int>(cudaErrorInvalidValue);

  const size_t smem = static_cast<size_t>(shared) * sizeof(float);
  // Above the default 48 KB a launch needs the attribute raised first;
  // raise it only when a launch needs more than any before it.  (One
  // process, one card: the attribute is not tracked per device.)
  static size_t granted = 48 * 1024;
  if (smem > granted) {
    const cudaError_t err = cudaFuncSetAttribute(
        fused_train_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
    granted = smem;
  }
  const AdamRule rule{b1, b2, one_minus_b1, one_minus_b2, eps, weight_decay};
  fused_train_kernel<<<1, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<const float*>(y),
      n_rows / tile, tile, net, static_cast<const float*>(p_in),
      static_cast<float*>(p_out), static_cast<const float*>(mu_in),
      static_cast<const float*>(nu_in), static_cast<float*>(mu_out),
      static_cast<float*>(nu_out), static_cast<const int*>(step0),
      static_cast<float*>(losses), static_cast<float*>(act),
      static_cast<float*>(dz), static_cast<float*>(wq), lr, rule, qat);
  return static_cast<int>(cudaGetLastError());
}
