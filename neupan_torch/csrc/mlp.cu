// The DUNE point encoder, fused: one thread carries one point through
//   2 -> 32 [LayerNorm, tanh] -> 32 [ReLU] -> 32 [LayerNorm, tanh]
//     -> 32 [ReLU] -> 32 [LayerNorm, tanh] -> E [ReLU].
//
// Replaces neupan_tpu/ops/pallas/mlp.py:dune_mlp_pallas (_mlp_kernel). The
// TPU kernel tiles 512 points and feeds six products to the matrix unit;
// here the whole hidden state of a point (32 floats) lives in one thread's
// registers and the weights (4,776 floats, 19 KB, packed by
// ops/kernels/mlp.py:pack_weights) sit in shared memory, read as 16-byte
// broadcasts: every lane of a warp reads the same weight, so there is no
// bank conflict and no cross-thread reduction anywhere, LayerNorm
// included. Blocks walk over the points with a grid stride, so a block
// loads the weights once for many tiles, and the ragged end is a
// predicate, not a padded copy. Float32 FMAs, not the tensor cores: TF32
// keeps three digits and the contract against the plain version is 1e-5.
// The normalization divides by sqrtf (both correctly rounded without
// fast-math), and tanhf is the accurate one. See ops/kernels/mlp.py for
// the bound.
#include "common.cuh"

namespace {

constexpr int H = 32;        // hidden width
constexpr int EP = 8;        // head columns as packed (E <= 8, zero padded)
constexpr int kThreads = 256;
constexpr float kLnEps = 1e-5f;

// offsets into the packed weights, in floats (all multiples of 8, so every
// row is 16-byte aligned)
constexpr int W0 = 0, B0 = W0 + 2 * H, LN0S = B0 + H, LN0B = LN0S + H;
constexpr int W1 = LN0B + H, B1 = W1 + H * H;
constexpr int W2 = B1 + H, B2 = W2 + H * H, LN1S = B2 + H, LN1B = LN1S + H;
constexpr int W3 = LN1B + H, B3 = W3 + H * H;
constexpr int W4 = B3 + H, B4 = W4 + H * H, LN2S = B4 + H, LN2B = LN2S + H;
constexpr int W5 = LN2B + H, B5 = W5 + H * EP;
constexpr int kPacked = B5 + EP;  // 4,776

// o = b + h W for W (IN, OUT) row-major in shared memory.
template <int IN, int OUT>
__device__ __forceinline__ void dense(const float* __restrict__ W, const float* __restrict__ b,
                                      const float (&h)[IN], float (&o)[OUT]) {
#pragma unroll
  for (int j = 0; j < OUT; ++j) o[j] = b[j];
#pragma unroll
  for (int i = 0; i < IN; ++i) {
    const float4* row = reinterpret_cast<const float4*>(W + i * OUT);
    const float hi = h[i];
#pragma unroll
    for (int q = 0; q < OUT / 4; ++q) {
      const float4 w = row[q];
      o[4 * q + 0] = fmaf(hi, w.x, o[4 * q + 0]);
      o[4 * q + 1] = fmaf(hi, w.y, o[4 * q + 1]);
      o[4 * q + 2] = fmaf(hi, w.z, o[4 * q + 2]);
      o[4 * q + 3] = fmaf(hi, w.w, o[4 * q + 3]);
    }
  }
}

// x <- tanh(LayerNorm(x) * scale + bias), biased variance, eps 1e-5.
__device__ __forceinline__ void ln_tanh(float (&x)[H], const float* __restrict__ scale,
                                        const float* __restrict__ bias) {
  float mean = 0.0f;
#pragma unroll
  for (int j = 0; j < H; ++j) mean += x[j];
  mean *= 1.0f / H;
  float var = 0.0f;
#pragma unroll
  for (int j = 0; j < H; ++j) {
    x[j] -= mean;
    var = fmaf(x[j], x[j], var);
  }
  const float inv = 1.0f / sqrtf(var * (1.0f / H) + kLnEps);
#pragma unroll
  for (int j = 0; j < H; ++j) x[j] = tanhf(fmaf(x[j] * inv, scale[j], bias[j]));
}

__device__ __forceinline__ void relu(float (&x)[H]) {
#pragma unroll
  for (int j = 0; j < H; ++j) x[j] = fmaxf(x[j], 0.0f);
}

__global__ void __launch_bounds__(kThreads)
dune_mlp_kernel(const float* __restrict__ points, const float* __restrict__ packed,
                float* __restrict__ out, long long N, int E) {
  __shared__ __align__(16) float w[kPacked];
  for (int e = threadIdx.x; e < kPacked; e += kThreads) w[e] = packed[e];
  __syncthreads();

  const long long stride = static_cast<long long>(gridDim.x) * kThreads;
  for (long long n = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x; n < N;
       n += stride) {
    // The weight loads below do not depend on n; without this the compiler
    // hoists all 4,776 of them out of the loop and spills them to local
    // memory. The clobber makes it read shared memory anew for each point.
    asm volatile("" ::: "memory");
    const float2 p = reinterpret_cast<const float2*>(points)[n];
    const float in[2] = {p.x, p.y};
    float a[H], c[H];
    dense<2, H>(w + W0, w + B0, in, a);
    ln_tanh(a, w + LN0S, w + LN0B);
    dense<H, H>(w + W1, w + B1, a, c);
    relu(c);
    dense<H, H>(w + W2, w + B2, c, a);
    ln_tanh(a, w + LN1S, w + LN1B);
    dense<H, H>(w + W3, w + B3, a, c);
    relu(c);
    dense<H, H>(w + W4, w + B4, c, a);
    ln_tanh(a, w + LN2S, w + LN2B);
    float mu[EP];
    dense<H, EP>(w + W5, w + B5, a, mu);
#pragma unroll
    for (int j = 0; j < EP; ++j) mu[j] = fmaxf(mu[j], 0.0f);
    if (E == 4) {
      reinterpret_cast<float4*>(out)[n] = make_float4(mu[0], mu[1], mu[2], mu[3]);
    } else {
#pragma unroll
      for (int j = 0; j < EP; ++j)
        if (j < E) out[n * E + j] = mu[j];
    }
  }
}

}  // namespace

extern "C" int dune_mlp_packed_size() { return kPacked; }

extern "C" int dune_mlp_launch(const void* points, const void* packed, void* out,
                               long long N, int E, void* stream) {
  static int sms = 0;
  if (sms == 0) {
    int dev = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err == cudaSuccess)
      err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const long long tiles = (N + kThreads - 1) / kThreads;
  const long long cap = static_cast<long long>(sms) * 8;  // a few blocks in flight per SM
  const int grid = static_cast<int>(tiles < cap ? tiles : cap);
  dune_mlp_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(points), static_cast<const float*>(packed),
      static_cast<float*>(out), N, E);
  return static_cast<int>(cudaGetLastError());
}
