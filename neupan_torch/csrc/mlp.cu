// The DUNE point encoder, fused, with its products on the tensor cores:
//   2 -> 32 [LayerNorm, tanh] -> 32 [ReLU] -> 32 [LayerNorm, tanh]
//     -> 32 [ReLU] -> 32 [LayerNorm, tanh] -> E [ReLU].
//
// Replaces neupan_tpu/ops/pallas/mlp.py:dune_mlp_pallas (_mlp_kernel). The
// TPU kernel feeds a tile of points to the matrix unit; here each warp
// carries 16 * MT points at a time through the whole network in registers.
//
// Products: mma.sync m16n8k8 in TF32, points as the M side, kept at float32
// accuracy by error-compensated TF32 ("3xTF32", as CUTLASS's
// OpMultiplyAddFastF32): every operand is split into a TF32 high part and
// a TF32 low part, and a product is hi*hi + hi*lo + lo*hi; the dropped
// lo*lo is below float32 rounding. The weights come split and laid out as
// B fragments from the packing (ops/kernels/mlp.py:pack_weights), so only
// the hidden state is split here, by integer adds and masks. The two cross
// terms add into an accumulator of their own and join the main one once
// per layer; where the main one's own sums are rounded is set out at dense().
//
// Layout: a point's 32 features lie across the 4 lanes of a quad, 8 each,
// as the accumulator fragment leaves them (lane 4g + t holds features
// 8j + 2t and 8j + 2t + 1 of rows g and g + 8). The packing permutes the
// rows of each weight matrix so that this accumulator fragment is, register
// for register, the next product's A fragment: no shuffle and no shared
// memory tile sits between two layers. LayerNorm's mean and variance are a
// quad sum each (two __shfl_xor_sync); tanh, ReLU and the affine step run
// on the fragment in place. The 2 -> 32 layer is 64 float32 FMAs per point
// on the CUDA cores.
//
// What bounds it is the rate of mma.sync: three TF32 passes are 204 mma per
// 16 points, and the same kernel without tanh still takes 1.89 of its 2.43
// ms at N = 11.5M, ~13.5 cycles per mma on an SM sub-partition, a third of
// the rate Hopper's warpgroup mma (wgmma) reaches. Around them sit ~150 warp
// instructions per point, a third of them the 96 accurate tanhf (each 2
// MUFU and 13 other instructions), then the operand splits, the LayerNorms
// and the adds that keep the sums accurate. One warp step carries 16
// points (MT = 1): 32 ran slower at twice the registers. The B fragments
// (36.5 KB with the biases and LayerNorm parameters) sit in shared memory,
// one 16-byte load feeding 3 * MT products. Blocks walk over the warp tiles
// with a grid stride, so a block copies the weights once for many tiles;
// the ragged end is a predicate. See ops/kernels/mlp.py for the bounds and
// PERF.md for the measured variants (scripts/exp_mlp_timing.py).
#include <cstdint>

#include "common.cuh"

namespace {

constexpr int H = 32;          // hidden width
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int MT = 1;          // 16-point m-tiles a warp carries at once
constexpr int kTilePoints = 16 * MT;
constexpr float kLnEps = 1e-5f;

// The packed buffer: the plain section (what ops/kernels/mlp.py:
// dune_mlp_plain reads, 4,776 floats), then the kernel's section, whose
// offsets (in floats) follow. Every block starts on a 16-byte boundary.
constexpr int kPlain = 4776;
constexpr int KW0 = 0, KB0 = KW0 + 2 * H, KLN0S = KB0 + H, KLN0B = KLN0S + H;
constexpr int KB1 = KLN0B + H, KB2 = KB1 + H, KLN1S = KB2 + H, KLN1B = KLN1S + H;
constexpr int KB3 = KLN1B + H, KB4 = KB3 + H, KLN2S = KB4 + H, KLN2B = KLN2S + H;
constexpr int KB5 = KLN2B + H;
// B fragments: [k-step][n-tile][lane] x {hi row 2t, hi row 2t+1, lo row 2t, lo row 2t+1}
constexpr int kFragHidden = 4 * 4 * 32 * 4;
constexpr int KF1 = KB5 + 8, KF2 = KF1 + kFragHidden, KF3 = KF2 + kFragHidden;
constexpr int KF4 = KF3 + kFragHidden, KF5 = KF4 + kFragHidden;
constexpr int kKernel = KF5 + 4 * 32 * 4;   // 9,128 floats
static_assert(kPlain % 4 == 0 && KF1 % 4 == 0 && kKernel % 4 == 0, "16-byte blocks");

// x rounded to TF32, to nearest with ties away from zero: cvt.rna.tf32.f32
// without its NaN case, which costs three more instructions on sm_90a.
__device__ __forceinline__ uint32_t tf32(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
}

// The same rounding for an operand that only the tensor cores read: they
// ignore the 13 low bits, so adding half a TF32 unit is enough.
__device__ __forceinline__ uint32_t tf32_operand(float x) { return __float_as_uint(x) + 0x1000u; }

// d += a b for one m16n8k8 TF32 tile, float32 accumulator.
__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                    uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ float act(float v) { return tanhf(v); }

__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

// A fragment x[m][j][i] of the hidden state: m-tile m, features 8j + 2t +
// (i & 1) of row g (i < 2) or g + 8 (i >= 2).
using Frag = float[MT][4][4];

// The 2 -> 32 layer on the CUDA cores: o = b + x w0[0] + y w0[1], as the
// plain version orders it. Points past N read as 0 and are never stored.
__device__ __forceinline__ void first_layer(const float* __restrict__ points, long long base,
                                            long long N, const float* __restrict__ w, Frag& x,
                                            int g, int t) {
#pragma unroll
  for (int m = 0; m < MT; ++m) {
    float2 p[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const long long n = base + 16 * m + 8 * r + g;
      p[r] = n < N ? reinterpret_cast<const float2*>(points)[n] : make_float2(0.0f, 0.0f);
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int f = 8 * j + 2 * t;
      const float2 b = *reinterpret_cast<const float2*>(w + KB0 + f);
      const float2 wx = *reinterpret_cast<const float2*>(w + KW0 + f);
      const float2 wy = *reinterpret_cast<const float2*>(w + KW0 + H + f);
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        x[m][j][2 * r] = fmaf(p[r].y, wy.x, fmaf(p[r].x, wx.x, b.x));
        x[m][j][2 * r + 1] = fmaf(p[r].y, wy.y, fmaf(p[r].x, wx.y, b.y));
      }
    }
  }
}

// y = b + x W on the tensor cores, NT n-tiles of 8 output columns.
//
// The tensor cores truncate the sums of an mma, so a sum carried through
// one accumulator drifts by a few units in its last place, always the same
// way (carried through it in every layer, the kernel sat 1.8x further from
// float64 on the acker checkpoint). Before a LayerNorm (kNearest false)
// that drift is nearly the same for all 32 outputs where it matters, at
// nearly equal activations, and leaves with the mean; before a ReLU or at
// the head (kNearest true) it would not, so there each k-step's hi*hi tile
// starts from zero and is added to y rounding to nearest.
template <int NT, bool kNearest>
__device__ __forceinline__ void dense(const float4* __restrict__ frag,
                                      const float* __restrict__ bias, const Frag& x,
                                      float (&y)[MT][NT][4], int lane) {
  const int t = lane & 3;
  float cross[MT][NT][4];
#pragma unroll
  for (int j = 0; j < NT; ++j) {
    const float2 b = *reinterpret_cast<const float2*>(bias + 8 * j + 2 * t);
#pragma unroll
    for (int m = 0; m < MT; ++m) {
      y[m][j][0] = b.x, y[m][j][1] = b.y, y[m][j][2] = b.x, y[m][j][3] = b.y;
#pragma unroll
      for (int i = 0; i < 4; ++i) cross[m][j][i] = 0.0f;
    }
  }
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    // A fragment of k-step kk: (row g, col t), (g + 8, t), (g, t + 4), (g + 8, t + 4),
    // which the packing's row order maps to x[m][kk][0], [2], [1], [3]
    uint32_t hi[MT][4], lo[MT][4];
#pragma unroll
    for (int m = 0; m < MT; ++m) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float v = x[m][kk][(i >> 1) | ((i & 1) << 1)];
        hi[m][i] = tf32(v);
        lo[m][i] = tf32_operand(v - __uint_as_float(hi[m][i]));
      }
    }
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      const float4 b = frag[(kk * NT + j) * 32 + lane];
      const uint32_t bh0 = __float_as_uint(b.x), bh1 = __float_as_uint(b.y);
      const uint32_t bl0 = __float_as_uint(b.z), bl1 = __float_as_uint(b.w);
#pragma unroll
      for (int m = 0; m < MT; ++m) {
        mma(cross[m][j], lo[m], bh0, bh1);
        mma(cross[m][j], hi[m], bl0, bl1);
        if (kNearest) {
          float p[4] = {0.0f, 0.0f, 0.0f, 0.0f};
          mma(p, hi[m], bh0, bh1);
#pragma unroll
          for (int i = 0; i < 4; ++i) y[m][j][i] += p[i];
        } else {
          mma(y[m][j], hi[m], bh0, bh1);
        }
      }
    }
  }
#pragma unroll
  for (int m = 0; m < MT; ++m)
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int i = 0; i < 4; ++i) y[m][j][i] += cross[m][j][i];
}

// x <- tanh(LayerNorm(x) * scale + bias) per point, biased variance, eps 1e-5.
__device__ __forceinline__ void ln_tanh(Frag& x, const float* __restrict__ scale,
                                        const float* __restrict__ bias, int t) {
#pragma unroll
  for (int m = 0; m < MT; ++m) {
    float mean[2], inv[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float s = 0.0f;
#pragma unroll
      for (int j = 0; j < 4; ++j) s += x[m][j][2 * r] + x[m][j][2 * r + 1];
      mean[r] = quad_sum(s) * (1.0f / H);
      float v = 0.0f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
#pragma unroll
        for (int i = 2 * r; i < 2 * r + 2; ++i) {
          x[m][j][i] -= mean[r];
          v = fmaf(x[m][j][i], x[m][j][i], v);
        }
      }
      const float var = quad_sum(v) * (1.0f / H) + kLnEps;
      const float r0 = rsqrtf(var);   // and one Newton step: within an ulp of 1 / sqrt
      inv[r] = r0 * fmaf(-0.5f * var * r0, r0, 1.5f);
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const float2 sc = *reinterpret_cast<const float2*>(scale + 8 * j + 2 * t);
      const float2 bi = *reinterpret_cast<const float2*>(bias + 8 * j + 2 * t);
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        x[m][j][2 * r] = act(fmaf(x[m][j][2 * r] * inv[r], sc.x, bi.x));
        x[m][j][2 * r + 1] = act(fmaf(x[m][j][2 * r + 1] * inv[r], sc.y, bi.y));
      }
    }
  }
}

template <int NT>
__device__ __forceinline__ void relu(float (&x)[MT][NT][4]) {
#pragma unroll
  for (int m = 0; m < MT; ++m)
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int i = 0; i < 4; ++i) x[m][j][i] = fmaxf(x[m][j][i], 0.0f);
}

__global__ void __launch_bounds__(kThreads)
dune_mlp_kernel(const float* __restrict__ points, const float* __restrict__ packed,
                float* __restrict__ out, long long N, int E) {
  __shared__ __align__(16) float w[kKernel];
  const float4* src = reinterpret_cast<const float4*>(packed + kPlain);
  for (int e = threadIdx.x; e < kKernel / 4; e += kThreads) reinterpret_cast<float4*>(w)[e] = src[e];
  __syncthreads();
  const float4* frag = reinterpret_cast<const float4*>(w);

  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const long long tiles = (N + kTilePoints - 1) / kTilePoints;
  const long long stride = static_cast<long long>(gridDim.x) * kWarps;
  for (long long tile = static_cast<long long>(blockIdx.x) * kWarps + (threadIdx.x >> 5);
       tile < tiles; tile += stride) {
    const long long base = tile * kTilePoints;
    Frag a, c;
    first_layer(points, base, N, w, a, g, t);
    ln_tanh(a, w + KLN0S, w + KLN0B, t);
    dense<4, true>(frag + KF1 / 4, w + KB1, a, c, lane);
    relu(c);
    dense<4, false>(frag + KF2 / 4, w + KB2, c, a, lane);
    ln_tanh(a, w + KLN1S, w + KLN1B, t);
    dense<4, true>(frag + KF3 / 4, w + KB3, a, c, lane);
    relu(c);
    dense<4, false>(frag + KF4 / 4, w + KB4, c, a, lane);
    ln_tanh(a, w + KLN2S, w + KLN2B, t);
    float mu[MT][1][4];
    dense<1, true>(frag + KF5 / 4, w + KB5, a, mu, lane);
    relu(mu);
    // head columns 2t and 2t + 1 of rows g and g + 8
    const int col = 2 * t;
#pragma unroll
    for (int m = 0; m < MT; ++m) {
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const long long n = base + 16 * m + 8 * r + g;
        if (n >= N || col >= E) continue;
        if (E % 2 == 0) {
          *reinterpret_cast<float2*>(out + n * E + col) =
              make_float2(mu[m][0][2 * r], mu[m][0][2 * r + 1]);
        } else {
          out[n * E + col] = mu[m][0][2 * r];
          if (col + 1 < E) out[n * E + col + 1] = mu[m][0][2 * r + 1];
        }
      }
    }
  }
}

}  // namespace

extern "C" int dune_mlp_packed_size() { return kPlain + kKernel; }

extern "C" int dune_mlp_launch(const void* points, const void* packed, void* out,
                               long long N, int E, void* stream) {
  static int cap = 0;   // blocks that fit on the card at once
  if (cap == 0) {
    int dev = 0, sms = 0, per_sm = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err == cudaSuccess)
      err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, dune_mlp_kernel, kThreads, 0);
    if (err != cudaSuccess) return static_cast<int>(err);
    cap = sms * (per_sm > 0 ? per_sm : 1);
  }
  const long long blocks = (N + kTilePoints * kWarps - 1) / (kTilePoints * kWarps);
  const int grid = static_cast<int>(blocks < cap ? blocks : cap);
  dune_mlp_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(points), static_cast<const float*>(packed),
      static_cast<float*>(out), N, E);
  return static_cast<int>(cudaGetLastError());
}
