// GroupNorm(+SiLU) forward for NCHW activations, hand-written for Hopper (sm_90a).
//
// Replaces the TPU kernel `_kernel` / `_fused_fwd` in
// lidar_layout_tpu/ops/pallas_groupnorm.py (GroupNorm with f32 statistics,
// per-channel affine, optional fused SiLU, eps 1e-6).
//
// What bounds it on this card: bytes. It does about 15 f32 operations per
// element, a few per byte moved, against the ~20 f32 operations per byte
// (67 TFLOP/s over 3.35 TB/s) at which the H100 turns compute-bound, so the
// least time is one read of x plus one write of y at the memory rate.
//
// Design:
//   * In NCHW each (batch, group) is one contiguous span of C/G * H * W
//     elements, so one block owns one span and nothing crosses blocks.
//   * Statistics are exact two-pass quality without a second read: every
//     thread walks its 16-byte packs, takes each pack's mean and centred sum of
//     squares in registers, and folds them into a running (n, mean, M2) with
//     Chan's parallel update; warps and then the block fold the same way.
//     This is held to the two-pass `_ref` formula, not to the TPU kernel's
//     clamped E[x^2] - E[x]^2, which cancels badly on groups of 262K values.
//   * All of it runs on x minus the group's first element, a shift that
//     every thread reads. x - shift is exact for x within a factor 2 of the
//     shift (Sterbenz), so a large common offset costs no precision: the
//     mean is never formed near the offset, where an f32 ulp can be a sizable
//     part of the spread.
//   * The second sweep re-reads the span (often from L2), applies the
//     per-channel affine and the optional SiLU, and writes the input dtype.
//     So the kernel moves 2 reads + 1 write where the bound counts 1 + 1.
//   * 16-byte vector loads when H*W is a multiple of the pack width, so a
//     pack never straddles two channels; scalar loads otherwise.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 512;

struct Stat {
  float n, mean, m2;
};

__device__ __forceinline__ Stat merge(Stat a, Stat b) {
  const float n = a.n + b.n;
  if (n == 0.f) return a;
  const float delta = b.mean - a.mean;
  const float wb = b.n / n;
  return Stat{n, a.mean + delta * wb, a.m2 + b.m2 + delta * delta * a.n * wb};
}

__device__ __forceinline__ Stat shfl_xor(Stat s, int off) {
  return Stat{__shfl_xor_sync(0xffffffffu, s.n, off),
              __shfl_xor_sync(0xffffffffu, s.mean, off),
              __shfl_xor_sync(0xffffffffu, s.m2, off)};
}

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T>
__device__ __forceinline__ T from_f(float x);
template <>
__device__ __forceinline__ float from_f<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

template <typename T, int V>
struct alignas(sizeof(T) * V) Pack {
  T v[V];
};

template <typename T, int V>
__global__ void __launch_bounds__(kThreads)
group_norm_fwd(const T* __restrict__ x, const float* __restrict__ gamma,
               const float* __restrict__ beta, T* __restrict__ y, int C, int G,
               int hw, float eps, int act) {
  const int bg = blockIdx.x;  // b * G + g
  const int g = bg % G;
  const int cpg = C / G;
  const int npack = cpg * hw / V;
  const long long base = (long long)bg * cpg * hw;
  const Pack<T, V>* xp = reinterpret_cast<const Pack<T, V>*>(x + base);
  Pack<T, V>* yp = reinterpret_cast<Pack<T, V>*>(y + base);

  const float shift = to_f(x[base]);
  Stat s{0.f, 0.f, 0.f};
  for (int i = threadIdx.x; i < npack; i += kThreads) {
    const Pack<T, V> p = xp[i];
    float f[V];
    float pm = 0.f;
#pragma unroll
    for (int j = 0; j < V; ++j) {
      f[j] = to_f(p.v[j]) - shift;
      pm += f[j];
    }
    pm *= 1.f / V;
    float pm2 = 0.f;
#pragma unroll
    for (int j = 0; j < V; ++j) {
      const float d = f[j] - pm;
      pm2 += d * d;
    }
    s = merge(s, Stat{(float)V, pm, pm2});
  }

  __shared__ Stat warp_stat[kThreads / 32];
  __shared__ float sh_mean, sh_rstd;
  const int lane = threadIdx.x & 31, wid = threadIdx.x >> 5;
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) s = merge(s, shfl_xor(s, off));
  if (lane == 0) warp_stat[wid] = s;
  __syncthreads();
  if (wid == 0) {
    s = lane < kThreads / 32 ? warp_stat[lane] : Stat{0.f, 0.f, 0.f};
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) s = merge(s, shfl_xor(s, off));
    if (lane == 0) {
      sh_mean = s.mean;  // of x - shift
      sh_rstd = rsqrtf(s.m2 / s.n + eps);
    }
  }
  __syncthreads();
  const float mean = sh_mean, rstd = sh_rstd;

  for (int i = threadIdx.x; i < npack; i += kThreads) {
    const int c = g * cpg + (i * V) / hw;
    const float sc = gamma[c] * rstd, sh = beta[c];
    const Pack<T, V> p = xp[i];
    Pack<T, V> o;
#pragma unroll
    for (int j = 0; j < V; ++j) {
      float v = ((to_f(p.v[j]) - shift) - mean) * sc + sh;
      if (act) v = v / (1.f + expf(-v));
      o.v[j] = from_f<T>(v);
    }
    yp[i] = o;
  }
}

template <typename T, int V>
void launch(const void* x, const void* gamma, const void* beta, void* y, int B,
            int C, int G, int hw, float eps, int act, cudaStream_t stream) {
  group_norm_fwd<T, V><<<B * G, kThreads, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const float*>(gamma),
      static_cast<const float*>(beta), static_cast<T*>(y), C, G, hw, eps, act);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. x, y: contiguous (B, C, H*W); gamma, beta:
// float32 (C,). Returns cudaGetLastError() after the launch.
extern "C" int llt_group_norm_fwd(const void* x, const void* gamma,
                                  const void* beta, void* y, int dtype, int B,
                                  int C, int G, int hw, float eps, int act,
                                  void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    if (hw % 4 == 0)
      launch<float, 4>(x, gamma, beta, y, B, C, G, hw, eps, act, st);
    else
      launch<float, 1>(x, gamma, beta, y, B, C, G, hw, eps, act, st);
  } else if (dtype == 1) {
    if (hw % 8 == 0)
      launch<__nv_bfloat16, 8>(x, gamma, beta, y, B, C, G, hw, eps, act, st);
    else
      launch<__nv_bfloat16, 1>(x, gamma, beta, y, B, C, G, hw, eps, act, st);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
