// Nearest-neighbour squared distance (one direction of the chamfer distance),
// hand-written for Hopper (sm_90a).
//
// Replaces the TPU kernel `_nn_kernel` / `nn_dist_pallas` in
// lidar_layout_tpu/ops/pallas_chamfer.py: for each x point, the squared
// distance to the nearest valid y point. It is held to the XLA path
// (`ops/chamfer.nn_dist_one_way`): distances are >= 0, and an x whose y set
// is all masked gets BIG = 1e10 (the wrapper's fill), not the Pallas
// kernel's sentinel distance. The value returned is the direct form
//     d(x, y) = fl(fl(fl(dx dx) + dy dy) + dz dz),  d. = x. - y.  (two FMAs),
// minimised over every valid y: the same bits as a kernel that forms the
// direct form for every pair.
//
// What bounds it on this card. The work is N*M pairs (775 M a launch on the
// eval's clouds, 22K x 35K points) on 12 bytes a point. Forming the direct
// form costs 7 issue slots a pair on the CUDA cores (3 FADD, 1 FMUL, 2 FFMA,
// 1 FMNMX), which held the previous design of this kernel at about 76% of
// what that form can reach. The expansion |x|^2 + |y|^2 - 2 x.y is one
// product of depth 4, work for the tensor cores, and leaves one operation a
// pair that no tensor core can do: the minimum. So the least time is the
// pairs at the FMNMX rate (64 a clock per SM on compute capability 9.0).
//
// Design, two stages:
//  1. Candidates on the tensor cores. With every point translated by one
//     centre c (the mean of 64 valid y sampled at fixed indices; x' = x - c,
//     y' = y - c in f32) and rounded to TF32 (xh, yh: the low 13 mantissa
//     bits cleared), v~ = |yh|^2 - 2 xh.yh is one mma.sync m16n8k8 TF32
//     product of depth 8:
//       A(x) = [-2xh0, -2xh1, -2xh2, 1, 1, 0, 0, 0]
//       B(y) = [  yh0,   yh1,   yh2, sh, sl, *, *, *]
//     with s = |yh|^2 in f32 split into two TF32 values, sh + sl. So v~ +
//     |xh|^2 = |xh - yh|^2 up to the sum's roundings, and one product serves
//     16 x by 8 y. Masked and ragged y get zero coordinates and sh = +inf (an
//     infinite coordinate would make 0 * inf = NaN inside the mma). The *
//     slots, multiplied by A's zeros, carry y's original coordinates for
//     stage 2. A warp takes 32 x rows (two m16 tiles); the y records (32
//     bytes: B's two k values of each lane t = 0..3 as one float2) stream
//     through shared memory by cp.async, one LDS.64 a lane feeding two
//     products. Per 64 y (a chunk) a lane keeps the least of its values for
//     each of its 4 rows: one FMNMX a pair.
//  2. Exact re-check in the direct form. Let D = |x' - y'|^2, r = sqrt(D),
//     R = |x'|, w = |x'| + |y'| <= 2R + r. Per pair
//       |v~ + |xh|^2 - D| <= 2^-9 w r + 2^-18 w^2:
//       * truncation moves each coordinate by under 2^-10 of itself, so
//         |xh - yh| differs from |x' - y'| by under 2^-10 w, and the squares
//         by under 2^-9 w r + 2^-20 w^2;
//       * the products of TF32 values are exact in f32; the tensor cores'
//         sum of the 5 products (and C) is taken to err by at most one unit
//         of 2^-23 of the sum of magnitudes a term (truncation to the
//         largest exponent): < 6 * 2^-23 w^2, with s's roundings < 2^-19 w^2.
//     K4 uses e(r) = 1.1 (2^-9 (2R + r) r + 2^-16 (2R + r)^2): the factor 4 on
//     the w^2 term is room for the tensor cores' summation, which NVIDIA
//     does not document, and 1.1 covers the roundings of the translation and
//     of the direct form. Let m = min_y v~, ya its y, and y* the y whose
//     direct form is least. Any y with v~ <= m has r^2 - e(r) <= m + |xh|^2,
//     so r <= r_max, the root of that quadratic; D(y*) <= D(ya), so both lie
//     within r_max, and v~(y*) <= D(y*) - |xh|^2 + e <= m + 2 e(r_max) =
//     tau(m). So every y with v~ <= tau(m) is re-checked in the direct form
//     on the original coordinates, and the least of those is the answer: y*
//     is always among them. tau grows with m, so any upper bound of m gives
//     a larger set: per chunk the row's least value over its 4 lanes (two
//     shuffles) lowers the row's running m and tau, and a lane's chunk
//     passes when its own least value is under tau. A chunk that passes is
//     not re-checked at once (that would stop the warp): the row keeps it in
//     a short list in shared memory (kList entries; an entry above the
//     current tau is free; a full list gives its largest entry's value to an
//     overflow value), and at the end of the split each lane forms the
//     direct form of its 16 y of every listed chunk under the row's final
//     tau (the y from a compact copy in L2, eight loads in flight), or of
//     all its y of the split if the overflow value is under it. So a chunk
//     that passed only while m was still falling costs a few instructions.
//   * Splits over y fill the 132 SMs (each split is its own search with its
//     own m); each folds its minimum into the output with atomicMin on the
//     int bit pattern, which orders non-negative floats as the floats
//     themselves, so the result is exact and independent of block order.
//     The wrapper fills the output with BIG (or +inf without a mask) first.
//   * A first small kernel writes the y records, their compact copy and c
//     once a launch. ptxas (sm_90a, CUDA 12.8): 106 registers and no stack
//     for the main kernel, so two blocks of 8 warps an SM.
//   * With `counts` (measurement only), each x counts the direct forms it
//     formed, counts[n] gets the number of splits, and counts[n + 1] the
//     largest |v~ + |xh|^2 - d| / (2^-9 w r + (2^-18 + 2^-20) w^2) over the
//     pairs under tau in the chunks that passed (their products recomputed),
//     as float bits: the error model checked on the card.
//   * Tried on the H100 (chip_smoke.py, timing phase, the eval's 64
//     launches; 14.0 ms for the direct form on every pair): two products a
//     tile (k = 16, each coordinate split into two TF32 values) with the
//     re-check at once, 27.5 ms; one product a tile with the re-check at
//     once, 26.1 ms with the chunk's 64 values held in registers for it,
//     31.6 ms once they spilled, 23.6 ms recomputing the chunk's products
//     after a first bound from the split's first tile; the list, 12.2 ms.
//     The re-checks at once stopped the warp whenever one of its 128 (row,
//     lane) streams set a new minimum, which happens often early in every
//     split.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "mma_tiles.cuh"

namespace {

using mma_tiles::cp_async16;
using mma_tiles::cp_async_commit;
using mma_tiles::cp_async_wait;
using mma_tiles::smem_addr;

constexpr int kThreads = 256;                        // 8 warps
constexpr int kMaxDevices = 64;  // devices whose launch set-up is remembered
constexpr int kRowsWarp = 32;                        // two m16 tiles a warp
constexpr int kXBlock = kThreads / 32 * kRowsWarp;   // x points a block
constexpr int kTileY = 512;                          // y records a stage (16 KB)
constexpr int kStages = 3;                           // stages in the cp.async ring
constexpr int kChunk = 64;                           // y a candidate test (8 n8 tiles)
constexpr int kCentreSamples = 64;
constexpr int kList = 4;                             // deferred chunks a row and lane

struct __align__(16) Rec {
  float2 t[4];  // lane t's B values for k = t and t + 4
};

__device__ __forceinline__ float tf32_hi(float v) {
  return __uint_as_float(__float_as_uint(v) & 0xffffe000u);
}

// The bound e(r) on |v~ + |xh|^2 - D| for a y at distance r = sqrt(D) from
// x (R = |x'|), with its margins: 1.1 (2^-9 (2R + r) r + 2^-16 (2R + r)^2).
// tau(m) = m + 2 e(r_max), where r_max is the largest r with r^2 - e(r) <=
// max(m + |xh|^2, 0): no y beyond r_max can have v~ <= m.
__device__ __forceinline__ float tau_of(float m, float R, float xh2) {
  constexpr float a = 0x1p-9f, b = 0x1p-16f;
  const float a2 = 1.1f * (a + b), a1 = 1.1f * (2.f * a + 4.f * b) * R,
              a0 = 1.1f * 4.f * b * R * R;
  const float dm = fmaxf(m + xh2, 0.f);
  const float r = (a1 + sqrtf(a1 * a1 + 4.f * (1.f - a2) * (a0 + dm))) / (2.f * (1.f - a2));
  return m + 2.f * (r * (a2 * r + a1) + a0);
}

// the direct form, the same operations as the kernel it replaces
__device__ __forceinline__ float direct(float px, float py, float pz, float qx, float qy,
                                        float qz) {
  const float dx = px - qx, dy = py - qy, dz = pz - qz;
  float d = dx * dx;
  d = fmaf(dy, dy, d);
  return fmaf(dz, dz, d);
}

// D = A B, one m16n8k8 TF32 product, C = 0
__device__ __forceinline__ void mma_k8(float (&d)[4], const uint32_t (&a)[4], const float2& b) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, "
      "{%8,%9}, {%10,%10,%10,%10};\n"
      : "=f"(d[0]), "=f"(d[1]), "=f"(d[2]), "=f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(__float_as_uint(b.x)),
        "r"(__float_as_uint(b.y)), "f"(0.f));
}

// c: the mean of up to 64 valid y at fixed indices, by warp 0, in a fixed
// order (0 if none is valid or the mean is not finite)
__device__ float3 cloud_centre(const float* y, const uint8_t* mask, int m) {
  const int lane = threadIdx.x & 31;
  float s[4] = {0.f, 0.f, 0.f, 0.f};
  for (int k = lane; k < kCentreSamples; k += 32) {
    const long long i = (long long)k * m / kCentreSamples;
    if (mask == nullptr || mask[i]) {
      s[0] += y[3 * i];
      s[1] += y[3 * i + 1];
      s[2] += y[3 * i + 2];
      s[3] += 1.f;
    }
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
#pragma unroll
    for (int j = 0; j < 4; ++j) s[j] += __shfl_xor_sync(0xffffffffu, s[j], off);
  float3 c = make_float3(0.f, 0.f, 0.f);
  if (s[3] > 0.f) c = make_float3(s[0] / s[3], s[1] / s[3], s[2] / s[3]);
  if (!(isfinite(c.x) && isfinite(c.y) && isfinite(c.z))) c = make_float3(0.f, 0.f, 0.f);
  return c;
}

// one record per y, m_pad of them (the ragged tail masked); c into centre
__global__ void __launch_bounds__(256)
nn_prep(const float* __restrict__ y, const uint8_t* __restrict__ y_mask, Rec* __restrict__ rec,
        float4* __restrict__ pts, float4* __restrict__ centre, int m, int m_pad) {
  __shared__ float3 cs;
  if (threadIdx.x < 32) {
    const float3 c = cloud_centre(y, y_mask, m);
    if (threadIdx.x == 0) {
      cs = c;
      if (blockIdx.x == 0) *centre = make_float4(c.x, c.y, c.z, 0.f);
    }
  }
  __syncthreads();
  const int j = blockIdx.x * 256 + threadIdx.x;
  if (j >= m_pad) return;
  float o[3] = {0.f, 0.f, 0.f}, h[3] = {0.f, 0.f, 0.f};
  float sh = INFINITY, sl = 0.f;
  const bool valid = j < m && (y_mask == nullptr || y_mask[j]);
  if (valid) {
    const float c[3] = {cs.x, cs.y, cs.z};
#pragma unroll
    for (int i = 0; i < 3; ++i) {
      o[i] = y[3ll * j + i];
      h[i] = tf32_hi(o[i] - c[i]);
    }
    float s = h[0] * h[0];  // |yh|^2: the squares are exact, two roundings
    s = fmaf(h[1], h[1], s);
    s = fmaf(h[2], h[2], s);
    sh = tf32_hi(s);
    sl = tf32_hi(s - sh);
  }
  Rec r;  // B = [yh0, yh1, yh2, sh, sl, o0, o1, o2]
  r.t[0] = make_float2(h[0], sl);
  r.t[1] = make_float2(h[1], o[0]);
  r.t[2] = make_float2(h[2], o[1]);
  r.t[3] = make_float2(sh, o[2]);
  rec[j] = r;
  // the re-check's copy: masked and ragged y at +inf, whose direct form is +inf
  pts[j] = valid ? make_float4(o[0], o[1], o[2], 0.f)
                 : make_float4(INFINITY, INFINITY, INFINITY, 0.f);
}

__global__ void __launch_bounds__(kThreads, 2)
nn_main(const float* __restrict__ x, const Rec* __restrict__ rec,
        const float4* __restrict__ pts, const float4* __restrict__ centre, float* __restrict__ out, int* __restrict__ counts,
        int n, int m_pad, int span) {
  extern __shared__ __align__(16) unsigned char smem[];
  Rec* tiles = reinterpret_cast<Rec*>(smem);  // kStages x kTileY
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const float4 c = *centre;
  const int row0 = blockIdx.x * kXBlock + warp * kRowsWarp + g;  // rows row0 + 8 i

  // this lane's 4 rows (i = 0, 1: m16 tile 0, rows g and g + 8; i = 2, 3:
  // tile 1) and its A values, A = [-2xh0, -2xh1, -2xh2, 1, 1, 0, 0, 0] at
  // k = t and t + 4
  float px[4], py[4], pz[4], R[4], xh2[4], best[4], tau[4], r[4];
  int nd[4];
  uint32_t a[2][4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = row0 + 8 * i;
    const bool in = row < n;  // rows past n sit on c: x' = 0
    px[i] = in ? x[3ll * row] : c.x;
    py[i] = in ? x[3ll * row + 1] : c.y;
    pz[i] = in ? x[3ll * row + 2] : c.z;
    const float ex = px[i] - c.x, ey = py[i] - c.y, ez = pz[i] - c.z;
    R[i] = sqrtf(fmaf(ez, ez, fmaf(ey, ey, ex * ex)));  // |x'|, and |xh|^2, for tau
    const float hx = tf32_hi(ex), hy = tf32_hi(ey), hz = tf32_hi(ez);
    xh2[i] = fmaf(hz, hz, fmaf(hy, hy, hx * hx));
    const float h = -2.f * (t == 0 ? hx : t == 1 ? hy : hz);
    a[i >> 1][i & 1] = __float_as_uint(t == 3 ? 1.f : h);
    a[i >> 1][2 + (i & 1)] = __float_as_uint(t == 0 ? 1.f : 0.f);
    best[i] = tau[i] = r[i] = INFINITY;
    nd[i] = 0;
  }
  float worst = 0.f;
  auto lower = [&](int i, float m) {  // m, the new least value of row i: its tau
    best[i] = m;
    tau[i] = tau_of(m, R[i], xh2[i]);
  };

  const int y_begin = blockIdx.y * span;
  const int ntiles = (min(m_pad, y_begin + span) - y_begin) / kTileY;

  // The re-checks wait for the end of the split: each row keeps up to kList
  // chunks whose least value (in this lane's columns) passed tau when it was
  // seen, as (least value, chunk), in shared memory. tau only falls, so an
  // entry above the current tau holds no candidate and its slot is free.
  float2* list = reinterpret_cast<float2*>(smem + kStages * kTileY * sizeof(Rec));
  auto entry = [&](int i, int k) -> float2& {
    return list[(i * kList + k) * kThreads + threadIdx.x];
  };
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int k = 0; k < kList; ++k) entry(i, k) = make_float2(INFINITY, -1.f);
  // the direct form of row i against this lane's 16 y of chunk ch, read
  // from the compact copy in L2, eight loads in flight
  auto recheck = [&](int i, int ch) {
    const float4* base = pts + y_begin + ch * kChunk + 2 * t;
#pragma unroll
    for (int k0 = 0; k0 < kChunk / 4; k0 += 8) {
      float4 q[8];
#pragma unroll
      for (int k = 0; k < 8; ++k) q[k] = __ldg(base + ((k0 + k) >> 1) * 8 + (k & 1));
#pragma unroll
      for (int k = 0; k < 8; ++k) r[i] = fminf(r[i], direct(px[i], py[i], pz[i], q[k].x, q[k].y, q[k].z));
    }
    nd[i] += kChunk / 4;
  };
  // chunk ch's least value lo passed row i's tau: keep it in a free slot,
  // else in the slot of the largest value, whose value goes to the row's
  // overflow: if that is still under the final tau, the lane re-checks all
  // of its y of the split
  float* overflow = reinterpret_cast<float*>(list + 4 * kList * kThreads);
#pragma unroll
  for (int i = 0; i < 4; ++i) overflow[i * kThreads + threadIdx.x] = INFINITY;
  auto defer = [&](int i, float lo, int ch) {
    int worst_k = 0;
    float worst_lo = -INFINITY;  // values are v~ = D - |xh|^2, often negative
#pragma unroll
    for (int k = 0; k < kList; ++k) {
      const float2 e = entry(i, k);
      if (e.y < 0.f || e.x > tau[i]) {
        entry(i, k) = make_float2(lo, (float)ch);
        return;
      }
      if (e.x > worst_lo) {
        worst_lo = e.x;
        worst_k = k;
      }
    }
    float& o = overflow[i * kThreads + threadIdx.x];
    o = fminf(o, worst_lo);
    entry(i, worst_k) = make_float2(lo, (float)ch);
  };
  auto issue = [&](int j) {  // tile j into stage j % kStages
    if (j < ntiles) {
      const float4* src = reinterpret_cast<const float4*>(rec + y_begin + j * kTileY);
      float4* dst = reinterpret_cast<float4*>(tiles + (j % kStages) * kTileY);
#pragma unroll
      for (int v = threadIdx.x; v < kTileY * 2; v += kThreads)
        cp_async16(smem_addr(dst + v), src + v, true);
    }
    cp_async_commit();  // an empty group past the end keeps the count
  };
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) issue(s);

  for (int j = 0; j < ntiles; ++j) {
    cp_async_wait<kStages - 2>();
    __syncthreads();  // tile j has landed everywhere; tile j - 1's stage is free
    issue(j + kStages - 1);
    const Rec* tile = tiles + (j % kStages) * kTileY;
#pragma unroll 1
    for (int ch = 0; ch < kTileY / kChunk; ++ch) {
      const Rec* chunk = tile + ch * kChunk;
      float lo[4] = {INFINITY, INFINITY, INFINITY, INFINITY};
#pragma unroll
      for (int nt = 0; nt < kChunk / 8; ++nt) {
        const float2 b = chunk[nt * 8 + g].t[t];
        float d0[4], d1[4];
        mma_k8(d0, a[0], b);
        mma_k8(d1, a[1], b);
        lo[0] = fminf(lo[0], fminf(d0[0], d0[1]));
        lo[1] = fminf(lo[1], fminf(d0[2], d0[3]));
        lo[2] = fminf(lo[2], fminf(d1[0], d1[1]));
        lo[3] = fminf(lo[3], fminf(d1[2], d1[3]));
      }
      // the row's least value of the chunk over its 4 lanes: m and tau are
      // the row's, kept alike in its lanes
      bool any = false;
      float lq[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        lq[i] = fminf(lo[i], __shfl_xor_sync(0xffffffffu, lo[i], 1));
        lq[i] = fminf(lq[i], __shfl_xor_sync(0xffffffffu, lq[i], 2));
        any |= lq[i] <= tau[i] && lq[i] < INFINITY;
      }
      if (!__any_sync(0xffffffffu, any)) continue;
      const int chunk_index = j * (kTileY / kChunk) + ch;
      bool pass[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        if (lq[i] < best[i]) lower(i, lq[i]);
        pass[i] = lo[i] <= tau[i] && lo[i] < INFINITY;
        if (pass[i]) defer(i, lo[i], chunk_index);
      }
      if (counts != nullptr) {  // measurement: the error model, on these values
#pragma unroll 1
        for (int nt = 0; nt < kChunk / 8; ++nt) {
          const float2 b = chunk[nt * 8 + g].t[t];
          float d[2][4];
          mma_k8(d[0], a[0], b);
          mma_k8(d[1], a[1], b);
#pragma unroll
          for (int mt = 0; mt < 2; ++mt)
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              const int i = 2 * mt + (e >> 1);
              const float val = d[mt][e];
              if (pass[i] && val <= tau[i] && val < INFINITY) {
                const Rec& yr = chunk[nt * 8 + 2 * t + (e & 1)];
                const float qx = yr.t[1].y, qy = yr.t[2].y, qz = yr.t[3].y;
                const float dd = direct(px[i], py[i], pz[i], qx, qy, qz);
                const float ux = qx - c.x, uy = qy - c.y, uz = qz - c.z;
                const float w = R[i] + sqrtf(fmaf(uz, uz, fmaf(uy, uy, ux * ux)));
                const float model = 0x1p-9f * w * sqrtf(dd) + (0x1p-18f + 0x1p-20f) * w * w;
                worst = fmaxf(worst, fabsf(val + xh2[i] - dd) / model);
              }
            }
        }
      }
    }
  }
  // the deferred re-checks, against the row's final tau
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    if (overflow[i * kThreads + threadIdx.x] <= tau[i]) {
#pragma unroll 1
      for (int ch = 0; ch < ntiles * (kTileY / kChunk); ++ch) recheck(i, ch);
      continue;
    }
#pragma unroll 1
    for (int k = 0; k < kList; ++k) {
      const float2 e = entry(i, k);
      if (e.y >= 0.f && e.x <= tau[i]) recheck(i, (int)e.y);
    }
  }
  cp_async_wait<0>();  // no copy may outlive the block

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    r[i] = fminf(r[i], __shfl_xor_sync(0xffffffffu, r[i], 1));
    r[i] = fminf(r[i], __shfl_xor_sync(0xffffffffu, r[i], 2));
    const int row = row0 + 8 * i;
    if (t == 0 && row < n && r[i] < INFINITY)
      atomicMin(reinterpret_cast<int*>(out) + row, __float_as_int(r[i]));
  }
  if (counts != nullptr) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      nd[i] += __shfl_xor_sync(0xffffffffu, nd[i], 1);
      nd[i] += __shfl_xor_sync(0xffffffffu, nd[i], 2);
      const int row = row0 + 8 * i;
      if (t == 0 && row < n) atomicAdd(counts + row, nd[i]);
    }
    if (worst > 0.f) atomicMax(counts + n + 1, __float_as_int(worst));
    if (blockIdx.x == 0 && blockIdx.y == 0 && threadIdx.x == 0) counts[n] = gridDim.y;
  }
}

}  // namespace

// x: contiguous float32 (n, 3); y: contiguous float32 (m, 3); y_mask: bool
// (m,) stored as bytes, or null; out: float32 (n,), filled by the caller with
// the value for "no valid y"; rec: float32 scratch of 12 values for each of
// m_pad = ceil(m / 512) * 512 y (a record and a point), 16-byte aligned; centre: float32
// scratch of 4; counts: int32 (n + 2,) zeroed, or null (see the header).
// Returns cudaGetLastError() after the launches.
extern "C" int llt_chamfer_nn(const void* x, const void* y, const void* y_mask, void* out,
                              void* rec, void* centre, void* counts, int n, int m,
                              void* stream) {
  if (n <= 0 || m <= 0 || m > 0x7fffffff - kTileY) return (int)cudaErrorInvalidValue;
  int dev = 0, sms = 132;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int m_pad = (m + kTileY - 1) / kTileY * kTileY;
  Rec* recs = static_cast<Rec*>(rec);
  float4* pts = reinterpret_cast<float4*>(recs + m_pad);
  nn_prep<<<(m_pad + 255) / 256, 256, 0, st>>>(
      static_cast<const float*>(y), static_cast<const uint8_t*>(y_mask), recs, pts,
      static_cast<float4*>(centre), m, m_pad);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;

  constexpr int smem = kStages * kTileY * (int)sizeof(Rec) + 4 * kThreads * (8 * kList + 4);
  static bool ready[kMaxDevices] = {};   // the attribute is set on each device apart
  if (dev >= kMaxDevices || !ready[dev]) {
    cudaFuncSetAttribute(nn_main, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (dev < kMaxDevices) ready[dev] = true;
  }
  const int blocks_x = (n + kXBlock - 1) / kXBlock;
  const int tiles = m_pad / kTileY;
  // splits over y: the count (up to 16) whose blocks best fill whole waves
  // of the card's resident blocks, the fewest among equals
  int per_sm = 1;
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, nn_main, kThreads, smem);
  const long long wave = (long long)(per_sm > 0 ? per_sm : 1) * sms;
  int splits = 1;
  double fill = 0.0;
  for (int s = 1; s <= 16 && s <= tiles; ++s) {
    const long long blocks = (long long)blocks_x * s;
    const double f = (double)blocks / (double)(((blocks + wave - 1) / wave) * wave);
    if (f > fill + 1e-9) {
      fill = f;
      splits = s;
    }
  }
  const int span = (tiles + splits - 1) / splits * kTileY;  // whole tiles a split
  const dim3 grid(blocks_x, (m_pad + span - 1) / span);
  nn_main<<<grid, kThreads, smem, st>>>(
      static_cast<const float*>(x), recs, pts, static_cast<const float4*>(centre),
      static_cast<float*>(out), static_cast<int*>(counts), n, m_pad, span);
  return (int)cudaGetLastError();
}
