// GroupNorm(+SiLU) forward and backward for NCHW activations, hand-written
// for Hopper (sm_90a).
//
// Replaces the TPU kernel `_kernel` / `_fused_fwd` in
// lidar_layout_tpu/ops/pallas_groupnorm.py (GroupNorm with f32 statistics,
// per-channel affine, optional fused SiLU, eps 1e-6) and its analytic
// backward `_fused_vjp_bwd` there (plain jnp that XLA fuses).
//
// What bounds it on this card: bytes. The forward does about 10 f32
// operations an element and the backward about 26 (SiLU's exponential and
// reciprocal included), a few per byte moved, against the ~20 f32 operations
// a byte (67 TFLOP/s over 3.35 TB/s) at which the H100 turns compute-bound.
// So the least time is, forward, one read of x and one write of y; backward,
// one read of x and dy and one write of dx, at the memory rate.
//
// Design: a (batch, group) span is read from device memory once and stays on
// chip until its output is written. In NCHW each span is one contiguous run
// of C/G * H*W elements.
//   * On-chip path (group_norm_fwd_onchip, group_norm_bwd_onchip): one block,
//     or one thread block cluster of k = 2, 4 or 8 blocks, owns a span; each
//     block owns a contiguous slice. One thread copies the slice (x, and dy
//     in the backward) into shared memory with TMA bulk copies
//     (cp.async.bulk) that complete on one mbarrier, so the whole slice is in
//     flight at once and no register waits on it. k is the smallest that
//     keeps a slice within 96 KB (two blocks an SM), up to 8 blocks of at
//     most 192 KB. In the flagship at batch 16 in bf16 every U-Net span
//     (4-96 KB) and the decoder's 32-64 KB spans take one block; the
//     decoder's 128, 256 and 512 KB spans take clusters of 2, 4 and 8 (64 KB
//     a block, three blocks an SM). In the backward x and dy count together.
//   * Statistics are `_ref`'s two-pass formula over the block's slice: the
//     sum gives the mean, then the sum of squares about it is taken from the
//     same shared copy, each a block reduction (warp shuffles, one barrier).
//     In a cluster the k slices' (mean, M2) then cross blocks through
//     distributed shared memory after one cluster barrier and merge exactly
//     (equal slices: M2 = sum M2_r + n_r sum (mean_r - mean)^2), read in
//     rank order, so every block gets the same bits. A block arrives at a
//     second, split cluster barrier once it has read the others' sums and
//     waits on it only before it exits, so its normalising pass never waits
//     for the rest of the cluster.
//   * All of it runs on x minus the span's first element, a shift that every
//     block reads. x - shift is exact for x within a factor 2 of the shift
//     (Sterbenz), so a large common offset costs no precision: the mean is
//     never formed near the offset, where an f32 ulp can be a sizable part of
//     the spread.
//   * The block size follows the slice: 128 threads up to 512 16-byte packs
//     (8 KB, so the 4-8 KB groups keep every thread loading), 256 up to 2048
//     packs, 512 above. The normalising pass reads shared memory, finds each
//     pack's channel by a multiply-high, and writes 16-byte packs straight
//     to device memory.
//   * Backward: the same load and statistics, then one warp a run of packs
//     inside one channel sums g*xhat and g (g = dy, or dy * silu'(y) with
//     SiLU), in a fixed order, into that channel's partial of dgamma and dbeta
//     for this batch row; the block (and cluster) sums gamma-weighted
//     channel partials into m1 = mean(g*gamma) and m2 = mean(g*gamma*xhat),
//     and writes dx = (g*gamma - m1 - xhat*m2) * rstd. A block holds whole
//     channels (k divides C/G), so each (batch, channel) partial is written by
//     one block to an f32 (2, B, C) scratch; group_norm_param_sum sums it over
//     B in a fixed order. No float atomics: two launches agree bit for bit.
//   * Two-sweep path (group_norm_fwd_sweep, group_norm_bwd_sweep) for what
//     the on-chip path does not take: H*W not a multiple of the 16-byte pack
//     (scalar loads then), a pointer not 16-byte aligned, or a span larger
//     than 8 blocks hold: above 1.5 MB in the forward, above 768 KB of x in
//     the backward (so 192K f32 or 384K bf16 elements). The flagship's main
//     paths never take it. The forward sweeps twice (shifted pack statistics
//     folded by Chan's update, then normalise); the backward three times
//     (statistics, channel sums with one block reduction a channel, dx).
//   * Tried on the H100 and dropped, none faster at the decoder's shapes:
//     statistics taken part by part as the slice lands (two or four
//     mbarriers), persistent clusters that copy the next span while
//     normalising one (two buffers, one block an SM), 32-48 KB slices in
//     larger clusters, 256 or 1024 threads a block, one warp waiting on the
//     mbarrier, larger or smaller bulk copies, streaming stores. A shifted
//     one-pass sum of squares was slightly faster but is not `_ref`'s formula.
//
// Split form, for a tensor whose azimuth (W) is sharded over ranks (the
// spatial `sp` axis of parallel/): a group's statistics span every shard,
// and GSPMD, which splits the TPU kernel's reductions across devices for
// JAX, has no counterpart here. So the forward is two kernels around a
// collective:
//   * group_norm_stats: one block a (batch, group) span of this shard, 512
//     threads; `_ref`'s two passes over the span from device memory (the
//     sum gives the mean, then the sum of squares about it), each a block
//     reduction in a fixed order; it writes the shard's f32 (mean, M2).
//   * the ranks merge the shards' (mean, M2) exactly, in rank order, by
//     Chan's formula for equal counts (ops/groupnorm.py,
//     parallel/collectives.all_reduce_group_stats).
//   * group_norm_apply: normalise, affine and the optional SiLU from the
//     merged (mean, M2) and the whole count, blocks over each span's packs.
// Bytes bound both: stats reads x (twice, the second time mostly from L2
// at the sp shapes), apply reads x and writes y. A simple form: no TMA, no
// cluster; the span is read again by apply rather than kept on chip.
#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kMaxThreads = 512;
constexpr int kSweepThreads = 512;
constexpr int kMaxCluster = 8;                  // the portable cluster size
constexpr long long kSliceTarget = 96 * 1024;   // bytes of a block's slice(s): two blocks an SM
constexpr long long kSliceMax = 192 * 1024;
constexpr int kSmemMax = 227 * 1024;            // opt-in dynamic shared memory
constexpr uint32_t kCopyBytes = 16 * 1024;      // bytes a bulk copy
constexpr int kCtlBytes = 1024;                 // control block ahead of the data

struct Ctl {
  unsigned long long bar;   // mbarrier of the bulk copies
  float slot[2][2];         // this block's sums, read by the cluster
  float red[3][64];         // one buffer per block reduction
};
static_assert(sizeof(Ctl) <= kCtlBytes, "control block too large");

// ------------------------------------------------------------ element packs
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

__device__ __forceinline__ void unpack(const uint4& u, float (&f)[4]) {
  f[0] = __uint_as_float(u.x);
  f[1] = __uint_as_float(u.y);
  f[2] = __uint_as_float(u.z);
  f[3] = __uint_as_float(u.w);
}

__device__ __forceinline__ void unpack(const uint4& u, float (&f)[8]) {
  const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
  for (int j = 0; j < 4; ++j) {   // the lower half is the element at the lower address
    f[2 * j] = __uint_as_float(w[j] << 16);
    f[2 * j + 1] = __uint_as_float(w[j] & 0xffff0000u);
  }
}

__device__ __forceinline__ uint4 pack(const float (&f)[4]) {
  return make_uint4(__float_as_uint(f[0]), __float_as_uint(f[1]), __float_as_uint(f[2]),
                    __float_as_uint(f[3]));
}

__device__ __forceinline__ uint32_t bf16x2(float lo, float hi) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&h);
}

__device__ __forceinline__ uint4 pack(const float (&f)[8]) {
  return make_uint4(bf16x2(f[0], f[1]), bf16x2(f[2], f[3]), bf16x2(f[4], f[5]),
                    bf16x2(f[6], f[7]));
}

template <typename T, int V>
struct alignas(sizeof(T) * V) Pack {
  T v[V];
};

__device__ __forceinline__ float sigmoid(float v) { return __fdividef(1.f, 1.f + __expf(-v)); }
__device__ __forceinline__ float silu(float v) { return __fdividef(v, 1.f + __expf(-v)); }

// g = dy, or dy * d silu(y) / dy at y = xhat * gamma + beta
__device__ __forceinline__ float grad_in(float dy, float xh, float ga, float be, int act) {
  if (!act) return dy;
  const float y = xh * ga + be;
  const float s = sigmoid(y);
  return dy * (s * (1.f + y * (1.f - s)));
}

// -------------------------------------------------------------- reductions
template <int N>
__device__ __forceinline__ void warp_sum(float (&v)[N]) {
  // a butterfly: every lane ends with the same bits
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
#pragma unroll
    for (int j = 0; j < N; ++j) v[j] += __shfl_xor_sync(0xffffffffu, v[j], off);
}

// v summed over the block, in every thread, with the same bits in each. red
// holds 32 * N floats and must not be written again before the next barrier.
template <int N>
__device__ __forceinline__ void block_sum(float (&v)[N], float* red) {
  const int lane = threadIdx.x & 31, wid = threadIdx.x >> 5, nw = blockDim.x >> 5;
  warp_sum(v);
  if (lane == 0) {
#pragma unroll
    for (int j = 0; j < N; ++j) red[wid * N + j] = v[j];
  }
  __syncthreads();
#pragma unroll
  for (int j = 0; j < N; ++j) v[j] = lane < nw ? red[lane * N + j] : 0.f;
  warp_sum(v);
}

// v (already the block's sum in every thread) summed over the k blocks of the
// cluster, in rank order, in every thread of every block
template <int N>
__device__ __forceinline__ void cluster_sum(float (&v)[N], float* slot, int k) {
  cg::cluster_group cluster = cg::this_cluster();
  if (threadIdx.x == 0) {
#pragma unroll
    for (int j = 0; j < N; ++j) slot[j] = v[j];
  }
  cluster.sync();
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int j = 0; j < N; ++j) v[j] = lane < k ? *cluster.map_shared_rank(slot + j, lane) : 0.f;
  warp_sum(v);
}

// split cluster barrier: a block may leave only when no other block still
// reads its shared memory
__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

// --------------------------------------------------------------- bulk copy
__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void bulk_copy(void* dst, const void* src, uint32_t bytes,
                                          unsigned long long* bar) {
  for (uint32_t off = 0; off < bytes; off += kCopyBytes) {
    const uint32_t n = bytes - off < kCopyBytes ? bytes - off : kCopyBytes;
    asm volatile(
        "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n"
        ::"r"(smem_addr(static_cast<char*>(dst) + off)),
        "l"(static_cast<const char*>(src) + off), "r"(n), "r"(smem_addr(bar))
        : "memory");
  }
}

__device__ __forceinline__ void bar_init(unsigned long long* bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(smem_addr(bar)) : "memory");
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

__device__ __forceinline__ void bar_expect(unsigned long long* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_addr(bar)),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void bar_wait(unsigned long long* bar, uint32_t parity) {
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n .reg .pred p;\n mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(smem_addr(bar)), "r"(parity)
        : "memory");
  }
}

// Copy `bytes` from each of src0 (and src1, when not null) into shared memory
// at dst0 (dst1); every thread returns once all of it has landed.
__device__ __forceinline__ void load_slices(Ctl& ctl, void* dst0, const void* src0, void* dst1,
                                            const void* src1, uint32_t bytes) {
  if (threadIdx.x == 0) {
    bar_init(&ctl.bar);
    bar_expect(&ctl.bar, src1 ? 2 * bytes : bytes);
    bulk_copy(dst0, src0, bytes, &ctl.bar);
    if (src1) bulk_copy(dst1, src1, bytes, &ctl.bar);
  }
  __syncthreads();   // the barrier is initialised before anyone waits on it
  bar_wait(&ctl.bar, 0);
}

// ----------------------------------------------------------- on-chip path
// Slice geometry of this block: the span's (batch, group), the cluster rank,
// packs a channel (cp), packs of this block (spk) and its first pack (p0).
struct Slice {
  int bg, g, cpg, cp, spk, p0, k;
  long long span;
};

template <typename T>
__device__ __forceinline__ Slice slice_of(int C, int G, int hw, int k) {
  constexpr int V = 16 / sizeof(T);
  Slice s;
  s.k = k;
  const int rank = k > 1 ? (int)cg::this_cluster().block_rank() : 0;
  s.bg = blockIdx.x / k;
  s.g = s.bg % G;
  s.cpg = C / G;
  s.span = (long long)s.cpg * hw;
  s.cp = hw / V;
  s.spk = (int)(s.span / V / k);
  s.p0 = rank * s.spk;
  return s;
}

// mean (of x - shift) and rstd of the span from this block's shared copy:
// `_ref`'s two passes over the block's slice (the sum, then the sum of
// squares about the slice's mean). In a cluster the k slices' (mean, M2) are
// then merged exactly for slices of equal size, M2 = sum M2_r + n_r sum
// (mean_r - mean)^2, read in rank order, so every block gets the same bits:
// one cluster barrier a span. slot: two floats of this block's shared memory.
template <typename T>
__device__ __forceinline__ void span_stats(const Slice& s, const uint4* xs, float shift,
                                           float eps, Ctl& ctl, float* slot, float& mean,
                                           float& rstd) {
  constexpr int V = 16 / sizeof(T);
  const float nl = (float)s.spk * V;
  float a[1] = {0.f};
#pragma unroll 4
  for (int i = threadIdx.x; i < s.spk; i += blockDim.x) {
    float f[V];
    unpack(xs[i], f);
#pragma unroll
    for (int j = 0; j < V; ++j) a[0] += f[j] - shift;
  }
  block_sum(a, ctl.red[0]);
  mean = a[0] / nl;
  // centred on shift + mean rounded to f32: an offset e of the centre adds
  // only n e^2 to the sum of squares
  const float centre = shift + mean;
  float q[1] = {0.f};
#pragma unroll 4
  for (int i = threadIdx.x; i < s.spk; i += blockDim.x) {
    float f[V];
    unpack(xs[i], f);
#pragma unroll
    for (int j = 0; j < V; ++j) {
      const float d = f[j] - centre;
      q[0] += d * d;
    }
  }
  block_sum(q, ctl.red[1]);
  if (s.k > 1) {
    cg::cluster_group cluster = cg::this_cluster();
    if (threadIdx.x == 0) {
      slot[0] = mean;
      slot[1] = q[0];
    }
    cluster.sync();
    const int lane = threadIdx.x & 31;
    float mr[1] = {0.f}, m2[1] = {0.f};
    if (lane < s.k) {
      mr[0] = *cluster.map_shared_rank(slot, lane);
      m2[0] = *cluster.map_shared_rank(slot + 1, lane);
    }
    float sum[1] = {mr[0]};
    warp_sum(sum);
    mean = sum[0] / s.k;
    const float dm = lane < s.k ? mr[0] - mean : 0.f;
    m2[0] += nl * dm * dm;
    warp_sum(m2);
    q[0] = m2[0];
  }
  rstd = rsqrtf(q[0] / (float)s.span + eps);
}

template <typename T>
__global__ void __launch_bounds__(kMaxThreads)
group_norm_fwd_onchip(const T* __restrict__ x, const float* __restrict__ gamma,
                      const float* __restrict__ beta, T* __restrict__ y, int C, int G, int hw,
                      float eps, int act, int k) {
  constexpr int V = 16 / sizeof(T);
  extern __shared__ __align__(128) unsigned char smem[];
  Ctl& ctl = *reinterpret_cast<Ctl*>(smem);
  uint4* xs = reinterpret_cast<uint4*>(smem + kCtlBytes);
  const Slice s = slice_of<T>(C, G, hw, k);
  const T* xspan = x + s.bg * s.span;
  const float shift = to_f(xspan[0]);   // issued before the wait for the copy
  load_slices(ctl, xs, xspan + (long long)s.p0 * V, nullptr, nullptr, s.spk * 16u);
  float mean, rstd;
  span_stats<T>(s, xs, shift, eps, ctl, ctl.slot[0], mean, rstd);
  if (k > 1) cluster_arrive();   // done reading the other blocks' slots

  uint4* ys = reinterpret_cast<uint4*>(y + s.bg * s.span) + s.p0;
  // i / cp as a multiply-high (exact while cpg * cp^2 < 2^32, which the plan
  // checks)
  const unsigned long long magic = ((1ull << 32) + s.cp - 1) / s.cp;
#pragma unroll 4
  for (int i = threadIdx.x; i < s.spk; i += blockDim.x) {
    const int c = s.g * s.cpg + (int)(((unsigned long long)(s.p0 + i) * magic) >> 32);
    const float sc = gamma[c] * rstd, sh = beta[c] - mean * sc;
    float f[V];
    unpack(xs[i], f);
#pragma unroll
    for (int j = 0; j < V; ++j) {
      const float v = (f[j] - shift) * sc + sh;   // x - shift is exact, mean is not added to it
      f[j] = act ? silu(v) : v;
    }
    ys[i] = pack(f);
  }
  if (k > 1) cluster_wait();   // no block leaves while another reads its slots
}

template <typename T>
__global__ void __launch_bounds__(kMaxThreads)
group_norm_bwd_onchip(const T* __restrict__ x, const float* __restrict__ gamma,
                      const float* __restrict__ beta, const T* __restrict__ dy,
                      T* __restrict__ dx, float* __restrict__ part, int B, int C, int G, int hw,
                      float eps, int act, int k, int parts) {
  constexpr int V = 16 / sizeof(T);
  extern __shared__ __align__(128) unsigned char smem[];
  Ctl& ctl = *reinterpret_cast<Ctl*>(smem);
  const Slice s = slice_of<T>(C, G, hw, k);
  const int nrun = s.spk / s.cp;   // whole channels of this block
  const int nunit = nrun * parts;
  float2* units = reinterpret_cast<float2*>(smem + kCtlBytes);
  uint4* xs = reinterpret_cast<uint4*>(smem + kCtlBytes + (nunit * 8 + 127) / 128 * 128);
  uint4* ds = xs + s.spk;
  const T* xspan = x + s.bg * s.span;
  const long long first = s.bg * s.span + (long long)s.p0 * V;
  const float shift = to_f(xspan[0]);
  load_slices(ctl, xs, x + first, ds, dy + first, s.spk * 16u);
  float mean, rstd;
  span_stats<T>(s, xs, shift, eps, ctl, ctl.slot[0], mean, rstd);
  const float mr = mean * rstd;

  // sums of g * xhat and g over each unit: a run of cp / parts packs inside
  // one channel, one warp a unit
  const int lane = threadIdx.x & 31, wid = threadIdx.x >> 5, nw = blockDim.x >> 5;
  const int b = s.bg / G, c0 = s.g * s.cpg + s.p0 / s.cp, ulen = s.cp / parts;
  for (int u = wid; u < nunit; u += nw) {
    const int c = c0 + u / parts;
    const float ga = gamma[c], be = beta[c];
    const int i0 = (u / parts) * s.cp + (u % parts) * ulen;
    float a[2] = {0.f, 0.f};
    for (int i = i0 + lane; i < i0 + ulen; i += 32) {
      float xf[V], df[V];
      unpack(xs[i], xf);
      unpack(ds[i], df);
#pragma unroll
      for (int j = 0; j < V; ++j) {
        const float xh = (xf[j] - shift) * rstd - mr;
        const float gj = grad_in(df[j], xh, ga, be, act);
        a[0] += gj * xh;
        a[1] += gj;
      }
    }
    warp_sum(a);
    if (lane == 0) units[u] = make_float2(a[0], a[1]);
  }
  __syncthreads();
  // per channel: the partials of dgamma and dbeta for this batch row, and the
  // gamma-weighted sums that give m1 and m2
  float m[2] = {0.f, 0.f};
  for (int r = threadIdx.x; r < nrun; r += blockDim.x) {
    float sgx = 0.f, sg = 0.f;
    for (int p = 0; p < parts; ++p) {
      const float2 t = units[r * parts + p];
      sgx += t.x;
      sg += t.y;
    }
    const int c = c0 + r;
    part[(long long)b * C + c] = sgx;
    part[(long long)(B + b) * C + c] = sg;
    m[0] += gamma[c] * sg;
    m[1] += gamma[c] * sgx;
  }
  block_sum(m, ctl.red[2]);
  if (k > 1) cluster_sum(m, ctl.slot[1], k);
  if (k > 1) cluster_arrive();
  const float n = (float)s.span;
  const float m1 = m[0] / n, m2 = m[1] / n;

  uint4* dxs = reinterpret_cast<uint4*>(dx + first);
  const unsigned long long magic = ((1ull << 32) + s.cp - 1) / s.cp;   // i / cp, as forward
#pragma unroll 2
  for (int i = threadIdx.x; i < s.spk; i += blockDim.x) {
    const int c = s.g * s.cpg + (int)(((unsigned long long)(s.p0 + i) * magic) >> 32);
    const float ga = gamma[c], be = beta[c];
    float xf[V], df[V];
    unpack(xs[i], xf);
    unpack(ds[i], df);
#pragma unroll
    for (int j = 0; j < V; ++j) {
      const float xh = (xf[j] - shift) * rstd - mr;
      const float gj = grad_in(df[j], xh, ga, be, act);
      xf[j] = (gj * ga - m1 - xh * m2) * rstd;
    }
    dxs[i] = pack(xf);
  }
  if (k > 1) cluster_wait();
}

// ----------------------------------------------------------- two-sweep path
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

// One sweep over the span for its mean (of x - shift) and rstd: each thread
// takes every pack's mean and centred sum of squares and folds them into a
// running (n, mean, M2) with Chan's update; warps and the block fold alike.
template <typename T, int V>
__device__ __forceinline__ void sweep_stats(const Pack<T, V>* xp, int npack, float shift,
                                            float eps, float& mean, float& rstd) {
  Stat s{0.f, 0.f, 0.f};
  for (int i = threadIdx.x; i < npack; i += kSweepThreads) {
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
  __shared__ Stat warp_stat[kSweepThreads / 32];
  __shared__ float sh_mean, sh_rstd;
  const int lane = threadIdx.x & 31, wid = threadIdx.x >> 5;
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) s = merge(s, shfl_xor(s, off));
  if (lane == 0) warp_stat[wid] = s;
  __syncthreads();
  if (wid == 0) {
    s = lane < kSweepThreads / 32 ? warp_stat[lane] : Stat{0.f, 0.f, 0.f};
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) s = merge(s, shfl_xor(s, off));
    if (lane == 0) {
      sh_mean = s.mean;
      sh_rstd = rsqrtf(s.m2 / s.n + eps);
    }
  }
  __syncthreads();
  mean = sh_mean;
  rstd = sh_rstd;
}

template <typename T, int V>
__global__ void __launch_bounds__(kSweepThreads)
group_norm_fwd_sweep(const T* __restrict__ x, const float* __restrict__ gamma,
                     const float* __restrict__ beta, T* __restrict__ y, int C, int G, int hw,
                     float eps, int act) {
  const int bg = blockIdx.x, g = bg % G, cpg = C / G;
  const int npack = cpg * hw / V;
  const long long base = (long long)bg * cpg * hw;
  const Pack<T, V>* xp = reinterpret_cast<const Pack<T, V>*>(x + base);
  Pack<T, V>* yp = reinterpret_cast<Pack<T, V>*>(y + base);
  const float shift = to_f(x[base]);
  float mean, rstd;
  sweep_stats<T, V>(xp, npack, shift, eps, mean, rstd);
  for (int i = threadIdx.x; i < npack; i += kSweepThreads) {
    const int c = g * cpg + (i * V) / hw;
    const float sc = gamma[c] * rstd, sh = beta[c];
    const Pack<T, V> p = xp[i];
    Pack<T, V> o;
#pragma unroll
    for (int j = 0; j < V; ++j) {
      const float v = (to_f(p.v[j]) - shift - mean) * sc + sh;
      o.v[j] = from_f<T>(act ? silu(v) : v);
    }
    yp[i] = o;
  }
}

template <typename T, int V>
__global__ void __launch_bounds__(kSweepThreads)
group_norm_bwd_sweep(const T* __restrict__ x, const float* __restrict__ gamma,
                     const float* __restrict__ beta, const T* __restrict__ dy,
                     T* __restrict__ dx, float* __restrict__ part, int B, int C, int G, int hw,
                     float eps, int act) {
  const int bg = blockIdx.x, b = bg / G, g = bg % G, cpg = C / G;
  const int npack = cpg * hw / V, cpk = hw / V;
  const long long base = (long long)bg * cpg * hw;
  const Pack<T, V>* xp = reinterpret_cast<const Pack<T, V>*>(x + base);
  const Pack<T, V>* dp = reinterpret_cast<const Pack<T, V>*>(dy + base);
  Pack<T, V>* dxp = reinterpret_cast<Pack<T, V>*>(dx + base);
  const float shift = to_f(x[base]);
  float mean, rstd;
  sweep_stats<T, V>(xp, npack, shift, eps, mean, rstd);
  __shared__ float red[2][64];
  float m[2] = {0.f, 0.f};
  for (int cl = 0; cl < cpg; ++cl) {   // one block reduction a channel
    const int c = g * cpg + cl;
    const float ga = gamma[c], be = beta[c];
    float a[2] = {0.f, 0.f};
    for (int i = cl * cpk + threadIdx.x; i < (cl + 1) * cpk; i += kSweepThreads) {
      const Pack<T, V> px = xp[i], pd = dp[i];
#pragma unroll
      for (int j = 0; j < V; ++j) {
        const float xh = (to_f(px.v[j]) - shift - mean) * rstd;
        const float gj = grad_in(to_f(pd.v[j]), xh, ga, be, act);
        a[0] += gj * xh;
        a[1] += gj;
      }
    }
    block_sum(a, red[cl & 1]);
    if (threadIdx.x == 0) {
      part[(long long)b * C + c] = a[0];
      part[(long long)(B + b) * C + c] = a[1];
    }
    m[0] += ga * a[1];
    m[1] += ga * a[0];
  }
  const float n = (float)cpg * hw;
  const float m1 = m[0] / n, m2 = m[1] / n;
  for (int i = threadIdx.x; i < npack; i += kSweepThreads) {
    const int c = g * cpg + i / cpk;
    const float ga = gamma[c], be = beta[c];
    const Pack<T, V> px = xp[i], pd = dp[i];
    Pack<T, V> o;
#pragma unroll
    for (int j = 0; j < V; ++j) {
      const float xh = (to_f(px.v[j]) - shift - mean) * rstd;
      const float gj = grad_in(to_f(pd.v[j]), xh, ga, be, act);
      o.v[j] = from_f<T>((gj * ga - m1 - xh * m2) * rstd);
    }
    dxp[i] = o;
  }
}

// dgamma[c] and dbeta[c]: the (2, B, C) partials summed over B in order
__global__ void group_norm_param_sum(const float* __restrict__ part, float* __restrict__ dgamma,
                                     float* __restrict__ dbeta, int B, int C) {
  const int c = blockIdx.x * blockDim.x + threadIdx.x;
  if (c >= C) return;
  float sgx = 0.f, sg = 0.f;
  for (int b = 0; b < B; ++b) {
    sgx += part[(long long)b * C + c];
    sg += part[(long long)(B + b) * C + c];
  }
  dgamma[c] = sgx;
  dbeta[c] = sg;
}

// -------------------------------------------------------------- split form
constexpr int kSplitThreads = 512;
constexpr int kApplyPacks = 4 * kSplitThreads;   // packs a block of group_norm_apply

// (mean, M2) of each (batch, group) span of this shard: `_ref`'s two passes
template <typename T, int V>
__global__ void __launch_bounds__(kSplitThreads)
group_norm_stats(const T* __restrict__ x, float* __restrict__ stats, int C, int G, int hw) {
  const int bg = blockIdx.x;
  const long long span = (long long)(C / G) * hw;
  const int npack = (int)(span / V);
  const Pack<T, V>* xp = reinterpret_cast<const Pack<T, V>*>(x + bg * span);
  __shared__ float red[2][32];
  float a[1] = {0.f};
  for (int i = threadIdx.x; i < npack; i += kSplitThreads) {
    const Pack<T, V> p = xp[i];
#pragma unroll
    for (int j = 0; j < V; ++j) a[0] += to_f(p.v[j]);
  }
  block_sum(a, red[0]);
  const float mean = a[0] / (float)span;
  float q[1] = {0.f};
  for (int i = threadIdx.x; i < npack; i += kSplitThreads) {
    const Pack<T, V> p = xp[i];
#pragma unroll
    for (int j = 0; j < V; ++j) {
      const float d = to_f(p.v[j]) - mean;
      q[0] += d * d;
    }
  }
  block_sum(q, red[1]);
  if (threadIdx.x == 0) {
    stats[2 * bg] = mean;
    stats[2 * bg + 1] = q[0];
  }
}

// y = (x - mean) * rstd * gamma + beta (then SiLU), rstd = (M2 / n + eps)^-1/2
// from the whole width's (mean, M2); grid (packs / kApplyPacks, B * G)
template <typename T, int V>
__global__ void __launch_bounds__(kSplitThreads)
group_norm_apply(const T* __restrict__ x, const float* __restrict__ stats,
                 const float* __restrict__ gamma, const float* __restrict__ beta,
                 T* __restrict__ y, int C, int G, int hw, float n, float eps, int act) {
  const int bg = blockIdx.y, g = bg % G, cpg = C / G, cpk = hw / V;
  const long long span = (long long)cpg * hw;
  const int npack = (int)(span / V);
  const float mean = stats[2 * bg], rstd = rsqrtf(stats[2 * bg + 1] / n + eps);
  const Pack<T, V>* xp = reinterpret_cast<const Pack<T, V>*>(x + bg * span);
  Pack<T, V>* yp = reinterpret_cast<Pack<T, V>*>(y + bg * span);
  const int end = min(npack, (int)(blockIdx.x + 1) * kApplyPacks);
  for (int i = blockIdx.x * kApplyPacks + threadIdx.x; i < end; i += kSplitThreads) {
    const int c = g * cpg + i / cpk;
    const float ga = gamma[c], be = beta[c];
    const Pack<T, V> p = xp[i];
    Pack<T, V> o;
#pragma unroll
    for (int j = 0; j < V; ++j) {
      const float v = fmaf((to_f(p.v[j]) - mean) * rstd, ga, be);
      o.v[j] = from_f<T>(act ? silu(v) : v);
    }
    yp[i] = o;
  }
}

// ------------------------------------------------------------------- host
struct Plan {
  int k = 0, threads = 0, parts = 1;
  size_t smem = 0;
};

// The on-chip plan of a span, or false for the two-sweep path. bufs: 1 for
// the forward (x), 2 for the backward (x and dy), whose blocks hold whole
// channels.
bool plan_onchip(int itemsize, int C, int G, int hw, bool aligned, int bufs, Plan& p) {
  const int V = 16 / itemsize;
  if (!aligned || hw % V) return false;
  const int cp = hw / V;
  const long long span_packs = (long long)(C / G) * cp;
  // the kernels find a pack's channel by a multiply-high, exact below this
  if ((unsigned long long)span_packs * cp >= (1ull << 32)) return false;
  int k = 0;
  for (int kk = 1; kk <= kMaxCluster; kk *= 2) {
    if (span_packs % kk || (bufs == 2 && (span_packs / kk) % cp)) break;
    k = kk;
    if (span_packs / kk * 16 * bufs <= kSliceTarget) break;
  }
  const long long spk = span_packs / k;
  if (spk * 16 * bufs > kSliceMax) return false;
  p.k = k;
  p.threads = spk <= 512 ? 128 : spk <= 2048 ? 256 : 512;
  p.parts = 1;
  long long unit_bytes = 0;
  if (bufs == 2) {
    const long long nrun = spk / cp;
    while (nrun * p.parts < p.threads / 32 && cp % (2 * p.parts) == 0 &&
           cp / (2 * p.parts) >= 32)
      p.parts *= 2;
    unit_bytes = (nrun * p.parts * 8 + 127) / 128 * 128;
  }
  const long long smem = kCtlBytes + unit_bytes + spk * 16 * bufs;
  if (smem > kSmemMax) return false;
  p.smem = (size_t)smem;
  return true;
}

template <typename... Params, typename... Args>
cudaError_t launch_onchip(void (*kernel)(Params...), int clusters, const Plan& p,
                          cudaStream_t stream, Args... args) {
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)p.smem);
  if (err != cudaSuccess) return err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(clusters * p.k);
  cfg.blockDim = dim3(p.threads);
  cfg.dynamicSmemBytes = p.smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = p.k;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = p.k > 1 ? 1 : 0;
  return cudaLaunchKernelEx(&cfg, kernel, args...);
}

bool aligned16(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; }

template <typename T>
int fwd(const void* x, const void* gamma, const void* beta, void* y, int B, int C, int G,
        int hw, float eps, int act, cudaStream_t st) {
  constexpr int V = 16 / sizeof(T);
  const T* xt = static_cast<const T*>(x);
  const float* ga = static_cast<const float*>(gamma);
  const float* be = static_cast<const float*>(beta);
  T* yt = static_cast<T*>(y);
  Plan p;
  if (plan_onchip(sizeof(T), C, G, hw, aligned16(x) && aligned16(y), 1, p)) {
    cudaError_t err = launch_onchip(group_norm_fwd_onchip<T>, B * G, p, st, xt, ga, be, yt, C, G,
                                    hw, eps, act, p.k);
    if (err != cudaSuccess) return (int)err;
  } else if (hw % V == 0 && aligned16(x) && aligned16(y)) {
    group_norm_fwd_sweep<T, V><<<B * G, kSweepThreads, 0, st>>>(xt, ga, be, yt, C, G, hw, eps,
                                                                 act);
  } else {
    group_norm_fwd_sweep<T, 1><<<B * G, kSweepThreads, 0, st>>>(xt, ga, be, yt, C, G, hw, eps,
                                                                 act);
  }
  return (int)cudaGetLastError();
}

template <typename T>
int bwd(const void* x, const void* gamma, const void* beta, const void* dy, void* dx,
        void* part, void* dgamma, void* dbeta, int B, int C, int G, int hw, float eps, int act,
        cudaStream_t st) {
  constexpr int V = 16 / sizeof(T);
  const T* xt = static_cast<const T*>(x);
  const T* dyt = static_cast<const T*>(dy);
  const float* ga = static_cast<const float*>(gamma);
  const float* be = static_cast<const float*>(beta);
  T* dxt = static_cast<T*>(dx);
  float* pt = static_cast<float*>(part);
  const bool al = aligned16(x) && aligned16(dy) && aligned16(dx);
  Plan p;
  if (plan_onchip(sizeof(T), C, G, hw, al, 2, p)) {
    cudaError_t err = launch_onchip(group_norm_bwd_onchip<T>, B * G, p, st, xt, ga, be, dyt, dxt,
                                    pt, B, C, G, hw, eps, act, p.k, p.parts);
    if (err != cudaSuccess) return (int)err;
  } else if (hw % V == 0 && al) {
    group_norm_bwd_sweep<T, V><<<B * G, kSweepThreads, 0, st>>>(xt, ga, be, dyt, dxt, pt, B, C,
                                                                 G, hw, eps, act);
  } else {
    group_norm_bwd_sweep<T, 1><<<B * G, kSweepThreads, 0, st>>>(xt, ga, be, dyt, dxt, pt, B, C,
                                                                 G, hw, eps, act);
  }
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  group_norm_param_sum<<<(C + 255) / 256, 256, 0, st>>>(pt, static_cast<float*>(dgamma),
                                                        static_cast<float*>(dbeta), B, C);
  return (int)cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. x, y: contiguous (B, C, H*W); gamma, beta:
// float32 (C,). Returns cudaGetLastError() after the launch.
extern "C" int llt_group_norm_fwd(const void* x, const void* gamma,
                                  const void* beta, void* y, int dtype, int B,
                                  int C, int G, int hw, float eps, int act,
                                  void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return fwd<float>(x, gamma, beta, y, B, C, G, hw, eps, act, st);
  if (dtype == 1) return fwd<__nv_bfloat16>(x, gamma, beta, y, B, C, G, hw, eps, act, st);
  return (int)cudaErrorInvalidValue;
}

// The backward: x, dy, dx contiguous (B, C, H*W) of one dtype; gamma, beta
// float32 (C,); part a float32 (2, B, C) scratch; dgamma, dbeta float32 (C,).
// Two launches (the span kernel, then the sum over B). Returns
// cudaGetLastError() after them.
extern "C" int llt_group_norm_bwd(const void* x, const void* gamma,
                                  const void* beta, const void* dy, void* dx,
                                  void* part, void* dgamma, void* dbeta,
                                  int dtype, int B, int C, int G, int hw,
                                  float eps, int act, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return bwd<float>(x, gamma, beta, dy, dx, part, dgamma, dbeta, B, C, G, hw, eps, act, st);
  if (dtype == 1)
    return bwd<__nv_bfloat16>(x, gamma, beta, dy, dx, part, dgamma, dbeta, B, C, G, hw, eps,
                              act, st);
  return (int)cudaErrorInvalidValue;
}

namespace {

template <typename T>
int split_stats(const void* x, void* stats, int B, int C, int G, int hw, cudaStream_t st) {
  constexpr int V = 16 / sizeof(T);
  const T* xt = static_cast<const T*>(x);
  float* out = static_cast<float*>(stats);
  if (hw % V == 0 && aligned16(x))
    group_norm_stats<T, V><<<B * G, kSplitThreads, 0, st>>>(xt, out, C, G, hw);
  else
    group_norm_stats<T, 1><<<B * G, kSplitThreads, 0, st>>>(xt, out, C, G, hw);
  return (int)cudaGetLastError();
}

template <typename T>
int split_apply(const void* x, const void* stats, const void* gamma, const void* beta, void* y,
                int B, int C, int G, int hw, float n, float eps, int act, cudaStream_t st) {
  constexpr int V = 16 / sizeof(T);
  const T* xt = static_cast<const T*>(x);
  const float* s = static_cast<const float*>(stats);
  const float* ga = static_cast<const float*>(gamma);
  const float* be = static_cast<const float*>(beta);
  T* yt = static_cast<T*>(y);
  const long long span = (long long)(C / G) * hw;
  if (hw % V == 0 && aligned16(x) && aligned16(y)) {
    const dim3 grid((unsigned)((span / V + kApplyPacks - 1) / kApplyPacks), B * G);
    group_norm_apply<T, V><<<grid, kSplitThreads, 0, st>>>(xt, s, ga, be, yt, C, G, hw, n, eps,
                                                           act);
  } else {
    const dim3 grid((unsigned)((span + kApplyPacks - 1) / kApplyPacks), B * G);
    group_norm_apply<T, 1><<<grid, kSplitThreads, 0, st>>>(xt, s, ga, be, yt, C, G, hw, n, eps,
                                                           act);
  }
  return (int)cudaGetLastError();
}

}  // namespace

// The split form's statistics: x contiguous (B, C, H*W), this shard's
// columns; stats a float32 (B, G, 2) of each span's (mean, M2). Returns
// cudaGetLastError() after the launch.
extern "C" int llt_group_norm_stats(const void* x, void* stats, int dtype, int B, int C, int G,
                                    int hw, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if ((long long)B * G > 0x7fffffffLL || (long long)(C / G) * hw >= 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  if (dtype == 0) return split_stats<float>(x, stats, B, C, G, hw, st);
  if (dtype == 1) return split_stats<__nv_bfloat16>(x, stats, B, C, G, hw, st);
  return (int)cudaErrorInvalidValue;
}

// The split form's normalisation: x, y contiguous (B, C, H*W) of one dtype;
// stats float32 (B, G, 2), the whole width's (mean, M2) over n elements a
// span; gamma, beta float32 (C,). Returns cudaGetLastError() after the launch.
extern "C" int llt_group_norm_apply(const void* x, const void* stats, const void* gamma,
                                    const void* beta, void* y, int dtype, int B, int C, int G,
                                    int hw, float n, float eps, int act, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (B * G > 65535 || (long long)(C / G) * hw >= 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  if (dtype == 0) return split_apply<float>(x, stats, gamma, beta, y, B, C, G, hw, n, eps, act, st);
  if (dtype == 1)
    return split_apply<__nv_bfloat16>(x, stats, gamma, beta, y, B, C, G, hw, n, eps, act, st);
  return (int)cudaErrorInvalidValue;
}

// The path a span takes with 16-byte aligned tensors: the blocks of its
// cluster (1 for one block) on the on-chip path, or 0 for the two-sweep path.
extern "C" int llt_group_norm_path(int dtype, int C, int G, int hw,
                                   int backward) {
  Plan p;
  const int itemsize = dtype == 0 ? 4 : 2;
  return plan_onchip(itemsize, C, G, hw, true, backward ? 2 : 1, p) ? p.k : 0;
}
