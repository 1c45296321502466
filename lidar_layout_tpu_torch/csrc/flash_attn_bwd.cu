// Self-attention backward: dq, dk, dv of softmax(Q K^T D^-1/2 + kbias) V,
// hand-written for Hopper (sm_90a).
//
// Replaces the TPU kernel `_bwd_kernel` / `_flash_bwd_tpu` in
// lidar_layout_tpu/ops/pallas_attention.py. Same meaning: (B, H, S, D) with
// S_q == S_kv, the probabilities recomputed in f32, delta = rowsum(dO * O),
// dS = P * (dP - delta), products summed in f32, P and dS rounded to bf16
// before their products on the bf16 path, results in the input dtype. The
// key bias gets no gradient (it is a padding mask).
//
// What bounds it on this card: operations. It does 10*B*H*S^2*D operations
// (the JAX CostEstimate): 171.8 GFLOP at the flagship's (16, 8, 2048, 32), or
// 0.174 ms at 989 TFLOP/s, against 0.040 ms for its bytes (5 reads and 3
// writes of 16.8 MB in bf16). It also takes B*H*S^2 exponentials on the
// special-function units per pass that recomputes P (two passes here).
//
// Why the design differs from the TPU kernel: that kernel keeps all of K and
// V of a (batch, head) in VMEM, recomputes each q-block's softmax with no
// saved statistics, and sums dk/dv over the sequential q grid axis in a
// revisited output block. On the H100 blocks run in parallel in no order,
// and K/V for S = 2048 in f32 do not fit a block's shared memory. So:
//   * The forward (flash_attn_fwd.cu) saves each row's log-sum-exp, and
//     P = exp(S - lse) is recomputed tile by tile (FlashAttention-2).
//   * A small pass writes delta = rowsum(dO * O) in f32.
//   * dK/dV: one block owns 64 keys of one (batch, head), holds their K and
//     V fragments in registers, and loops over the q-tiles: S^T = K Q^T,
//     P^T, dV += P^T dO, dP^T = V dO^T, dS^T = P^T (dP^T - delta),
//     dK += dS^T Q. Key rows are independent, so nothing crosses blocks.
//   * dQ: one block owns 64 query rows and loops over the key tiles:
//     S = Q K^T, P, dP = dO V^T, dS, dQ += dS K.
//   Two kernels recompute P twice, but every sum is owned by one block: no
//   atomics, and the result does not depend on scheduling.
//   * bf16: 4 warps of 16 rows, mma.sync m16n8k16 (bf16 in, f32 accumulate)
//     as in the forward; an f32 accumulator fragment is re-packed in
//     registers as the A operand of the next product. Operands needed as
//     "B" in both orientations are staged in shared memory twice (row-major
//     and transposed). f32: one thread per key (dK/dV) or per query (dQ)
//     with FMAs, since the tensor cores have no full-f32 mode.
//   * Rows past S are zero-filled and masked (lse = +inf gives P = 0), so S
//     needs no alignment; D is padded to 16/32/64/128. Any strides for the
//     b, h and s axes, as in the forward, so q, k and v can be views of one
//     fused qkv projection and dq/dk/dv can be written in any layout.
//   * Plain synchronous tile loads; no TMA/wgmma/cp.async pipelining yet.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr float kLog2e = 1.4426950408889634f;

struct Params {
  const void* q;
  const void* k;
  const void* v;
  const void* o;
  const void* dO;
  const float* kb;   // (B, S) f32 or nullptr
  const float* lse;  // (B*H, S) f32, natural log
  float* delta;      // (B*H, S) f32, written by the first pass
  void* dq;
  void* dk;
  void* dv;
  // element strides of b, h, s for q, k, v, o, dO, dq, dk, dv
  long long qs[3], ks[3], vs[3], os[3], dos[3], dqs[3], dks[3], dvs[3];
  int H, S, D;
  float scale;       // D^-1/2
  float scale_log2;  // D^-1/2 * log2(e)
};

typedef __nv_bfloat16 bf16;

template <typename T>
__device__ __forceinline__ const T* row_base(const void* base, const long long (&st)[3],
                                             int b, int h) {
  return static_cast<const T*>(base) + b * st[0] + h * st[1];
}

template <typename T>
__device__ __forceinline__ T* row_base_w(void* base, const long long (&st)[3], int b,
                                         int h) {
  return static_cast<T*>(base) + b * st[0] + h * st[1];
}

// 8 consecutive elements (16-byte aligned for bf16, 32-byte for f32) as float
__device__ __forceinline__ void load8(const bf16* ptr, float (&out)[8]) {
  const uint4 raw = *reinterpret_cast<const uint4*>(ptr);
  const bf16* e = reinterpret_cast<const bf16*>(&raw);
#pragma unroll
  for (int j = 0; j < 8; ++j) out[j] = __bfloat162float(e[j]);
}

__device__ __forceinline__ void load8(const float* ptr, float (&out)[8]) {
  const float4 a = *reinterpret_cast<const float4*>(ptr);
  const float4 c = *reinterpret_cast<const float4*>(ptr + 4);
  out[0] = a.x; out[1] = a.y; out[2] = a.z; out[3] = a.w;
  out[4] = c.x; out[5] = c.y; out[6] = c.z; out[7] = c.w;
}

// ------------------------------------------------------- delta = rowsum(dO*O)

template <typename T>
__global__ void __launch_bounds__(128) bwd_delta(Params p) {
  const int bh = blockIdx.y, b = bh / p.H, h = bh % p.H;
  const int i = blockIdx.x * 128 + threadIdx.x;
  if (i >= p.S) return;
  const T* og = row_base<T>(p.o, p.os, b, h) + i * p.os[2];
  const T* dg = row_base<T>(p.dO, p.dos, b, h) + i * p.dos[2];
  float acc = 0.f;
  for (int d = 0; d < p.D; d += 8) {
    float ov[8], dv[8];
    load8(og + d, ov);
    load8(dg + d, dv);
#pragma unroll
    for (int j = 0; j < 8; ++j) acc = fmaf(ov[j], dv[j], acc);
  }
  p.delta[(long long)bh * p.S + i] = acc;
}

// ---------------------------------------------------------------- bf16 path

constexpr int kRows = 64;  // rows a bf16 block owns (4 warps x 16)

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// two bf16 at (row, col) of a strided (S, D) matrix, zero outside it
__device__ __forceinline__ uint32_t ld_pair(const bf16* base, long long stride, int row,
                                            int col, int S, int D) {
  if (row >= S || col >= D) return 0u;
  return *reinterpret_cast<const uint32_t*>(base + row * stride + col);
}

// A fragments (m16 x k16 chunks over D) of rows r0 and r0 + 8, from global
template <int KT>
__device__ __forceinline__ void load_a(uint32_t (&a)[KT][4], const bf16* base,
                                       long long stride, int r0, int t, int S, int D) {
#pragma unroll
  for (int kk = 0; kk < KT; ++kk) {
    const int c0 = kk * 16 + 2 * t, c1 = c0 + 8;
    a[kk][0] = ld_pair(base, stride, r0, c0, S, D);
    a[kk][1] = ld_pair(base, stride, r0 + 8, c0, S, D);
    a[kk][2] = ld_pair(base, stride, r0, c1, S, D);
    a[kk][3] = ld_pair(base, stride, r0 + 8, c1, S, D);
  }
}

// stage ROWS rows of a strided (S, D) matrix into shared memory, row-major
// (rm) and, when tr is given, transposed; zero past S and past D
template <int ROWS, int DP, int LD, int LDT>
__device__ __forceinline__ void stage(bf16 (*rm)[LD], bf16 (*tr)[LDT], const bf16* base,
                                      long long stride, int r0, int S, int D) {
  constexpr int VPR = DP / 8;
  for (int i = threadIdx.x; i < ROWS * VPR; i += 128) {
    const int r = i / VPR, c = (i % VPR) * 8;
    uint4 val = make_uint4(0, 0, 0, 0);
    if (r0 + r < S && c < D) val = *reinterpret_cast<const uint4*>(base + (r0 + r) * stride + c);
    *reinterpret_cast<uint4*>(&rm[r][c]) = val;
    if (tr != nullptr) {
      const bf16* e = reinterpret_cast<const bf16*>(&val);
#pragma unroll
      for (int j = 0; j < 8; ++j) tr[c + j][r] = e[j];
    }
  }
}

// dK, dV for kRows keys per block; BQ queries per shared-memory tile
template <int DP, int BQ>
__global__ void __launch_bounds__(128) bwd_dkdv_bf16(Params p) {
  constexpr int KT = DP / 16;  // k16 chunks over D
  constexpr int DT = DP / 8;   // n8 tiles over D
  constexpr int NT = BQ / 8;   // n8 tiles over the query tile
  constexpr int QC = BQ / 16;  // k16 chunks over the query tile
  __shared__ __align__(16) bf16 Qs[BQ][DP + 8];   // B of S^T = K Q^T
  __shared__ __align__(16) bf16 Qt[DP][BQ + 8];   // B of dK += dS^T Q
  __shared__ __align__(16) bf16 dOs[BQ][DP + 8];  // B of dP^T = V dO^T
  __shared__ __align__(16) bf16 dOt[DP][BQ + 8];  // B of dV += P^T dO
  __shared__ float Ls[BQ], Ds[BQ];

  const int S = p.S, D = p.D;
  const int bh = blockIdx.y, b = bh / p.H, h = bh % p.H;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int kr0 = blockIdx.x * kRows + warp * 16 + g, kr1 = kr0 + 8;

  const bf16* qg = row_base<bf16>(p.q, p.qs, b, h);
  const bf16* dog = row_base<bf16>(p.dO, p.dos, b, h);
  const float* lg = p.lse + (long long)bh * S;
  const float* dg = p.delta + (long long)bh * S;

  uint32_t ka[KT][4], va[KT][4];
  load_a<KT>(ka, row_base<bf16>(p.k, p.ks, b, h), p.ks[2], kr0, t, S, D);
  load_a<KT>(va, row_base<bf16>(p.v, p.vs, b, h), p.vs[2], kr0, t, S, D);
  const float* kbr = p.kb ? p.kb + (long long)b * S : nullptr;
  const float kb0 = (kbr && kr0 < S) ? kbr[kr0] * kLog2e : 0.f;
  const float kb1 = (kbr && kr1 < S) ? kbr[kr1] * kLog2e : 0.f;

  float dk[DT][4], dv[DT][4];
#pragma unroll
  for (int i = 0; i < DT; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) dk[i][j] = dv[i][j] = 0.f;

  for (int q0 = 0; q0 < S; q0 += BQ) {
    __syncthreads();  // the previous tile is fully consumed
    stage<BQ, DP, DP + 8, BQ + 8>(Qs, Qt, qg, p.qs[2], q0, S, D);
    stage<BQ, DP, DP + 8, BQ + 8>(dOs, dOt, dog, p.dos[2], q0, S, D);
    for (int i = threadIdx.x; i < BQ; i += 128) {
      const bool in = q0 + i < S;
      Ls[i] = in ? lg[q0 + i] * kLog2e : INFINITY;  // P = 0 on rows past S
      Ds[i] = in ? dg[q0 + i] : 0.f;
    }
    __syncthreads();

    uint32_t pa[QC][4], sa[QC][4];
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      float st[4] = {0.f, 0.f, 0.f, 0.f}, dpt[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
      for (int kk = 0; kk < KT; ++kk) {
        mma_bf16(st, ka[kk], *reinterpret_cast<const uint32_t*>(&Qs[nt * 8 + g][kk * 16 + 2 * t]),
                 *reinterpret_cast<const uint32_t*>(&Qs[nt * 8 + g][kk * 16 + 8 + 2 * t]));
        mma_bf16(dpt, va[kk], *reinterpret_cast<const uint32_t*>(&dOs[nt * 8 + g][kk * 16 + 2 * t]),
                 *reinterpret_cast<const uint32_t*>(&dOs[nt * 8 + g][kk * 16 + 8 + 2 * t]));
      }
      // C layout: [0..1] key kr0, [2..3] key kr1; queries nt*8 + 2t + {0,1}
      float pv[4], dsv[4];
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int qc = nt * 8 + 2 * t + j;
        const float l = Ls[qc], dl = Ds[qc];
        pv[j] = exp2f(st[j] * p.scale_log2 + kb0 - l);
        pv[2 + j] = exp2f(st[2 + j] * p.scale_log2 + kb1 - l);
        dsv[j] = pv[j] * (dpt[j] - dl);
        dsv[2 + j] = pv[2 + j] * (dpt[2 + j] - dl);
      }
      pa[nt / 2][(nt % 2) * 2 + 0] = pack_bf16(pv[0], pv[1]);
      pa[nt / 2][(nt % 2) * 2 + 1] = pack_bf16(pv[2], pv[3]);
      sa[nt / 2][(nt % 2) * 2 + 0] = pack_bf16(dsv[0], dsv[1]);
      sa[nt / 2][(nt % 2) * 2 + 1] = pack_bf16(dsv[2], dsv[3]);
    }

#pragma unroll
    for (int dt = 0; dt < DT; ++dt) {
#pragma unroll
      for (int kc = 0; kc < QC; ++kc) {
        mma_bf16(dv[dt], pa[kc], *reinterpret_cast<const uint32_t*>(&dOt[dt * 8 + g][kc * 16 + 2 * t]),
                 *reinterpret_cast<const uint32_t*>(&dOt[dt * 8 + g][kc * 16 + 8 + 2 * t]));
        mma_bf16(dk[dt], sa[kc], *reinterpret_cast<const uint32_t*>(&Qt[dt * 8 + g][kc * 16 + 2 * t]),
                 *reinterpret_cast<const uint32_t*>(&Qt[dt * 8 + g][kc * 16 + 8 + 2 * t]));
      }
    }
  }

  bf16* dkg = row_base_w<bf16>(p.dk, p.dks, b, h);
  bf16* dvg = row_base_w<bf16>(p.dv, p.dvs, b, h);
#pragma unroll
  for (int dt = 0; dt < DT; ++dt) {
    const int c = dt * 8 + 2 * t;
    if (dt * 8 >= D) break;
    if (kr0 < S) {
      *reinterpret_cast<uint32_t*>(dkg + kr0 * p.dks[2] + c) =
          pack_bf16(dk[dt][0] * p.scale, dk[dt][1] * p.scale);
      *reinterpret_cast<uint32_t*>(dvg + kr0 * p.dvs[2] + c) = pack_bf16(dv[dt][0], dv[dt][1]);
    }
    if (kr1 < S) {
      *reinterpret_cast<uint32_t*>(dkg + kr1 * p.dks[2] + c) =
          pack_bf16(dk[dt][2] * p.scale, dk[dt][3] * p.scale);
      *reinterpret_cast<uint32_t*>(dvg + kr1 * p.dvs[2] + c) = pack_bf16(dv[dt][2], dv[dt][3]);
    }
  }
}

// dQ for kRows queries per block; BK keys per shared-memory tile
template <int DP, int BK>
__global__ void __launch_bounds__(128) bwd_dq_bf16(Params p) {
  constexpr int KT = DP / 16;
  constexpr int DT = DP / 8;
  constexpr int NT = BK / 8;
  constexpr int KC = BK / 16;
  __shared__ __align__(16) bf16 Ks[BK][DP + 8];  // B of S = Q K^T
  __shared__ __align__(16) bf16 Kt[DP][BK + 8];  // B of dQ += dS K
  __shared__ __align__(16) bf16 Vs[BK][DP + 8];  // B of dP = dO V^T
  __shared__ float Bs[BK];                       // key bias (log2 units), -inf past S

  const int S = p.S, D = p.D;
  const int bh = blockIdx.y, b = bh / p.H, h = bh % p.H;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int r0 = blockIdx.x * kRows + warp * 16 + g, r1 = r0 + 8;

  const bf16* kg = row_base<bf16>(p.k, p.ks, b, h);
  const bf16* vg = row_base<bf16>(p.v, p.vs, b, h);
  const float* kbr = p.kb ? p.kb + (long long)b * S : nullptr;

  uint32_t qa[KT][4], da[KT][4];
  load_a<KT>(qa, row_base<bf16>(p.q, p.qs, b, h), p.qs[2], r0, t, S, D);
  load_a<KT>(da, row_base<bf16>(p.dO, p.dos, b, h), p.dos[2], r0, t, S, D);
  const float* lg = p.lse + (long long)bh * S;
  const float* dg = p.delta + (long long)bh * S;
  const float L0 = r0 < S ? lg[r0] * kLog2e : 0.f, L1 = r1 < S ? lg[r1] * kLog2e : 0.f;
  const float D0 = r0 < S ? dg[r0] : 0.f, D1 = r1 < S ? dg[r1] : 0.f;

  float dq[DT][4];
#pragma unroll
  for (int i = 0; i < DT; ++i) dq[i][0] = dq[i][1] = dq[i][2] = dq[i][3] = 0.f;

  for (int k0 = 0; k0 < S; k0 += BK) {
    __syncthreads();
    stage<BK, DP, DP + 8, BK + 8>(Ks, Kt, kg, p.ks[2], k0, S, D);
    stage<BK, DP, DP + 8, BK + 8>(Vs, static_cast<bf16 (*)[BK + 8]>(nullptr), vg, p.vs[2],
                                  k0, S, D);
    for (int i = threadIdx.x; i < BK; i += 128)
      Bs[i] = k0 + i < S ? (kbr ? kbr[k0 + i] * kLog2e : 0.f) : -INFINITY;
    __syncthreads();

    uint32_t sa[KC][4];
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      float sc[4] = {0.f, 0.f, 0.f, 0.f}, dp[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
      for (int kk = 0; kk < KT; ++kk) {
        mma_bf16(sc, qa[kk], *reinterpret_cast<const uint32_t*>(&Ks[nt * 8 + g][kk * 16 + 2 * t]),
                 *reinterpret_cast<const uint32_t*>(&Ks[nt * 8 + g][kk * 16 + 8 + 2 * t]));
        mma_bf16(dp, da[kk], *reinterpret_cast<const uint32_t*>(&Vs[nt * 8 + g][kk * 16 + 2 * t]),
                 *reinterpret_cast<const uint32_t*>(&Vs[nt * 8 + g][kk * 16 + 8 + 2 * t]));
      }
      // C layout: [0..1] row r0, [2..3] row r1; keys nt*8 + 2t + {0,1}
      float dsv[4];
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const float bias = Bs[nt * 8 + 2 * t + j];
        dsv[j] = exp2f(sc[j] * p.scale_log2 + bias - L0) * (dp[j] - D0);
        dsv[2 + j] = exp2f(sc[2 + j] * p.scale_log2 + bias - L1) * (dp[2 + j] - D1);
      }
      sa[nt / 2][(nt % 2) * 2 + 0] = pack_bf16(dsv[0], dsv[1]);
      sa[nt / 2][(nt % 2) * 2 + 1] = pack_bf16(dsv[2], dsv[3]);
    }

#pragma unroll
    for (int dt = 0; dt < DT; ++dt)
#pragma unroll
      for (int kc = 0; kc < KC; ++kc)
        mma_bf16(dq[dt], sa[kc], *reinterpret_cast<const uint32_t*>(&Kt[dt * 8 + g][kc * 16 + 2 * t]),
                 *reinterpret_cast<const uint32_t*>(&Kt[dt * 8 + g][kc * 16 + 8 + 2 * t]));
  }

  bf16* dqg = row_base_w<bf16>(p.dq, p.dqs, b, h);
#pragma unroll
  for (int dt = 0; dt < DT; ++dt) {
    const int c = dt * 8 + 2 * t;
    if (dt * 8 >= D) break;
    if (r0 < S)
      *reinterpret_cast<uint32_t*>(dqg + r0 * p.dqs[2] + c) =
          pack_bf16(dq[dt][0] * p.scale, dq[dt][1] * p.scale);
    if (r1 < S)
      *reinterpret_cast<uint32_t*>(dqg + r1 * p.dqs[2] + c) =
          pack_bf16(dq[dt][2] * p.scale, dq[dt][3] * p.scale);
  }
}

// ---------------------------------------------------------------- f32 path

constexpr int kRowsF = 128;  // rows a f32 block owns, one per thread
constexpr int kTileF = 32;   // rows per shared-memory tile

// one row of a strided (S, D) f32 matrix into registers, zero outside it
template <int DP>
__device__ __forceinline__ void load_row(float (&r)[DP], const float* base, long long stride,
                                         int row, int S, int D) {
#pragma unroll
  for (int d = 0; d < DP; d += 4) {
    float4 val = make_float4(0.f, 0.f, 0.f, 0.f);
    if (row < S && d < D) val = *reinterpret_cast<const float4*>(base + row * stride + d);
    r[d] = val.x;
    r[d + 1] = val.y;
    r[d + 2] = val.z;
    r[d + 3] = val.w;
  }
}

template <int DP>
__device__ __forceinline__ void stage_f32(float (*sm)[DP], const float* base, long long stride,
                                          int r0, int S, int D) {
  constexpr int VPR = DP / 4;
  for (int i = threadIdx.x; i < kTileF * VPR; i += kRowsF) {
    const int r = i / VPR, c = (i % VPR) * 4;
    float4 val = make_float4(0.f, 0.f, 0.f, 0.f);
    if (r0 + r < S && c < D) val = *reinterpret_cast<const float4*>(base + (r0 + r) * stride + c);
    *reinterpret_cast<float4*>(&sm[r][c]) = val;
  }
}

template <int DP>
__device__ __forceinline__ void store_row(float* base, long long stride, int row, int D,
                                          const float (&r)[DP], float mul) {
#pragma unroll
  for (int d = 0; d < DP; d += 4)
    if (d < D)
      *reinterpret_cast<float4*>(base + row * stride + d) =
          make_float4(r[d] * mul, r[d + 1] * mul, r[d + 2] * mul, r[d + 3] * mul);
}

template <int DP>
__global__ void __launch_bounds__(128) bwd_dkdv_f32(Params p) {
  __shared__ __align__(16) float Qs[kTileF][DP];
  __shared__ __align__(16) float dOs[kTileF][DP];
  __shared__ float Ls[kTileF], Ds[kTileF];

  const int S = p.S, D = p.D;
  const int bh = blockIdx.y, b = bh / p.H, h = bh % p.H;
  const int key = blockIdx.x * kRowsF + threadIdx.x;
  const float* qg = row_base<float>(p.q, p.qs, b, h);
  const float* dog = row_base<float>(p.dO, p.dos, b, h);
  const float* lg = p.lse + (long long)bh * S;
  const float* dg = p.delta + (long long)bh * S;

  float kr[DP], vr[DP], dk[DP], dv[DP];
  load_row<DP>(kr, row_base<float>(p.k, p.ks, b, h), p.ks[2], key, S, D);
  load_row<DP>(vr, row_base<float>(p.v, p.vs, b, h), p.vs[2], key, S, D);
#pragma unroll
  for (int d = 0; d < DP; ++d) dk[d] = dv[d] = 0.f;
  const float bias = (p.kb && key < S) ? p.kb[(long long)b * S + key] * kLog2e : 0.f;

  for (int q0 = 0; q0 < S; q0 += kTileF) {
    __syncthreads();
    stage_f32<DP>(Qs, qg, p.qs[2], q0, S, D);
    stage_f32<DP>(dOs, dog, p.dos[2], q0, S, D);
    if (threadIdx.x < kTileF) {
      const bool in = q0 + threadIdx.x < S;
      Ls[threadIdx.x] = in ? lg[q0 + threadIdx.x] * kLog2e : INFINITY;
      Ds[threadIdx.x] = in ? dg[q0 + threadIdx.x] : 0.f;
    }
    __syncthreads();
    for (int j = 0; j < kTileF; ++j) {
      float s = 0.f, dp = 0.f;
#pragma unroll
      for (int d = 0; d < DP; ++d) {
        s = fmaf(kr[d], Qs[j][d], s);
        dp = fmaf(vr[d], dOs[j][d], dp);
      }
      const float pj = exp2f(s * p.scale_log2 + bias - Ls[j]);
      const float ds = pj * (dp - Ds[j]);
#pragma unroll
      for (int d = 0; d < DP; ++d) {
        dv[d] = fmaf(pj, dOs[j][d], dv[d]);
        dk[d] = fmaf(ds, Qs[j][d], dk[d]);
      }
    }
  }
  if (key < S) {
    store_row<DP>(row_base_w<float>(p.dk, p.dks, b, h), p.dks[2], key, D, dk, p.scale);
    store_row<DP>(row_base_w<float>(p.dv, p.dvs, b, h), p.dvs[2], key, D, dv, 1.f);
  }
}

template <int DP>
__global__ void __launch_bounds__(128) bwd_dq_f32(Params p) {
  __shared__ __align__(16) float Ks[kTileF][DP];
  __shared__ __align__(16) float Vs[kTileF][DP];
  __shared__ float Bs[kTileF];

  const int S = p.S, D = p.D;
  const int bh = blockIdx.y, b = bh / p.H, h = bh % p.H;
  const int qi = blockIdx.x * kRowsF + threadIdx.x;
  const float* kg = row_base<float>(p.k, p.ks, b, h);
  const float* vg = row_base<float>(p.v, p.vs, b, h);
  const float* kbr = p.kb ? p.kb + (long long)b * S : nullptr;

  float qr[DP], dor[DP], dq[DP];
  load_row<DP>(qr, row_base<float>(p.q, p.qs, b, h), p.qs[2], qi, S, D);
  load_row<DP>(dor, row_base<float>(p.dO, p.dos, b, h), p.dos[2], qi, S, D);
#pragma unroll
  for (int d = 0; d < DP; ++d) dq[d] = 0.f;
  const float L = qi < S ? p.lse[(long long)bh * S + qi] * kLog2e : 0.f;
  const float Dl = qi < S ? p.delta[(long long)bh * S + qi] : 0.f;

  for (int k0 = 0; k0 < S; k0 += kTileF) {
    __syncthreads();
    stage_f32<DP>(Ks, kg, p.ks[2], k0, S, D);
    stage_f32<DP>(Vs, vg, p.vs[2], k0, S, D);
    if (threadIdx.x < kTileF) {
      const int key = k0 + threadIdx.x;
      Bs[threadIdx.x] = key < S ? (kbr ? kbr[key] * kLog2e : 0.f) : -INFINITY;
    }
    __syncthreads();
    for (int j = 0; j < kTileF; ++j) {
      float s = 0.f, dp = 0.f;
#pragma unroll
      for (int d = 0; d < DP; ++d) {
        s = fmaf(qr[d], Ks[j][d], s);
        dp = fmaf(dor[d], Vs[j][d], dp);
      }
      const float ds = exp2f(s * p.scale_log2 + Bs[j] - L) * (dp - Dl);
#pragma unroll
      for (int d = 0; d < DP; ++d) dq[d] = fmaf(ds, Ks[j][d], dq[d]);
    }
  }
  if (qi < S) store_row<DP>(row_base_w<float>(p.dq, p.dqs, b, h), p.dqs[2], qi, D, dq, p.scale);
}

template <int DP>
int launch(const Params& p, int B, int dtype, cudaStream_t stream) {
  const int bh = B * p.H;
  const dim3 rows128((p.S + 127) / 128, bh);
  cudaError_t err;
  if (dtype == 0) {
    bwd_delta<float><<<rows128, 128, 0, stream>>>(p);
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
    bwd_dkdv_f32<DP><<<rows128, kRowsF, 0, stream>>>(p);
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
    bwd_dq_f32<DP><<<rows128, kRowsF, 0, stream>>>(p);
  } else {
    // the shared-memory tile of the other operand: 64 rows, 32 at D = 128
    constexpr int T = DP <= 64 ? 64 : 32;
    const dim3 rows64((p.S + kRows - 1) / kRows, bh);
    bwd_delta<bf16><<<rows128, 128, 0, stream>>>(p);
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
    bwd_dkdv_bf16<DP, T><<<rows64, 128, 0, stream>>>(p);
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
    bwd_dq_bf16<DP, T><<<rows64, 128, 0, stream>>>(p);
  }
  return (int)cudaGetLastError();
}

}  // namespace

// q, k, v, o, dO, dq, dk, dv: (B, H, S, D) with any b/h/s element strides and
// contiguous d, 16-byte aligned rows; strides holds 24 values, (b, h, s) for
// each in that order. kbias: (B, S) float32 or null. lse: (B, H, S) float32
// from the forward (natural log); delta: (B, H, S) float32 scratch.
// dtype: 0 = float32, 1 = bfloat16. D % 8 == 0, D <= 128.
// Returns the first CUDA error of its three launches, or 0.
extern "C" int llt_flash_attn_bwd(const void* q, const void* k, const void* v,
                                  const void* o, const void* dO, const void* kbias,
                                  const void* lse, void* delta, void* dq, void* dk,
                                  void* dv, const long long* strides, int dtype, int B,
                                  int H, int S, int D, void* stream) {
  if (D <= 0 || D > 128 || D % 8 != 0 || (dtype != 0 && dtype != 1))
    return (int)cudaErrorInvalidValue;
  Params p;
  p.q = q;
  p.k = k;
  p.v = v;
  p.o = o;
  p.dO = dO;
  p.kb = static_cast<const float*>(kbias);
  p.lse = static_cast<const float*>(lse);
  p.delta = static_cast<float*>(delta);
  p.dq = dq;
  p.dk = dk;
  p.dv = dv;
  long long* dst[8] = {p.qs, p.ks, p.vs, p.os, p.dos, p.dqs, p.dks, p.dvs};
  for (int i = 0; i < 8; ++i)
    for (int j = 0; j < 3; ++j) dst[i][j] = strides[3 * i + j];
  p.H = H;
  p.S = S;
  p.D = D;
  p.scale = 1.f / sqrtf((float)D);
  p.scale_log2 = p.scale * kLog2e;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (D <= 16) return launch<16>(p, B, dtype, st);
  if (D <= 32) return launch<32>(p, B, dtype, st);
  if (D <= 64) return launch<64>(p, B, dtype, st);
  return launch<128>(p, B, dtype, st);
}
