// Self-attention forward, softmax(Q K^T D^-1/2 + kbias) V, hand-written for
// Hopper (sm_90a).
//
// Replaces the TPU kernel `_kernel` / `_flash_fwd_tpu` in
// lidar_layout_tpu/ops/pallas_attention.py. Same meaning: (B, H, S, D) with
// S_q == S_kv, logits and softmax in f32, an optional f32 per-(batch, key)
// additive bias row (-1e9 on padding), output in the input dtype. When asked
// (training), it also writes each row's f32 log-sum-exp of the logits, the
// residual that the backward kernel (flash_attn_bwd.cu) recomputes P from.
//
// What bounds it on this card: operations. At the flagship's (16, 8, 2048, 32)
// in bf16 it does 4*B*H*S^2*D = 68.7 GFLOP on ~17 MB of inputs, far above the
// ~295 bf16 operations per byte at which the H100 stops being memory-bound.
//
// Design (the TPU kernel's D-major layout and whole-K/V residency are TPU
// choices and are not carried over):
//   * One block per (q-tile, b*h); K/V stream through shared memory in tiles
//     of 64 keys and an online softmax runs in f32 registers, so nothing of
//     size S^2 ever exists and K/V for any S fits.
//   * bf16: 4 warps, 16 query rows each (q-tile 64). Q K^T and P V run on the
//     tensor cores with mma.sync m16n8k16 (bf16 in, f32 accumulate); the S
//     accumulator fragment is re-packed in registers as the A operand of P V,
//     as in FlashAttention-2. V is stored transposed in shared memory so every
//     B fragment is one 32-bit load. P is rounded to bf16 before P V, as the
//     reference rounds p to v's dtype.
//   * f32: the tensor cores have no full-f32 mode, so one thread owns one
//     query row and runs the same online softmax with FMAs; K/V rows are
//     broadcast from shared memory. This path serves the f32 parity runs.
//   * The scale D^-1/2 is applied to the f32 logits together with log2(e),
//     so the softmax uses exp2. Keys past S are masked to -inf and query rows
//     past S are not stored, so S needs no alignment (the TPU kernel needed
//     S % 128 == 0). D is padded with zeros to 16/32/64/128 in shared memory.
//   * Any strides for the b, h and s axes (d contiguous), so q, k and v can
//     be views of one fused qkv projection and o can be written straight into
//     the (B, S, H*D) layout the output projection reads.
//   * Plain synchronous tile loads, no TMA/wgmma/cp.async pipelining yet.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

struct Params {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  const float* kb;  // (B, S) f32 or nullptr
  float* lse;       // (B, H, S) f32 or nullptr
  long long qs[3], ks[3], vs[3], os[3];  // element strides of b, h, s
  int H, S, D;
  float scale_log2;  // D^-1/2 * log2(e)
};

// ---------------------------------------------------------------- bf16 path

constexpr int kBQ = 64;  // query rows per block (4 warps x 16)
constexpr int kBK = 64;  // keys per shared-memory tile

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&h);
}

__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

template <int DP>
__global__ void __launch_bounds__(128) attn_fwd_bf16(Params p) {
  constexpr int KT = DP / 16;     // k16 chunks over D
  constexpr int NT = kBK / 8;     // n8 tiles over the key tile
  constexpr int DT = DP / 8;      // n8 tiles over D
  constexpr int VPR = DP / 8;     // 16-byte vectors per row
  __shared__ __align__(16) __nv_bfloat16 Ks[kBK][DP + 8];  // also stages Q
  __shared__ __align__(16) __nv_bfloat16 Vt[DP][kBK + 8];

  const int S = p.S, D = p.D;
  const int bh = blockIdx.y, b = bh / p.H, h = bh % p.H;
  const int q0 = blockIdx.x * kBQ;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;

  const __nv_bfloat16* qg = static_cast<const __nv_bfloat16*>(p.q) + b * p.qs[0] + h * p.qs[1];
  const __nv_bfloat16* kg = static_cast<const __nv_bfloat16*>(p.k) + b * p.ks[0] + h * p.ks[1];
  const __nv_bfloat16* vg = static_cast<const __nv_bfloat16*>(p.v) + b * p.vs[0] + h * p.vs[1];
  const float* kb = p.kb ? p.kb + (long long)b * S : nullptr;

  // Q tile -> shared -> A fragments (rows warp*16 + g and + 8)
  for (int i = threadIdx.x; i < kBQ * VPR; i += 128) {
    const int r = i / VPR, c = (i % VPR) * 8;
    uint4 val = make_uint4(0, 0, 0, 0);
    if (q0 + r < S && c < D)
      val = *reinterpret_cast<const uint4*>(qg + (q0 + r) * p.qs[2] + c);
    *reinterpret_cast<uint4*>(&Ks[r][c]) = val;
  }
  __syncthreads();
  uint32_t qa[KT][4];
  const int r0 = warp * 16 + g;
#pragma unroll
  for (int kk = 0; kk < KT; ++kk) {
    qa[kk][0] = *reinterpret_cast<const uint32_t*>(&Ks[r0][kk * 16 + 2 * t]);
    qa[kk][1] = *reinterpret_cast<const uint32_t*>(&Ks[r0 + 8][kk * 16 + 2 * t]);
    qa[kk][2] = *reinterpret_cast<const uint32_t*>(&Ks[r0][kk * 16 + 8 + 2 * t]);
    qa[kk][3] = *reinterpret_cast<const uint32_t*>(&Ks[r0 + 8][kk * 16 + 8 + 2 * t]);
  }

  float oacc[DT][4];
#pragma unroll
  for (int i = 0; i < DT; ++i) oacc[i][0] = oacc[i][1] = oacc[i][2] = oacc[i][3] = 0.f;
  float m0 = -INFINITY, m1 = -INFINITY, l0 = 0.f, l1 = 0.f;

  for (int k0 = 0; k0 < S; k0 += kBK) {
    __syncthreads();  // previous tile (or the Q staging) fully consumed
    for (int i = threadIdx.x; i < kBK * VPR; i += 128) {
      const int r = i / VPR, c = (i % VPR) * 8;
      uint4 kv = make_uint4(0, 0, 0, 0), vv = make_uint4(0, 0, 0, 0);
      if (k0 + r < S && c < D) {
        kv = *reinterpret_cast<const uint4*>(kg + (k0 + r) * p.ks[2] + c);
        vv = *reinterpret_cast<const uint4*>(vg + (k0 + r) * p.vs[2] + c);
      }
      *reinterpret_cast<uint4*>(&Ks[r][c]) = kv;
      const __nv_bfloat16* ve = reinterpret_cast<const __nv_bfloat16*>(&vv);
#pragma unroll
      for (int j = 0; j < 8; ++j) Vt[c + j][r] = ve[j];
    }
    __syncthreads();

    // S = Q K^T for this warp's 16 rows x 64 keys
    float sacc[NT][4];
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      sacc[nt][0] = sacc[nt][1] = sacc[nt][2] = sacc[nt][3] = 0.f;
#pragma unroll
      for (int kk = 0; kk < KT; ++kk) {
        const uint32_t b0 = *reinterpret_cast<const uint32_t*>(&Ks[nt * 8 + g][kk * 16 + 2 * t]);
        const uint32_t b1 = *reinterpret_cast<const uint32_t*>(&Ks[nt * 8 + g][kk * 16 + 8 + 2 * t]);
        mma_bf16(sacc[nt], qa[kk], b0, b1);
      }
    }

    // scale, bias, ragged-edge mask; row maxima (rows g and g + 8)
    float mx0 = -INFINITY, mx1 = -INFINITY;
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int key = k0 + nt * 8 + 2 * t + j;
        float s0 = -INFINITY, s1 = -INFINITY;
        if (key < S) {
          const float bias = kb ? kb[key] * kLog2e : 0.f;
          s0 = sacc[nt][j] * p.scale_log2 + bias;
          s1 = sacc[nt][2 + j] * p.scale_log2 + bias;
        }
        sacc[nt][j] = s0;
        sacc[nt][2 + j] = s1;
        mx0 = fmaxf(mx0, s0);
        mx1 = fmaxf(mx1, s1);
      }
    }
#pragma unroll
    for (int off = 1; off <= 2; off <<= 1) {
      mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, off));
      mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, off));
    }
    const float mn0 = fmaxf(m0, mx0), mn1 = fmaxf(m1, mx1);
    const float corr0 = exp2f(m0 - mn0), corr1 = exp2f(m1 - mn1);
    m0 = mn0;
    m1 = mn1;
    l0 *= corr0;
    l1 *= corr1;
#pragma unroll
    for (int i = 0; i < DT; ++i) {
      oacc[i][0] *= corr0;
      oacc[i][1] *= corr0;
      oacc[i][2] *= corr1;
      oacc[i][3] *= corr1;
    }

    // P = exp2(S - m) re-packed as A fragments (k16 chunk = two n8 tiles)
    uint32_t pa[NT / 2][4];
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      const float p0 = exp2f(sacc[nt][0] - mn0), p1 = exp2f(sacc[nt][1] - mn0);
      const float p2 = exp2f(sacc[nt][2] - mn1), p3 = exp2f(sacc[nt][3] - mn1);
      l0 += p0 + p1;
      l1 += p2 + p3;
      pa[nt / 2][(nt % 2) * 2 + 0] = pack_bf16(p0, p1);
      pa[nt / 2][(nt % 2) * 2 + 1] = pack_bf16(p2, p3);
    }

    // O += P V
#pragma unroll
    for (int dt = 0; dt < DT; ++dt) {
#pragma unroll
      for (int kc = 0; kc < NT / 2; ++kc) {
        const uint32_t b0 = *reinterpret_cast<const uint32_t*>(&Vt[dt * 8 + g][kc * 16 + 2 * t]);
        const uint32_t b1 = *reinterpret_cast<const uint32_t*>(&Vt[dt * 8 + g][kc * 16 + 8 + 2 * t]);
        mma_bf16(oacc[dt], pa[kc], b0, b1);
      }
    }
  }

#pragma unroll
  for (int off = 1; off <= 2; off <<= 1) {
    l0 += __shfl_xor_sync(0xffffffffu, l0, off);
    l1 += __shfl_xor_sync(0xffffffffu, l1, off);
  }
  const float inv0 = 1.f / l0, inv1 = 1.f / l1;
  __nv_bfloat16* og = static_cast<__nv_bfloat16*>(p.o) + b * p.os[0] + h * p.os[1];
  const int row0 = q0 + r0, row1 = row0 + 8;
  if (p.lse && t == 0) {  // natural-log units: (m + log2 l) * ln 2
    float* lg = p.lse + (long long)bh * S;
    if (row0 < S) lg[row0] = (m0 + log2f(l0)) * kLn2;
    if (row1 < S) lg[row1] = (m1 + log2f(l1)) * kLn2;
  }
#pragma unroll
  for (int dt = 0; dt < DT; ++dt) {
    const int c = dt * 8 + 2 * t;
    if (dt * 8 >= D) break;
    if (row0 < S)
      *reinterpret_cast<uint32_t*>(og + row0 * p.os[2] + c) =
          pack_bf16(oacc[dt][0] * inv0, oacc[dt][1] * inv0);
    if (row1 < S)
      *reinterpret_cast<uint32_t*>(og + row1 * p.os[2] + c) =
          pack_bf16(oacc[dt][2] * inv1, oacc[dt][3] * inv1);
  }
}

// ---------------------------------------------------------------- f32 path

constexpr int kQF = 128;  // query rows per block, one per thread
constexpr int kKF = 32;   // keys per shared-memory tile

template <int DP>
__global__ void __launch_bounds__(128) attn_fwd_f32(Params p) {
  constexpr int VPR = DP / 4;  // float4 vectors per row
  __shared__ __align__(16) float Ks[kKF][DP];
  __shared__ __align__(16) float Vs[kKF][DP];

  const int S = p.S, D = p.D;
  const int bh = blockIdx.y, b = bh / p.H, h = bh % p.H;
  const int qi = blockIdx.x * kQF + threadIdx.x;
  const float* qg = static_cast<const float*>(p.q) + b * p.qs[0] + h * p.qs[1];
  const float* kg = static_cast<const float*>(p.k) + b * p.ks[0] + h * p.ks[1];
  const float* vg = static_cast<const float*>(p.v) + b * p.vs[0] + h * p.vs[1];
  const float* kb = p.kb ? p.kb + (long long)b * S : nullptr;

  float qr[DP], o[DP];
#pragma unroll
  for (int d = 0; d < DP; d += 4) {
    float4 val = make_float4(0.f, 0.f, 0.f, 0.f);
    if (qi < S && d < D) val = *reinterpret_cast<const float4*>(qg + qi * p.qs[2] + d);
    qr[d] = val.x;
    qr[d + 1] = val.y;
    qr[d + 2] = val.z;
    qr[d + 3] = val.w;
    o[d] = o[d + 1] = o[d + 2] = o[d + 3] = 0.f;
  }
  float m = -INFINITY, l = 0.f;

  for (int k0 = 0; k0 < S; k0 += kKF) {
    __syncthreads();
    for (int i = threadIdx.x; i < kKF * VPR; i += kQF) {
      const int r = i / VPR, c = (i % VPR) * 4;
      float4 kv = make_float4(0.f, 0.f, 0.f, 0.f), vv = kv;
      if (k0 + r < S && c < D) {
        kv = *reinterpret_cast<const float4*>(kg + (k0 + r) * p.ks[2] + c);
        vv = *reinterpret_cast<const float4*>(vg + (k0 + r) * p.vs[2] + c);
      }
      *reinterpret_cast<float4*>(&Ks[r][c]) = kv;
      *reinterpret_cast<float4*>(&Vs[r][c]) = vv;
    }
    __syncthreads();

    float s[kKF];
    float mx = -INFINITY;
#pragma unroll
    for (int j = 0; j < kKF; ++j) {
      float acc = 0.f;
#pragma unroll
      for (int d = 0; d < DP; ++d) acc = fmaf(qr[d], Ks[j][d], acc);
      const int key = k0 + j;
      s[j] = key < S ? acc * p.scale_log2 + (kb ? kb[key] * kLog2e : 0.f) : -INFINITY;
      mx = fmaxf(mx, s[j]);
    }
    const float mn = fmaxf(m, mx);
    const float corr = exp2f(m - mn);
    m = mn;
    l *= corr;
#pragma unroll
    for (int d = 0; d < DP; ++d) o[d] *= corr;
#pragma unroll
    for (int j = 0; j < kKF; ++j) {
      const float pj = exp2f(s[j] - mn);
      l += pj;
#pragma unroll
      for (int d = 0; d < DP; ++d) o[d] = fmaf(pj, Vs[j][d], o[d]);
    }
  }

  if (qi < S) {
    float* og = static_cast<float*>(p.o) + b * p.os[0] + h * p.os[1] + qi * p.os[2];
    const float inv = 1.f / l;
    if (p.lse) p.lse[(long long)bh * S + qi] = (m + log2f(l)) * kLn2;
#pragma unroll
    for (int d = 0; d < DP; d += 4)
      if (d < D)
        *reinterpret_cast<float4*>(og + d) =
            make_float4(o[d] * inv, o[d + 1] * inv, o[d + 2] * inv, o[d + 3] * inv);
  }
}

template <int DP>
void launch(const Params& p, int B, int dtype, cudaStream_t stream) {
  if (dtype == 0) {
    dim3 grid((p.S + kQF - 1) / kQF, B * p.H);
    attn_fwd_f32<DP><<<grid, kQF, 0, stream>>>(p);
  } else {
    dim3 grid((p.S + kBQ - 1) / kBQ, B * p.H);
    attn_fwd_bf16<DP><<<grid, 128, 0, stream>>>(p);
  }
}

}  // namespace

// q, k, v: (B, H, S, D) with any b/h/s element strides and contiguous d;
// strides holds 12 values, (b, h, s) for q, k, v, then o. kbias: (B, S)
// float32 or null. lse: (B, H, S) float32 written when not null.
// dtype: 0 = float32, 1 = bfloat16. D % 8 == 0, D <= 128.
// Returns cudaGetLastError() after the launch.
extern "C" int llt_flash_attn_fwd(const void* q, const void* k, const void* v,
                                  const void* kbias, void* o, void* lse,
                                  const long long* strides, int dtype, int B,
                                  int H, int S, int D, void* stream) {
  if (D <= 0 || D > 128 || D % 8 != 0 || (dtype != 0 && dtype != 1))
    return (int)cudaErrorInvalidValue;
  Params p;
  p.q = q;
  p.k = k;
  p.v = v;
  p.o = o;
  p.kb = static_cast<const float*>(kbias);
  p.lse = static_cast<float*>(lse);
  for (int i = 0; i < 3; ++i) {
    p.qs[i] = strides[i];
    p.ks[i] = strides[3 + i];
    p.vs[i] = strides[6 + i];
    p.os[i] = strides[9 + i];
  }
  p.H = H;
  p.S = S;
  p.D = D;
  p.scale_log2 = (1.f / sqrtf((float)D)) * kLog2e;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (D <= 16)
    launch<16>(p, B, dtype, st);
  else if (D <= 32)
    launch<32>(p, B, dtype, st);
  else if (D <= 64)
    launch<64>(p, B, dtype, st);
  else
    launch<128>(p, B, dtype, st);
  return (int)cudaGetLastError();
}
