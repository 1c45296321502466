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
// What bounds it on this card: operations. The bf16 path does 10*B*H*S^2*D
// operations and B*H*S^2 exponentials, as the JAX CostEstimate counts: 171.8
// GFLOP and 537 M exponentials at the flagship's (16, 8, 2048, 32), or 0.174
// ms at 989 TFLOP/s and 0.13 ms for the special-function unit (16 exp2 a
// clock per SM, 1.98 GHz, 132 SMs), against 0.040 ms for its bytes.
//
// Why the design differs from the TPU kernel: that kernel keeps all of K and
// V of a (batch, head) in VMEM, recomputes each q-block's softmax with no
// saved statistics, and sums dk/dv over the sequential q grid axis in a
// revisited output block. On the H100 blocks run in parallel in no order,
// and K/V for S = 2048 in f32 do not fit a block's shared memory. So
// (FlashAttention-2):
//   * The forward (flash_attn_fwd.cu) saves each row's log-sum-exp less the
//     largest key bias of its batch row (bmax, 0 without a bias), and P =
//     exp((S - bmax) - lse) is recomputed tile by tile: with every key of a
//     row at the padding bias (-1e9) the products round away, S - bmax is
//     0 and P the uniform 1 / S of the forward (an lse near -1e9 would
//     have lost log S to rounding).
//   * A small pass writes delta = rowsum(dO * O) in f32.
//   * bf16, the main pass: one block of 8 warps owns 128 keys of one (batch,
//     head), a warp 16 of them, and loops over the query tiles (64 queries,
//     32 at D = 128). Per tile, with K and V as A fragments: S^T = K Q^T and
//     dP^T = V dO^T, then P^T = exp2(S^T * scale_log2 - lse_log2) (one FFMA
//     and one MUFU.EX2 without a bias; with one, the biased logit less bmax
//     less lse_log2, two FADDs more) and dS^T = P^T (dP^T - delta), each
//     exponential taken once; dV += P^T dO and dK += dS^T Q in registers.
//     dS^T goes to shared memory (bf16), and the block forms its partial
//     dQ = dS K of the tile over its 128 keys.
//     So the bf16 path takes B*H*S^2 exponentials and 10*B*H*S^2*D FLOPs.
//   * Every output is summed in a fixed order, so two launches give the
//     same bits (the TPU kernel sums into a revisited output block, also in
//     order). dk and dv are summed by one warp. dq sums over the key blocks
//     of a (b, h): each block stores its f32 partial of each query tile
//     from the fragments (plain stores into its own slice of a scratch
//     buffer, where an earlier design added them into one accumulator by
//     float4 RED atomics in no fixed order), and a last pass sums the
//     partials in index order and writes dq in bf16. No block waits for
//     another. With one key block (S <= 128) the block writes dq directly.
//     Tried on the H100 at (16, 8, 2048, 32), in chip_smoke.py's timing
//     phase, against 0.900 ms for the RED atomics (the partials of this
//     design were then staged in shared memory behind a block barrier:
//     1.195 ms; as kept, 1.047 ms): thread block clusters of 8 key blocks
//     summing their partials through distributed shared memory, one
//     cluster barrier a tile, 1.454 ms; the block that counts a tile last
//     on a counter sums it (threadfence reduction), 1.251 ms, its fence on
//     the path of every tile. Not built: ordered REDs behind a turn counter
//     per tile (FlashAttention-3's deterministic mode), which spin on global
//     memory and rest their progress on the order in which blocks are
//     launched; and a separate dq pass over the key blocks in order
//     (FlashAttention-2's split), which recomputes S, P and dP: three more
//     products where this design adds a pass over the partials.
//   * Copies: K and V of the block, then the Q, dO, lse and delta tiles
//     through a ring of NS slots filled by cp.async copies (16 bytes; 4 for
//     lse and delta, whose rows need not be 16-byte aligned), tiles j + 1 ..
//     j + NS - 1 in flight while tile j is computed. Every operand is staged
//     once, row-major, with a pitch of D+8 elements (no bank conflicts for
//     ldmatrix), and read with ldmatrix plain or .trans as each product needs
//     (Q and dO are B operands both ways round). At D <= 64 the K and V fragments stay in
//     registers; at D = 128 they are re-read from shared memory.
//     (Plain loads of lse and delta made their warps wait on global memory
//     right before the tile's barrier.)
//   * Two blocks (16 warps) an SM at D <= 32, so at most 128 registers a
//     thread. Timed against it in turns on the H100 at (16, 8, 2048, 32),
//     one block an SM (234 registers), and, while dq was summed by REDs, a
//     bulk (TMA) reduction of each dQ tile in their place and 256-key blocks
//     of 16 warps (half the REDs) were each slower.
//     P, dS and their products go a k16 chunk of queries at a time, so one
//     chunk of each is live in registers.
//   * ptxas (sm_90a, CUDA 12.8) at D = 32: 128 registers, 16 bytes of stack,
//     60,416 bytes of dynamic shared memory a block; one MUFU.EX2 per (key,
//     query) pair in the SASS (32 a tile of 16 x 64 per thread).
//   * Rows past S are zero-filled, lse and delta too: there P = exp2(0) but
//     dO = 0, so they add nothing to dV, dS = 0 adds nothing to dK, and their
//     dq is not stored. So S needs no alignment; D is padded to 16/32/64/128.
//     Any strides for the b, h and s axes, as in the forward, so q, k and v
//     can be views of one fused qkv projection and dq/dk/dv can be written in
//     any layout.
//   * f32 (the parity runs): one thread per key (dK/dV) or per query (dQ)
//     with FMAs, since the tensor cores have no full-f32 mode; two kernels
//     recompute P twice, no atomics.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "mma_tiles.cuh"

namespace {

using namespace mma_tiles;
constexpr float kLog2e = 1.4426950408889634f;
constexpr int kMaxDevices = 64;  // devices whose launch set-up is remembered

struct Params {
  const void* q;
  const void* k;
  const void* v;
  const void* o;
  const void* dO;
  const float* kb;   // (B, S) f32 or nullptr
  const float* lse;  // (B*H, S) f32, natural log
  float* delta;      // (B*H, S) f32, written by the first pass
  float* dqpart;     // (kblocks, B*H, S, D) f32 partials of dq (bf16 path, kblocks > 1)
  void* dq;
  void* dk;
  void* dv;
  // element strides of b, h, s for q, k, v, o, dO, dq, dk, dv
  long long qs[3], ks[3], vs[3], os[3], dos[3], dqs[3], dks[3], dvs[3];
  int H, S, D;
  int kblocks;       // key blocks a (b, h), ceil(S / 128)
  float scale;       // D^-1/2
  float scale_log2;  // D^-1/2 * log2(e)
};

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
  const int tiles = (p.S + 127) / 128;  // B*H on x with the row tiles: no 65535 limit
  const int bh = blockIdx.x / tiles, b = bh / p.H, h = bh % p.H;
  const int i = blockIdx.x % tiles * 128 + threadIdx.x;
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

constexpr int kBKV = 128;  // keys a block owns
constexpr int kNWB = 8;    // warps, 16 keys each

template <int DP>
struct BwdTile {
  static constexpr int BQ = DP <= 64 ? 64 : 32;  // queries per tile
  static constexpr int NS = 2;                    // query tiles in the ring
  static constexpr int LD = DP + 8;              // pitch of K, V, Q, dO tiles
  static constexpr int LDS = BQ + 8;             // pitch of the dS^T tile
  // K, V; NS slots of Q and dO; dS^T; NS slots of lse and delta
  static constexpr int kSmem = (2 * kBKV + 2 * NS * BQ) * LD * 2 + kBKV * LDS * 2 +
                               2 * NS * BQ * 4;
};

template <int DP, bool BIAS>
__global__ void __launch_bounds__(kNWB * 32, DP <= 32 ? 2 : 1) bwd_bf16(Params p) {
  using T = BwdTile<DP>;
  constexpr int BQ = T::BQ, NS = T::NS, LD = T::LD, LDS = T::LDS;
  constexpr int NTH = kNWB * 32;
  constexpr int KT = DP / 16;   // k16 chunks over D
  constexpr int DT = DP / 8;    // n8 tiles over D
  constexpr int NT = BQ / 8;    // n8 tiles over the query tile
  constexpr int QC = BQ / 16;   // k16 chunks over the query tile
  constexpr int RG = BQ / 16;   // dQ: groups of 16 query rows ...
  constexpr int DG = kNWB / RG;  // ... times groups of columns
  constexpr int NDW = DT / DG;   // n8 tiles over D per warp
  constexpr bool KREG = DP <= 64;  // K, V A fragments held in registers
  static_assert(NDW == 1 || (NDW >= 2 && NDW % 2 == 0), "dQ split");
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* Ks = reinterpret_cast<bf16*>(smem);
  bf16* Vs = Ks + kBKV * LD;
  bf16* Qs = Vs + kBKV * LD;      // NS slots of BQ x LD
  bf16* dOs = Qs + NS * BQ * LD;  // NS slots of BQ x LD
  bf16* dSt = dOs + NS * BQ * LD; // kBKV x LDS
  float* Ls = reinterpret_cast<float*>(dSt + kBKV * LDS);  // NS slots of BQ (lse)
  float* Dl = Ls + NS * BQ;                                 // NS slots of BQ

  const int S = p.S, D = p.D;
  const int kblk = blockIdx.x % p.kblocks;
  const int bh = blockIdx.x / p.kblocks, b = bh / p.H, h = bh % p.H;
  const int k0 = kblk * kBKV;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int kr0 = k0 + warp * 16 + g, kr1 = kr0 + 8;
  const float sl2 = p.scale_log2;

  const bf16* qg = row_base<bf16>(p.q, p.qs, b, h);
  const bf16* dog = row_base<bf16>(p.dO, p.dos, b, h);
  const float* lg = p.lse + (long long)bh * S;
  const float* dg = p.delta + (long long)bh * S;
  float kb0 = 0.f, kb1 = 0.f, bmax = 0.f;
  if (BIAS) {
    const float* kbr = p.kb + (long long)b * S;
    if (kr0 < S) kb0 = kbr[kr0] * kLog2e;
    if (kr1 < S) kb1 = kbr[kr1] * kLog2e;
    bmax = block_max(kbr, S) * kLog2e;
  }
  const int nq = (S + BQ - 1) / BQ;
  const int rg = warp % RG, dgp = warp / RG;  // this warp's dQ rows and columns

  // this block's f32 partial of dq
  float* part = p.kblocks > 1
                    ? p.dqpart + ((long long)kblk * (gridDim.x / p.kblocks) + bh) * S * D
                    : nullptr;
  // this block's partial of query tile jt from its warps' dQ fragments (dq
  // itself in bf16 when the block is the (b, h)'s only key block)
  auto store_tile = [&](int jt, const float (&f)[NDW][4]) {
#pragma unroll
    for (int n = 0; n < NDW; ++n) {
      const int c = (dgp * NDW + n) * 8 + 2 * t;
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        const int row = jt * BQ + rg * 16 + g + 8 * hf;
        if (row < S && c < D) {
          if (p.kblocks > 1)
            *reinterpret_cast<float2*>(part + (long long)row * D + c) =
                make_float2(f[n][2 * hf], f[n][2 * hf + 1]);
          else
            *reinterpret_cast<uint32_t*>(row_base_w<bf16>(p.dq, p.dqs, b, h) +
                                         row * p.dqs[2] + c) =
                pack_bf16(f[n][2 * hf] * p.scale, f[n][2 * hf + 1] * p.scale);
        }
      }
    }
  };

  auto issue = [&](int j) {  // copies of query tile j into slot j % NS
    if (j < nq) {
      const int slot = j % NS, qq = j * BQ;
      load_tile<BQ, DP, LD, NTH>(Qs + slot * BQ * LD, qg, p.qs[2], qq, S, D);
      load_tile<BQ, DP, LD, NTH>(dOs + slot * BQ * LD, dog, p.dos[2], qq, S, D);
      for (int i = threadIdx.x; i < BQ; i += NTH) {
        const bool in = qq + i < S;
        cp_async4(smem_addr(Ls + slot * BQ + i), in ? lg + qq + i : lg, in);
        cp_async4(smem_addr(Dl + slot * BQ + i), in ? dg + qq + i : dg, in);
      }
    }
    cp_async_commit();  // an empty group past the end keeps the count
  };

  load_tile<kBKV, DP, LD, NTH>(Ks, row_base<bf16>(p.k, p.ks, b, h), p.ks[2], k0, S, D);
  load_tile<kBKV, DP, LD, NTH>(Vs, row_base<bf16>(p.v, p.vs, b, h), p.vs[2], k0, S, D);
#pragma unroll
  for (int j = 0; j < NS - 1; ++j) issue(j);  // K and V ride with query tile 0

  uint32_t ka[KREG ? KT : 1][4], va[KREG ? KT : 1][4];
  float dk[DT][4], dv[DT][4];
#pragma unroll
  for (int i = 0; i < DT; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk[i][e] = dv[i][e] = 0.f;
  const int rofs = b_rows_offset(lane, LD), tofs = b_trans_offset(lane, LD);

  for (int j = 0; j < nq; ++j) {
    cp_async_wait<NS - 2>();  // this thread's copies of tile j have landed
    __syncthreads();  // everyone's have; tile j - 1 and its dS^T tile are consumed
    issue(j + NS - 1);  // into the slot tile j - 1 used
    if (KREG && j == 0) {
      load_a<KREG ? KT : 1, LD>(ka, Ks, warp * 16, lane);
      load_a<KREG ? KT : 1, LD>(va, Vs, warp * 16, lane);
    }
    const int slot = j % NS;
    const bf16* Qt = Qs + slot * BQ * LD;
    const bf16* dOt = dOs + slot * BQ * LD;
    const float* Lt = Ls + slot * BQ;
    const float* Dd = Dl + slot * BQ;

    // S^T = K Q^T and dP^T = V dO^T: this warp's 16 keys x BQ queries
    float st[NT][4], dpt[NT][4];
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) st[nt][e] = dpt[nt][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < KT; ++kk) {
      uint32_t kf[4], vf[4];
      if (KREG) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          kf[e] = ka[KREG ? kk : 0][e];
          vf[e] = va[KREG ? kk : 0][e];
        }
      } else {
        const int off = (warp * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * LD + kk * 16 +
                        (lane >> 4) * 8;
        ldsm_x4(kf, smem_addr(Ks + off));
        ldsm_x4(vf, smem_addr(Vs + off));
      }
#pragma unroll
      for (int n2 = 0; n2 < NT / 2; ++n2) {
        uint32_t qf[4], df[4];
        ldsm_x4(qf, smem_addr(Qt + n2 * 16 * LD + kk * 16 + rofs));
        ldsm_x4(df, smem_addr(dOt + n2 * 16 * LD + kk * 16 + rofs));
        mma_bf16(st[2 * n2], kf, qf[0], qf[1]);
        mma_bf16(st[2 * n2 + 1], kf, qf[2], qf[3]);
        mma_bf16(dpt[2 * n2], vf, df[0], df[1]);
        mma_bf16(dpt[2 * n2 + 1], vf, df[2], df[3]);
      }
    }

    // P^T and dS^T (rows: keys kr0, kr1; columns: queries nt*8 + 2t + {0, 1}),
    // each exponential once, a k16 chunk of queries at a time: the chunk's
    // dS^T also goes to shared memory for dQ, then dV += P^T dO and
    // dK += dS^T Q for the chunk (B operands read with .trans: k = query)
    bf16* dsw = dSt + (warp * 16 + g) * LDS + 2 * t;
#pragma unroll
    for (int kc = 0; kc < QC; ++kc) {
      uint32_t pa[4], sa[4];
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int nt = 2 * kc + e;
        float2 nl = *reinterpret_cast<const float2*>(Lt + nt * 8 + 2 * t);
        nl.x *= -kLog2e;  // -lse in log2 units
        nl.y *= -kLog2e;
        const float2 dd = *reinterpret_cast<const float2*>(Dd + nt * 8 + 2 * t);
        const float p0 = ex2(BIAS ? fmaf(st[nt][0], sl2, kb0) - bmax + nl.x
                                  : fmaf(st[nt][0], sl2, nl.x));
        const float p1 = ex2(BIAS ? fmaf(st[nt][1], sl2, kb0) - bmax + nl.y
                                  : fmaf(st[nt][1], sl2, nl.y));
        const float p2 = ex2(BIAS ? fmaf(st[nt][2], sl2, kb1) - bmax + nl.x
                                  : fmaf(st[nt][2], sl2, nl.x));
        const float p3 = ex2(BIAS ? fmaf(st[nt][3], sl2, kb1) - bmax + nl.y
                                  : fmaf(st[nt][3], sl2, nl.y));
        pa[2 * e] = pack_bf16(p0, p1);
        pa[2 * e + 1] = pack_bf16(p2, p3);
        sa[2 * e] = pack_bf16(p0 * (dpt[nt][0] - dd.x), p1 * (dpt[nt][1] - dd.y));
        sa[2 * e + 1] = pack_bf16(p2 * (dpt[nt][2] - dd.x), p3 * (dpt[nt][3] - dd.y));
        *reinterpret_cast<uint32_t*>(dsw + nt * 8) = sa[2 * e];
        *reinterpret_cast<uint32_t*>(dsw + 8 * LDS + nt * 8) = sa[2 * e + 1];
      }
#pragma unroll
      for (int d2 = 0; d2 < DT / 2; ++d2) {
        uint32_t of[4], qf[4];
        ldsm_x4_trans(of, smem_addr(dOt + kc * 16 * LD + d2 * 16 + tofs));
        ldsm_x4_trans(qf, smem_addr(Qt + kc * 16 * LD + d2 * 16 + tofs));
        mma_bf16(dv[2 * d2], pa, of[0], of[1]);
        mma_bf16(dv[2 * d2 + 1], pa, of[2], of[3]);
        mma_bf16(dk[2 * d2], sa, qf[0], qf[1]);
        mma_bf16(dk[2 * d2 + 1], sa, qf[2], qf[3]);
      }
    }
    __syncthreads();  // the dS^T tile is complete

    // dQ (16 queries x NDW n8 tiles of D per warp) = dS K over the block's
    // keys, this block's partial of the tile
    float dq[NDW][4];
#pragma unroll
    for (int n = 0; n < NDW; ++n) dq[n][0] = dq[n][1] = dq[n][2] = dq[n][3] = 0.f;
#pragma unroll
    for (int kc = 0; kc < kBKV / 16; ++kc) {
      uint32_t sf[4];
      ldsm_x4_trans(sf, smem_addr(dSt + kc * 16 * LDS + rg * 16 + b_rows_offset(lane, LDS)));
      const bf16* kt = Ks + kc * 16 * LD + dgp * NDW * 8 + tofs;
      if (NDW == 1) {
        uint32_t b0, b1;
        ldsm_x2_trans(b0, b1, smem_addr(kt));
        mma_bf16(dq[0], sf, b0, b1);
      } else {
#pragma unroll
        for (int n2 = 0; n2 < NDW / 2; ++n2) {
          uint32_t kf[4];
          ldsm_x4_trans(kf, smem_addr(kt + n2 * 16));
          mma_bf16(dq[2 * n2], sf, kf[0], kf[1]);
          mma_bf16(dq[2 * n2 + 1], sf, kf[2], kf[3]);
        }
      }
    }
    store_tile(j, dq);
  }
  cp_async_wait<0>();  // no copy may outlive the block

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

// dq = D^-1/2 * the key blocks' f32 partials summed in index order, in bf16
// into dq's strides; one thread per 8 columns of a row
__global__ void __launch_bounds__(256) bwd_dq_sum(Params p, long long total) {
  const long long i = (long long)blockIdx.x * 256 + threadIdx.x;
  if (i >= total) return;
  const int vpr = p.D / 8;
  const long long row = i / vpr;  // over B*H*S
  const int c = (int)(i % vpr) * 8;
  const int bh = (int)(row / p.S), r = (int)(row % p.S);
  const long long stride = total / vpr * p.D;  // elements of one partial, B*H*S*D
  const float* src = p.dqpart + row * p.D + c;
  float a[8], e[8];
  load8(src, a);
  for (int q = 1; q < p.kblocks; ++q) {
    load8(src + q * stride, e);
#pragma unroll
    for (int k = 0; k < 8; ++k) a[k] += e[k];
  }
  uint4 out;
  uint32_t* o = reinterpret_cast<uint32_t*>(&out);
#pragma unroll
  for (int k = 0; k < 4; ++k) o[k] = pack_bf16(a[2 * k] * p.scale, a[2 * k + 1] * p.scale);
  *reinterpret_cast<uint4*>(row_base_w<bf16>(p.dq, p.dqs, bh / p.H, bh % p.H) + r * p.dqs[2] +
                            c) = out;
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
  const int tiles = (S + kRowsF - 1) / kRowsF;
  const int bh = blockIdx.x / tiles, b = bh / p.H, h = bh % p.H;
  const int key = blockIdx.x % tiles * kRowsF + threadIdx.x;
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
  const float bmax = p.kb ? block_max(p.kb + (long long)b * S, S) * kLog2e : 0.f;

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
      const float pj = exp2f(s * p.scale_log2 + bias - bmax - Ls[j]);
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
  const int tiles = (S + kRowsF - 1) / kRowsF;
  const int bh = blockIdx.x / tiles, b = bh / p.H, h = bh % p.H;
  const int qi = blockIdx.x % tiles * kRowsF + threadIdx.x;
  const float* kg = row_base<float>(p.k, p.ks, b, h);
  const float* vg = row_base<float>(p.v, p.vs, b, h);
  const float* kbr = p.kb ? p.kb + (long long)b * S : nullptr;
  const float bmax = kbr ? block_max(kbr, S) * kLog2e : 0.f;

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
      const float ds = exp2f(s * p.scale_log2 + Bs[j] - bmax - L) * (dp - Dl);
#pragma unroll
      for (int d = 0; d < DP; ++d) dq[d] = fmaf(ds, Ks[j][d], dq[d]);
    }
  }
  if (qi < S) store_row<DP>(row_base_w<float>(p.dq, p.dqs, b, h), p.dqs[2], qi, D, dq, p.scale);
}

template <int DP, bool BIAS>
cudaError_t launch_bf16(const Params& p, int B, cudaStream_t stream) {
  constexpr int smem = BwdTile<DP>::kSmem;
  static bool ready[kMaxDevices] = {};   // an attribute is set on each device apart
  int cur = 0;
  cudaGetDevice(&cur);
  if (cur >= kMaxDevices || !ready[cur]) {  // opt in to more than 48 KB of shared memory,
    cudaFuncSetAttribute(bwd_bf16<DP, BIAS>,  // all of it shared
                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    cudaFuncSetAttribute(bwd_bf16<DP, BIAS>, cudaFuncAttributePreferredSharedMemoryCarveout,
                         cudaSharedmemCarveoutMaxShared);
    if (cur < kMaxDevices) ready[cur] = true;
  }
  bwd_bf16<DP, BIAS><<<p.kblocks * B * p.H, kNWB * 32, smem, stream>>>(p);  // B*H on x
  return cudaGetLastError();
}

template <int DP>
int launch(const Params& p, int B, int dtype, cudaStream_t stream) {
  const int bh = B * p.H;
  const dim3 rows128((p.S + 127) / 128 * bh);  // B*H on x with the row tiles
  cudaError_t err;
  if (dtype == 0) {
    bwd_delta<float><<<rows128, 128, 0, stream>>>(p);
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
    bwd_dkdv_f32<DP><<<rows128, kRowsF, 0, stream>>>(p);
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
    bwd_dq_f32<DP><<<rows128, kRowsF, 0, stream>>>(p);
  } else {
    bwd_delta<bf16><<<rows128, 128, 0, stream>>>(p);
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
    err = p.kb ? launch_bf16<DP, true>(p, B, stream) : launch_bf16<DP, false>(p, B, stream);
    if (err != cudaSuccess) return (int)err;
    if (p.kblocks > 1) {
      const long long total = (long long)bh * p.S * (p.D / 8);
      bwd_dq_sum<<<(unsigned)((total + 255) / 256), 256, 0, stream>>>(p, total);
    }
  }
  return (int)cudaGetLastError();
}

}  // namespace

// q, k, v, o, dO, dq, dk, dv: (B, H, S, D) with any b/h/s element strides and
// contiguous d, 16-byte aligned rows; strides holds 24 values, (b, h, s) for
// each in that order. kbias: (B, S) float32 or null. lse: (B, H, S) float32
// from the forward (natural log); delta: (B, H, S) float32 scratch. For
// bfloat16 with S > 128, dqpart: (ceil(S / 128), B, H, S, D) float32
// scratch, else it may be null. dtype: 0 = float32, 1 = bfloat16. D % 8 == 0,
// D <= 128. Returns the first CUDA error of its launches, or 0.
extern "C" int llt_flash_attn_bwd(const void* q, const void* k, const void* v,
                                  const void* o, const void* dO, const void* kbias,
                                  const void* lse, void* delta, void* dqpart, void* dq,
                                  void* dk, void* dv, const long long* strides,
                                  int dtype, int B, int H, int S, int D, void* stream) {
  const int kb = (S + kBKV - 1) / kBKV;
  if (D <= 0 || D > 128 || D % 8 != 0 || (dtype != 0 && dtype != 1) || S <= 0 ||
      (dtype == 1 && kb > 1 && dqpart == nullptr) ||
      (long long)B * H * kb > 0x7fffffffLL)
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
  p.dqpart = static_cast<float*>(dqpart);
  p.kblocks = kb;
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
