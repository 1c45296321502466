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
// What bounds it on this card. Operations: 4*B*H*S^2*D on the tensor cores
// (68.7 GFLOP at the flagship's (16, 8, 2048, 32) in bf16, 0.069 ms at 989
// TFLOP/s), on ~17 MB of inputs. But at D = 32 the B*H*S^2 exponentials
// (537 M there) are the tighter floor: the special-function unit does 16
// exp2 a clock per SM, 0.13 ms at 1.98 GHz on 132 SMs. So the kernel keeps
// the work around each exponential small and lets the products of one warp
// overlap the exponentials of another.
//
// Design of the bf16 path (the TPU kernel's D-major layout and whole-K/V
// residency are TPU choices and are not carried over):
//   * One block per (128 query rows, b*h): at D <= 32 4 warps of 32 rows
//     (two m16 tiles, so each K/V fragment read from shared memory feeds two
//     products), above 8 warps of 16 rows (registers). K/V stream through
//     shared memory in tiles of BK keys (128 at D <= 32, 64 above) and an
//     online softmax runs in f32 registers, so nothing of size S^2 exists
//     and any S fits. Each K/V tile fetched serves 128 queries.
//   * Copies: a ring of NS tiles (3 up to D = 64) in shared memory filled by
//     cp.async.cg 16-byte copies (commit/wait_group); tiles j+1 .. j+NS-1 are
//     in flight while tile j is computed, and one barrier a tile both
//     publishes tile j and frees the slot that the next copy fills. Rows past
//     S and columns past D are zero-filled by the copy itself (src-size 0).
//   * Storage: Q, K and V row-major with a pitch of D+8 elements (16 bytes of
//     padding), so the 8 rows of every 8x8 ldmatrix read fall in distinct
//     banks. Fragments come from ldmatrix: Q and K plain, V with .trans (the
//     B operand of P V), four 8x8 tiles an instruction.
//   * Products: mma.sync m16n8k16 (bf16 in, f32 accumulate) on the tensor
//     cores. The S accumulator is re-packed in registers as the A operand of
//     P V, as in FlashAttention-2. P is rounded to bf16 before P V, as the
//     reference rounds p to v's dtype. Chosen over wgmma for this step: at
//     D = 32 the exponentials, not the products, set the floor, and the lever
//     is to keep enough warps on each SM that one warp's products run under
//     another's exponentials, and P is exponentiated a k16 chunk of keys at
//     a time, each chunk's P V issued at once, so one chunk of P is live.
//     Two blocks an SM up to D = 64, and all of the SM's L1 as shared memory.
//     Timed against it in turns on the H100 at (16, 8, 2048, 32), 16 rows a
//     warp (two blocks of 8 warps an SM, 128 registers) and 64-row blocks
//     of 4 such warps were both slower in most processes (PERF.md, open
//     questions).
//   * Softmax: the logits are kept in log2 units. Without a bias, the row
//     max is taken on the raw products, and p = ex2.approx.ftz(s * scale_log2
//     - m) is one FFMA and one MUFU.EX2. With a bias, the bias row of the
//     tile (log2 units, -inf past S) is staged in shared memory with the
//     tile, and x = s * scale_log2 + bias is one FFMA. Only the last tile
//     can be ragged, so only it tests key < S (bias-free path).
//   * The log-sum-exp (written for K2) is taken less the batch row's
//     largest key bias (block_max): a row whose every key carries the
//     padding bias (-1e9) attends uniformly, as the plain version does, and
//     keeps log S in its lse, which -1e9 + log S in f32 would lose.
//   * The scale D^-1/2 is folded with log2(e). Query rows past S are not
//     stored, so S needs no alignment (the TPU kernel needed S % 128 == 0).
//   * Any strides for the b, h and s axes (d contiguous), so q, k and v can
//     be views of one fused qkv projection and o can be written straight into
//     the (B, S, H*D) layout the output projection reads.
//   * Deterministic: every output is summed by one warp in a fixed order.
//   * Cross-length (S_kv != S_q): under the spatial `sp` axis a shard's
//     queries are its own positions and its keys every position of the
//     level, gathered over the shards (512/2048, 128/512, 32/128 at the
//     flagship's full width over 4 shards). The key count Sk only bounds
//     the key loop, the ragged-tile masks and the bias row; the query
//     tiles, the stores and the lse follow S. At Sk == S the kernels run
//     the same instructions as before it was split.
//   * ptxas (sm_90a, CUDA 12.8) at D = 32: 255 registers and 48 bytes of
//     stack without a bias (255 and none with one), 73,216 bytes of dynamic
//     shared memory a block; one MUFU.EX2 per logit in the SASS (132 a
//     tile of 32 x 128 per thread: 128 and the two rows' rescales).
//     chip_smoke.py's build phase prints every instantiation.
//
// The f32 path serves the f32 parity runs: the tensor cores have no full-f32
// mode, so one thread owns one query row and runs the same online softmax
// with FMAs; K/V rows are broadcast from shared memory.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "mma_tiles.cuh"

// Built in parts (ops/_build.py PARTS), side by side, then linked into one
// library: -DLLT_PART=0 holds the entry point and instantiates no kernel;
// -DLLT_PART=<DP> (16, 32, 64) the three kernels of head dim DP (f32, bf16,
// bf16 with a bias); -DLLT_PART=<DP * 10 + v> one of them, v = 0 f32, 1
// bf16, 2 bf16 with a bias (1280-1282: head dim 128, whose kernels took
// 64.8 s of nvcc together on the H100 host, against 91.0 s for the whole
// file). Without LLT_PART the file builds whole.
namespace llt_attn_fwd {

struct Params {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  const float* kb;  // (B, Sk) f32 or nullptr
  float* lse;       // (B, H, S) f32 or nullptr
  long long qs[3], ks[3], vs[3], os[3];  // element strides of b, h, s
  int H, S, Sk, D;   // S queries, Sk keys (S == Sk but for a W-sharded level's)
  float scale_log2;  // D^-1/2 * log2(e)
};

}  // namespace llt_attn_fwd

namespace {

using namespace mma_tiles;
using llt_attn_fwd::Params;

constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;
constexpr int kMaxDevices = 64;  // devices whose launch set-up is remembered

// ---------------------------------------------------------------- bf16 path

constexpr int kBQ = 128;  // query rows per block

template <int DP>
struct FwdTile {
  static constexpr int MT = DP <= 32 ? 2 : 1;      // m16 row tiles per warp
  static constexpr int NW = kBQ / (16 * MT);       // warps
  static constexpr int BK = DP <= 32 ? 128 : 64;   // keys per tile
  static constexpr int NS = DP <= 64 ? 3 : 2;      // tiles in the ring
  static constexpr int LD = DP + 8;                // shared-memory pitch
  static constexpr int kSmem = (kBQ + 2 * NS * BK) * LD * 2 + NS * BK * 4;
};

// two blocks an SM up to D = 64 (registers: 4 warps of 255 at D <= 32, 8
// warps of 128 at D = 64)
template <int DP, bool BIAS>
__global__ void __launch_bounds__(FwdTile<DP>::NW * 32, DP <= 64 ? 2 : 1)
    attn_fwd_bf16(Params p) {
  using T = FwdTile<DP>;
  constexpr int MT = T::MT, NW = T::NW, BK = T::BK, NS = T::NS, LD = T::LD;
  constexpr int NTH = NW * 32;
  constexpr int KT = DP / 16;  // k16 chunks over D
  constexpr int NT = BK / 8;   // n8 tiles over the key tile
  constexpr int DT = DP / 8;   // n8 tiles over D
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* Qs = reinterpret_cast<bf16*>(smem);
  bf16* Ks = Qs + kBQ * LD;       // NS tiles of BK x LD
  bf16* Vs = Ks + NS * BK * LD;   // NS tiles of BK x LD
  float* Bs = reinterpret_cast<float*>(Vs + NS * BK * LD);  // NS rows of BK

  const int S = p.S, Sk = p.Sk, D = p.D;
  const int tiles = (p.S + kBQ - 1) / kBQ;  // B*H on x with the tiles: no 65535 limit
  const int bh = blockIdx.x / tiles, b = bh / p.H, h = bh % p.H;
  const int q0 = blockIdx.x % tiles * kBQ;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const float sl2 = p.scale_log2;

  const bf16* qg = static_cast<const bf16*>(p.q) + b * p.qs[0] + h * p.qs[1];
  const bf16* kg = static_cast<const bf16*>(p.k) + b * p.ks[0] + h * p.ks[1];
  const bf16* vg = static_cast<const bf16*>(p.v) + b * p.vs[0] + h * p.vs[1];
  const float* kb = BIAS ? p.kb + (long long)b * Sk : nullptr;
  const float bmax = BIAS ? block_max(kb, Sk) * kLog2e : 0.f;  // log2 units
  const int ntiles = (Sk + BK - 1) / BK;

  auto issue = [&](int j) {  // copies of key tile j into slot j % NS
    if (j < ntiles) {
      const int slot = j % NS, k0 = j * BK;
      load_tile<BK, DP, LD, NTH>(Ks + slot * BK * LD, kg, p.ks[2], k0, Sk, D);
      load_tile<BK, DP, LD, NTH>(Vs + slot * BK * LD, vg, p.vs[2], k0, Sk, D);
      if (BIAS)
        for (int i = threadIdx.x; i < BK; i += NTH)
          Bs[slot * BK + i] = k0 + i < Sk ? kb[k0 + i] * kLog2e : -INFINITY;
    }
    cp_async_commit();  // an empty group past the end keeps the count
  };

  load_tile<kBQ, DP, LD, NTH>(Qs, qg, p.qs[2], q0, S, D);
#pragma unroll
  for (int j = 0; j < NS - 1; ++j) issue(j);  // Q rides with tile 0

  uint32_t qa[MT][KT][4];
  float oacc[MT][DT][4];
  // running max (log2 units) and partial row sums of rows g and g + 8
  float m[MT][2], l[MT][2];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
#pragma unroll
    for (int i = 0; i < DT; ++i)
      oacc[mt][i][0] = oacc[mt][i][1] = oacc[mt][i][2] = oacc[mt][i][3] = 0.f;
    m[mt][0] = m[mt][1] = -INFINITY;
    l[mt][0] = l[mt][1] = 0.f;
  }
  const int wrow = warp * 16 * MT;
  const int kofs = b_rows_offset(lane, LD), vofs = b_trans_offset(lane, LD);

  for (int j = 0; j < ntiles; ++j) {
    cp_async_wait<NS - 2>();  // this thread's copies of tile j have landed
    __syncthreads();          // everyone's have, and tile j - 1 is consumed
    issue(j + NS - 1);        // into the slot tile j - 1 used
    if (j == 0) {
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) load_a<KT, LD>(qa[mt], Qs, wrow + mt * 16, lane);
    }
    const int slot = j % NS, k0 = j * BK;
    const bf16* Kt = Ks + slot * BK * LD;
    const bf16* Vt = Vs + slot * BK * LD;

    // S = Q K^T: this warp's 16*MT rows x BK keys; each K fragment feeds MT
    float s[MT][NT][4];
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) s[mt][nt][0] = s[mt][nt][1] = s[mt][nt][2] = s[mt][nt][3] = 0.f;
#pragma unroll
    for (int n2 = 0; n2 < NT / 2; ++n2) {
#pragma unroll
      for (int kk = 0; kk < KT; ++kk) {
        uint32_t kf[4];
        ldsm_x4(kf, smem_addr(Kt + n2 * 16 * LD + kk * 16 + kofs));
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) {
          mma_bf16(s[mt][2 * n2], qa[mt][kk], kf[0], kf[1]);
          mma_bf16(s[mt][2 * n2 + 1], qa[mt][kk], kf[2], kf[3]);
        }
      }
    }

    // logits in log2 units
    if (BIAS) {
      const float* bt = Bs + slot * BK;
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        const float2 bb = *reinterpret_cast<const float2*>(bt + nt * 8 + 2 * t);
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) {
          s[mt][nt][0] = fmaf(s[mt][nt][0], sl2, bb.x);
          s[mt][nt][1] = fmaf(s[mt][nt][1], sl2, bb.y);
          s[mt][nt][2] = fmaf(s[mt][nt][2], sl2, bb.x);
          s[mt][nt][3] = fmaf(s[mt][nt][3], sl2, bb.y);
        }
      }
    } else if (k0 + BK > Sk) {  // the ragged last tile
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
#pragma unroll
        for (int e = 0; e < 2; ++e)
          if (k0 + nt * 8 + 2 * t + e >= Sk)
#pragma unroll
            for (int mt = 0; mt < MT; ++mt) s[mt][nt][e] = s[mt][nt][2 + e] = -INFINITY;
    }
    // bias-free: max on the raw products (scale > 0), one FFMA per element
    const float mul = BIAS ? 1.f : sl2;
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) {
      float mx0 = -INFINITY, mx1 = -INFINITY;
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        mx0 = fmaxf(mx0, fmaxf(s[mt][nt][0], s[mt][nt][1]));
        mx1 = fmaxf(mx1, fmaxf(s[mt][nt][2], s[mt][nt][3]));
      }
#pragma unroll
      for (int off = 1; off <= 2; off <<= 1) {
        mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, off));
        mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, off));
      }
      const float mn0 = fmaxf(m[mt][0], mx0 * mul), mn1 = fmaxf(m[mt][1], mx1 * mul);
      // a row with every logit -inf so far keeps p = 0 rather than NaN
      const float neg0 = mn0 == -INFINITY ? 0.f : -mn0;
      const float neg1 = mn1 == -INFINITY ? 0.f : -mn1;
      const float corr0 = ex2(m[mt][0] + neg0), corr1 = ex2(m[mt][1] + neg1);
      m[mt][0] = mn0;
      m[mt][1] = mn1;
      l[mt][0] *= corr0;
      l[mt][1] *= corr1;
#pragma unroll
      for (int i = 0; i < DT; ++i) {
        oacc[mt][i][0] *= corr0;
        oacc[mt][i][1] *= corr0;
        oacc[mt][i][2] *= corr1;
        oacc[mt][i][3] *= corr1;
      }
      // a k16 chunk of keys at a time: P = exp2(x - m) re-packed as an A
      // fragment (two n8 tiles), then O += P V for that chunk, so only one
      // chunk of P is held in registers
#pragma unroll
      for (int kc = 0; kc < NT / 2; ++kc) {
        uint32_t pa[4];
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int nt = 2 * kc + e;
          const float p0 = ex2(fmaf(s[mt][nt][0], mul, neg0));
          const float p1 = ex2(fmaf(s[mt][nt][1], mul, neg0));
          const float p2 = ex2(fmaf(s[mt][nt][2], mul, neg1));
          const float p3 = ex2(fmaf(s[mt][nt][3], mul, neg1));
          l[mt][0] += p0 + p1;
          l[mt][1] += p2 + p3;
          pa[2 * e] = pack_bf16(p0, p1);
          pa[2 * e + 1] = pack_bf16(p2, p3);
        }
#pragma unroll
        for (int d2 = 0; d2 < DT / 2; ++d2) {
          uint32_t vf[4];
          ldsm_x4_trans(vf, smem_addr(Vt + kc * 16 * LD + d2 * 16 + vofs));
          mma_bf16(oacc[mt][2 * d2], pa, vf[0], vf[1]);
          mma_bf16(oacc[mt][2 * d2 + 1], pa, vf[2], vf[3]);
        }
      }
    }
  }
  cp_async_wait<0>();  // no copy may outlive the block

  bf16* og = static_cast<bf16*>(p.o) + b * p.os[0] + h * p.os[1];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
    float l0 = l[mt][0], l1 = l[mt][1];
#pragma unroll
    for (int off = 1; off <= 2; off <<= 1) {
      l0 += __shfl_xor_sync(0xffffffffu, l0, off);
      l1 += __shfl_xor_sync(0xffffffffu, l1, off);
    }
    const float inv0 = 1.f / l0, inv1 = 1.f / l1;
    const int row0 = q0 + wrow + mt * 16 + g, row1 = row0 + 8;
    if (p.lse && t == 0) {  // natural-log units: (m - bias max + log2 l) * ln 2
      float* lg = p.lse + (long long)bh * S;
      if (row0 < S) lg[row0] = ((m[mt][0] - bmax) + log2f(l0)) * kLn2;
      if (row1 < S) lg[row1] = ((m[mt][1] - bmax) + log2f(l1)) * kLn2;
    }
#pragma unroll
    for (int dt = 0; dt < DT; ++dt) {
      const int c = dt * 8 + 2 * t;
      if (dt * 8 >= D) break;
      if (row0 < S)
        *reinterpret_cast<uint32_t*>(og + row0 * p.os[2] + c) =
            pack_bf16(oacc[mt][dt][0] * inv0, oacc[mt][dt][1] * inv0);
      if (row1 < S)
        *reinterpret_cast<uint32_t*>(og + row1 * p.os[2] + c) =
            pack_bf16(oacc[mt][dt][2] * inv1, oacc[mt][dt][3] * inv1);
    }
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

  const int S = p.S, Sk = p.Sk, D = p.D;
  const int tiles = (p.S + kQF - 1) / kQF;
  const int bh = blockIdx.x / tiles, b = bh / p.H, h = bh % p.H;
  const int qi = blockIdx.x % tiles * kQF + threadIdx.x;
  const float* qg = static_cast<const float*>(p.q) + b * p.qs[0] + h * p.qs[1];
  const float* kg = static_cast<const float*>(p.k) + b * p.ks[0] + h * p.ks[1];
  const float* vg = static_cast<const float*>(p.v) + b * p.vs[0] + h * p.vs[1];
  const float* kb = p.kb ? p.kb + (long long)b * Sk : nullptr;
  const float bmax = kb ? block_max(kb, Sk) * kLog2e : 0.f;  // log2 units

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

  for (int k0 = 0; k0 < Sk; k0 += kKF) {
    __syncthreads();
    for (int i = threadIdx.x; i < kKF * VPR; i += kQF) {
      const int r = i / VPR, c = (i % VPR) * 4;
      float4 kv = make_float4(0.f, 0.f, 0.f, 0.f), vv = kv;
      if (k0 + r < Sk && c < D) {
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
      s[j] = key < Sk ? acc * p.scale_log2 + (kb ? kb[key] * kLog2e : 0.f) : -INFINITY;
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
    if (p.lse) p.lse[(long long)bh * S + qi] = ((m - bmax) + log2f(l)) * kLn2;
#pragma unroll
    for (int d = 0; d < DP; d += 4)
      if (d < D)
        *reinterpret_cast<float4*>(og + d) =
            make_float4(o[d] * inv, o[d + 1] * inv, o[d + 2] * inv, o[d + 3] * inv);
  }
}

}  // namespace

namespace llt_attn_fwd {

template <int DP, bool BIAS>
void launch_bf16(const Params& p, int B, cudaStream_t stream) {
  using T = FwdTile<DP>;
  static bool ready[kMaxDevices] = {};   // an attribute is set on each device apart
  int cur = 0;
  cudaGetDevice(&cur);
  if (cur >= kMaxDevices || !ready[cur]) {  // opt in to more than 48 KB of shared memory,
    cudaFuncSetAttribute(attn_fwd_bf16<DP, BIAS>,  // all of it shared
                         cudaFuncAttributeMaxDynamicSharedMemorySize, T::kSmem);
    cudaFuncSetAttribute(attn_fwd_bf16<DP, BIAS>,
                         cudaFuncAttributePreferredSharedMemoryCarveout,
                         cudaSharedmemCarveoutMaxShared);
    if (cur < kMaxDevices) ready[cur] = true;
  }
  const dim3 grid((p.S + kBQ - 1) / kBQ * B * p.H);
  attn_fwd_bf16<DP, BIAS><<<grid, T::NW * 32, T::kSmem, stream>>>(p);
}

template <int DP>
void launch_f32(const Params& p, int B, cudaStream_t stream) {
  const dim3 grid((p.S + kQF - 1) / kQF * B * p.H);
  attn_fwd_f32<DP><<<grid, kQF, 0, stream>>>(p);
}

template <int DP>
void launch(const Params& p, int B, int dtype, cudaStream_t stream) {
  if (dtype == 0)
    launch_f32<DP>(p, B, stream);
  else if (p.kb)
    launch_bf16<DP, true>(p, B, stream);
  else
    launch_bf16<DP, false>(p, B, stream);
}

#define LLT_LEAVES(KW, DP)                                           \
  KW void launch_f32<DP>(const Params&, int, cudaStream_t);         \
  KW void launch_bf16<DP, false>(const Params&, int, cudaStream_t); \
  KW void launch_bf16<DP, true>(const Params&, int, cudaStream_t);
#if defined(LLT_PART) && LLT_PART >= 1000 && LLT_PART % 10 == 0
template void launch_f32<LLT_PART / 10>(const Params&, int, cudaStream_t);
#elif defined(LLT_PART) && LLT_PART >= 1000
template void launch_bf16<LLT_PART / 10, LLT_PART % 10 == 2>(const Params&, int, cudaStream_t);
#elif defined(LLT_PART) && LLT_PART > 0
LLT_LEAVES(template, LLT_PART)
#elif defined(LLT_PART)
LLT_LEAVES(extern template, 16)
LLT_LEAVES(extern template, 32)
LLT_LEAVES(extern template, 64)
LLT_LEAVES(extern template, 128)
#endif
#undef LLT_LEAVES

}  // namespace llt_attn_fwd

#if !defined(LLT_PART) || LLT_PART == 0
using llt_attn_fwd::launch;

// q, o: (B, H, S, D); k, v: (B, H, Sk, D) (Sk == S for self-attention, the
// keys of every shard for a W-sharded level's queries); any b/h/s element
// strides and contiguous d; strides holds 12 values, (b, h, s) for q, k, v,
// then o. kbias: (B, Sk) float32 or null. lse: (B, H, S) float32 written
// when not null. dtype: 0 = float32, 1 = bfloat16. D % 8 == 0, D <= 128.
// Returns cudaGetLastError() after the launch.
extern "C" int llt_flash_attn_fwd(const void* q, const void* k, const void* v,
                                  const void* kbias, void* o, void* lse,
                                  const long long* strides, int dtype, int B,
                                  int H, int S, int Sk, int D, void* stream) {
  // one block per (query tile, b*h), all on gridDim.x (at most 2^31 - 1)
  if (D <= 0 || D > 128 || D % 8 != 0 || (dtype != 0 && dtype != 1) || S <= 0 || Sk <= 0 ||
      (long long)B * H * ((S + kQF - 1) / kQF) > 0x7fffffffLL)
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
  p.Sk = Sk;
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
#endif
