// Building blocks of the bf16 attention kernels (flash_attn_fwd.cu and
// flash_attn_bwd.cu) for sm_90a: asynchronous 16-byte global -> shared
// copies, ldmatrix fragment loads, the m16n8k16 bf16 tensor-core product and
// the hardware exp2, and a block-wide max. Fragment layouts are PTX's for mma.m16n8k16: in lane
// (g = lane / 4, t = lane % 4), an A fragment holds rows g and g + 8, columns
// 2t, 2t + 1 and 2t + 8, 2t + 9; a B fragment holds columns (n) g, rows (k)
// 2t, 2t + 1 and 2t + 8, 2t + 9; a C fragment holds rows g and g + 8,
// columns 2t and 2t + 1.
#pragma once
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

namespace mma_tiles {

typedef __nv_bfloat16 bf16;

// The largest of x[0 .. n), by the whole block (every thread calls it and
// gets the value). The attention kernels take it of a batch row's key bias:
// K1 writes its log-sum-exp less it and K2 subtracts it back, so a row whose
// every key carries the padding bias (-1e9, next to which the products
// round away) keeps log l, which -1e9 + log l in f32 would lose.
__device__ __forceinline__ float block_max(const float* x, int n) {
  __shared__ float red[32];
  float mx = -INFINITY;
  for (int i = threadIdx.x; i < n; i += blockDim.x) mx = fmaxf(mx, x[i]);
#pragma unroll
  for (int off = 16; off; off >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = mx;
  __syncthreads();
  mx = -INFINITY;
  for (int w = 0; w < (int)(blockDim.x + 31) / 32; ++w) mx = fmaxf(mx, red[w]);
  __syncthreads();
  return mx;
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared, asynchronously; zeros when !valid (nothing is
// read from src then)
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src),
               "r"(valid ? 16 : 0));
}

// 4 bytes global -> shared, asynchronously; zero when !valid
__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src, bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst), "l"(src),
               "r"(valid ? 4 : 0));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

// wait until at most N of this thread's committed copy groups are in flight
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// four 8x8 b16 matrices; lanes 8i..8i+7 address the rows of matrix i
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

// two 8x8 matrices; lanes 0..15 give the addresses
__device__ __forceinline__ void ldsm_x2_trans(uint32_t& r0, uint32_t& r1, uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0,%1}, [%2];\n"
               : "=r"(r0), "=r"(r1)
               : "r"(addr));
}

__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&h);
}

// one MUFU.EX2; subnormal results flush to 0, exp2(-inf) = 0
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// Copy ROWS rows of a strided (S, D) bf16 matrix, from row r0, into a
// row-major shared tile of pitch LD elements, with cp.async; rows past S and
// columns past D are zero-filled. DP: the tile's padded width.
template <int ROWS, int DP, int LD, int NTHREADS>
__device__ __forceinline__ void load_tile(bf16* tile, const bf16* base, long long stride,
                                          int r0, int S, int D) {
  constexpr int VPR = DP / 8;  // 16-byte vectors per row
#pragma unroll
  for (int i = threadIdx.x; i < ROWS * VPR; i += NTHREADS) {
    const int r = i / VPR, c = (i % VPR) * 8;
    const bool valid = r0 + r < S && c < D;
    cp_async16(smem_addr(tile + r * LD + c), valid ? base + (r0 + r) * stride + c : base,
               valid);
  }
}

// The A fragments (k16 chunks over DP columns) of the 16 rows from row0 of a
// row-major shared tile of pitch LD.
template <int KT, int LD>
__device__ __forceinline__ void load_a(uint32_t (&a)[KT][4], const bf16* tile, int row0,
                                       int lane) {
  const int r = row0 + (lane & 7) + ((lane >> 3) & 1) * 8, c = (lane >> 4) * 8;
#pragma unroll
  for (int kk = 0; kk < KT; ++kk) ldsm_x4(a[kk], smem_addr(tile + r * LD + kk * 16 + c));
}

// Lane offsets (elements) into a row-major tile of pitch LD for ldmatrix.x4:
// b_rows: B fragments of two n8 tiles (rows n0.., n0 + 8..) for one k16
//   chunk, from a tile whose rows are n and columns k (K for Q K^T):
//   r0, r1 = b0, b1 of the first n8 tile, r2, r3 of the second.
// b_trans: the same from a tile whose rows are k and columns n (V for P V),
//   with .trans.
__device__ __forceinline__ int b_rows_offset(int lane, int ld) {
  return ((lane & 7) + (lane >> 4) * 8) * ld + ((lane >> 3) & 1) * 8;
}

__device__ __forceinline__ int b_trans_offset(int lane, int ld) {
  return ((lane & 7) + ((lane >> 3) & 1) * 8) * ld + (lane >> 4) * 8;
}

}  // namespace mma_tiles
