// Building blocks shared by the bf16 bodies of K1 (fused_attention_fwd.cu)
// and K2 (fused_attention_bwd.cu): 16-byte cp.async staging of a head into
// swizzled shared-memory tiles, ldmatrix loads of mma.sync fragments, and
// the bf16 m16n8k16 tensor-core product with fp32 accumulation.
//
// A head tile is [rows][64] bf16: 128-byte rows of eight 16-byte chunks,
// chunk c of row r stored at chunk c ^ (r & 7). The eight rows an ldmatrix
// 8x8 reads (one chunk each) and the eight rows a warp's 16-byte copies
// write then fall on eight distinct 16-byte bank groups: no conflicts.
//
// Fragment layouts (PTX ISA, mma.m16n8k16 with .bf16): lane l holds
//   A (16x16, row-major)  a0 = row l/4,   cols 2(l%4)..+1;  a1 = row l/4+8;
//                         a2 = row l/4,   cols 8+2(l%4)..;  a3 = row l/4+8
//   B (16x8, col-major)   b0 = rows 2(l%4)..+1, col l/4;    b1 = rows +8
//   C (16x8, fp32)        c0,c1 = row l/4, cols 2(l%4)..+1; c2,c3 = row +8
// so the C fragments of two adjacent n-tiles, packed to bf16, are the A
// fragment of one 16-deep k-step (the identity FlashAttention-2 uses).

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace hmmc {

constexpr int kHeadDim = 64;
constexpr int kTileRowBytes = kHeadDim * 2;   // one bf16 head row
constexpr float kScale = 0.125f;              // kHeadDim ** -0.5, exact

struct Strides {
  long long b, h, l;
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// byte offset of 16-byte chunk `chunk` of row `row` in a swizzled head tile
__device__ __forceinline__ uint32_t tile_off(int row, int chunk) {
  return row * kTileRowBytes + ((chunk ^ (row & 7)) << 4);
}

__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void ldsm_x4(uint32_t addr, uint32_t (&r)[4]) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr)
      : "memory");
}

__device__ __forceinline__ void ldsm_x4_t(uint32_t addr, uint32_t (&r)[4]) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr)
      : "memory");
}

// d += a . b on the tensor cores: bf16 inputs, fp32 accumulation
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// two floats rounded to bf16, the first in the low half (the lower column)
__device__ __forceinline__ uint32_t pack_bf16(float x0, float x1) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(x0, x1);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// x = hi + lo with hi = bf16(x) and lo = bf16(x - hi): about 16
// significant bits of x in two bf16 operands
__device__ __forceinline__ void split_bf16(float x0, float x1, uint32_t& hi,
                                           uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x0, x1);
  const float2 hf = __bfloat1622float2(h);
  hi = *reinterpret_cast<const uint32_t*>(&h);
  lo = pack_bf16(x0 - hf.x, x1 - hf.y);
}

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}

__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

// ldmatrix lane addresses into a swizzled head tile at `tile`:
// A fragment of rows r0..r0+15, k-step ks (columns 16ks..16ks+15)
__device__ __forceinline__ uint32_t a_addr(uint32_t tile, int r0, int ks,
                                           int lane) {
  return tile + tile_off(r0 + (lane & 15), 2 * ks + (lane >> 4));
}

// B fragments of two n-tiles whose n index is the tile's row (S = q . k^T:
// keys n0..n0+15), k-step ks: r[0], r[1] for keys n0.., r[2], r[3] n0+8..
__device__ __forceinline__ uint32_t b_addr(uint32_t tile, int n0, int ks,
                                           int lane) {
  return tile + tile_off(n0 + (lane & 7) + ((lane >> 4) << 3),
                         2 * ks + ((lane >> 3) & 1));
}

// B fragments (through ldmatrix.trans) of two n-tiles whose k index is the
// tile's row (P . v: keys k0..k0+15) and n the columns 16dp..16dp+15:
// r[0], r[1] for columns 16dp.., r[2], r[3] for 16dp+8..
__device__ __forceinline__ uint32_t bt_addr(uint32_t tile, int k0, int dp,
                                            int lane) {
  return tile + tile_off(k0 + (lane & 7) + (((lane >> 3) & 1) << 3),
                         2 * dp + (lane >> 4));
}

// Issue 16-byte copies of rows 0..len-1 of `ntensor` head tensors into
// consecutive tiles of `tile_bytes` at `dst`. Every source row is 128
// contiguous, 16-byte aligned bytes (the wrapper checks the alignment).
template <int kTensors>
__device__ __forceinline__ void stage_head(uint32_t dst, int tile_bytes,
                                           const __nv_bfloat16* const* src,
                                           const long long* row_stride,
                                           int len) {
  for (int c = threadIdx.x; c < len * 8; c += blockDim.x) {
    const int row = c >> 3, chunk = c & 7;
    const uint32_t off = tile_off(row, chunk);
#pragma unroll
    for (int t = 0; t < kTensors; ++t)
      cp_async16(dst + t * tile_bytes + off, src[t] + row * row_stride[t] +
                                                 chunk * 8);
  }
}

// Zero rows len..lp-1 of `ntiles` consecutive head tiles (generic pointer)
__device__ __forceinline__ void zero_pad_rows(char* tiles, int ntiles,
                                              int tile_bytes, int len,
                                              int lp) {
  const int per_tile = (lp - len) * 8;
  for (int c = threadIdx.x; c < ntiles * per_tile; c += blockDim.x) {
    const int t = c / per_tile, rc = c - t * per_tile;
    *reinterpret_cast<uint4*>(tiles + t * tile_bytes + len * kTileRowBytes +
                              rc * 16) = make_uint4(0, 0, 0, 0);
  }
}

// A warp's 16 x 64 fp32 C fragments (8 n-tiles of 8 columns), rounded to
// bf16, into rows r0..r0+15 (those below len) of a swizzled tile.
__device__ __forceinline__ void frags_to_tile(char* tile, int r0,
                                              const float (&acc)[8][4],
                                              int len, int lane) {
  const int r = r0 + (lane >> 2);
  const int byte = (lane & 3) * 4;
#pragma unroll
  for (int nt = 0; nt < 8; ++nt) {
    if (r < len)
      *reinterpret_cast<uint32_t*>(tile + tile_off(r, nt) + byte) =
          pack_bf16(acc[nt][0], acc[nt][1]);
    if (r + 8 < len)
      *reinterpret_cast<uint32_t*>(tile + tile_off(r + 8, nt) + byte) =
          pack_bf16(acc[nt][2], acc[nt][3]);
  }
}

// Rows r0..r0+15 (those below len) of a swizzled tile to device memory,
// 16 bytes a lane: eight lanes write one 128-byte row.
__device__ __forceinline__ void tile_rows_to_global(const char* tile, int r0,
                                                    __nv_bfloat16* dst,
                                                    long long row_stride,
                                                    int len, int lane) {
#pragma unroll
  for (int c = lane; c < 16 * 8; c += 32) {
    const int row = r0 + (c >> 3), chunk = c & 7;
    if (row < len)
      *reinterpret_cast<uint4*>(dst + row * row_stride + chunk * 8) =
          *reinterpret_cast<const uint4*>(tile + tile_off(row, chunk));
  }
}

// Allow `bytes` of dynamic shared memory for `kernel`, once per device.
template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, size_t bytes, unsigned* done_mask) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  const unsigned bit = dev < 32 ? (1u << dev) : 0u;
  if (bit && (*done_mask & bit)) return cudaSuccess;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             232448);
  if (err == cudaSuccess) *done_mask |= bit;
  return err;
}

}  // namespace hmmc
