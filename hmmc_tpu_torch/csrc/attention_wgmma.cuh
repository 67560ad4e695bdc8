// Hopper building blocks of K2's tiled bf16 pair (fused_attention_bwd.cu):
// TMA tile loads into shared memory with mbarrier completion, the wgmma
// shared-memory matrix descriptors, and the warpgroup products
// (wgmma.mma_async m64nNk16, bf16 in, fp32 accumulate). Everything here is
// sm_90a only.
//
// A head tile is 64 rows of D bf16 (D = 64, 80, 96 or 128), staged by TMA
// as one or two column blocks, each in the canonical swizzled layout that
// wgmma reads and TMA writes:
//   block 0  columns 0..63, rows of 128 bytes, 128-byte swizzle (8 KB)
//   block 1  columns 64..D-1 (D > 64), rows of 2 (D - 64) bytes: 128 (D =
//            128), 64 (D = 96) or 32 (D = 80) bytes, the swizzle of that
//            width, right after block 0
// so a tile is exactly 64 x D x 2 bytes. In each block, 16-byte chunk c of
// row r sits at chunk c ^ (r % 8 / (8 / chunks a row)) of its row: the
// hardware's XOR of address bits [4, 7) with [7, 10). Every block starts
// on a 1024-byte boundary (the swizzle's period), so descriptors carry
// base offset 0.
//
// One tile serves as both kinds of operand:
//   K-major (the reduction runs along D: S = q . k^T, dP = g . v^T): a
//     16-deep k-step ks reads columns 16 ks..16 ks + 15, 32 bytes into the
//     block's rows; the descriptor's start moves by 32 bytes inside the
//     swizzle atom (the hardware applies the XOR to the final address).
//     SBO = 8 rows of the block, LBO unused.
//   MN-major (the reduction runs along the tile's rows, D is the product's
//     N: dQ += dS . k, dV += P^T g, dK += dS^T q): k-step kk reads rows
//     16 kk..16 kk + 15; one instruction a block, N = the block's columns
//     (64, 32 or 16: exactly one swizzle atom wide, so LBO is unused).
//     SBO = 8 rows of the block (the next eight k), transpose bit set.
//
// Register fragments (PTX ISA, wgmma m64nNk16): warp w of the warpgroup
// owns rows 16 w..16 w + 15; lane l holds, of the fp32 accumulator,
//   d[4 n + e]      row 16 w + l / 4,      column 8 n + 2 (l % 4) + e
//   d[4 n + 2 + e]  row 16 w + l / 4 + 8,  the same column     (e = 0, 1)
// and of a bf16 A operand (k-step of 16) a0 = row l / 4, columns 2 (l % 4)
// ..+1; a1 = row + 8; a2 = row l / 4, columns 8 + 2 (l % 4)..; a3 = row +
// 8. So the accumulators of columns 16 kk..16 kk + 15, packed to bf16, are
// the A operand of k-step kk (a_frag below).

#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "attention_mma.cuh"

namespace hmmc {

// ---------------------------------------------------------------------------
// tile geometry
// ---------------------------------------------------------------------------

template <int D>
struct TmaTile {
  static_assert(is_head_dim(D), "head_dim must be 64, 80, 96 or 128");
  static constexpr int kRows = 64;
  static constexpr int kBlock0 = kRows * 128;          // bytes of block 0
  static constexpr int kCols1 = D - 64;                // block 1's columns
  static constexpr int kRowBytes1 = 2 * kCols1;        // 0, 32, 64, 128
  static constexpr int kBytes = kRows * D * 2;         // the whole tile
  static constexpr int kKSteps = D / 16;
  // wgmma layout type of block 1: 1 = 128-byte, 2 = 64-byte, 3 = 32-byte
  // swizzle (the same codes as CU_TENSOR_MAP_SWIZZLE_{128,64,32}B's order)
  static constexpr int kLayout1 =
      kRowBytes1 == 128 ? 1 : kRowBytes1 == 64 ? 2 : 3;
};

// Shared-memory matrix descriptor (PTX ISA, "Matrix Descriptor Format"):
// start address, leading and stride byte offsets (all >> 4), layout type.
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr, uint32_t lbo,
                                              uint32_t sbo, int layout) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>((lbo & 0x3FFFF) >> 4) << 16) |
         (static_cast<uint64_t>((sbo & 0x3FFFF) >> 4) << 32) |
         (static_cast<uint64_t>(layout) << 62);
}

// K-major descriptor of k-step ks (columns 16 ks..) of the tile at `tile`
template <int D>
__device__ __forceinline__ uint64_t kmajor_desc(uint32_t tile, int ks) {
  using T = TmaTile<D>;
  if (ks < 4) return smem_desc(tile + 32 * ks, 16, 8 * 128, 1);
  return smem_desc(tile + T::kBlock0 + 32 * (ks - 4), 16, 8 * T::kRowBytes1,
                   T::kLayout1);
}

// MN-major descriptor of block `blk`, k-step kk (rows 16 kk..), of the
// tile at `tile`
template <int D>
__device__ __forceinline__ uint64_t mnmajor_desc(uint32_t tile, int blk,
                                                 int kk) {
  using T = TmaTile<D>;
  if (blk == 0) return smem_desc(tile + kk * 16 * 128, T::kBlock0, 8 * 128, 1);
  return smem_desc(tile + T::kBlock0 + kk * 16 * T::kRowBytes1, T::kBlock0,
                   8 * T::kRowBytes1, T::kLayout1);
}

// byte offset of 16-byte chunk c (columns 8 c..8 c + 7) of row r in a
// tile, as TMA's swizzle leaves it
template <int D>
__device__ __forceinline__ uint32_t tma_chunk_off(int r, int c) {
  using T = TmaTile<D>;
  if (c < 8) return r * 128 + ((c ^ (r & 7)) << 4);
  constexpr int kChunks1 = T::kRowBytes1 / 16;         // 2, 4 or 8
  // the XOR of a 2^n-chunk row is row bits [3 - n, 3), per 8-row period
  // of 1024 bytes: 128-byte rows r & 7, 64-byte (r >> 1) & 3, 32-byte
  // (r >> 2) & 1
  const int x = kChunks1 == 8 ? (r & 7) : kChunks1 == 4 ? ((r >> 1) & 3)
                                                        : ((r >> 2) & 1);
  return T::kBlock0 + r * T::kRowBytes1 + (((c - 8) ^ x) << 4);
}

// ---------------------------------------------------------------------------
// mbarriers and TMA
// ---------------------------------------------------------------------------

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_init_fence() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::
                   "r"(bar),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar)
               : "memory");
}

// wait until the phase of parity `parity` has completed. A wait that
// lasts ~2^34 cycles (about 10 s) cannot complete in these kernels: it
// traps, so a fault in the ring ends the launch with an error instead of
// hanging the card.
__device__ __forceinline__ void mbar_wait(uint32_t bar, int parity) {
  uint32_t done = 0;
  long long start = -1;
  while (true) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
    if (done) return;
    const long long now = clock64();
    if (start < 0) start = now;
    else if (now - start > (1LL << 34)) __trap();
  }
}

// one TMA box of a 4-d [B][H][L][D] map (coordinates innermost first)
// into shared memory, completing on `bar`
__device__ __forceinline__ void tma_load_4d(uint32_t dst,
                                            const CUtensorMap* map,
                                            uint32_t bar, int c0, int c1,
                                            int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.tile.mbarrier::"
      "complete_tx::bytes [%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1),
      "r"(c2), "r"(c3)
      : "memory");
}

// `bytes` (a multiple of 16) from 16-byte aligned device memory, completing
// on `bar`
__device__ __forceinline__ void bulk_load(uint32_t dst, const void* src,
                                          uint32_t bytes, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(dst),
      "l"(src), "r"(bytes), "r"(bar)
      : "memory");
}

// The two tensor maps of one [B, H, L, D] bf16 tensor: block 0 (64
// columns) and, for D > 64, block 1 (columns 64..D-1).
struct TileMaps {
  CUtensorMap m0, m1;
};

// Load rows row0..row0+63 of head (b, h) into the tile at `dst` (rows past
// L are zero-filled by the hardware); TmaTile<D>::kBytes complete on `bar`.
template <int D>
__device__ __forceinline__ void tma_tile(uint32_t dst, const TileMaps& maps,
                                         uint32_t bar, int row0, int h,
                                         int b) {
  tma_load_4d(dst, &maps.m0, bar, 0, row0, h, b);
  if constexpr (D > 64)
    tma_load_4d(dst + TmaTile<D>::kBlock0, &maps.m1, bar, 64, row0, h, b);
}

// ---------------------------------------------------------------------------
// wgmma
// ---------------------------------------------------------------------------

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// keep the compiler from moving accesses of the n accumulators across an
// asynchronous product (CUTLASS's warpgroup_fence_operand)
template <int N>
__device__ __forceinline__ void fence_regs(float* d) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// the same for the A fragments of the 4 k-steps of a product in flight
__device__ __forceinline__ void fence_frags(uint32_t (&a)[4][4]) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
#pragma unroll
    for (int i = 0; i < 4; ++i) asm volatile("" : "+r"(a[kk][i])::"memory");
}

// The bf16 A fragment of k-step kk from fp32 accumulators x of a 64-column
// product (columns 16 kk..16 kk + 15)
__device__ __forceinline__ void a_frag(const float* x, int kk,
                                       uint32_t (&a)[4]) {
  a[0] = pack_bf16(x[8 * kk + 0], x[8 * kk + 1]);
  a[1] = pack_bf16(x[8 * kk + 2], x[8 * kk + 3]);
  a[2] = pack_bf16(x[8 * kk + 4], x[8 * kk + 5]);
  a[3] = pack_bf16(x[8 * kk + 6], x[8 * kk + 7]);
}

// d (64 x 64 fp32) += A . B, A and B in shared memory (K-major: tnsp 0)
__device__ __forceinline__ void wgmma_ss_n64(float* d, uint64_t da, uint64_t db,
                                             int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(accumulate));
}

// d (64 x 64 fp32) += A . B, A in registers (a bf16 m64k16 fragment),
// B in shared memory MN-major (tnsp 1)
__device__ __forceinline__ void wgmma_rs_n64(float* d, const uint32_t (&a)[4],
                                            uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// d (64 x 32 fp32) += A . B, A in registers (a bf16 m64k16 fragment),
// B in shared memory MN-major (tnsp 1)
__device__ __forceinline__ void wgmma_rs_n32(float* d, const uint32_t (&a)[4],
                                            uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15"
      "}, {%16, %17, %18, %19}, %20, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// d (64 x 16 fp32) += A . B, A in registers (a bf16 m64k16 fragment),
// B in shared memory MN-major (tnsp 1)
__device__ __forceinline__ void wgmma_rs_n16(float* d, const uint32_t (&a)[4],
                                            uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7"
      "}, {%8, %9, %10, %11}, %12, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// acc (64 x D) += A . B for the A fragment of k-step kk and B the tile at
// `tile` read MN-major (its rows 16 kk.. the reduction, D the product's N):
// one instruction a column block; acc[0..31] block 0, acc[32..] block 1.
template <int D>
__device__ __forceinline__ void wgmma_rs_tile(float* acc,
                                              const uint32_t (&a)[4],
                                              uint32_t tile, int kk) {
  wgmma_rs_n64(acc, a, mnmajor_desc<D>(tile, 0, kk));
  const uint64_t b1 = mnmajor_desc<D>(tile, 1, kk);
  if constexpr (D == 128) wgmma_rs_n64(acc + 32, a, b1);
  if constexpr (D == 96) wgmma_rs_n32(acc + 32, a, b1);
  if constexpr (D == 80) wgmma_rs_n16(acc + 32, a, b1);
}

// s (64 x 64) = A . B^T over D for A the tile at `ta` (its rows M) and B
// the tile at `tb` (its rows N), both K-major
template <int D>
__device__ __forceinline__ void wgmma_ss_tiles(float* s, uint32_t ta,
                                               uint32_t tb) {
#pragma unroll
  for (int ks = 0; ks < TmaTile<D>::kKSteps; ++ks)
    wgmma_ss_n64(s, kmajor_desc<D>(ta, ks), kmajor_desc<D>(tb, ks), ks > 0);
}

}  // namespace hmmc
