// Building blocks shared by the bodies of K1 (fused_attention_fwd.cu) and
// K2 (fused_attention_bwd.cu), most of them the bf16 bodies': 16-byte
// cp.async staging of a head into swizzled shared-memory tiles, ldmatrix
// loads of mma.sync fragments, and the bf16 m16n8k16 tensor-core product
// with fp32 accumulation. Each piece
// is a template on the head_dim D (64, 80, 96 or 128: is_head_dim), one
// compile-time instance each.
//
// A head tile is [rows][D] bf16: rows of D / 8 16-byte chunks, stored
// back to back (no padding). The eight rows an ldmatrix 8x8 reads (one
// chunk each, rows 8i..8i+7) must fall on eight distinct 16-byte bank
// groups (a 128-byte line holds eight), and so must the eight chunks of
// each quarter-warp's 16-byte copies. So chunk c of row r is stored at
// chunk c ^ x(r) of its row, with x(r) < the largest power of two that
// divides D / 8 (the XOR stays inside the row):
//   D = 64, 128   (8, 16 chunks; a row starts on a line)  x = r & 7
//   D = 96        (12 chunks; a row starts 4r mod 8 chunks into a line)
//                 x = (r >> 1) & 3: rows of one parity share the offset
//                 and get four distinct XORs
//   D = 80        (10 chunks; 2r mod 8)  x = (r >> 2) & 1: rows r, r + 4
//                 share the offset and differ in the XOR
// The copies take consecutive chunks in row-major order, eight to a
// quarter-warp; the XOR permutes aligned blocks of 8, 4 or 2 chunks, and
// D / 8 is a multiple of that block, so each quarter-warp's eight chunks
// fill eight consecutive slots: no conflicts in either access.
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

// The head_dims the kernels are instantiated for; the entry points refuse
// any other (cudaErrorInvalidValue).
constexpr bool is_head_dim(int d) {
  return d == 64 || d == 80 || d == 96 || d == 128;
}

// D ** -0.5 as the plain version has it (`q.shape[-1] ** -0.5`, a double
// rounded once to fp32 where it multiplies the fp32 logits), and that fp32
// value times log2(e) for the tiled bodies' ex2. Exact at 64; hexadecimal
// literals elsewhere (rsqrtf could differ by an ulp).
template <int D>
struct Scale;
template <>
struct Scale<64> {
  static constexpr float kScale = 0x1p-3f;
  static constexpr float kLog2 = 0x1.715476p-3f;
};
template <>
struct Scale<80> {
  static constexpr float kScale = 0x1.c9f25cp-4f;
  static constexpr float kLog2 = 0x1.4a56b6p-3f;
};
template <>
struct Scale<96> {
  static constexpr float kScale = 0x1.a20bd8p-4f;
  static constexpr float kLog2 = 0x1.2d8e8p-3f;
};
template <>
struct Scale<128> {
  static constexpr float kScale = 0x1.6a09e6p-4f;
  static constexpr float kLog2 = 0x1.0527dcp-3f;
};

// Row geometry of a bf16 head tile at head_dim D.
template <int D>
struct Row {
  static_assert(is_head_dim(D), "head_dim must be 64, 80, 96 or 128");
  static constexpr int kChunks = D / 8;          // 16-byte chunks a row
  static constexpr int kBytes = D * 2;
  static constexpr int kNTiles = D / 8;          // 8-column mma n-tiles
  static constexpr int kKSteps = D / 16;         // 16-deep mma k-steps
  // the swizzle's XOR: ((row >> kShift) & kMask), see the header
  static constexpr int kShift = kChunks % 8 == 0 ? 0 : kChunks % 4 == 0 ? 1 : 2;
  static constexpr int kMask = kChunks % 8 == 0 ? 7 : kChunks % 4 == 0 ? 3 : 1;
};

// c / N and c % N of a non-negative int through unsigned arithmetic: a
// shift and a mask where N is a power of two
template <int N>
__device__ __forceinline__ int udiv(int c) {
  return static_cast<int>(static_cast<unsigned>(c) / N);
}
template <int N>
__device__ __forceinline__ int umod(int c) {
  return static_cast<int>(static_cast<unsigned>(c) % N);
}

struct Strides {
  long long b, h, l;
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// byte offset of 16-byte chunk `chunk` of row `row` in a swizzled head tile
template <int D>
__device__ __forceinline__ uint32_t tile_off(int row, int chunk) {
  using R = Row<D>;
  return row * R::kBytes + ((chunk ^ ((row >> R::kShift) & R::kMask)) << 4);
}

__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// as cp_async16, but copies `src_bytes` (0 or 16) and zero-fills the rest
__device__ __forceinline__ void cp_async16_zfill(uint32_t dst, const void* src,
                                                 int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(src_bytes)
               : "memory");
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

// The tiled bodies keep the logits unscaled and take exp((s - m) * scale)
// as one ex2 of fma(s, Scale<D>::kLog2, -m * Scale<D>::kLog2).

__device__ __forceinline__ float ex2(float x) {   // 2^x; 2^-inf = +0
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
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
template <int D>
__device__ __forceinline__ uint32_t a_addr(uint32_t tile, int r0, int ks,
                                           int lane) {
  return tile + tile_off<D>(r0 + (lane & 15), 2 * ks + (lane >> 4));
}

// B fragments of two n-tiles whose n index is the tile's row (S = q . k^T:
// keys n0..n0+15), k-step ks: r[0], r[1] for keys n0.., r[2], r[3] n0+8..
template <int D>
__device__ __forceinline__ uint32_t b_addr(uint32_t tile, int n0, int ks,
                                           int lane) {
  return tile + tile_off<D>(n0 + (lane & 7) + ((lane >> 4) << 3),
                         2 * ks + ((lane >> 3) & 1));
}

// B fragments (through ldmatrix.trans) of two n-tiles whose k index is the
// tile's row (P . v: keys k0..k0+15) and n the columns 16dp..16dp+15:
// r[0], r[1] for columns 16dp.., r[2], r[3] for 16dp+8..
template <int D>
__device__ __forceinline__ uint32_t bt_addr(uint32_t tile, int k0, int dp,
                                            int lane) {
  return tile + tile_off<D>(k0 + (lane & 7) + (((lane >> 3) & 1) << 3),
                         2 * dp + (lane >> 4));
}

// Issue 16-byte copies of rows 0..len-1 of `ntensor` head tensors into
// consecutive tiles of `tile_bytes` at `dst`. Every source row is 2D
// contiguous, 16-byte aligned bytes (the wrapper checks the alignment).
template <int D, int kTensors>
__device__ __forceinline__ void stage_head(uint32_t dst, int tile_bytes,
                                           const __nv_bfloat16* const* src,
                                           const long long* row_stride,
                                           int len) {
  constexpr int kChunks = Row<D>::kChunks;
  for (int c = threadIdx.x; c < len * kChunks; c += blockDim.x) {
    const int row = udiv<kChunks>(c), chunk = umod<kChunks>(c);
    const uint32_t off = tile_off<D>(row, chunk);
#pragma unroll
    for (int t = 0; t < kTensors; ++t)
      cp_async16(dst + t * tile_bytes + off, src[t] + row * row_stride[t] +
                                                 chunk * 8);
  }
}

// The tiled bodies (L > 128) cut a head into tiles of kTileRows rows.
constexpr int kTileRows = 64;

// The shortest L at which K2 runs its bf16 tiled pair at some head_dim
// (K2's short limit is 112 or 128 in bf16), which takes K1's row
// statistics: K1's short body writes them only past this length, so its
// shorter instances keep their code.
constexpr int kStatsMinLen = 113;

// L rounded up to whole tiles: the row stride (in floats, per (batch,
// head)) of K1's statistics and of K2's per-row scratch, so a tile's 64
// values are one aligned block
__host__ __device__ inline int tiles_len(int len) {
  return (len + kTileRows - 1) / kTileRows * kTileRows;
}
template <int D>
__host__ __device__ constexpr int tile_bytes() {
  return kTileRows * Row<D>::kBytes;
}

// Issue 16-byte copies of rows row0..row0+63 of a head (`src` its row 0)
// into a swizzled 64-row tile at `dst`; rows at or past len are
// zero-filled by the copy itself, so a tile can be refilled in a ring.
template <int D>
__device__ __forceinline__ void stage_tile(uint32_t dst,
                                           const __nv_bfloat16* src,
                                           long long row_stride, int row0,
                                           int len) {
  constexpr int kChunks = Row<D>::kChunks;
  for (int c = threadIdx.x; c < kTileRows * kChunks; c += blockDim.x) {
    const int row = udiv<kChunks>(c), chunk = umod<kChunks>(c);
    const int g = row0 + row;
    const bool in = g < len;
    cp_async16_zfill(dst + tile_off<D>(row, chunk),
                     src + (in ? g : 0) * row_stride + chunk * 8,
                     in ? 16 : 0);
  }
}

// Zero rows len..lp-1 of `ntiles` consecutive head tiles (generic pointer)
template <int D>
__device__ __forceinline__ void zero_pad_rows(char* tiles, int ntiles,
                                              int tile_bytes, int len,
                                              int lp) {
  const int per_tile = (lp - len) * Row<D>::kChunks;
  for (int c = threadIdx.x; c < ntiles * per_tile; c += blockDim.x) {
    const int t = c / per_tile, rc = c - t * per_tile;
    *reinterpret_cast<uint4*>(tiles + t * tile_bytes + len * Row<D>::kBytes +
                              rc * 16) = make_uint4(0, 0, 0, 0);
  }
}

// A warp's 16 x D fp32 C fragments (D / 8 n-tiles of 8 columns), rounded
// to bf16, into rows r0..r0+15 (those below len) of a swizzled tile.
template <int D>
__device__ __forceinline__ void frags_to_tile(
    char* tile, int r0, const float (&acc)[Row<D>::kNTiles][4], int len,
    int lane) {
  const int r = r0 + (lane >> 2);
  const int byte = (lane & 3) * 4;
#pragma unroll
  for (int nt = 0; nt < Row<D>::kNTiles; ++nt) {
    if (r < len)
      *reinterpret_cast<uint32_t*>(tile + tile_off<D>(r, nt) + byte) =
          pack_bf16(acc[nt][0], acc[nt][1]);
    if (r + 8 < len)
      *reinterpret_cast<uint32_t*>(tile + tile_off<D>(r + 8, nt) + byte) =
          pack_bf16(acc[nt][2], acc[nt][3]);
  }
}

// Rows r0..r0+15 (those below len) of a swizzled tile to device memory,
// 16 bytes a lane, consecutive lanes on consecutive chunks of a row.
template <int D>
__device__ __forceinline__ void tile_rows_to_global(const char* tile, int r0,
                                                    __nv_bfloat16* dst,
                                                    long long row_stride,
                                                    int len, int lane) {
  constexpr int kChunks = Row<D>::kChunks;
#pragma unroll
  for (int c = lane; c < 16 * kChunks; c += 32) {
    const int row = r0 + udiv<kChunks>(c), chunk = umod<kChunks>(c);
    if (row < len)
      *reinterpret_cast<uint4*>(dst + row * row_stride + chunk * 8) =
          *reinterpret_cast<const uint4*>(tile + tile_off<D>(row, chunk));
  }
}

// Shared memory a CTA can be given (the H100's 227 KB).
constexpr size_t kMaxSmem = 232448;

// The fp32 bodies' output columns: each lane owns columns 2 lane and
// 2 lane + 1 of every 64-column group (at D = 80 lanes 0-7 take the
// second group's 16).
template <int D>
constexpr int kColGroups = (D + 63) / 64;

// whether lane owns a column pair in group g (always, for a full group)
template <int D>
__device__ __forceinline__ bool owns_cols(int g, int lane) {
  return 64 * (g + 1) <= D || 64 * g + 2 * lane < D;
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
                             static_cast<int>(kMaxSmem));
  if (err == cudaSuccess) *done_mask |= bit;
  return err;
}

}  // namespace hmmc
