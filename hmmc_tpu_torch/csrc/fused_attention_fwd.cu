// Fused attention forward (K1), CUDA C++ for sm_90a, at any L.
//
// Replaces the TPU kernel `_attention_kernel` launched by `_flash_forward`
// (hmmc_tpu/ops/pallas_attention.py). Same arithmetic, per (batch, head):
//   logits = (q . k^T in fp32) * head_dim^-0.5     [causal: keep cols <= rows]
//   P      = fp32 row softmax (max, exp, divide by the sum)
//   o      = (P rounded to v's dtype) . v, fp32 accumulation, stored in q's dtype
// No [L, L] tensor reaches device memory. Where a gradient will flow to
// K2's bf16 tiled pair (L past K2's short limit), the bf16 bodies also
// write each row's log-sum-exp of its scaled logits in log2 units (`lse`,
// rows of L rounded up to 64 floats a head; write_lse): K2 takes P from it
// instead of walking the logits again. Inference writes none. Two bodies,
// chosen by L: the short ones (L <= 128, one CTA per head, the whole row
// of keys on chip) and the tiled ones (L > 128); the tiled one writes
// them in an instance of its own, so inference runs its earlier code.
//
// Head_dim D is 64, 80, 96 or 128, each a compile-time instance of every
// body (template parameter D; the entry point picks it by head_dim and
// refuses any other). Logits are scaled by hmmc::Scale<D>::kScale, the
// plain version's fp32 D ** -0.5.
//
// What bounds it on an H100: q, k, v and o, counted once each, are
// 4*B*H*L*D elements; the two products are 4*B*H*L*L*D operations; at
// D = 64 about 25 per byte at L = 50 and 290 at L = 577, against the
// card's ~295 bf16 operations per byte. So at the short sites the bytes bound it: in bf16,
// 0.0704 ms at the ViT-B/32 site [768, 12, 50], 0.0200 ms at the text site
// [512, 8, 32, causal] and 0.0009 ms at the temporal site [64, 8, 12]
// (3.35 TB/s); at the towers' sites bytes and operations meet: 0.0694 ms
// (bytes) at ViT-B/16's [192, 12, 197], 0.0302 (bytes) at ViT-L/14's
// [48, 16, 257], 0.0677 (bytes; 0.0662 operations at 989 TFLOPS) at
// ViT-L/14@336px's [48, 16, 577].
//
// bf16, L <= 128 (the short sites): `attention_fwd_mma_kernel`. A CTA of 4
// warps takes kHeadsPerCta = 2 consecutive (batch, head) pairs through a
// 2-stage ring: while it computes head i from one stage, 16-byte cp.async
// copies bring head i+1's q, k and v into the other. Of 1, 2, 4 and 8
// heads per CTA, 2 was the fastest at the ViT site (PERF.md). Each stage
// holds q, k, v as bf16 [Lp][D] tiles (Lp = L rounded up to 16; rows past
// L zero-filled once), swizzled so that the copies and ldmatrix reads are
// conflict-free (attention_mma.cuh). Each warp owns 16 query rows: S = q .
// k^T runs on the tensor cores (mma.sync m16n8k16, bf16 in, fp32
// accumulate) with the whole row of Lp <= 128 keys in registers; masked
// and padded keys go to -inf, the row max and sum are quad shuffles, the
// row is scaled by the reciprocal of its sum and rounded to bf16, and
// those fragments are the A operand of P . v (v through ldmatrix.trans).
// That is the TPU kernel's cast order (fp32 logits and softmax, normalise,
// round, fp32 accumulation) with no online softmax. The exponential is
// __expf (ex2.approx of x log2 e) and the sum is inverted once per row:
// with the IEEE expf and a divide per element the softmax, not the bytes,
// bounded the kernel (0.125 against 0.086 ms at the ViT site, PERF.md).
// The output goes through the warp's own q rows in shared memory and
// leaves as 16-byte row stores.
// Per CTA (ptxas -v on sm_90a): shared memory 2 stages x 3 tiles x Lp x
// 2D bytes = 49,152 bytes at D = 64, L = 50 (NT = 4, 4 CTAs an SM),
// 98,304 at L = 128 (196,608 at D = 128: the short limit stays 128 at
// every D); at D = 64 80 registers at NT = 4 (8 bytes of spill stores),
// 43-134 over NT = 1..8 (the other D: PERF.md).
//
// bf16, L > 128 (the towers' ViT sites): `attention_fwd_tiled_kernel`, a
// CTA of 4 warps per (64-row Q tile, batch * head). It stages its Q tile
// and walks the head's 64-key tiles through a 2-stage cp.async ring (the
// copies zero-fill rows past L), each warp holding its 16 rows' running
// max and sum and a 16 x D fp32 output accumulator in registers (online
// softmax, FlashAttention-2's loop): S = q . k^T on the tensor cores,
// the tile's max, the accumulator rescaled by exp(m_old - m_new), P =
// exp(s - m) rounded to bf16 and P . v added; one division by the row
// sum at the end. So P is rounded before it is divided by the row sum,
// where the plain version divides first: bf16 results are not bitwise the
// plain version's (within one output ulp: atol 1e-2, rtol 2^-7), and the
// short bodies stay for L <= 128 (every bitwise check of the earlier
// paths, and at L = 50 the tiled body measured 6% slower when it was
// added, PERF.md). Only the tiles that hold a masked pair (the causal
// diagonal, the ragged last tile) are masked, the logits stay unscaled
// and exp((s - m) * scale) is one ex2 of an FMA (masking every tile
// measured within the run-to-run spread at L = 577 here, 13% in the first
// tiled K2); causal skips the tiles past
// the diagonal. Per CTA: 5 x 64 x 2D bytes of shared memory (Q and two
// (K, V) stages: 40,960 at D = 64), 97 registers at D = 64 (97-137 over
// the D), no spills.
//
// fp32 (reference checks only): `attention_fwd_fp32_kernel` (L <= 128),
// the CUDA-core body of the first version (one CTA per head, fp32 staging,
// fmaf loops), and `attention_fwd_fp32_tiled_kernel` (L > 128), the same
// loops over 32-row Q tiles and 64-key tiles with an online softmax (each
// warp keeps its 8 rows' max, sum and output in registers; IEEE expf).
// Each lane owns output columns 2 lane, 2 lane + 1 of every 64-column
// group (D / 64 rounded up; at D = 80 lanes 0-7 take the second group's
// 16). The
// tensor cores would take fp32 only as TF32, which keeps ~10 bits and
// would break the fp32 reference tolerances (2e-5 against the plain
// version, 1e-3 card against CPU), so fp32 stays on the CUDA cores.
//
// Layout: q, k, v, o are [B, H, L, D] with arbitrary batch/head/sequence
// strides and unit stride on the last axis, so the caller can pass head
// views of a packed qkv projection without copying; every pointer and
// stride must be 16-byte aligned (the wrapper checks). The kernel launches
// on the caller's stream, allocates nothing, and the entry point returns
// cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "attention_mma.cuh"

namespace {

using hmmc::kColGroups;
using hmmc::owns_cols;
using hmmc::Row;
using hmmc::Scale;
using hmmc::Strides;

constexpr int kMaxLen = 128;   // the short bodies' longest L, at every D
constexpr int kMmaWarps = 4;   // warps of a bf16 CTA, each owning 16 rows
constexpr int kHeadsPerCta = 2;   // (batch, head) pairs a bf16 CTA takes

// ---------------------------------------------------------------------------
// bf16: tensor cores
// ---------------------------------------------------------------------------

struct Args {
  const __nv_bfloat16 *q, *k, *v;
  __nv_bfloat16* o;
  int heads, len, causal, heads_total;
  Strides sq, sk, sv, so;
  float* lse;   // optional: per-row statistics, tiles_len(L) floats a head
};

constexpr float kLog2e = 0x1.715476p+0f;   // log2(e) rounded to fp32

// Row statistics for K2 (rows below len, one lane of each quad): the
// log-sum-exp of the row's scaled logits in log2 units, lse = m + log2(sum)
// for the row's max m (in log2 units) and sum of 2^(logit - m), so that
// K2 takes P = 2^(unscaled logit x Scale<D>::kLog2 - lse).
__device__ __forceinline__ void write_lse(float* lse, int head, int len,
                                          int r, float m0, float m1,
                                          float sum0, float sum1, int lane) {
  if (lse == nullptr || (lane & 3) != 0) return;
  float* row = lse + static_cast<long long>(head) * hmmc::tiles_len(len);
  if (r < len) row[r] = m0 + __log2f(sum0);
  if (r + 8 < len) row[r + 8] = m1 + __log2f(sum1);
}

// NT = Lp / 16 row (and key) tiles of 16.
template <int D, int NT>
__global__ void __launch_bounds__(kMmaWarps * 32)
attention_fwd_mma_kernel(Args a) {
  constexpr int kLp = 16 * NT;
  constexpr int kTile = kLp * Row<D>::kBytes;
  constexpr float kScale = Scale<D>::kScale;
  constexpr int kStage = 3 * kTile;   // q, k, v
  extern __shared__ uint4 smem_raw[];
  char* smem = reinterpret_cast<char*>(smem_raw);
  const uint32_t smem_base = hmmc::smem_u32(smem);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int len = a.len;

  hmmc::zero_pad_rows<D>(smem, 6, kTile, len, kLp);

  const int first = blockIdx.x * kHeadsPerCta;
  const int last = min(first + kHeadsPerCta, a.heads_total);
  const long long row_stride[3] = {a.sq.l, a.sk.l, a.sv.l};
  auto issue = [&](int head, int stage) {
    const int b = head / a.heads, h = head - b * a.heads;
    const __nv_bfloat16* src[3] = {a.q + b * a.sq.b + h * a.sq.h,
                                   a.k + b * a.sk.b + h * a.sk.h,
                                   a.v + b * a.sv.b + h * a.sv.h};
    hmmc::stage_head<D, 3>(smem_base + stage * kStage, kTile, src, row_stride,
                           len);
  };
  issue(first, 0);
  hmmc::cp_async_commit();

  for (int head = first, it = 0; head < last; ++head, ++it) {
    if (head + 1 < last) issue(head + 1, (it + 1) & 1);
    hmmc::cp_async_commit();   // possibly empty: one group per iteration
    hmmc::cp_async_wait<1>();  // this head's group has landed
    __syncthreads();

    const int stage = it & 1;
    char* s_q = smem + stage * kStage;
    const uint32_t tq = smem_base + stage * kStage;
    const uint32_t tk = tq + kTile, tv = tk + kTile;
    const int b = head / a.heads, hh = head - b * a.heads;
    __nv_bfloat16* ob = a.o + b * a.so.b + hh * a.so.h;

    for (int mt = warp; mt < NT; mt += kMmaWarps) {
      // S = q . k^T for rows 16mt..16mt+15 against all keys
      float s[2 * NT][4];
#pragma unroll
      for (int n = 0; n < 2 * NT; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[n][e] = 0.f;
#pragma unroll
      for (int ks = 0; ks < Row<D>::kKSteps; ++ks) {
        uint32_t qa[4];
        hmmc::ldsm_x4(hmmc::a_addr<D>(tq, 16 * mt, ks, lane), qa);
#pragma unroll
        for (int np = 0; np < NT; ++np) {
          if (a.causal && np > mt) continue;   // keys all after the rows
          uint32_t kb[4];
          hmmc::ldsm_x4(hmmc::b_addr<D>(tk, 16 * np, ks, lane), kb);
          hmmc::mma_bf16(s[2 * np], qa, kb[0], kb[1]);
          hmmc::mma_bf16(s[2 * np + 1], qa, kb[2], kb[3]);
        }
      }

      // fp32 row softmax of rows r and r + 8; masked and padded keys get
      // probability 0 (no row is all masked: key 0 is always kept)
      const int r = 16 * mt + (lane >> 2);
      float m0 = -INFINITY, m1 = -INFINITY;
#pragma unroll
      for (int n = 0; n < 2 * NT; ++n)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int j = 8 * n + 2 * (lane & 3) + e;
          const bool keep0 = j < len && (!a.causal || j <= r);
          const bool keep1 = j < len && (!a.causal || j <= r + 8);
          s[n][e] = keep0 ? s[n][e] * kScale : -INFINITY;
          s[n][2 + e] = keep1 ? s[n][2 + e] * kScale : -INFINITY;
          m0 = fmaxf(m0, s[n][e]);
          m1 = fmaxf(m1, s[n][2 + e]);
        }
      m0 = hmmc::quad_max(m0);
      m1 = hmmc::quad_max(m1);
      float sum0 = 0.f, sum1 = 0.f;
#pragma unroll
      for (int n = 0; n < 2 * NT; ++n)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          s[n][e] = __expf(s[n][e] - m0);
          s[n][2 + e] = __expf(s[n][2 + e] - m1);
          sum0 += s[n][e];
          sum1 += s[n][2 + e];
        }
      sum0 = hmmc::quad_sum(sum0);
      sum1 = hmmc::quad_sum(sum1);
      const float inv0 = 1.f / sum0, inv1 = 1.f / sum1;
      if constexpr (16 * NT >= hmmc::kStatsMinLen)
        write_lse(a.lse, head, len, r, m0 * kLog2e, m1 * kLog2e, sum0, sum1,
                  lane);

      // o = (P rounded to bf16) . v: the C fragments of key tiles 2j and
      // 2j + 1, divided and packed, are the A fragment of k-step j
      float o[Row<D>::kNTiles][4];
#pragma unroll
      for (int n = 0; n < Row<D>::kNTiles; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) o[n][e] = 0.f;
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        if (a.causal && j > mt) continue;   // P = 0 there
        const uint32_t pa[4] = {
            hmmc::pack_bf16(s[2 * j][0] * inv0, s[2 * j][1] * inv0),
            hmmc::pack_bf16(s[2 * j][2] * inv1, s[2 * j][3] * inv1),
            hmmc::pack_bf16(s[2 * j + 1][0] * inv0, s[2 * j + 1][1] * inv0),
            hmmc::pack_bf16(s[2 * j + 1][2] * inv1, s[2 * j + 1][3] * inv1)};
#pragma unroll
        for (int dp = 0; dp < Row<D>::kKSteps; ++dp) {
          uint32_t vb[4];
          hmmc::ldsm_x4_t(hmmc::bt_addr<D>(tv, 16 * j, dp, lane), vb);
          hmmc::mma_bf16(o[2 * dp], pa, vb[0], vb[1]);
          hmmc::mma_bf16(o[2 * dp + 1], pa, vb[2], vb[3]);
        }
      }

      // the warp's own q rows are free now: stage o there, store rows
      __syncwarp();
      hmmc::frags_to_tile<D>(s_q, 16 * mt, o, len, lane);
      __syncwarp();
      hmmc::tile_rows_to_global<D>(s_q, 16 * mt, ob, a.so.l, len, lane);
    }
    __syncthreads();   // the stage is refilled two heads on
  }
}

template <int D>
constexpr size_t smem_bytes_mma(int len) {
  const size_t lp = static_cast<size_t>((len + 15) & ~15);
  return 2 * 3 * lp * Row<D>::kBytes;
}

template <int D, int NT>
cudaError_t launch_mma(const Args& a, cudaStream_t stream) {
  static unsigned allowed = 0;
  auto kernel = attention_fwd_mma_kernel<D, NT>;
  const size_t smem = smem_bytes_mma<D>(a.len);
  const cudaError_t err = hmmc::allow_smem(kernel, smem, &allowed);
  if (err != cudaSuccess) return err;
  const int grid = (a.heads_total + kHeadsPerCta - 1) / kHeadsPerCta;
  kernel<<<grid, kMmaWarps * 32, smem, stream>>>(a);
  return cudaGetLastError();
}

// the instance of NT = ceil(L / 16) tiles, L <= kMaxLen
template <int D, int NT = 1>
cudaError_t dispatch_mma(const Args& a, cudaStream_t stream) {
  if constexpr (16 * NT < kMaxLen) {
    if (a.len > 16 * NT) return dispatch_mma<D, NT + 1>(a, stream);
  }
  return launch_mma<D, NT>(a, stream);
}

// ---------------------------------------------------------------------------
// bf16, L > 128: Q tiles against a ring of KV tiles, online softmax
// ---------------------------------------------------------------------------

using hmmc::kTileRows;

// Logits of keys past L, or (causal) after their row, to -inf: a warp's
// 16 x 64 C fragments of rows r and r + 8 against keys k0..k0+63.
__device__ __forceinline__ void mask_tile(float (&s)[8][4], int k0, int r,
                                          int len, int causal, int lane) {
#pragma unroll
  for (int n = 0; n < 8; ++n)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int j = k0 + 8 * n + 2 * (lane & 3) + e;
      if (j >= len || (causal && j > r)) s[n][e] = -INFINITY;
      if (j >= len || (causal && j > r + 8)) s[n][2 + e] = -INFINITY;
    }
}

// CTA (blockIdx.y, blockIdx.x) = (Q tile, batch * head): 4 warps, 16 query
// rows each. Shared memory: the Q tile, then two stages of (K, V) tiles.
// kStats: the instance that writes the row statistics (a.lse), so the
// inference instance keeps its code and registers.
template <int D, bool kStats>
__global__ void __launch_bounds__(kMmaWarps * 32)
attention_fwd_tiled_kernel(Args a) {
  constexpr int kTileBytes = hmmc::tile_bytes<D>();
  constexpr float kScaleLog2 = Scale<D>::kLog2;
  extern __shared__ uint4 smem_raw[];
  char* smem = reinterpret_cast<char*>(smem_raw);
  const uint32_t base = hmmc::smem_u32(smem);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int len = a.len, head = blockIdx.x, qt = blockIdx.y;
  const int q0 = qt * kTileRows;
  const int b = head / a.heads, hh = head - b * a.heads;
  const __nv_bfloat16* kb = a.k + b * a.sk.b + hh * a.sk.h;
  const __nv_bfloat16* vb = a.v + b * a.sv.b + hh * a.sv.h;
  // causal: the KV tiles up to the diagonal one
  const int n_kv = a.causal ? qt + 1 : (len + kTileRows - 1) / kTileRows;
  auto issue = [&](int kt) {
    const uint32_t dst = base + kTileBytes + (kt & 1) * 2 * kTileBytes;
    hmmc::stage_tile<D>(dst, kb, a.sk.l, kt * kTileRows, len);
    hmmc::stage_tile<D>(dst + kTileBytes, vb, a.sv.l, kt * kTileRows, len);
  };
  hmmc::stage_tile<D>(base, a.q + b * a.sq.b + hh * a.sq.h, a.sq.l, q0, len);
  issue(0);
  hmmc::cp_async_commit();

  const int r = q0 + 16 * warp + (lane >> 2);   // rows r and r + 8
  float o[Row<D>::kNTiles][4], m0 = -INFINITY, m1 = -INFINITY, l0 = 0.f,
                               l1 = 0.f;
#pragma unroll
  for (int n = 0; n < Row<D>::kNTiles; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[n][e] = 0.f;

  for (int kt = 0; kt < n_kv; ++kt) {
    if (kt + 1 < n_kv) issue(kt + 1);
    hmmc::cp_async_commit();   // possibly empty: one group per tile
    hmmc::cp_async_wait<1>();  // this tile's group (and Q) has landed
    __syncthreads();
    const uint32_t tk = base + kTileBytes + (kt & 1) * 2 * kTileBytes;
    const uint32_t tv = tk + kTileBytes;
    const int k0 = kt * kTileRows;
    const bool diag = a.causal && kt == qt;   // keys of pair np > warp
                                              // all lie after the rows
    float s[8][4];
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[n][e] = 0.f;
#pragma unroll
    for (int ks = 0; ks < Row<D>::kKSteps; ++ks) {
      uint32_t qa[4];
      hmmc::ldsm_x4(hmmc::a_addr<D>(base, 16 * warp, ks, lane), qa);
#pragma unroll
      for (int np = 0; np < 4; ++np) {
        if (diag && np > warp) continue;
        uint32_t kf[4];
        hmmc::ldsm_x4(hmmc::b_addr<D>(tk, 16 * np, ks, lane), kf);
        hmmc::mma_bf16(s[2 * np], qa, kf[0], kf[1]);
        hmmc::mma_bf16(s[2 * np + 1], qa, kf[2], kf[3]);
      }
    }
    // masked and padded keys to -inf, on the tiles that hold any (the
    // causal diagonal, the last tile of a ragged L); the tile's row max of
    // the unscaled logits (key 0 is in the first tile and kept for every
    // row, so the running max is finite from there on)
    if (diag || k0 + kTileRows > len) mask_tile(s, k0, r, len, a.causal, lane);
    float mx0 = -INFINITY, mx1 = -INFINITY;
#pragma unroll
    for (int n = 0; n < 8; ++n) {
      mx0 = fmaxf(mx0, fmaxf(s[n][0], s[n][1]));
      mx1 = fmaxf(mx1, fmaxf(s[n][2], s[n][3]));
    }
    const float mn0 = fmaxf(m0, hmmc::quad_max(mx0));
    const float mn1 = fmaxf(m1, hmmc::quad_max(mx1));
    const float al0 = hmmc::ex2((m0 - mn0) * kScaleLog2);
    const float al1 = hmmc::ex2((m1 - mn1) * kScaleLog2);
    m0 = mn0;
    m1 = mn1;
    const float c0 = m0 * kScaleLog2, c1 = m1 * kScaleLog2;
    float t0 = 0.f, t1 = 0.f;
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        s[n][e] = hmmc::ex2(fmaf(s[n][e], kScaleLog2, -c0));
        s[n][2 + e] = hmmc::ex2(fmaf(s[n][2 + e], kScaleLog2, -c1));
        t0 += s[n][e];
        t1 += s[n][2 + e];
      }
    l0 = l0 * al0 + t0;   // this lane's columns; summed over the quad
    l1 = l1 * al1 + t1;   // at the end
#pragma unroll
    for (int n = 0; n < Row<D>::kNTiles; ++n) {
      o[n][0] *= al0;
      o[n][1] *= al0;
      o[n][2] *= al1;
      o[n][3] *= al1;
    }
    // o += (P rounded to bf16) . v, P not yet divided by the row sum
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      if (diag && j > warp) continue;   // P = 0 there
      const uint32_t pa[4] = {hmmc::pack_bf16(s[2 * j][0], s[2 * j][1]),
                              hmmc::pack_bf16(s[2 * j][2], s[2 * j][3]),
                              hmmc::pack_bf16(s[2 * j + 1][0], s[2 * j + 1][1]),
                              hmmc::pack_bf16(s[2 * j + 1][2], s[2 * j + 1][3])};
#pragma unroll
      for (int dp = 0; dp < Row<D>::kKSteps; ++dp) {
        uint32_t vf[4];
        hmmc::ldsm_x4_t(hmmc::bt_addr<D>(tv, 16 * j, dp, lane), vf);
        hmmc::mma_bf16(o[2 * dp], pa, vf[0], vf[1]);
        hmmc::mma_bf16(o[2 * dp + 1], pa, vf[2], vf[3]);
      }
    }
    __syncthreads();   // the stage is refilled two tiles on
  }
  l0 = hmmc::quad_sum(l0);
  l1 = hmmc::quad_sum(l1);
  const float inv0 = 1.f / l0, inv1 = 1.f / l1;
  if constexpr (kStats)
    write_lse(a.lse, head, len, r, m0 * kScaleLog2, m1 * kScaleLog2, l0, l1,
              lane);
#pragma unroll
  for (int n = 0; n < Row<D>::kNTiles; ++n) {
    o[n][0] *= inv0;
    o[n][1] *= inv0;
    o[n][2] *= inv1;
    o[n][3] *= inv1;
  }
  // only this warp reads its rows of the Q tile: stage o there
  const int rows = len - q0;
  __nv_bfloat16* ob = a.o + b * a.so.b + hh * a.so.h + q0 * a.so.l;
  hmmc::frags_to_tile<D>(smem, 16 * warp, o, rows, lane);
  __syncwarp();
  hmmc::tile_rows_to_global<D>(smem, 16 * warp, ob, a.so.l, rows, lane);
}

template <int D>   // Q, then 2 x (K, V)
constexpr size_t kSmemTiled = 5 * hmmc::tile_bytes<D>();

template <int D, bool kStats>
cudaError_t launch_tiled_as(const Args& a, cudaStream_t stream) {
  static unsigned allowed = 0;
  auto kernel = attention_fwd_tiled_kernel<D, kStats>;
  const cudaError_t err = hmmc::allow_smem(kernel, kSmemTiled<D>, &allowed);
  if (err != cudaSuccess) return err;
  const dim3 grid(a.heads_total, (a.len + kTileRows - 1) / kTileRows);
  kernel<<<grid, kMmaWarps * 32, kSmemTiled<D>, stream>>>(a);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_tiled(const Args& a, cudaStream_t stream) {
  return a.lse != nullptr ? launch_tiled_as<D, true>(a, stream)
                          : launch_tiled_as<D, false>(a, stream);
}

// ---------------------------------------------------------------------------
// fp32: CUDA cores (reference checks only, see the header)
// ---------------------------------------------------------------------------

constexpr int kWarps = 4;
constexpr int kRows = 4;                // query rows a warp handles at once
// K rows of D + 4 floats: a quarter-warp's float4 loads of 8 keys step
// D / 4 + 1 four-bank groups a row, odd at every D in the set (a multiple
// of 8), so they hit 32 distinct banks
template <int D>
constexpr int kKStride = D + 4;

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, off));
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

// One CTA per (batch, head). NT = ceil(L / 32) key slots per lane.
template <int D, int NT>
__global__ void __launch_bounds__(kWarps * 32)
attention_fwd_fp32_kernel(const float* __restrict__ q,
                          const float* __restrict__ k,
                          const float* __restrict__ v, float* __restrict__ o,
                          int heads, int len, Strides sq, Strides sk,
                          Strides sv, Strides so, int causal) {
  constexpr int kHeadDim = D, kKS = kKStride<D>, kCG = kColGroups<D>;
  constexpr float kScale = Scale<D>::kScale;
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int lp = (len + 3) & ~3;
  float* s_q = smem;                         // [lp][D]
  float* s_k = s_q + lp * kHeadDim;          // [lp][D + 4]
  float* s_v = s_k + lp * kKS;               // [lp][D]
  float* s_p = s_v + lp * kHeadDim;          // [kWarps][kRows][lp]

  const int b = blockIdx.x / heads;
  const int h = blockIdx.x - b * heads;
  const float* qb = q + b * sq.b + h * sq.h;
  const float* kb = k + b * sk.b + h * sk.h;
  const float* vb = v + b * sv.b + h * sv.h;
  float* ob = o + b * so.b + h * so.h;

  // stage the head: consecutive threads read consecutive elements of a row;
  // kUnroll rounds of loads are issued before any is stored, so a thread
  // keeps 3 * kUnroll device-memory reads in flight
  constexpr int kUnroll = 8;
  const int n = len * kHeadDim;
  for (int base = threadIdx.x; base < n; base += kUnroll * blockDim.x) {
    float tq[kUnroll], tk[kUnroll], tv[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int idx = base + u * blockDim.x;
      if (idx < n) {
        const int l = hmmc::udiv<kHeadDim>(idx);
        const int d = idx - l * kHeadDim;
        tq[u] = qb[l * sq.l + d];
        tk[u] = kb[l * sk.l + d];
        tv[u] = vb[l * sv.l + d];
      }
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int idx = base + u * blockDim.x;
      if (idx < n) {
        const int l = hmmc::udiv<kHeadDim>(idx);
        const int d = idx - l * kHeadDim;
        s_q[l * kHeadDim + d] = tq[u];
        s_k[l * kKS + d] = tk[u];
        s_v[l * kHeadDim + d] = tv[u];
      }
    }
  }
  __syncthreads();

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  float* p_row = s_p + warp * kRows * lp;

  int kj[NT];
#pragma unroll
  for (int t = 0; t < NT; ++t) kj[t] = min(lane + 32 * t, len - 1);

  // the loop bound is warp-uniform, so the shuffles below see a full warp
  for (int i0 = warp * kRows; i0 < len; i0 += kWarps * kRows) {
    int qi[kRows];
#pragma unroll
    for (int r = 0; r < kRows; ++r) qi[r] = min(i0 + r, len - 1);

    // logits for rows i0..i0+3 against keys lane, lane+32, ...
    float acc[kRows][NT];
#pragma unroll
    for (int r = 0; r < kRows; ++r)
#pragma unroll
      for (int t = 0; t < NT; ++t) acc[r][t] = 0.f;

#pragma unroll 4
    for (int d = 0; d < kHeadDim; d += 4) {
      float4 qv[kRows];
#pragma unroll
      for (int r = 0; r < kRows; ++r)
        qv[r] = *reinterpret_cast<const float4*>(s_q + qi[r] * kHeadDim + d);
#pragma unroll
      for (int t = 0; t < NT; ++t) {
        const float4 kv =
            *reinterpret_cast<const float4*>(s_k + kj[t] * kKS + d);
#pragma unroll
        for (int r = 0; r < kRows; ++r) {
          acc[r][t] = fmaf(qv[r].x, kv.x, acc[r][t]);
          acc[r][t] = fmaf(qv[r].y, kv.y, acc[r][t]);
          acc[r][t] = fmaf(qv[r].z, kv.z, acc[r][t]);
          acc[r][t] = fmaf(qv[r].w, kv.w, acc[r][t]);
        }
      }
    }

    // fp32 row softmax; masked and out-of-range keys get probability 0.
    // Rows past the end (i0 + r >= len) are computed but never stored.
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      const int i = i0 + r;
      float m = -INFINITY;
#pragma unroll
      for (int t = 0; t < NT; ++t) {
        const int j = lane + 32 * t;
        const bool keep = j < len && (!causal || j <= i);
        acc[r][t] = keep ? acc[r][t] * kScale : -INFINITY;
        m = fmaxf(m, acc[r][t]);
      }
      m = warp_max(m);
      float sum = 0.f;
#pragma unroll
      for (int t = 0; t < NT; ++t) {
        acc[r][t] = expf(acc[r][t] - m);
        sum += acc[r][t];
      }
      sum = warp_sum(sum);
#pragma unroll
      for (int t = 0; t < NT; ++t) {
        const int j = lane + 32 * t;
        if (j < len) p_row[r * lp + j] = acc[r][t] / sum;
      }
    }
    __syncwarp();

    // o = P . v: each lane owns output columns 2 lane and 2 lane + 1 of
    // each 64-column group
    const int jmax = causal ? min(len, i0 + kRows) : len;
    float2 out[kRows][kCG];
#pragma unroll
    for (int r = 0; r < kRows; ++r)
#pragma unroll
      for (int g = 0; g < kCG; ++g) out[r][g] = make_float2(0.f, 0.f);
    for (int j = 0; j < jmax; ++j) {
#pragma unroll
      for (int g = 0; g < kCG; ++g) {
        if (!owns_cols<D>(g, lane)) continue;
        const float2 vv = *reinterpret_cast<const float2*>(
            s_v + j * kHeadDim + 64 * g + 2 * lane);
#pragma unroll
        for (int r = 0; r < kRows; ++r) {
          const float p = p_row[r * lp + j];
          out[r][g].x = fmaf(p, vv.x, out[r][g].x);
          out[r][g].y = fmaf(p, vv.y, out[r][g].y);
        }
      }
    }
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      const int i = i0 + r;
#pragma unroll
      for (int g = 0; g < kCG; ++g)
        if (i < len && owns_cols<D>(g, lane)) {
          float* op = ob + i * so.l + 64 * g + 2 * lane;
          op[0] = out[r][g].x;
          op[1] = out[r][g].y;
        }
    }
    __syncwarp();
  }
}

// dynamic shared memory of one fp32 CTA: q, k (padded rows), v and the
// per-warp probability rows
template <int D>
constexpr size_t smem_bytes_fp32(int len) {
  const size_t lp = static_cast<size_t>((len + 3) & ~3);
  return sizeof(float) * (lp * (2 * D + kKStride<D>) + kWarps * kRows * lp);
}

template <int D, int NT>
cudaError_t launch_fp32(const void* q, const void* k, const void* v, void* o,
                        int batch, int heads, int len, Strides sq, Strides sk,
                        Strides sv, Strides so, int causal,
                        cudaStream_t stream) {
  static unsigned allowed = 0;
  const size_t smem = smem_bytes_fp32<D>(len);
  auto kernel = attention_fwd_fp32_kernel<D, NT>;
  const cudaError_t err = hmmc::allow_smem(kernel, smem, &allowed);
  if (err != cudaSuccess) return err;
  kernel<<<batch * heads, kWarps * 32, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(o), heads, len, sq,
      sk, sv, so, causal);
  return cudaGetLastError();
}

// the instance of NT = ceil(L / 32) key slots, L <= kMaxLen
template <int D, int NT = 1>
cudaError_t dispatch_fp32(const void* q, const void* k, const void* v,
                          void* o, int batch, int heads, int len, Strides sq,
                          Strides sk, Strides sv, Strides so, int causal,
                          cudaStream_t stream) {
  if constexpr (32 * NT < kMaxLen) {
    if (len > 32 * NT)
      return dispatch_fp32<D, NT + 1>(q, k, v, o, batch, heads, len, sq, sk,
                                      sv, so, causal, stream);
  }
  return launch_fp32<D, NT>(q, k, v, o, batch, heads, len, sq, sk, sv, so,
                            causal, stream);
}

// fp32, L > 128: one CTA per (32-row Q tile, batch * head), KV tiles of 64
// keys staged in turn, online softmax. Each warp owns 8 query rows for the
// whole loop: their running max, sum and output stay in registers.
constexpr int kF32Rows = 8;
constexpr int kF32QTile = kWarps * kF32Rows;   // 32
constexpr int kF32KTile = 64;

template <int D>
__global__ void __launch_bounds__(kWarps * 32)
attention_fwd_fp32_tiled_kernel(const float* __restrict__ q,
                                const float* __restrict__ k,
                                const float* __restrict__ v,
                                float* __restrict__ o, int heads, int len,
                                Strides sq, Strides sk, Strides sv, Strides so,
                                int causal) {
  constexpr int kHeadDim = D, kKS = kKStride<D>, kCG = kColGroups<D>;
  constexpr int kF4 = D / 4;                       // float4s a row
  constexpr float kScale = Scale<D>::kScale;
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  float* s_q = smem;                               // [32][D]
  float* s_k = s_q + kF32QTile * kHeadDim;         // [64][D + 4]
  float* s_v = s_k + kF32KTile * kKS;              // [64][D]
  float* s_p = s_v + kF32KTile * kHeadDim;         // [kWarps][8][64]
  const int head = blockIdx.x, q0 = blockIdx.y * kF32QTile;
  const int b = head / heads, h = head - b * heads;
  const float* qb = q + b * sq.b + h * sq.h;
  const float* kb = k + b * sk.b + h * sk.h;
  const float* vb = v + b * sv.b + h * sv.h;
  float* ob = o + b * so.b + h * so.h;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;

  // rows at or past len are staged as zeros (16-byte loads: the wrapper
  // checks every pointer and stride is 16-byte aligned)
  for (int c = threadIdx.x; c < kF32QTile * kF4; c += blockDim.x) {
    const int row = hmmc::udiv<kF4>(c), col = hmmc::umod<kF4>(c) * 4;
    const int i = q0 + row;
    *reinterpret_cast<float4*>(s_q + row * kHeadDim + col) =
        i < len ? *reinterpret_cast<const float4*>(qb + i * sq.l + col)
                : make_float4(0.f, 0.f, 0.f, 0.f);
  }

  const int i0 = q0 + warp * kF32Rows;   // the warp's first row
  const float* q_rows = s_q + warp * kF32Rows * kHeadDim;
  float* p_row = s_p + warp * kF32Rows * kF32KTile;
  float m[kF32Rows], l[kF32Rows];
  float2 out[kF32Rows][kCG];
#pragma unroll
  for (int r = 0; r < kF32Rows; ++r) {
    m[r] = -INFINITY;
    l[r] = 0.f;
#pragma unroll
    for (int g = 0; g < kCG; ++g) out[r][g] = make_float2(0.f, 0.f);
  }
  const int kv_end = causal ? min(len, q0 + kF32QTile) : len;
  for (int k0 = 0; k0 < kv_end; k0 += kF32KTile) {
    __syncthreads();   // the previous tile's readers are done
    for (int c = threadIdx.x; c < kF32KTile * kF4; c += blockDim.x) {
      const int row = hmmc::udiv<kF4>(c), col = hmmc::umod<kF4>(c) * 4;
      const int j = k0 + row;
      const bool in = j < len;
      const float4 z = make_float4(0.f, 0.f, 0.f, 0.f);
      *reinterpret_cast<float4*>(s_k + row * kKS + col) =
          in ? *reinterpret_cast<const float4*>(kb + j * sk.l + col) : z;
      *reinterpret_cast<float4*>(s_v + row * kHeadDim + col) =
          in ? *reinterpret_cast<const float4*>(vb + j * sv.l + col) : z;
    }
    __syncthreads();

    // logits of the warp's rows against keys k0 + lane and k0 + lane + 32
    float acc[kF32Rows][2];
#pragma unroll
    for (int r = 0; r < kF32Rows; ++r) acc[r][0] = acc[r][1] = 0.f;
#pragma unroll 4
    for (int d = 0; d < kHeadDim; d += 4) {
      const float4 k0v =
          *reinterpret_cast<const float4*>(s_k + lane * kKS + d);
      const float4 k1v =
          *reinterpret_cast<const float4*>(s_k + (lane + 32) * kKS + d);
#pragma unroll
      for (int r = 0; r < kF32Rows; ++r) {
        const float4 qv =
            *reinterpret_cast<const float4*>(q_rows + r * kHeadDim + d);
        acc[r][0] = fmaf(qv.x, k0v.x, acc[r][0]);
        acc[r][0] = fmaf(qv.y, k0v.y, acc[r][0]);
        acc[r][0] = fmaf(qv.z, k0v.z, acc[r][0]);
        acc[r][0] = fmaf(qv.w, k0v.w, acc[r][0]);
        acc[r][1] = fmaf(qv.x, k1v.x, acc[r][1]);
        acc[r][1] = fmaf(qv.y, k1v.y, acc[r][1]);
        acc[r][1] = fmaf(qv.z, k1v.z, acc[r][1]);
        acc[r][1] = fmaf(qv.w, k1v.w, acc[r][1]);
      }
    }
    // online softmax per row: key 0 is in the first tile and kept for
    // every row, so the running max is finite from there on
#pragma unroll
    for (int r = 0; r < kF32Rows; ++r) {
      const int i = i0 + r;
      float mx = -INFINITY;
#pragma unroll
      for (int t = 0; t < 2; ++t) {
        const int j = k0 + lane + 32 * t;
        const bool keep = j < len && (!causal || j <= i);
        acc[r][t] = keep ? acc[r][t] * kScale : -INFINITY;
        mx = fmaxf(mx, acc[r][t]);
      }
      const float mn = fmaxf(m[r], warp_max(mx));
      const float al = expf(m[r] - mn);
      m[r] = mn;
      float ts = 0.f;
#pragma unroll
      for (int t = 0; t < 2; ++t) {
        const float p = expf(acc[r][t] - mn);
        p_row[r * kF32KTile + lane + 32 * t] = p;
        ts += p;
      }
      l[r] = l[r] * al + warp_sum(ts);
#pragma unroll
      for (int g = 0; g < kCG; ++g) {
        out[r][g].x *= al;
        out[r][g].y *= al;
      }
    }
    __syncwarp();
    // out += P . v: each lane owns output columns 2 lane and 2 lane + 1 of
    // each 64-column group; keys past the end (and, causal, past the
    // warp's last row) add 0
    int jmax = min(kF32KTile, len - k0);
    if (causal) jmax = min(jmax, i0 + kF32Rows - k0);
    for (int j = 0; j < jmax; ++j) {
#pragma unroll
      for (int g = 0; g < kCG; ++g) {
        if (!owns_cols<D>(g, lane)) continue;
        const float2 vv = *reinterpret_cast<const float2*>(
            s_v + j * kHeadDim + 64 * g + 2 * lane);
#pragma unroll
        for (int r = 0; r < kF32Rows; ++r) {
          const float p = p_row[r * kF32KTile + j];
          out[r][g].x = fmaf(p, vv.x, out[r][g].x);
          out[r][g].y = fmaf(p, vv.y, out[r][g].y);
        }
      }
    }
    __syncwarp();
  }
#pragma unroll
  for (int r = 0; r < kF32Rows; ++r) {
    const int i = i0 + r;
#pragma unroll
    for (int g = 0; g < kCG; ++g)
      if (i < len && owns_cols<D>(g, lane)) {
        float* op = ob + i * so.l + 64 * g + 2 * lane;
        op[0] = out[r][g].x / l[r];
        op[1] = out[r][g].y / l[r];
      }
  }
}

template <int D>
constexpr size_t kSmemF32Tiled =
    sizeof(float) * (kF32QTile * D + kF32KTile * kKStride<D> +
                     kF32KTile * D + kWarps * kF32Rows * kF32KTile);

template <int D>
cudaError_t launch_fp32_tiled(const void* q, const void* k, const void* v,
                              void* o, int batch, int heads, int len,
                              Strides sq, Strides sk, Strides sv, Strides so,
                              int causal, cudaStream_t stream) {
  static unsigned allowed = 0;
  auto kernel = attention_fwd_fp32_tiled_kernel<D>;
  const cudaError_t err = hmmc::allow_smem(kernel, kSmemF32Tiled<D>, &allowed);
  if (err != cudaSuccess) return err;
  const dim3 grid(batch * heads, (len + kF32QTile - 1) / kF32QTile);
  kernel<<<grid, kWarps * 32, kSmemF32Tiled<D>, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(o), heads, len, sq,
      sk, sv, so, causal);
  return cudaGetLastError();
}

// the short bodies at kMaxLen fit the SM's shared memory at every D
static_assert(smem_bytes_mma<128>(kMaxLen) <= hmmc::kMaxSmem &&
                  smem_bytes_fp32<128>(kMaxLen) <= hmmc::kMaxSmem,
              "K1's short bodies overflow shared memory at head_dim 128");

template <int D>
cudaError_t run(const void* q, const void* k, const void* v, void* o,
                int dtype, int batch, int heads, int len, Strides sq,
                Strides sk, Strides sv, Strides so, int causal, float* lse,
                cudaStream_t s) {
  const bool tiled = len > kMaxLen;
  if (dtype == 0) {
    if (lse != nullptr) return cudaErrorInvalidValue;   // bf16 only
    return tiled ? launch_fp32_tiled<D>(q, k, v, o, batch, heads, len, sq, sk,
                                        sv, so, causal, s)
                 : dispatch_fp32<D>(q, k, v, o, batch, heads, len, sq, sk, sv,
                                    so, causal, s);
  }
  if (dtype == 1) {
    const Args a{static_cast<const __nv_bfloat16*>(q),
                 static_cast<const __nv_bfloat16*>(k),
                 static_cast<const __nv_bfloat16*>(v),
                 static_cast<__nv_bfloat16*>(o),
                 heads, len, causal, batch * heads,
                 sq, sk, sv, so, lse};
    return tiled ? launch_tiled<D>(a, s) : dispatch_mma<D>(a, s);
  }
  return cudaErrorInvalidValue;
}

template <int D>
long long smem_bytes(int len, int dtype) {
  if (len > kMaxLen)
    return static_cast<long long>(dtype == 1 ? kSmemTiled<D>
                                             : kSmemF32Tiled<D>);
  return static_cast<long long>(dtype == 1 ? smem_bytes_mma<D>(len)
                                           : smem_bytes_fp32<D>(len));
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16; head_dim 64, 80, 96 or 128. `lse`,
// where not null (bfloat16, L >= hmmc::kStatsMinLen), receives each row's
// log-sum-exp of its scaled logits in log2 units, tiles_len(L) floats per
// (batch, head), rows below L written (K2's tiled pair reads them).
// Returns a cudaError_t as int (cudaErrorInvalidValue for any other
// head_dim, or `lse` in float32 or below that length).
int hmmc_fused_attention_fwd(const void* q, const void* k, const void* v,
                             void* o, int dtype, int batch, int heads,
                             int len, int head_dim, long long q_sb,
                             long long q_sh, long long q_sl, long long k_sb,
                             long long k_sh, long long k_sl, long long v_sb,
                             long long v_sh, long long v_sl, long long o_sb,
                             long long o_sh, long long o_sl, int causal,
                             void* stream, float* lse) {
  if (len < 1 || batch < 1 || heads < 1 ||
      (lse != nullptr && len < hmmc::kStatsMinLen))
    return static_cast<int>(cudaErrorInvalidValue);
  const Strides sq{q_sb, q_sh, q_sl}, sk{k_sb, k_sh, k_sl},
      sv{v_sb, v_sh, v_sl}, so{o_sb, o_sh, o_sl};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (head_dim) {
    case 64:
      return static_cast<int>(run<64>(q, k, v, o, dtype, batch, heads, len,
                                      sq, sk, sv, so, causal, lse, s));
    case 80:
      return static_cast<int>(run<80>(q, k, v, o, dtype, batch, heads, len,
                                      sq, sk, sv, so, causal, lse, s));
    case 96:
      return static_cast<int>(run<96>(q, k, v, o, dtype, batch, heads, len,
                                      sq, sk, sv, so, causal, lse, s));
    case 128:
      return static_cast<int>(run<128>(q, k, v, o, dtype, batch, heads, len,
                                       sq, sk, sv, so, causal, lse, s));
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

// The longest sequence the short (one CTA per head) bodies take at this
// dtype and head_dim (0 for a head_dim not built); longer ones take the
// tiled bodies.
int hmmc_fused_attention_short_max_len(int dtype, int head_dim) {
  (void)dtype;
  return hmmc::is_head_dim(head_dim) ? kMaxLen : 0;
}

// Dynamic shared memory of one CTA (-1 for a head_dim not built).
long long hmmc_fused_attention_smem_bytes(int len, int dtype, int head_dim) {
  switch (head_dim) {
    case 64: return smem_bytes<64>(len, dtype);
    case 80: return smem_bytes<80>(len, dtype);
    case 96: return smem_bytes<96>(len, dtype);
    case 128: return smem_bytes<128>(len, dtype);
    default: return -1;
  }
}

// (batch, head) pairs one CTA takes in this dtype.
int hmmc_fused_attention_heads_per_cta(int dtype) {
  return dtype == 1 ? kHeadsPerCta : 1;
}

const char* hmmc_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
