// Fused attention backward (K2), CUDA C++ for sm_90a, at any L.
//
// Replaces the TPU kernel `_attention_bwd_kernel` launched by
// `_flash_backward` (hmmc_tpu/ops/pallas_attention.py). Same arithmetic, per
// (batch, head):
//   P  = fp32 row softmax((q . k^T) * head_dim^-0.5)   [causal: cols <= rows]
//        (P is NOT rounded to v's dtype here, though the forward rounds it)
//   dV = P^T g                dP = g . v^T
//   dS = P o (dP - rowsum(dP o P)) * head_dim^-0.5
//   dQ = dS . k               dK = dS^T . q
// with fp32 accumulation and dq, dk, dv stored in q's dtype. No [L, L]
// tensor reaches device memory and there are no atomics, so results repeat
// bit for bit. Two bodies, chosen by L: the short one (one CTA owns every
// row of a head) up to the longest L whose staging fits the SM's shared
// memory (short_max_len_bwd: in bf16 128 at D = 64 and 80, 112 at 96 and
// 128; in fp32 112 at 64, 96 at 80 and 96, 80 at 128), and the tiled pair.
// Head_dim D is 64, 80, 96 or 128, each a compile-time instance of every
// body (the entry point picks it and refuses any other); the scale is
// hmmc::Scale<D>::kScale, the plain version's fp32 D ** -0.5.
//
// What bounds it on an H100: q, k, v, g read once and dq, dk, dv written
// once are 7*B*H*L*D elements; the five products are 10*B*H*L*L*D
// operations (causal: only the pairs a query needs); at D = 64 about 36
// per byte at L = 50 and 412 at L = 577, against the card's ~295 bf16
// operations per byte. So the short sites are bound by bytes: in bf16, 0.1232 ms at the
// ViT-B/32 site [768, 12, 50], 0.0044 ms at the fine-tune's text site
// [64, 8, 32, causal] and 0.0016 ms at the temporal site [64, 8, 12]
// (3.35 TB/s); the towers' by bytes at ViT-B/16's [192, 12, 197] (0.1214
// ms) and ViT-L/14's [48, 16, 257] (0.0528), by operations at
// ViT-L/14@336px's [48, 16, 577] (0.1655 ms at 989 TFLOPS). The tiled
// pair below does 1.6x those operations (0.265 ms there at that rate).
//
// bf16, L <= 128: `attention_bwd_mma_kernel`, one CTA of 4 warps per
// (batch, head). 16-byte cp.async copies stage the head's q, k, v and g as
// bf16 [Lp][D] tiles (Lp = L rounded up to 16, rows past L zero-filled),
// swizzled as in attention_mma.cuh. One head's loads overlap the products
// of the other CTAs on the SM: 69,632 bytes at L = 50 fit 3 CTAs, and a
// 2-stage ring inside the CTA, which fits only 2, measured slower. All
// products run on the tensor cores (mma.sync m16n8k16, bf16 in, fp32
// accumulate):
//   phase 1  each warp owns 16 query rows: S = q . k^T and dP = g . v^T
//            (exact in fp32 from bf16 inputs), the full-row fp32 softmax
//            (K1 saves no log-sum-exp; __expf and one reciprocal per row,
//            as in K1), rowsum(dP o P) by quad shuffles and dS, all in
//            registers. P and dS are fp32 there, but the tensor cores take
//            bf16: each is split as x = hi + lo (two bf16, about 16
//            significant bits) and both halves go into every product.
//            dQ = dS . k from the register fragments (k via ldmatrix.trans),
//            stored from the fragments; P and dS (hi and lo) go to shared
//            memory, [Lp][Lp] each with an odd number of 16-byte chunks per
//            row (conflict-free).
//   phase 2  each warp owns 16 key rows: dV = P^T g and dK = dS^T q, the
//            transposed A operands read back with ldmatrix.trans. k and v
//            are not read in this phase, so the warp's own rows of their
//            tiles stage dK and dV for 16-byte row stores.
// Per CTA (ptxas -v on sm_90a): shared memory 4 tiles x Lp x 2D bytes +
// 4 x Lp x (Lp + 8) x 2 bytes of P / dS = 69,632 bytes at D = 64, L = 50,
// 204,800 at L = 128 (at D = 96 and 128 L = 128 would take 237,568 and
// 270,336 bytes: their limit is 112); at D = 64 96 registers at NT = 4,
// 71-164 over NT = 1..8, no spills (the other D: PERF.md).
//
// bf16, L > 128: two kernels over 64-row tiles, one launch each, in stream
// order, on Hopper's warpgroup products (wgmma, attention_wgmma.cuh) with
// TMA staging, no atomics. They take K1's output o and its row statistics
// (lse: each row's log-sum-exp of its scaled logits in log2 units, which
// K1 writes when a gradient will flow here), so P = 2^(S c - lse) (c =
// scale log2 e: one ex2 of an FMA) needs no walk of its own:
//   rows  `attention_bwd_rows_kernel`, a CTA per (two Q tiles, batch *
//         head): one consumer warpgroup per Q tile holds its q and g tiles
//         in shared memory; thread 0 streams the head's (K, V) tile pairs
//         through a 4-stage ring (TMA, mbarriers: a stage is refilled once
//         both warpgroups have released it). Per pair: S = q .
//         k^T and dP = g . v^T (both operands from shared memory), P, the
//         exact D = rowsum(P o dP) summed as it goes, dS~ = P o (dP - D~)
//         scale with the shift D~ = rowsum(g o o), then dQ~ += dS~ . k and
//         Y += P . k with the A operands from registers (the fp32
//         accumulators packed to bf16 in place). At the end dQ = dQ~ -
//         scale (D - D~) Y, and D goes to scratch (tiles_len(L) floats a
//         head) for the keys pass.
//   keys  `attention_bwd_keys_kernel`, a CTA per (two KV tiles, batch *
//         head): one warpgroup per KV tile holds k and v; the ring brings
//         the Q tiles (causal: from the diagonal) with their rows' lse and
//         D. Per tile: S^T = k . q^T, dP^T = v . g^T, P^T and dS^T = P^T o
//         (dP^T - D) scale, dV += P^T g and dK += dS^T q (q and g read
//         MN-major: the descriptor's transpose bit).
// Why the shift: D = rowsum(g o o) alone is not the plain version's fp32
// sum (o was made with P rounded to bf16, and is rounded) and breaks the
// tolerance (1.48x at worst in tests/test_torch_attention_tiled.py's
// emulation), and dQ = scale ((P o dP) k - D P k) in one walk cancels in
// bf16 (1.87x); with the shift dS~ is as small as dS and the correction's
// factor D - D~ is ~1e-3 of D, so one bf16 operand in every product keeps
// all three outputs within 0.81 of it, and no product is split into hi +
// lo. S and dP are computed twice a tile pair and Y is one extra product:
// eight 64 x 64 x D products against the function's five (1.6x its
// operations). Only the tiles that hold a masked pair are masked (the
// causal diagonal, a ragged last tile; rows and queries past L take lse =
// +inf, so P = 0); causal skips the tiles past the diagonal. Head tiles
// are 64 rows of D bf16 in one or two column blocks (64 columns with the
// 128-byte swizzle, then D - 64 with their width's: 80 and 96 without
// padding); the tensor maps are encoded per launch over the strided [B,
// H, L, D] views (cuTensorMapEncodeTiled through the runtime's driver
// entry point; rows past L arrive as zeros). dQ, dK, dV leave through the
// warp's own rows of a tile no one reads any more, as 16-byte row stores.
// Per CTA: 256 threads, two warpgroups and no producer warpgroup (a third
// warpgroup would cap every thread at 168 registers; these take 159-235,
// no spills), 1 KB alignment slack + 4 resident tiles + 4 stages of 2
// tiles (keys: + 1 KB of lse and D a stage) of shared memory: 99,400
// (rows) and 103,496 (keys) bytes at D = 64, 197,704 and 201,800 at
// D = 128. Thread 0 refills the stage of the tile before the one it has
// just finished, which the other warpgroup has most likely left, so it
// seldom waits for it. Each tile's products complete before the next
// tile's S and dP are issued: keeping the register-A products in flight
// across the next tile's barrier wait made ptxas serialise every wgmma of
// the kernel (C7518: a dependence in a divergent path), 1.2x slower. What
// holds each pass at 34-45% of the tensor cores' rate over its padded
// tiles is latency: a warpgroup's products and its exponentials run one
// after the other, and the two warpgroups overlap each other only in part
// (PERF.md).
//
// fp32 (reference checks only): `attention_bwd_fp32_kernel` (L <= 112 at
// D = 64), the CUDA-core body of the first version: q, k, v, g staged as
// fp32, P and dS rows in shared memory, fmaf loops (its staging fits 227 KB
// up to the limit); past it the same pair as bf16's on the CUDA cores,
// `attention_bwd_fp32_rows_kernel` (32-row Q tiles, 8 rows a warp) and
// `attention_bwd_fp32_keys_kernel` (32-key tiles over 64-row Q tiles, IEEE
// expf). Each lane owns dQ / dK / dV columns 2 lane, 2 lane + 1 of every
// 64-column group (at D = 80 lanes 0-7 take the second group's 16). The
// tensor cores would take fp32 only as TF32 (~10 bits), which
// would break the fp32 tolerances (5e-5 against the plain version, 1e-3
// card against CPU), so fp32 stays on the CUDA cores.
//
// Layout: q, k, v, g, dq, dk, dv are [B, H, L, D] with arbitrary batch /
// head / sequence strides and unit stride on the last axis, so the caller
// passes head views of a packed qkv projection and the incoming gradient as
// it arrives, without copies; every pointer and stride must be 16-byte
// aligned (the wrapper checks). The kernels launch on the caller's
// stream, allocate nothing, and the entry point returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "attention_mma.cuh"
#include "attention_wgmma.cuh"

namespace {

using hmmc::kColGroups;
using hmmc::owns_cols;
using hmmc::Row;
using hmmc::Scale;
using hmmc::Strides;

constexpr int kMaxLen = 128;   // the short bodies' longest L, where the
                               // staging fits (short_max_len_bwd)
constexpr int kWarpsBwd = 4;           // warps of a bf16 CTA

struct Args {
  const void *q, *k, *v, *g;
  void *dq, *dk, *dv;
  int heads, len, causal;
  Strides sq, sk, sv, sg, sdq, sdk, sdv;
};

// What the bf16 tiled pair takes from K1: its output o (strides so) and
// its statistics lse
struct TiledIn {
  const void* o;
  const float* lse;
  Strides so;
};

// ---------------------------------------------------------------------------
// bf16: tensor cores
// ---------------------------------------------------------------------------

__host__ __device__ constexpr int p_stride(int nt) {   // bytes
  return (2 * nt + 1) * 16;
}

template <int D>
constexpr size_t smem_bytes_mma(int len) {
  const size_t lp = static_cast<size_t>((len + 15) & ~15);
  return 4 * lp * Row<D>::kBytes +
         4 * lp * p_stride(static_cast<int>(lp / 16));
}

// ldmatrix.trans lane address of the A fragment of a transposed [Lp][Lp]
// matrix (P^T or dS^T): rows (keys) 16jt.., k-step over queries 16it..
__device__ __forceinline__ uint32_t at_addr(uint32_t mat, int stride, int it,
                                            int jt, int lane) {
  return mat + (16 * it + (lane & 7) + ((lane >> 4) << 3)) * stride +
         (2 * jt + ((lane >> 3) & 1)) * 16;
}

// NT = Lp / 16 row (and key) tiles of 16.
template <int D, int NT>
__global__ void __launch_bounds__(kWarpsBwd * 32)
attention_bwd_mma_kernel(Args a) {
  using bf16 = __nv_bfloat16;
  constexpr int kLp = 16 * NT;
  constexpr int kTile = kLp * Row<D>::kBytes;
  constexpr int kNT = Row<D>::kNTiles, kKS = Row<D>::kKSteps;
  constexpr float kScale = Scale<D>::kScale;
  constexpr int kStage = 4 * kTile;            // q, k, v, g
  constexpr int kPS = p_stride(NT);
  constexpr int kMat = kLp * kPS;
  extern __shared__ uint4 smem_raw[];
  char* smem = reinterpret_cast<char*>(smem_raw);
  const uint32_t smem_base = hmmc::smem_u32(smem);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int len = a.len;
  // P hi, P lo, dS hi, dS lo after the four tiles
  char* s_mats = smem + kStage;
  const uint32_t t_phi = smem_base + kStage;
  const uint32_t t_plo = t_phi + kMat, t_dhi = t_plo + kMat,
                 t_dlo = t_dhi + kMat;

  const int b = blockIdx.x / a.heads, hh = blockIdx.x - b * a.heads;
  const bf16* src[4] = {
      static_cast<const bf16*>(a.q) + b * a.sq.b + hh * a.sq.h,
      static_cast<const bf16*>(a.k) + b * a.sk.b + hh * a.sk.h,
      static_cast<const bf16*>(a.v) + b * a.sv.b + hh * a.sv.h,
      static_cast<const bf16*>(a.g) + b * a.sg.b + hh * a.sg.h};
  const long long row_stride[4] = {a.sq.l, a.sk.l, a.sv.l, a.sg.l};
  hmmc::stage_head<D, 4>(smem_base, kTile, src, row_stride, len);
  hmmc::cp_async_commit();
  hmmc::zero_pad_rows<D>(smem, 4, kTile, len, kLp);
  hmmc::cp_async_wait<0>();
  __syncthreads();

  const uint32_t tq = smem_base;
  const uint32_t tk = tq + kTile, tv = tk + kTile, tg = tv + kTile;
  bf16* dqb = static_cast<bf16*>(a.dq) + b * a.sdq.b + hh * a.sdq.h;
  bf16* dkb = static_cast<bf16*>(a.dk) + b * a.sdk.b + hh * a.sdk.h;
  bf16* dvb = static_cast<bf16*>(a.dv) + b * a.sdv.b + hh * a.sdv.h;

  // ---- phase 1: query rows -> P, dS (shared memory) and dQ -------------
  for (int mt = warp; mt < NT; mt += kWarpsBwd) {
    float s[2 * NT][4], dp[2 * NT][4];
#pragma unroll
    for (int n = 0; n < 2 * NT; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[n][e] = dp[n][e] = 0.f;
#pragma unroll
    for (int ks = 0; ks < kKS; ++ks) {
      uint32_t qa[4], ga[4];
      hmmc::ldsm_x4(hmmc::a_addr<D>(tq, 16 * mt, ks, lane), qa);
      hmmc::ldsm_x4(hmmc::a_addr<D>(tg, 16 * mt, ks, lane), ga);
#pragma unroll
      for (int np = 0; np < NT; ++np) {
        if (a.causal && np > mt) continue;   // keys all after the rows
        uint32_t kb[4], vb[4];
        hmmc::ldsm_x4(hmmc::b_addr<D>(tk, 16 * np, ks, lane), kb);
        hmmc::mma_bf16(s[2 * np], qa, kb[0], kb[1]);
        hmmc::mma_bf16(s[2 * np + 1], qa, kb[2], kb[3]);
        hmmc::ldsm_x4(hmmc::b_addr<D>(tv, 16 * np, ks, lane), vb);
        hmmc::mma_bf16(dp[2 * np], ga, vb[0], vb[1]);
        hmmc::mma_bf16(dp[2 * np + 1], ga, vb[2], vb[3]);
      }
    }

    // fp32 softmax of rows r and r + 8; masked and padded keys, and
    // padded rows, get P = 0 and so dS = 0
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
    const float inv0 = 1.f / hmmc::quad_sum(sum0);
    const float inv1 = 1.f / hmmc::quad_sum(sum1);
    const bool row0 = r < len, row1 = r + 8 < len;
    float dot0 = 0.f, dot1 = 0.f;
#pragma unroll
    for (int n = 0; n < 2 * NT; ++n)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        s[n][e] = row0 ? s[n][e] * inv0 : 0.f;
        s[n][2 + e] = row1 ? s[n][2 + e] * inv1 : 0.f;
        dot0 = fmaf(dp[n][e], s[n][e], dot0);
        dot1 = fmaf(dp[n][2 + e], s[n][2 + e], dot1);
      }
    dot0 = hmmc::quad_sum(dot0);
    dot1 = hmmc::quad_sum(dot1);
#pragma unroll
    for (int n = 0; n < 2 * NT; ++n)
#pragma unroll
      for (int e = 0; e < 2; ++e) {   // dP becomes dS in place
        dp[n][e] = s[n][e] * (dp[n][e] - dot0) * kScale;
        dp[n][2 + e] = s[n][2 + e] * (dp[n][2 + e] - dot1) * kScale;
      }

    // P and dS, split into hi and lo, to shared memory (rows r, r + 8)
#pragma unroll
    for (int n = 0; n < 2 * NT; ++n) {
      if (a.causal && n / 2 > mt) continue;   // never read
      const int off0 = r * kPS + n * 16 + (lane & 3) * 4;
      const int off1 = off0 + 8 * kPS;
      uint32_t hi, lo;
      hmmc::split_bf16(s[n][0], s[n][1], hi, lo);
      *reinterpret_cast<uint32_t*>(s_mats + off0) = hi;
      *reinterpret_cast<uint32_t*>(s_mats + kMat + off0) = lo;
      hmmc::split_bf16(s[n][2], s[n][3], hi, lo);
      *reinterpret_cast<uint32_t*>(s_mats + off1) = hi;
      *reinterpret_cast<uint32_t*>(s_mats + kMat + off1) = lo;
      hmmc::split_bf16(dp[n][0], dp[n][1], hi, lo);
      *reinterpret_cast<uint32_t*>(s_mats + 2 * kMat + off0) = hi;
      *reinterpret_cast<uint32_t*>(s_mats + 3 * kMat + off0) = lo;
      hmmc::split_bf16(dp[n][2], dp[n][3], hi, lo);
      *reinterpret_cast<uint32_t*>(s_mats + 2 * kMat + off1) = hi;
      *reinterpret_cast<uint32_t*>(s_mats + 3 * kMat + off1) = lo;
    }

    // dQ = dS . k: the dS fragments of key tiles 2j, 2j + 1 are the A
    // operand of k-step j
    float acc[kNT][4];
#pragma unroll
    for (int n = 0; n < kNT; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      if (a.causal && j > mt) continue;   // dS = 0 there
      uint32_t hi[4], lo[4];
      hmmc::split_bf16(dp[2 * j][0], dp[2 * j][1], hi[0], lo[0]);
      hmmc::split_bf16(dp[2 * j][2], dp[2 * j][3], hi[1], lo[1]);
      hmmc::split_bf16(dp[2 * j + 1][0], dp[2 * j + 1][1], hi[2], lo[2]);
      hmmc::split_bf16(dp[2 * j + 1][2], dp[2 * j + 1][3], hi[3], lo[3]);
#pragma unroll
      for (int c = 0; c < kKS; ++c) {
        uint32_t kb[4];
        hmmc::ldsm_x4_t(hmmc::bt_addr<D>(tk, 16 * j, c, lane), kb);
        hmmc::mma_bf16(acc[2 * c], hi, kb[0], kb[1]);
        hmmc::mma_bf16(acc[2 * c], lo, kb[0], kb[1]);
        hmmc::mma_bf16(acc[2 * c + 1], hi, kb[2], kb[3]);
        hmmc::mma_bf16(acc[2 * c + 1], lo, kb[2], kb[3]);
      }
    }
    // k and v are still read by the other warps: dQ leaves straight
    // from the fragments, 4 bytes a lane
#pragma unroll
    for (int n = 0; n < kNT; ++n) {
      bf16* out = dqb + r * a.sdq.l + 8 * n + 2 * (lane & 3);
      if (row0)
        *reinterpret_cast<uint32_t*>(out) = hmmc::pack_bf16(acc[n][0],
                                                            acc[n][1]);
      if (row1)
        *reinterpret_cast<uint32_t*>(out + 8 * a.sdq.l) =
            hmmc::pack_bf16(acc[n][2], acc[n][3]);
    }
  }
  __syncthreads();

  // ---- phase 2: key rows -> dV = P^T g, dK = dS^T q --------------------
  for (int jt = warp; jt < NT; jt += kWarpsBwd) {
    float dv[kNT][4], dk[kNT][4];
#pragma unroll
    for (int n = 0; n < kNT; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) dv[n][e] = dk[n][e] = 0.f;
    // causal: P = dS = 0 for query tiles before jt
    for (int qt = a.causal ? jt : 0; qt < NT; ++qt) {
      uint32_t hi[4], lo[4];
      hmmc::ldsm_x4_t(at_addr(t_phi, kPS, qt, jt, lane), hi);
      hmmc::ldsm_x4_t(at_addr(t_plo, kPS, qt, jt, lane), lo);
#pragma unroll
      for (int c = 0; c < kKS; ++c) {
        uint32_t gb[4];
        hmmc::ldsm_x4_t(hmmc::bt_addr<D>(tg, 16 * qt, c, lane), gb);
        hmmc::mma_bf16(dv[2 * c], hi, gb[0], gb[1]);
        hmmc::mma_bf16(dv[2 * c], lo, gb[0], gb[1]);
        hmmc::mma_bf16(dv[2 * c + 1], hi, gb[2], gb[3]);
        hmmc::mma_bf16(dv[2 * c + 1], lo, gb[2], gb[3]);
      }
      hmmc::ldsm_x4_t(at_addr(t_dhi, kPS, qt, jt, lane), hi);
      hmmc::ldsm_x4_t(at_addr(t_dlo, kPS, qt, jt, lane), lo);
#pragma unroll
      for (int c = 0; c < kKS; ++c) {
        uint32_t qb[4];
        hmmc::ldsm_x4_t(hmmc::bt_addr<D>(tq, 16 * qt, c, lane), qb);
        hmmc::mma_bf16(dk[2 * c], hi, qb[0], qb[1]);
        hmmc::mma_bf16(dk[2 * c], lo, qb[0], qb[1]);
        hmmc::mma_bf16(dk[2 * c + 1], hi, qb[2], qb[3]);
        hmmc::mma_bf16(dk[2 * c + 1], lo, qb[2], qb[3]);
      }
    }
    // k and v are not read in this phase: the warp's own rows of their
    // tiles stage dK and dV
    char* s_k = smem + kTile;
    char* s_v = s_k + kTile;
    hmmc::frags_to_tile<D>(s_v, 16 * jt, dv, len, lane);
    hmmc::frags_to_tile<D>(s_k, 16 * jt, dk, len, lane);
    __syncwarp();
    hmmc::tile_rows_to_global<D>(s_v, 16 * jt, dvb, a.sdv.l, len, lane);
    hmmc::tile_rows_to_global<D>(s_k, 16 * jt, dkb, a.sdk.l, len, lane);
  }
}

template <int D, int NT>
cudaError_t launch_mma(const Args& a, int batch, cudaStream_t stream) {
  static unsigned allowed = 0;
  auto kernel = attention_bwd_mma_kernel<D, NT>;
  const size_t smem = smem_bytes_mma<D>(a.len);
  const cudaError_t err = hmmc::allow_smem(kernel, smem, &allowed);
  if (err != cudaSuccess) return err;
  kernel<<<batch * a.heads, kWarpsBwd * 32, smem, stream>>>(a);
  return cudaGetLastError();
}

// fp32 staging of one short CTA: q, g, k, v (padded rows), P, dS
template <int D>
constexpr size_t smem_bytes_fp32(int len);

// The short body's longest L at (dtype, D): the longest multiple of 16 up
// to kMaxLen whose staging fits the SM's shared memory.
template <int D>
constexpr int short_max_len_bwd(int dtype) {
  int l = kMaxLen;
  while (l > 0 && (dtype == 1 ? smem_bytes_mma<D>(l) : smem_bytes_fp32<D>(l))
                      > hmmc::kMaxSmem)
    l -= 16;
  return l;
}

// the instance of NT = ceil(L / 16) tiles, L <= short_max_len_bwd<D>(1)
template <int D, int NT = 1>
cudaError_t dispatch_mma(const Args& a, int batch, cudaStream_t stream) {
  if constexpr (16 * NT < short_max_len_bwd<D>(1)) {
    if (a.len > 16 * NT) return dispatch_mma<D, NT + 1>(a, batch, stream);
  }
  return launch_mma<D, NT>(a, batch, stream);
}

// ---------------------------------------------------------------------------
// bf16, L > 128: two passes over 64-row tiles on wgmma, no atomics
// ---------------------------------------------------------------------------

using hmmc::kTileRows;
using hmmc::tiles_len;
using hmmc::TmaTile;

// Scratch the fp32 tiled pair needs per (batch, head): three planes of
// tiles_len(L) floats, the row max m of the unscaled logits, 1 / the row
// sum and D = rowsum(dP o P), written by its rows pass (zeros past L).
__host__ __device__ inline long long stats_floats(int len) {
  return 3LL * tiles_len(len);
}

constexpr int kWG = 2;        // consumer warpgroups a CTA, one 64-row tile each
constexpr int kStages = 4;    // depth of the ring of streamed tiles
// Two warpgroups and no more: registers are handed out by whole
// warpgroups, so a third (a producer) would cap every thread at 168
// registers (65,536 / 384), where one of these needs up to 235 (keys, D =
// 128). Thread 0 issues the copies itself (TMA costs it a few instructions
// a tile).
constexpr int kThreadsTiled = kWG * 128;

struct TiledParams {
  hmmc::TileMaps q, k, v, g;   // TMA maps over the [B, H, L, D] views
  const __nv_bfloat16* o;      // K1's output, for the shift of D (rows pass)
  const float* lse;            // K1's log2-sum-exp, tiles_len(L) a head
  float* delta;                // D = rowsum(dP o P), tiles_len(L) a head
  __nv_bfloat16 *dq, *dk, *dv;
  Strides so, sdq, sdk, sdv;
  int heads, len, causal;
};

// The shared memory of a tiled CTA: 1 KB of slack to align the tiles on
// 1024 bytes (the swizzle's period), the resident tiles (two a warpgroup),
// the ring of streamed stages, and the mbarriers.
template <int D>
constexpr int kResident = 2 * kWG * TmaTile<D>::kBytes;
template <int D>
constexpr int kStageRows = 2 * TmaTile<D>::kBytes;          // k, v
template <int D>   // q, g, then lse and D of the tile's rows (512 bytes,
constexpr int kStageKeys = 2 * TmaTile<D>::kBytes + 1024;   // padded)
constexpr int kBarBytes = 8 * (1 + 2 * kStages);
template <int D>
constexpr size_t kSmemRows = 1024 + kResident<D> + kStages * kStageRows<D> +
                             kBarBytes;
template <int D>
constexpr size_t kSmemKeys = 1024 + kResident<D> + kStages * kStageKeys<D> +
                             kBarBytes;

// fp32 dot product of eight bf16 pairs (two 16-byte chunks)
__device__ __forceinline__ float dot8(uint4 a, uint4 b, float acc) {
  const __nv_bfloat162* x = reinterpret_cast<const __nv_bfloat162*>(&a);
  const __nv_bfloat162* y = reinterpret_cast<const __nv_bfloat162*>(&b);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 xf = __bfloat1622float2(x[i]), yf = __bfloat1622float2(y[i]);
    acc = fmaf(xf.x, yf.x, acc);
    acc = fmaf(xf.y, yf.y, acc);
  }
  return acc;
}

// The CTA's mbarriers: full_a (the resident tiles), then full and empty
// per stage; thread 0 initialises them.
struct Ring {
  uint32_t full_a, full0, empty0;
  __device__ Ring(uint32_t bars)
      : full_a(bars), full0(bars + 8), empty0(bars + 8 + 8 * kStages) {}
  __device__ uint32_t full(int s) const { return full0 + 8 * s; }
  __device__ uint32_t empty(int s) const { return empty0 + 8 * s; }
  __device__ void init() const {
    hmmc::mbar_init(full_a, 1);
    for (int s = 0; s < kStages; ++s) {
      hmmc::mbar_init(full(s), 1);
      hmmc::mbar_init(empty(s), kWG * 128);
    }
    hmmc::mbar_init_fence();
  }
};

// The tiles' base in shared memory, aligned on 1024 bytes: its shared
// address and its generic pointer
struct SmemBase {
  uint32_t addr;
  char* ptr;
};
__device__ __forceinline__ SmemBase aligned_smem(void* raw) {
  const uint32_t a = hmmc::smem_u32(raw);
  const uint32_t aligned = (a + 1023) & ~1023u;
  return {aligned, static_cast<char*>(raw) + (aligned - a)};
}

// A warp's rows of the 64 x D fp32 product `acc` (the wgmma fragment
// layout, which is mma.sync's per warp), rounded to bf16, to rows
// 16 w..16 w + 15 of a tile (those below `rows`) through that warp's rows
// of the shared tile `stage`, which no one reads any more
template <int D>
__device__ __forceinline__ void store_rows(char* stage, const float* acc,
                                           int wwarp, __nv_bfloat16* dst,
                                           long long row_stride, int rows,
                                           int lane) {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  const auto& frags =
      *reinterpret_cast<const float(*)[Row<D>::kNTiles][4]>(acc);
  hmmc::frags_to_tile<D>(stage, 16 * wwarp, frags, rows, lane);
  __syncwarp();
  hmmc::tile_rows_to_global<D>(stage, 16 * wwarp, dst, row_stride, rows,
                               lane);
}

// A warpgroup of the rows pass: warpgroup wg, its warp wwarp owns rows
// r0 and r0 + 8 of Q tile kWG * blockIdx.y + wg. release(t): the
// warpgroup is done with KV tile t (its stage may be refilled).
template <int D, typename Release>
__device__ __forceinline__ void rows_consumer(const TiledParams& p,
                                              const SmemBase& sm,
                                              const Ring& ring,
                                              Release release) {
  using T = TmaTile<D>;
  constexpr int kTile = T::kBytes;
  constexpr int kAcc = D / 2;   // fp32 accumulators a thread of a D product
  constexpr float kScale = Scale<D>::kScale, kLog2 = Scale<D>::kLog2;
  const int len = p.len, head = blockIdx.x;
  const int b = head / p.heads, hh = head - b * p.heads;
  const int n_q = (len + kTileRows - 1) / kTileRows;
  const int qt0 = kWG * blockIdx.y;
  const int n_act = min(kWG, n_q - qt0);
  const int n_it = p.causal ? min(n_q, qt0 + kWG) : n_q;
  const int lp = tiles_len(len);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int wg = warp / 4, wwarp = warp % 4;
  const int qt = qt0 + wg;
  const bool active = wg < n_act;
  const uint32_t tq = sm.addr + 2 * wg * kTile, tg = tq + kTile;
  const int r0 = 16 * wwarp + lane / 4;
  const int i0 = qt * kTileRows + r0, i1 = i0 + 8;
  // K1's statistics; rows past L get +inf, so P = 0 on them
  float lse0 = INFINITY, lse1 = INFINITY;
  const float* lse_h = p.lse + static_cast<long long>(head) * lp;
  if (active && i0 < len) lse0 = lse_h[i0];
  if (active && i1 < len) lse1 = lse_h[i1];
  // D~ = rowsum(g o o) of rows i0, i1, over the quad: lane l % 4 takes
  // the 16-byte chunks c = l % 4 + 4 t; its o chunks are loaded before the
  // wait for the resident tiles, so their latency overlaps the copies
  constexpr int kChunks = D / 8, kMine = (kChunks + 3) / 4;
  uint4 o0[kMine], o1[kMine];
  const __nv_bfloat16* ob = p.o + b * p.so.b + hh * p.so.h;
#pragma unroll
  for (int t = 0; t < kMine; ++t) {
    const int cc = 4 * t + (lane & 3);
    const bool in = active && cc < kChunks;
    o0[t] = in && i0 < len
                ? *reinterpret_cast<const uint4*>(ob + i0 * p.so.l + 8 * cc)
                : make_uint4(0, 0, 0, 0);
    o1[t] = in && i1 < len
                ? *reinterpret_cast<const uint4*>(ob + i1 * p.so.l + 8 * cc)
                : make_uint4(0, 0, 0, 0);
  }
  hmmc::mbar_wait(ring.full_a, 0);
  float dt0 = 0.f, dt1 = 0.f;
  if (active) {
    const char* sg = sm.ptr + 2 * wg * kTile + kTile;
#pragma unroll
    for (int t = 0; t < kMine; ++t) {
      const int cc = 4 * t + (lane & 3);
      if (cc < kChunks) {
        dt0 = dot8(*reinterpret_cast<const uint4*>(
                       sg + hmmc::tma_chunk_off<D>(r0, cc)), o0[t], dt0);
        dt1 = dot8(*reinterpret_cast<const uint4*>(
                       sg + hmmc::tma_chunk_off<D>(r0 + 8, cc)), o1[t], dt1);
      }
    }
    dt0 = hmmc::quad_sum(dt0);
    dt1 = hmmc::quad_sum(dt1);
  }

  float dq[kAcc], y[kAcc];
#pragma unroll
  for (int i = 0; i < kAcc; ++i) dq[i] = y[i] = 0.f;
  float dsum0 = 0.f, dsum1 = 0.f;   // this lane's part of D
  for (int it = 0; it < n_it; ++it) {
    const int s = it % kStages;
    hmmc::mbar_wait(ring.full(s), (it / kStages) & 1);
    if (!active || (p.causal && it > qt)) {
      release(it);
      continue;
    }
    const uint32_t tk = sm.addr + kResident<D> + s * kStageRows<D>;
    const uint32_t tv = tk + kTile;
    float sc[32], dp[32];
    hmmc::wgmma_fence();
    hmmc::wgmma_ss_tiles<D>(sc, tq, tk);
    hmmc::wgmma_ss_tiles<D>(dp, tg, tv);
    hmmc::wgmma_commit();
    hmmc::wgmma_wait<0>();
    hmmc::fence_regs<32>(sc);
    hmmc::fence_regs<32>(dp);
    // masked pairs only on the tiles that hold any: the causal diagonal
    // and the last tile of a ragged L
    const int k0 = it * kTileRows;
    const bool edge = (p.causal && it == qt) || k0 + kTileRows > len;
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        float p0 = hmmc::ex2(fmaf(sc[4 * n + e], kLog2, -lse0));
        float p1 = hmmc::ex2(fmaf(sc[4 * n + 2 + e], kLog2, -lse1));
        if (edge) {
          const int j = k0 + 8 * n + 2 * (lane & 3) + e;
          if (j >= len || (p.causal && j > i0)) p0 = 0.f;
          if (j >= len || (p.causal && j > i1)) p1 = 0.f;
        }
        const float d0 = dp[4 * n + e], d1 = dp[4 * n + 2 + e];
        dsum0 = fmaf(p0, d0, dsum0);
        dsum1 = fmaf(p1, d1, dsum1);
        sc[4 * n + e] = p0;
        sc[4 * n + 2 + e] = p1;
        dp[4 * n + e] = p0 * (d0 - dt0) * kScale;
        dp[4 * n + 2 + e] = p1 * (d1 - dt1) * kScale;
      }
    uint32_t pa[4][4], da[4][4];   // P and dS as bf16 A operands
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      hmmc::a_frag(sc, kk, pa[kk]);
      hmmc::a_frag(dp, kk, da[kk]);
    }
    hmmc::fence_regs<kAcc>(dq);
    hmmc::fence_regs<kAcc>(y);
    hmmc::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      hmmc::wgmma_rs_tile<D>(dq, da[kk], tk, kk);
      hmmc::wgmma_rs_tile<D>(y, pa[kk], tk, kk);
    }
    hmmc::wgmma_commit();
    hmmc::wgmma_wait<0>();
    hmmc::fence_regs<kAcc>(dq);
    hmmc::fence_regs<kAcc>(y);
    hmmc::fence_frags(pa);
    hmmc::fence_frags(da);
    release(it);
  }
  if (!active) return;

  // D of rows i0, i1 for the keys pass (zeros on rows past L), and
  // dQ = dQ~ - scale (D - D~) Y
  const float dd0 = hmmc::quad_sum(dsum0), dd1 = hmmc::quad_sum(dsum1);
  if ((lane & 3) == 0) {
    float* dh = p.delta + static_cast<long long>(head) * lp;
    dh[i0] = dd0;
    dh[i1] = dd1;
  }
  const float c0 = kScale * (dd0 - dt0), c1 = kScale * (dd1 - dt1);
#pragma unroll
  for (int n = 0; n < D / 8; ++n) {
    dq[4 * n] -= c0 * y[4 * n];
    dq[4 * n + 1] -= c0 * y[4 * n + 1];
    dq[4 * n + 2] -= c1 * y[4 * n + 2];
    dq[4 * n + 3] -= c1 * y[4 * n + 3];
  }
  const int q0 = qt * kTileRows;
  store_rows<D>(sm.ptr + 2 * wg * kTile, dq, wwarp,
                p.dq + b * p.sdq.b + hh * p.sdq.h + q0 * p.sdq.l, p.sdq.l,
                len - q0, lane);
}

// Rows pass: CTA (kWG consecutive Q tiles, batch * head). Warpgroup w owns
// Q tile kWG * blockIdx.y + w: its q and g tiles stay in shared memory
// while thread 0 streams the head's (K, V) tile pairs through the ring
// (causal: up to the CTA's last diagonal). Per KV tile, in fp32:
//   S = q . k^T, dP = g . v^T          (wgmma, both operands in smem)
//   P = 2^(S c - lse)                  (c = scale log2 e; K1's statistics)
//   D += rowsum(P o dP)                (exact, for the keys pass)
//   dS~ = P o (dP - D~) scale          (D~ = rowsum(g o o), K1's output)
//   dQ~ += dS~ . k,  Y += P . k        (wgmma, A from registers, bf16)
// and at the end dQ = dQ~ - scale (D - D~) Y. D~ is within ~1e-3 of D,
// so dS~ is as small as dS and one bf16 operand keeps dQ in tolerance;
// the correction's factor is that small difference.
template <int D>
__global__ void __launch_bounds__(kThreadsTiled, 1)
attention_bwd_rows_kernel(const __grid_constant__ TiledParams p) {
  constexpr int kTile = TmaTile<D>::kBytes;
  extern __shared__ uint4 smem_raw[];
  const SmemBase sm = aligned_smem(smem_raw);
  const Ring ring(sm.addr + kResident<D> + kStages * kStageRows<D>);
  const int b = blockIdx.x / p.heads, hh = blockIdx.x - b * p.heads;
  const int n_q = (p.len + kTileRows - 1) / kTileRows;
  const int qt0 = kWG * blockIdx.y;
  const int n_act = min(kWG, n_q - qt0);   // warpgroups with a tile
  const int n_it = p.causal ? min(n_q, qt0 + kWG) : n_q;
  // thread 0 issues every copy: the resident tiles and the first stages
  // here, each later KV tile once both warpgroups have released its stage
  const bool issuer = threadIdx.x == 0;
  auto load = [&](int t) {
    const int s = t % kStages;
    const uint32_t st = sm.addr + kResident<D> + s * kStageRows<D>;
    hmmc::mbar_expect_tx(ring.full(s), kStageRows<D>);
    hmmc::tma_tile<D>(st, p.k, ring.full(s), t * kTileRows, hh, b);
    hmmc::tma_tile<D>(st + kTile, p.v, ring.full(s), t * kTileRows, hh, b);
  };
  if (issuer) {
    ring.init();
    hmmc::mbar_expect_tx(ring.full_a, 2 * kTile * n_act);
    for (int w = 0; w < n_act; ++w) {
      const uint32_t t = sm.addr + 2 * w * kTile;
      hmmc::tma_tile<D>(t, p.q, ring.full_a, (qt0 + w) * kTileRows, hh, b);
      hmmc::tma_tile<D>(t + kTile, p.g, ring.full_a, (qt0 + w) * kTileRows,
                        hh, b);
    }
    for (int t = 0; t < min(kStages, n_it); ++t) load(t);
  }
  __syncthreads();
  rows_consumer<D>(p, sm, ring, [&](int t) {
    hmmc::mbar_arrive(ring.empty(t % kStages));
    const int r = t - 1;   // the tile before: the other warpgroup has
    if (issuer && r >= 0 && r + kStages < n_it) {   // most likely left it
      hmmc::mbar_wait(ring.empty(r % kStages), (r / kStages) & 1);
      load(r + kStages);
    }
  });
}

// A warpgroup of the keys pass: warpgroup wg, its warp wwarp owns keys
// j0 and j0 + 8 of KV tile kWG * blockIdx.y + wg. release(it): the
// warpgroup is done with the walk's it-th Q tile.
template <int D, typename Release>
__device__ __forceinline__ void keys_consumer(const TiledParams& p,
                                              const SmemBase& sm,
                                              const Ring& ring,
                                              Release release) {
  using T = TmaTile<D>;
  constexpr int kTile = T::kBytes;
  constexpr int kAcc = D / 2;
  constexpr float kScale = Scale<D>::kScale, kLog2 = Scale<D>::kLog2;
  const int len = p.len, head = blockIdx.x;
  const int b = head / p.heads, hh = head - b * p.heads;
  const int n_t = (len + kTileRows - 1) / kTileRows;
  const int kt0 = kWG * blockIdx.y;
  const int n_act = min(kWG, n_t - kt0);
  const int first = p.causal ? kt0 : 0;
  const int n_it = n_t - first;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int wg = warp / 4, wwarp = warp % 4;
  const int kt = kt0 + wg;
  const bool active = wg < n_act;
  const uint32_t tk = sm.addr + 2 * wg * kTile, tv = tk + kTile;
  const int j0 = kt * kTileRows + 16 * wwarp + lane / 4, j1 = j0 + 8;
  float dk[kAcc], dv[kAcc];
#pragma unroll
  for (int i = 0; i < kAcc; ++i) dk[i] = dv[i] = 0.f;
  hmmc::mbar_wait(ring.full_a, 0);
  for (int it = 0; it < n_it; ++it) {
    const int s = it % kStages, qt = first + it;
    hmmc::mbar_wait(ring.full(s), (it / kStages) & 1);
    if (!active || (p.causal && qt < kt)) {
      release(it);
      continue;
    }
    const uint32_t tq = sm.addr + kResident<D> + s * kStageKeys<D>;
    const uint32_t tg = tq + kTile;
    float sc[32], dp[32];   // S^T, dP^T: rows keys, columns queries
    hmmc::wgmma_fence();
    hmmc::wgmma_ss_tiles<D>(sc, tk, tq);
    hmmc::wgmma_ss_tiles<D>(dp, tv, tg);
    hmmc::wgmma_commit();
    hmmc::wgmma_wait<0>();
    hmmc::fence_regs<32>(sc);
    hmmc::fence_regs<32>(dp);
    const float* st = reinterpret_cast<const float*>(
        sm.ptr + kResident<D> + s * kStageKeys<D> + 2 * kTile);
    const bool diag = p.causal && qt == kt;
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int il = 8 * n + 2 * (lane & 3) + e, i = qt * kTileRows + il;
        // queries past L get lse = +inf (their slots hold no statistics)
        const float lse = i < len ? st[il] : INFINITY, d = st[64 + il];
        float p0 = hmmc::ex2(fmaf(sc[4 * n + e], kLog2, -lse));
        float p1 = hmmc::ex2(fmaf(sc[4 * n + 2 + e], kLog2, -lse));
        if (diag) {
          if (j0 > i) p0 = 0.f;
          if (j1 > i) p1 = 0.f;
        }
        dp[4 * n + e] = p0 * (dp[4 * n + e] - d) * kScale;
        dp[4 * n + 2 + e] = p1 * (dp[4 * n + 2 + e] - d) * kScale;
        sc[4 * n + e] = p0;
        sc[4 * n + 2 + e] = p1;
      }
    uint32_t pa[4][4], da[4][4];   // P and dS as bf16 A operands
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      hmmc::a_frag(sc, kk, pa[kk]);
      hmmc::a_frag(dp, kk, da[kk]);
    }
    hmmc::fence_regs<kAcc>(dv);
    hmmc::fence_regs<kAcc>(dk);
    hmmc::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      hmmc::wgmma_rs_tile<D>(dv, pa[kk], tg, kk);
      hmmc::wgmma_rs_tile<D>(dk, da[kk], tq, kk);
    }
    hmmc::wgmma_commit();
    hmmc::wgmma_wait<0>();
    hmmc::fence_regs<kAcc>(dv);
    hmmc::fence_regs<kAcc>(dk);
    hmmc::fence_frags(pa);
    hmmc::fence_frags(da);
    release(it);
  }
  if (!active) return;
  const int k0 = kt * kTileRows;
  store_rows<D>(sm.ptr + 2 * wg * kTile, dk, wwarp,
                p.dk + b * p.sdk.b + hh * p.sdk.h + k0 * p.sdk.l, p.sdk.l,
                len - k0, lane);
  store_rows<D>(sm.ptr + 2 * wg * kTile + kTile, dv, wwarp,
                p.dv + b * p.sdv.b + hh * p.sdv.h + k0 * p.sdv.l, p.sdv.l,
                len - k0, lane);
}

// Keys pass: CTA (kWG consecutive KV tiles, batch * head). Warpgroup w
// owns KV tile kWG * blockIdx.y + w: its k and v tiles stay in shared
// memory while thread 0 streams the Q tiles (causal: from the CTA's first
// diagonal) with their rows' lse and D. Per Q tile, in fp32:
//   S^T = k . q^T, dP^T = v . g^T      (wgmma, both operands in smem)
//   P^T = 2^(S^T c - lse)  dS^T = P^T o (dP^T - D) scale
//   dV += P^T g,  dK += dS^T q         (wgmma, A from registers, bf16)
template <int D>
__global__ void __launch_bounds__(kThreadsTiled, 1)
attention_bwd_keys_kernel(const __grid_constant__ TiledParams p) {
  constexpr int kTile = TmaTile<D>::kBytes;
  extern __shared__ uint4 smem_raw[];
  const SmemBase sm = aligned_smem(smem_raw);
  const Ring ring(sm.addr + kResident<D> + kStages * kStageKeys<D>);
  const int head = blockIdx.x, b = head / p.heads, hh = head - b * p.heads;
  const int n_t = (p.len + kTileRows - 1) / kTileRows;   // Q and KV tiles
  const int kt0 = kWG * blockIdx.y;
  const int n_act = min(kWG, n_t - kt0);
  const int first = p.causal ? kt0 : 0;   // no query before the CTA's keys
  const int n_it = n_t - first;
  const long long hoff = static_cast<long long>(head) * tiles_len(p.len);
  // thread 0 issues every copy, as in the rows pass
  const bool issuer = threadIdx.x == 0;
  auto load = [&](int it) {   // the walk's it-th Q tile, its lse and D
    const int s = it % kStages, q0 = (first + it) * kTileRows;
    const uint32_t st = sm.addr + kResident<D> + s * kStageKeys<D>;
    hmmc::mbar_expect_tx(ring.full(s), 2 * kTile + 512);
    hmmc::tma_tile<D>(st, p.q, ring.full(s), q0, hh, b);
    hmmc::tma_tile<D>(st + kTile, p.g, ring.full(s), q0, hh, b);
    hmmc::bulk_load(st + 2 * kTile, p.lse + hoff + q0, 256, ring.full(s));
    hmmc::bulk_load(st + 2 * kTile + 256, p.delta + hoff + q0, 256,
                    ring.full(s));
  };
  if (issuer) {
    ring.init();
    hmmc::mbar_expect_tx(ring.full_a, 2 * kTile * n_act);
    for (int w = 0; w < n_act; ++w) {
      const uint32_t t = sm.addr + 2 * w * kTile;
      hmmc::tma_tile<D>(t, p.k, ring.full_a, (kt0 + w) * kTileRows, hh, b);
      hmmc::tma_tile<D>(t + kTile, p.v, ring.full_a, (kt0 + w) * kTileRows,
                        hh, b);
    }
    for (int it = 0; it < min(kStages, n_it); ++it) load(it);
  }
  __syncthreads();
  keys_consumer<D>(p, sm, ring, [&](int it) {
    hmmc::mbar_arrive(ring.empty(it % kStages));
    const int r = it - 1;
    if (issuer && r >= 0 && r + kStages < n_it) {
      hmmc::mbar_wait(ring.empty(r % kStages), (r / kStages) & 1);
      load(r + kStages);
    }
  });
}

// cuTensorMapEncodeTiled, a driver entry point, through the runtime (the
// library links no libcuda)
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                 void*, const cuuint64_t*, const cuuint64_t*,
                                 const cuuint32_t*, const cuuint32_t*,
                                 CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

EncodeTiled encode_tiled() {
  static const EncodeTiled fn = [] {
    void* f = nullptr;
    cudaDriverEntryPointQueryResult found;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &f,
                                cudaEnableDefault, &found) != cudaSuccess ||
        found != cudaDriverEntryPointSuccess)
      return static_cast<EncodeTiled>(nullptr);
    return reinterpret_cast<EncodeTiled>(f);
  }();
  return fn;
}

// byte stride of an axis for a tensor map: a multiple of 16 (the wrapper
// checks every axis longer than 1; a length-1 axis takes any)
inline cuuint64_t map_stride(long long elems, int extent) {
  const long long bytes = 2 * elems;
  if (extent == 1 && (bytes <= 0 || bytes % 16)) return 16;
  return static_cast<cuuint64_t>(bytes);
}

// The two maps of a bf16 [B, H, L, D] view: 64-row boxes of block 0's 64
// columns (128-byte swizzle) and of block 1's D - 64 (their width's
// swizzle). Rows past L read as zeros.
template <int D>
bool make_maps(hmmc::TileMaps* m, const void* ptr, int batch, int heads,
               int len, Strides s) {
  const EncodeTiled enc = encode_tiled();
  if (enc == nullptr) return false;
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(D),
                              static_cast<cuuint64_t>(len),
                              static_cast<cuuint64_t>(heads),
                              static_cast<cuuint64_t>(batch)};
  const cuuint64_t strides[3] = {map_stride(s.l, len), map_stride(s.h, heads),
                                 map_stride(s.b, batch)};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  const cuuint32_t box0[4] = {64, kTileRows, 1, 1};
  void* base = const_cast<void*>(ptr);
  if (enc(&m->m0, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, base, dims, strides,
          box0, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
          CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
          CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) != CUDA_SUCCESS)
    return false;
  if constexpr (D > 64) {
    const cuuint32_t box1[4] = {static_cast<cuuint32_t>(D - 64), kTileRows,
                                1, 1};
    const CUtensorMapSwizzle sw = D == 128  ? CU_TENSOR_MAP_SWIZZLE_128B
                                  : D == 96 ? CU_TENSOR_MAP_SWIZZLE_64B
                                            : CU_TENSOR_MAP_SWIZZLE_32B;
    if (enc(&m->m1, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, base, dims, strides,
            box1, unit, CU_TENSOR_MAP_INTERLEAVE_NONE, sw,
            CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) != CUDA_SUCCESS)
      return false;
  }
  return true;
}

template <int D>
cudaError_t launch_tiled(const Args& a, const TiledIn& in, int batch,
                         float* delta, cudaStream_t stream) {
  static unsigned allowed_rows = 0, allowed_keys = 0;
  TiledParams p{};
  if (!make_maps<D>(&p.q, a.q, batch, a.heads, a.len, a.sq) ||
      !make_maps<D>(&p.k, a.k, batch, a.heads, a.len, a.sk) ||
      !make_maps<D>(&p.v, a.v, batch, a.heads, a.len, a.sv) ||
      !make_maps<D>(&p.g, a.g, batch, a.heads, a.len, a.sg))
    return cudaErrorInvalidValue;
  p.o = static_cast<const __nv_bfloat16*>(in.o);
  p.lse = in.lse;
  p.delta = delta;
  p.dq = static_cast<__nv_bfloat16*>(a.dq);
  p.dk = static_cast<__nv_bfloat16*>(a.dk);
  p.dv = static_cast<__nv_bfloat16*>(a.dv);
  p.so = in.so;
  p.sdq = a.sdq;
  p.sdk = a.sdk;
  p.sdv = a.sdv;
  p.heads = a.heads;
  p.len = a.len;
  p.causal = a.causal;
  auto rows = attention_bwd_rows_kernel<D>;
  auto keys = attention_bwd_keys_kernel<D>;
  cudaError_t err = hmmc::allow_smem(rows, kSmemRows<D>, &allowed_rows);
  if (err != cudaSuccess) return err;
  err = hmmc::allow_smem(keys, kSmemKeys<D>, &allowed_keys);
  if (err != cudaSuccess) return err;
  const int n_t = (a.len + kTileRows - 1) / kTileRows;
  const dim3 grid(batch * a.heads, (n_t + kWG - 1) / kWG);
  rows<<<grid, kThreadsTiled, kSmemRows<D>, stream>>>(p);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  keys<<<grid, kThreadsTiled, kSmemKeys<D>, stream>>>(p);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// fp32: CUDA cores (reference checks only, see the header)
// ---------------------------------------------------------------------------

constexpr int kWarps = 8;
constexpr int kRows = 4;                // rows a warp handles at once
// rows of D + 4 floats: per-lane float4 row reads of 8 rows step D / 4 + 1
// four-bank groups a row, odd at every D in the set, so 32 distinct banks
template <int D>
constexpr int kPad = D + 4;

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

__device__ __forceinline__ float dot4(float4 a, float4 b, float acc) {
  acc = fmaf(a.x, b.x, acc);
  acc = fmaf(a.y, b.y, acc);
  acc = fmaf(a.z, b.z, acc);
  return fmaf(a.w, b.w, acc);
}

// One CTA per (batch, head). NT = ceil(L / 32) key slots per lane.
// Phase 1: each warp owns 4 query rows at a time, recomputes the logits and
// dP for them (lanes own keys), the softmax and dS, stores the rows of P
// and dS in shared memory and writes dQ; phase 2: each warp owns 4 key rows
// at a time and sums dV and dK over the query rows.
template <int D, int NT>
__global__ void __launch_bounds__(kWarps * 32) attention_bwd_fp32_kernel(Args a) {
  constexpr int kHeadDim = D, kPd = kPad<D>, kCG = kColGroups<D>;
  constexpr float kScale = Scale<D>::kScale;
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int len = a.len;
  const int lp = (len + 3) & ~3;
  float* s_q = smem;                        // [len][D]
  float* s_g = s_q + len * kHeadDim;        // [len][D]
  float* s_k = s_g + len * kHeadDim;        // [len][D + 4]
  float* s_v = s_k + len * kPd;             // [len][D + 4]
  float* s_p = s_v + len * kPd;             // [len][lp]
  float* s_ds = s_p + len * lp;             // [len][lp]

  const int b = blockIdx.x / a.heads;
  const int h = blockIdx.x - b * a.heads;
  const float* qb = static_cast<const float*>(a.q) + b * a.sq.b + h * a.sq.h;
  const float* kb = static_cast<const float*>(a.k) + b * a.sk.b + h * a.sk.h;
  const float* vb = static_cast<const float*>(a.v) + b * a.sv.b + h * a.sv.h;
  const float* gb = static_cast<const float*>(a.g) + b * a.sg.b + h * a.sg.h;
  float* dqb = static_cast<float*>(a.dq) + b * a.sdq.b + h * a.sdq.h;
  float* dkb = static_cast<float*>(a.dk) + b * a.sdk.b + h * a.sdk.h;
  float* dvb = static_cast<float*>(a.dv) + b * a.sdv.b + h * a.sdv.h;

  // stage the head: consecutive threads read consecutive elements of a row;
  // kUnroll rounds of loads are issued before any is stored
  constexpr int kUnroll = 4;
  const int n = len * kHeadDim;
  for (int base = threadIdx.x; base < n; base += kUnroll * blockDim.x) {
    float tq[kUnroll], tk[kUnroll], tv[kUnroll], tg[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int idx = base + u * blockDim.x;
      if (idx < n) {
        const int l = hmmc::udiv<kHeadDim>(idx);
        const int d = idx - l * kHeadDim;
        tq[u] = qb[l * a.sq.l + d];
        tk[u] = kb[l * a.sk.l + d];
        tv[u] = vb[l * a.sv.l + d];
        tg[u] = gb[l * a.sg.l + d];
      }
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int idx = base + u * blockDim.x;
      if (idx < n) {
        const int l = hmmc::udiv<kHeadDim>(idx);
        const int d = idx - l * kHeadDim;
        s_q[l * kHeadDim + d] = tq[u];
        s_g[l * kHeadDim + d] = tg[u];
        s_k[l * kPd + d] = tk[u];
        s_v[l * kPd + d] = tv[u];
      }
    }
  }
  __syncthreads();

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;

  // ---- phase 1: query rows -> P and dS rows in shared memory, dQ ----------
  int kj[NT];
#pragma unroll
  for (int t = 0; t < NT; ++t) kj[t] = min(lane + 32 * t, len - 1);

  // the loop bound is warp-uniform, so the shuffles below see a full warp
  for (int i0 = warp * kRows; i0 < len; i0 += kWarps * kRows) {
    int qi[kRows];
#pragma unroll
    for (int r = 0; r < kRows; ++r) qi[r] = min(i0 + r, len - 1);

    // logits (s) and dP for rows i0..i0+3 against keys lane, lane+32, ...
    float s[kRows][NT], dp[kRows][NT];
#pragma unroll
    for (int r = 0; r < kRows; ++r)
#pragma unroll
      for (int t = 0; t < NT; ++t) s[r][t] = dp[r][t] = 0.f;

#pragma unroll 2
    for (int d = 0; d < kHeadDim; d += 4) {
      float4 qv[kRows], gv[kRows];
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        qv[r] = *reinterpret_cast<const float4*>(s_q + qi[r] * kHeadDim + d);
        gv[r] = *reinterpret_cast<const float4*>(s_g + qi[r] * kHeadDim + d);
      }
#pragma unroll
      for (int t = 0; t < NT; ++t) {
        const float4 kv = *reinterpret_cast<const float4*>(s_k + kj[t] * kPd + d);
        const float4 vv = *reinterpret_cast<const float4*>(s_v + kj[t] * kPd + d);
#pragma unroll
        for (int r = 0; r < kRows; ++r) {
          s[r][t] = dot4(qv[r], kv, s[r][t]);
          dp[r][t] = dot4(gv[r], vv, dp[r][t]);
        }
      }
    }

    // fp32 row softmax, then dS. Masked and out-of-range keys get P = 0 and
    // so dS = 0. Rows past the end (i0 + r >= len) are computed on a clamped
    // row but never stored.
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      const int i = i0 + r;
      float m = -INFINITY;
#pragma unroll
      for (int t = 0; t < NT; ++t) {
        const int j = lane + 32 * t;
        const bool keep = j < len && (!a.causal || j <= i);
        s[r][t] = keep ? s[r][t] * kScale : -INFINITY;
        m = fmaxf(m, s[r][t]);
      }
      m = warp_max(m);
      float sum = 0.f;
#pragma unroll
      for (int t = 0; t < NT; ++t) {
        s[r][t] = expf(s[r][t] - m);
        sum += s[r][t];
      }
      sum = warp_sum(sum);
      float rowdot = 0.f;
#pragma unroll
      for (int t = 0; t < NT; ++t) {
        s[r][t] = s[r][t] / sum;
        rowdot = fmaf(dp[r][t], s[r][t], rowdot);
      }
      rowdot = warp_sum(rowdot);
      if (i < len) {
#pragma unroll
        for (int t = 0; t < NT; ++t) {
          const int j = lane + 32 * t;
          if (j < lp) {   // columns len..lp-1 hold P = dS = 0
            s_p[i * lp + j] = s[r][t];
            s_ds[i * lp + j] = s[r][t] * (dp[r][t] - rowdot) * kScale;
          }
        }
      }
    }
    __syncwarp();

    // dQ = dS . k: each lane owns output columns 2 lane and 2 lane + 1 of
    // each 64-column group
    const int jmax = a.causal ? min(len, i0 + kRows) : len;
    float2 acc[kRows][kCG];
#pragma unroll
    for (int r = 0; r < kRows; ++r)
#pragma unroll
      for (int g = 0; g < kCG; ++g) acc[r][g] = make_float2(0.f, 0.f);
    for (int j = 0; j < jmax; ++j) {
#pragma unroll
      for (int g = 0; g < kCG; ++g) {
        if (!owns_cols<D>(g, lane)) continue;
        const float2 kk = *reinterpret_cast<const float2*>(
            s_k + j * kPd + 64 * g + 2 * lane);
#pragma unroll
        for (int r = 0; r < kRows; ++r) {
          const float ds = s_ds[qi[r] * lp + j];
          acc[r][g].x = fmaf(ds, kk.x, acc[r][g].x);
          acc[r][g].y = fmaf(ds, kk.y, acc[r][g].y);
        }
      }
    }
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      const int i = i0 + r;
#pragma unroll
      for (int g = 0; g < kCG; ++g)
        if (i < len && owns_cols<D>(g, lane)) {
          float* out = dqb + i * a.sdq.l + 64 * g + 2 * lane;
          out[0] = acc[r][g].x;
          out[1] = acc[r][g].y;
        }
    }
  }
  __syncthreads();

  // ---- phase 2: key rows j0..j0+3 -> dV = P^T g, dK = dS^T q ---------------
  // j0 is a multiple of 4 and lp of 4, so the four P (dS) values of a query
  // row are one aligned float4, read by every lane at once (a broadcast)
  for (int j0 = warp * kRows; j0 < len; j0 += kWarps * kRows) {
    float2 adv[kRows][kCG], adk[kRows][kCG];
#pragma unroll
    for (int r = 0; r < kRows; ++r)
#pragma unroll
      for (int g = 0; g < kCG; ++g) {
        adv[r][g] = make_float2(0.f, 0.f);
        adk[r][g] = make_float2(0.f, 0.f);
      }
    // causal: P = dS = 0 for query rows i < j, so rows before j0 add nothing
    for (int i = a.causal ? j0 : 0; i < len; ++i) {
      const float4 p4 = *reinterpret_cast<const float4*>(s_p + i * lp + j0);
      const float4 d4 = *reinterpret_cast<const float4*>(s_ds + i * lp + j0);
      const float p[kRows] = {p4.x, p4.y, p4.z, p4.w};
      const float ds[kRows] = {d4.x, d4.y, d4.z, d4.w};
#pragma unroll
      for (int g = 0; g < kCG; ++g) {
        if (!owns_cols<D>(g, lane)) continue;
        const float2 gg = *reinterpret_cast<const float2*>(
            s_g + i * kHeadDim + 64 * g + 2 * lane);
        const float2 qq = *reinterpret_cast<const float2*>(
            s_q + i * kHeadDim + 64 * g + 2 * lane);
#pragma unroll
        for (int r = 0; r < kRows; ++r) {
          adv[r][g].x = fmaf(p[r], gg.x, adv[r][g].x);
          adv[r][g].y = fmaf(p[r], gg.y, adv[r][g].y);
          adk[r][g].x = fmaf(ds[r], qq.x, adk[r][g].x);
          adk[r][g].y = fmaf(ds[r], qq.y, adk[r][g].y);
        }
      }
    }
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      const int j = j0 + r;
#pragma unroll
      for (int g = 0; g < kCG; ++g)
        if (j < len && owns_cols<D>(g, lane)) {
          float* ov = dvb + j * a.sdv.l + 64 * g + 2 * lane;
          ov[0] = adv[r][g].x;
          ov[1] = adv[r][g].y;
          float* ok = dkb + j * a.sdk.l + 64 * g + 2 * lane;
          ok[0] = adk[r][g].x;
          ok[1] = adk[r][g].y;
        }
    }
  }
}

// dynamic shared memory of one fp32 CTA: q, g, k, v (padded rows), P, dS
template <int D>
constexpr size_t smem_bytes_fp32(int len) {
  const size_t l = static_cast<size_t>(len);
  const size_t lp = static_cast<size_t>((len + 3) & ~3);
  return sizeof(float) * (l * (2 * D + 2 * kPad<D>) + 2 * l * lp);
}

template <int D, int NT>
cudaError_t launch_fp32(const Args& a, int batch, cudaStream_t stream) {
  static unsigned allowed = 0;
  const size_t smem = smem_bytes_fp32<D>(a.len);
  auto kernel = attention_bwd_fp32_kernel<D, NT>;
  const cudaError_t err = hmmc::allow_smem(kernel, smem, &allowed);
  if (err != cudaSuccess) return err;
  kernel<<<batch * a.heads, kWarps * 32, smem, stream>>>(a);
  return cudaGetLastError();
}

// the instance of NT = ceil(L / 32) key slots, L <= short_max_len_bwd<D>(0)
template <int D, int NT = 1>
cudaError_t dispatch_fp32(const Args& a, int batch, cudaStream_t stream) {
  if constexpr (32 * NT < short_max_len_bwd<D>(0)) {
    if (a.len > 32 * NT) return dispatch_fp32<D, NT + 1>(a, batch, stream);
  }
  return launch_fp32<D, NT>(a, batch, stream);
}

// fp32, past the short limit: the bf16 tiled layout on the CUDA cores.
// Rows pass: a CTA per (32-row Q tile, batch * head), each warp owning 8 query rows for
// both walks over the KV tiles (64 keys, staged in turn). Keys pass: a CTA
// per (32-key tile, batch * head), each warp owning 8 keys, over Q tiles of
// 64 rows with their statistics.
constexpr int kF32Rows = 8;
constexpr int kF32Warps = 4;
constexpr int kF32RowTile = kF32Warps * kF32Rows;   // 32
constexpr int kF32Tile = 64;                        // the walked tiles

template <int D>
__device__ __forceinline__ void stage_f32_rows(float* dst, int stride,
                                               const float* src,
                                               long long row_stride, int row0,
                                               int rows, int len) {
  constexpr int kF4 = D / 4;   // float4s a row
  for (int c = threadIdx.x; c < rows * kF4; c += blockDim.x) {
    const int row = hmmc::udiv<kF4>(c), col = hmmc::umod<kF4>(c) * 4;
    const int g = row0 + row;
    *reinterpret_cast<float4*>(dst + row * stride + col) =
        g < len ? *reinterpret_cast<const float4*>(src + g * row_stride + col)
                : make_float4(0.f, 0.f, 0.f, 0.f);
  }
}

template <int D>
__global__ void __launch_bounds__(kF32Warps * 32)
attention_bwd_fp32_rows_kernel(Args a, float* stats) {
  constexpr int kHeadDim = D, kPd = kPad<D>, kCG = kColGroups<D>;
  constexpr float kScale = Scale<D>::kScale;
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  float* s_q = smem;                              // [32][D]
  float* s_g = s_q + kF32RowTile * kHeadDim;      // [32][D]
  float* s_k = s_g + kF32RowTile * kHeadDim;      // [64][D + 4]
  float* s_v = s_k + kF32Tile * kPd;              // [64][D + 4]
  float* s_ds = s_v + kF32Tile * kPd;             // [kF32Warps][8][64]
  const int len = a.len, head = blockIdx.x, q0 = blockIdx.y * kF32RowTile;
  const int b = head / a.heads, h = head - b * a.heads;
  const float* kb = static_cast<const float*>(a.k) + b * a.sk.b + h * a.sk.h;
  const float* vb = static_cast<const float*>(a.v) + b * a.sv.b + h * a.sv.h;
  stage_f32_rows<D>(s_q, kHeadDim,
                    static_cast<const float*>(a.q) + b * a.sq.b + h * a.sq.h,
                    a.sq.l, q0, kF32RowTile, len);
  stage_f32_rows<D>(s_g, kHeadDim,
                    static_cast<const float*>(a.g) + b * a.sg.b + h * a.sg.h,
                    a.sg.l, q0, kF32RowTile, len);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int i0 = q0 + warp * kF32Rows;
  const float* q_rows = s_q + warp * kF32Rows * kHeadDim;
  const float* g_rows = s_g + warp * kF32Rows * kHeadDim;
  float* ds_rows = s_ds + warp * kF32Rows * kF32Tile;
  float m[kF32Rows], l[kF32Rows], dd[kF32Rows];
  float2 acc[kF32Rows][kCG];
#pragma unroll
  for (int r = 0; r < kF32Rows; ++r) {
    m[r] = -INFINITY;
    l[r] = dd[r] = 0.f;
#pragma unroll
    for (int g = 0; g < kCG; ++g) acc[r][g] = make_float2(0.f, 0.f);
  }
  const int kv_end = a.causal ? min(len, q0 + kF32RowTile) : len;
  for (int pass = 0; pass < 2; ++pass) {
    for (int k0 = 0; k0 < kv_end; k0 += kF32Tile) {
      __syncthreads();   // the previous tile's readers are done
      stage_f32_rows<D>(s_k, kPd, kb, a.sk.l, k0, kF32Tile, len);
      stage_f32_rows<D>(s_v, kPd, vb, a.sv.l, k0, kF32Tile, len);
      __syncthreads();
      // logits and dP of the warp's rows, keys k0 + lane, k0 + lane + 32
      float s[kF32Rows][2], dp[kF32Rows][2];
#pragma unroll
      for (int r = 0; r < kF32Rows; ++r)
        s[r][0] = s[r][1] = dp[r][0] = dp[r][1] = 0.f;
#pragma unroll 2
      for (int d = 0; d < kHeadDim; d += 4) {
        const float4 ka = *reinterpret_cast<const float4*>(s_k + lane * kPd + d);
        const float4 kc =
            *reinterpret_cast<const float4*>(s_k + (lane + 32) * kPd + d);
        const float4 va = *reinterpret_cast<const float4*>(s_v + lane * kPd + d);
        const float4 vc =
            *reinterpret_cast<const float4*>(s_v + (lane + 32) * kPd + d);
#pragma unroll
        for (int r = 0; r < kF32Rows; ++r) {
          const float4 qv =
              *reinterpret_cast<const float4*>(q_rows + r * kHeadDim + d);
          const float4 gv =
              *reinterpret_cast<const float4*>(g_rows + r * kHeadDim + d);
          s[r][0] = dot4(qv, ka, s[r][0]);
          s[r][1] = dot4(qv, kc, s[r][1]);
          dp[r][0] = dot4(gv, va, dp[r][0]);
          dp[r][1] = dot4(gv, vc, dp[r][1]);
        }
      }
#pragma unroll
      for (int r = 0; r < kF32Rows; ++r) {
        const int i = i0 + r;
#pragma unroll
        for (int t = 0; t < 2; ++t) {
          const int j = k0 + lane + 32 * t;
          const bool keep = j < len && (!a.causal || j <= i);
          s[r][t] = keep ? s[r][t] * kScale : -INFINITY;
        }
      }
      if (pass == 0) {
        // statistics, online: key 0 is in the first tile and kept for
        // every row, so the running max is finite from there on
#pragma unroll
        for (int r = 0; r < kF32Rows; ++r) {
          const float mn =
              fmaxf(m[r], warp_max(fmaxf(s[r][0], s[r][1])));
          const float al = expf(m[r] - mn);
          m[r] = mn;
          const float p0 = expf(s[r][0] - mn), p1 = expf(s[r][1] - mn);
          l[r] = l[r] * al + (p0 + p1);   // this lane's keys; summed over
          dd[r] = dd[r] * al + fmaf(dp[r][1], p1, dp[r][0] * p0);  // the warp
        }
        continue;
      }
      // dS rows, then dQ += dS . k (each lane owns columns 2 lane, +1 of
      // each 64-column group)
#pragma unroll
      for (int r = 0; r < kF32Rows; ++r)
#pragma unroll
        for (int t = 0; t < 2; ++t) {
          const float p = expf(s[r][t] - m[r]) * l[r];
          ds_rows[r * kF32Tile + lane + 32 * t] =
              p * (dp[r][t] - dd[r]) * kScale;
        }
      __syncwarp();
      int jmax = min(kF32Tile, len - k0);
      if (a.causal) jmax = min(jmax, i0 + kF32Rows - k0);
      for (int j = 0; j < jmax; ++j) {
#pragma unroll
        for (int g = 0; g < kCG; ++g) {
          if (!owns_cols<D>(g, lane)) continue;
          const float2 kk = *reinterpret_cast<const float2*>(
              s_k + j * kPd + 64 * g + 2 * lane);
#pragma unroll
          for (int r = 0; r < kF32Rows; ++r) {
            const float ds = ds_rows[r * kF32Tile + j];
            acc[r][g].x = fmaf(ds, kk.x, acc[r][g].x);
            acc[r][g].y = fmaf(ds, kk.y, acc[r][g].y);
          }
        }
      }
      __syncwarp();
    }
    if (pass == 0) {
#pragma unroll
      for (int r = 0; r < kF32Rows; ++r) {
        l[r] = 1.f / warp_sum(l[r]);      // l holds 1 / the row sum
        dd[r] = warp_sum(dd[r]) * l[r];   // dd holds D
      }
    }
  }
  const int lp = static_cast<int>(stats_floats(len) / 3);
  float* st = stats + static_cast<long long>(head) * 3 * lp;
  float* dqb = static_cast<float*>(a.dq) + b * a.sdq.b + h * a.sdq.h;
#pragma unroll
  for (int r = 0; r < kF32Rows; ++r) {
    const int i = i0 + r;
#pragma unroll
    for (int g = 0; g < kCG; ++g)
      if (i < len && owns_cols<D>(g, lane)) {
        float* out = dqb + i * a.sdq.l + 64 * g + 2 * lane;
        out[0] = acc[r][g].x;
        out[1] = acc[r][g].y;
      }
    if (lane == 0 && i < lp) {
      st[i] = i < len ? m[r] : 0.f;
      st[lp + i] = i < len ? l[r] : 0.f;
      st[2 * lp + i] = i < len ? dd[r] : 0.f;
    }
  }
}

template <int D>
__global__ void __launch_bounds__(kF32Warps * 32)
attention_bwd_fp32_keys_kernel(Args a, const float* stats) {
  constexpr int kHeadDim = D, kPd = kPad<D>, kCG = kColGroups<D>;
  constexpr float kScale = Scale<D>::kScale;
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  float* s_k = smem;                              // [32][D]
  float* s_v = s_k + kF32RowTile * kHeadDim;      // [32][D]
  float* s_q = s_v + kF32RowTile * kHeadDim;      // [64][D + 4]
  float* s_g = s_q + kF32Tile * kPd;              // [64][D + 4]
  float* s_st = s_g + kF32Tile * kPd;             // [3][64]
  float* s_p = s_st + 3 * kF32Tile;               // [kF32Warps][8][64]
  float* s_ds = s_p + kF32Warps * kF32Rows * kF32Tile;
  const int len = a.len, head = blockIdx.x, k0 = blockIdx.y * kF32RowTile;
  const int b = head / a.heads, h = head - b * a.heads;
  const float* qb = static_cast<const float*>(a.q) + b * a.sq.b + h * a.sq.h;
  const float* gb = static_cast<const float*>(a.g) + b * a.sg.b + h * a.sg.h;
  const int lp = static_cast<int>(stats_floats(len) / 3);
  const float* st = stats + static_cast<long long>(head) * 3 * lp;
  stage_f32_rows<D>(s_k, kHeadDim,
                    static_cast<const float*>(a.k) + b * a.sk.b + h * a.sk.h,
                    a.sk.l, k0, kF32RowTile, len);
  stage_f32_rows<D>(s_v, kHeadDim,
                    static_cast<const float*>(a.v) + b * a.sv.b + h * a.sv.h,
                    a.sv.l, k0, kF32RowTile, len);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int j0 = k0 + warp * kF32Rows;   // the warp's first key
  const float* k_rows = s_k + warp * kF32Rows * kHeadDim;
  const float* v_rows = s_v + warp * kF32Rows * kHeadDim;
  float* p_rows = s_p + warp * kF32Rows * kF32Tile;
  float* ds_rows = s_ds + warp * kF32Rows * kF32Tile;
  float2 adv[kF32Rows][kCG], adk[kF32Rows][kCG];
#pragma unroll
  for (int r = 0; r < kF32Rows; ++r)
#pragma unroll
    for (int g = 0; g < kCG; ++g) {
      adv[r][g] = make_float2(0.f, 0.f);
      adk[r][g] = make_float2(0.f, 0.f);
    }
  // causal: queries before the tile's first key add nothing
  const int first = a.causal ? k0 / kF32Tile * kF32Tile : 0;
  for (int q0 = first; q0 < len; q0 += kF32Tile) {
    __syncthreads();   // the previous tile's readers are done
    stage_f32_rows<D>(s_q, kPd, qb, a.sq.l, q0, kF32Tile, len);
    stage_f32_rows<D>(s_g, kPd, gb, a.sg.l, q0, kF32Tile, len);
    for (int c = threadIdx.x; c < 3 * kF32Tile; c += blockDim.x)
      s_st[c] = st[(c / kF32Tile) * lp + q0 + c % kF32Tile];
    __syncthreads();
    // S^T and dP^T: the warp's keys against queries q0 + lane, + 32
    float s[kF32Rows][2], dp[kF32Rows][2];
#pragma unroll
    for (int r = 0; r < kF32Rows; ++r)
      s[r][0] = s[r][1] = dp[r][0] = dp[r][1] = 0.f;
#pragma unroll 2
    for (int d = 0; d < kHeadDim; d += 4) {
      const float4 qa = *reinterpret_cast<const float4*>(s_q + lane * kPd + d);
      const float4 qc =
          *reinterpret_cast<const float4*>(s_q + (lane + 32) * kPd + d);
      const float4 ga = *reinterpret_cast<const float4*>(s_g + lane * kPd + d);
      const float4 gc =
          *reinterpret_cast<const float4*>(s_g + (lane + 32) * kPd + d);
#pragma unroll
      for (int r = 0; r < kF32Rows; ++r) {
        const float4 kv =
            *reinterpret_cast<const float4*>(k_rows + r * kHeadDim + d);
        const float4 vv =
            *reinterpret_cast<const float4*>(v_rows + r * kHeadDim + d);
        s[r][0] = dot4(qa, kv, s[r][0]);
        s[r][1] = dot4(qc, kv, s[r][1]);
        dp[r][0] = dot4(ga, vv, dp[r][0]);
        dp[r][1] = dot4(gc, vv, dp[r][1]);
      }
    }
#pragma unroll
    for (int t = 0; t < 2; ++t) {
      const int il = lane + 32 * t, i = q0 + il;
      const float mi = s_st[il], inv = s_st[kF32Tile + il],
                  di = s_st[2 * kF32Tile + il];
#pragma unroll
      for (int r = 0; r < kF32Rows; ++r) {
        const int j = j0 + r;
        const bool keep = i < len && j < len && (!a.causal || j <= i);
        const float p = keep ? expf(s[r][t] * kScale - mi) * inv : 0.f;
        p_rows[r * kF32Tile + il] = p;
        ds_rows[r * kF32Tile + il] =
            keep ? p * (dp[r][t] - di) * kScale : 0.f;
      }
    }
    __syncwarp();
    // dV += P^T g, dK += dS^T q: each lane owns columns 2 lane, 2 lane + 1
    // of each 64-column group
    const int imax = min(kF32Tile, len - q0);
    for (int il = 0; il < imax; ++il) {
#pragma unroll
      for (int g = 0; g < kCG; ++g) {
        if (!owns_cols<D>(g, lane)) continue;
        const float2 gg = *reinterpret_cast<const float2*>(
            s_g + il * kPd + 64 * g + 2 * lane);
        const float2 qq = *reinterpret_cast<const float2*>(
            s_q + il * kPd + 64 * g + 2 * lane);
#pragma unroll
        for (int r = 0; r < kF32Rows; ++r) {
          const float p = p_rows[r * kF32Tile + il];
          const float ds = ds_rows[r * kF32Tile + il];
          adv[r][g].x = fmaf(p, gg.x, adv[r][g].x);
          adv[r][g].y = fmaf(p, gg.y, adv[r][g].y);
          adk[r][g].x = fmaf(ds, qq.x, adk[r][g].x);
          adk[r][g].y = fmaf(ds, qq.y, adk[r][g].y);
        }
      }
    }
    __syncwarp();
  }
  float* dkb = static_cast<float*>(a.dk) + b * a.sdk.b + h * a.sdk.h;
  float* dvb = static_cast<float*>(a.dv) + b * a.sdv.b + h * a.sdv.h;
#pragma unroll
  for (int r = 0; r < kF32Rows; ++r) {
    const int j = j0 + r;
#pragma unroll
    for (int g = 0; g < kCG; ++g)
      if (j < len && owns_cols<D>(g, lane)) {
        float* ov = dvb + j * a.sdv.l + 64 * g + 2 * lane;
        ov[0] = adv[r][g].x;
        ov[1] = adv[r][g].y;
        float* ok = dkb + j * a.sdk.l + 64 * g + 2 * lane;
        ok[0] = adk[r][g].x;
        ok[1] = adk[r][g].y;
      }
  }
}

template <int D>
constexpr size_t kSmemF32Rows =
    sizeof(float) * (2 * kF32RowTile * D + 2 * kF32Tile * kPad<D> +
                     kF32Warps * kF32Rows * kF32Tile);
template <int D>
constexpr size_t kSmemF32Keys =
    sizeof(float) * (2 * kF32RowTile * D + 2 * kF32Tile * kPad<D> +
                     3 * kF32Tile + 2 * kF32Warps * kF32Rows * kF32Tile);

template <int D>
cudaError_t launch_fp32_tiled(const Args& a, int batch, float* stats,
                              cudaStream_t stream) {
  static unsigned allowed_rows = 0, allowed_keys = 0;
  auto rows = attention_bwd_fp32_rows_kernel<D>;
  auto keys = attention_bwd_fp32_keys_kernel<D>;
  cudaError_t err = hmmc::allow_smem(rows, kSmemF32Rows<D>, &allowed_rows);
  if (err != cudaSuccess) return err;
  err = hmmc::allow_smem(keys, kSmemF32Keys<D>, &allowed_keys);
  if (err != cudaSuccess) return err;
  const dim3 grid(batch * a.heads, (a.len + kF32RowTile - 1) / kF32RowTile);
  rows<<<grid, kF32Warps * 32, kSmemF32Rows<D>, stream>>>(a, stats);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  keys<<<grid, kF32Warps * 32, kSmemF32Keys<D>, stream>>>(a, stats);
  return cudaGetLastError();
}

template <int D>
cudaError_t run(const Args& a, const TiledIn& in, int dtype, int batch,
                float* stats, cudaStream_t st) {
  const bool tiled = a.len > short_max_len_bwd<D>(dtype);
  if (tiled && stats == nullptr) return cudaErrorInvalidValue;
  if (dtype == 0)
    return tiled ? launch_fp32_tiled<D>(a, batch, stats, st)
                 : dispatch_fp32<D>(a, batch, st);
  if (dtype == 1) {
    if (!tiled) return dispatch_mma<D>(a, batch, st);
    // the tiled pair takes K1's output and statistics; it never makes its
    // own
    if (in.o == nullptr || in.lse == nullptr) return cudaErrorInvalidValue;
    return launch_tiled<D>(a, in, batch, stats, st);
  }
  return cudaErrorInvalidValue;
}

// the tiled pair takes K1's statistics, which K1 writes from this length
static_assert(short_max_len_bwd<64>(1) >= hmmc::kStatsMinLen - 1 &&
                  short_max_len_bwd<80>(1) >= hmmc::kStatsMinLen - 1 &&
                  short_max_len_bwd<96>(1) >= hmmc::kStatsMinLen - 1 &&
                  short_max_len_bwd<128>(1) >= hmmc::kStatsMinLen - 1,
              "K2's bf16 tiled pair would run where K1 writes no statistics");

template <int D>
long long smem_bytes(int len, int dtype) {
  if (len > short_max_len_bwd<D>(dtype))
    return static_cast<long long>(
        dtype == 1 ? (kSmemRows<D> > kSmemKeys<D> ? kSmemRows<D>
                                                  : kSmemKeys<D>)
                   : (kSmemF32Rows<D> > kSmemF32Keys<D> ? kSmemF32Rows<D>
                                                        : kSmemF32Keys<D>));
  return static_cast<long long>(dtype == 1 ? smem_bytes_mma<D>(len)
                                           : smem_bytes_fp32<D>(len));
}

// the short body's limit at (dtype, head_dim); 0 for a head_dim not built
int short_max_len(int dtype, int head_dim) {
  switch (head_dim) {
    case 64: return short_max_len_bwd<64>(dtype);
    case 80: return short_max_len_bwd<80>(dtype);
    case 96: return short_max_len_bwd<96>(dtype);
    case 128: return short_max_len_bwd<128>(dtype);
    default: return 0;
  }
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16; head_dim 64, 80, 96 or 128. strides:
// the batch, head and sequence strides (in elements) of q, k, v, g, dq, dk,
// dv and o, in that order (24 values). L above the short body's limit
// (hmmc_fused_attention_bwd_short_max_len) takes the tiled pair of
// kernels, which needs `stats`: fp32 scratch of
// hmmc_fused_attention_bwd_stats_floats(len, dtype, head_dim) floats per
// (batch, head), 16-byte aligned. In bfloat16 the tiled pair also needs K1's
// output `o` and its statistics `lse` (hmmc_fused_attention_fwd's, rows
// of tiles_len(L) floats a head); without them it returns
// cudaErrorInvalidValue, as for any other head_dim.
int hmmc_fused_attention_bwd(const void* q, const void* k, const void* v,
                             const void* g, const void* o, const float* lse,
                             void* dq, void* dk, void* dv, int dtype,
                             int batch, int heads, int len, int head_dim,
                             const long long* strides, float* stats,
                             int causal, void* stream) {
  if (len < 1 || batch < 1 || heads < 1 || strides == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  Strides s[8];
  for (int i = 0; i < 8; ++i)
    s[i] = Strides{strides[3 * i], strides[3 * i + 1], strides[3 * i + 2]};
  const Args a{q,    k,    v,    g,    dq,   dk,   dv,  heads, len,
               causal, s[0], s[1], s[2], s[3], s[4], s[5], s[6]};
  const TiledIn in{o, lse, s[7]};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (head_dim) {
    case 64: return static_cast<int>(run<64>(a, in, dtype, batch, stats, st));
    case 80: return static_cast<int>(run<80>(a, in, dtype, batch, stats, st));
    case 96: return static_cast<int>(run<96>(a, in, dtype, batch, stats, st));
    case 128:
      return static_cast<int>(run<128>(a, in, dtype, batch, stats, st));
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// The longest sequence the short (one CTA per head) body takes at this
// dtype and head_dim (0 for a head_dim not built); longer ones take the
// tiled pair.
int hmmc_fused_attention_bwd_short_max_len(int dtype, int head_dim) {
  return short_max_len(dtype, head_dim);
}

// fp32 scratch floats per (batch, head) the tiled pair needs (0: short):
// the fp32 pair's three statistics planes, the bf16 pair's D.
long long hmmc_fused_attention_bwd_stats_floats(int len, int dtype,
                                                int head_dim) {
  if (len <= short_max_len(dtype, head_dim)) return 0;
  return dtype == 1 ? tiles_len(len) : stats_floats(len);
}

// Dynamic shared memory per CTA; for the tiled pair, the larger of the two
// (-1 for a head_dim not built).
long long hmmc_fused_attention_bwd_smem_bytes(int len, int dtype,
                                              int head_dim) {
  switch (head_dim) {
    case 64: return smem_bytes<64>(len, dtype);
    case 80: return smem_bytes<80>(len, dtype);
    case 96: return smem_bytes<96>(len, dtype);
    case 128: return smem_bytes<128>(len, dtype);
    default: return -1;
  }
}

const char* hmmc_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
