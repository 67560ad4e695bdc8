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
// ViT-L/14@336px's [48, 16, 577] (0.1655 ms at 989 TFLOPS).
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
// order; the first leaves fp32 row statistics in scratch the wrapper
// allocates (3 x L rounded up to 64 floats a head), as no CTA can own a
// whole head's rows and keys at once without atomics:
//   rows  `attention_bwd_rows_kernel`, a CTA per (Q tile, batch * head),
//         walks the head's KV tiles twice through a 2-stage cp.async ring.
//         First S and dP for the row max m, the row sum and D =
//         rowsum(dP o P), online (rescaled as the max moves, as in K1's
//         tiled body); then S and dP again for P (fp32, not rounded) and dS,
//         and dQ = dS . k with dS split into hi + lo as above. It writes dQ
//         and m, 1 / sum and D per row.
//   keys  `attention_bwd_keys_kernel`, a CTA per (KV tile, batch * head),
//         each warp owning 16 keys: for every Q tile (with its statistics)
//         S^T = k . q^T and dP^T = v . g^T for its keys, P^T and dS^T from
//         the statistics, and dV += P^T g, dK += dS^T q (hi + lo) in
//         registers; causal starts at the diagonal tile.
// As in K1's tiled body, only the tiles that hold a masked pair are masked
// and exp is one ex2 of an FMA on unscaled logits. S and dP are computed
// three times a tile pair and the three products are split, so the pair
// does ~3.6x the five products' operations; at L = 577 each kernel takes
// about half the time, masking every tile would cost 13%, and a register
// cap (3 or 4 CTAs an SM) did not help (tools/attention_split.py). Per
// CTA: 6 x 64 x 2D bytes (rows) and 6 x 64 x 2D + 1,536 (keys) of shared
// memory (49,152 and 50,688 at D = 64), 149 (rows) and 168 (keys, 16
// bytes of spill stores) registers at D = 64; at D = 128 168 and 255, no
// spills (PERF.md).
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
// bf16, L > 128: two passes over tiles, no atomics
// ---------------------------------------------------------------------------

using hmmc::kTileRows;

// Per-row statistics the rows pass leaves for the keys pass, fp32, three
// planes of `lp` = L rounded up to 64 per (batch, head): the row max m of
// the unscaled logits q . k, 1 / the row sum of exp((q . k - m) * scale),
// and D = rowsum(dP o P). Rows past L hold zeros.
__host__ __device__ inline long long stats_floats(int len) {
  return 3LL * ((len + kTileRows - 1) / kTileRows) * kTileRows;
}

// S = q . k^T (unscaled) and dP = g . v^T of one warp's 16
// rows of the staged A tiles (`ta`, `tg`) against the 64 keys of the staged
// B tiles (`tb`, `tv`); key pairs np with skip(np) are left 0.
template <int D, typename Skip>
__device__ __forceinline__ void tile_products(uint32_t ta, uint32_t tg,
                                              uint32_t tb, uint32_t tv,
                                              int r0, int lane, Skip skip,
                                              float (&s)[8][4],
                                              float (&dp)[8][4]) {
#pragma unroll
  for (int n = 0; n < 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) s[n][e] = dp[n][e] = 0.f;
#pragma unroll
  for (int ks = 0; ks < Row<D>::kKSteps; ++ks) {
    uint32_t qa[4], ga[4];
    hmmc::ldsm_x4(hmmc::a_addr<D>(ta, r0, ks, lane), qa);
    hmmc::ldsm_x4(hmmc::a_addr<D>(tg, r0, ks, lane), ga);
#pragma unroll
    for (int np = 0; np < 4; ++np) {
      if (skip(np)) continue;
      uint32_t kf[4], vf[4];
      hmmc::ldsm_x4(hmmc::b_addr<D>(tb, 16 * np, ks, lane), kf);
      hmmc::mma_bf16(s[2 * np], qa, kf[0], kf[1]);
      hmmc::mma_bf16(s[2 * np + 1], qa, kf[2], kf[3]);
      hmmc::ldsm_x4(hmmc::b_addr<D>(tv, 16 * np, ks, lane), vf);
      hmmc::mma_bf16(dp[2 * np], ga, vf[0], vf[1]);
      hmmc::mma_bf16(dp[2 * np + 1], ga, vf[2], vf[3]);
    }
  }
}

// acc (16 x D) += X . B for X the 16 x 64 fp32 C fragments of one warp
// (split into bf16 hi + lo, as the short body does) and B the staged tile
// `tb` read with its rows as the k index; k-steps j with skip(j) are 0.
template <int D, typename Skip>
__device__ __forceinline__ void frag_product(
    const float (&x)[8][4], uint32_t tb, int lane, Skip skip,
    float (&acc)[Row<D>::kNTiles][4]) {
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    if (skip(j)) continue;
    uint32_t hi[4], lo[4];
    hmmc::split_bf16(x[2 * j][0], x[2 * j][1], hi[0], lo[0]);
    hmmc::split_bf16(x[2 * j][2], x[2 * j][3], hi[1], lo[1]);
    hmmc::split_bf16(x[2 * j + 1][0], x[2 * j + 1][1], hi[2], lo[2]);
    hmmc::split_bf16(x[2 * j + 1][2], x[2 * j + 1][3], hi[3], lo[3]);
#pragma unroll
    for (int c = 0; c < Row<D>::kKSteps; ++c) {
      uint32_t bf[4];
      hmmc::ldsm_x4_t(hmmc::bt_addr<D>(tb, 16 * j, c, lane), bf);
      hmmc::mma_bf16(acc[2 * c], hi, bf[0], bf[1]);
      hmmc::mma_bf16(acc[2 * c], lo, bf[0], bf[1]);
      hmmc::mma_bf16(acc[2 * c + 1], hi, bf[2], bf[3]);
      hmmc::mma_bf16(acc[2 * c + 1], lo, bf[2], bf[3]);
    }
  }
}

// Rows pass: CTA (Q tile, batch * head), 4 warps of 16 query rows; shared
// memory the Q and g tiles, then two stages of (K, V) tiles. It walks the
// head's KV tiles twice: first for m, the row sum and D (online: rescaled
// as the max moves), then for dS and dQ = dS . k. It writes dQ and the
// statistics.
template <int D>
__global__ void __launch_bounds__(kWarpsBwd * 32)
attention_bwd_rows_kernel(Args a, float* stats) {
  using bf16 = __nv_bfloat16;
  constexpr int kTileBytes = hmmc::tile_bytes<D>();
  constexpr int kNT = Row<D>::kNTiles;
  constexpr float kScale = Scale<D>::kScale, kScaleLog2 = Scale<D>::kLog2;
  extern __shared__ uint4 smem_raw[];
  char* smem = reinterpret_cast<char*>(smem_raw);
  const uint32_t base = hmmc::smem_u32(smem);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int len = a.len, head = blockIdx.x, qt = blockIdx.y;
  const int q0 = qt * kTileRows;
  const int b = head / a.heads, hh = head - b * a.heads;
  const bf16* kb = static_cast<const bf16*>(a.k) + b * a.sk.b + hh * a.sk.h;
  const bf16* vb = static_cast<const bf16*>(a.v) + b * a.sv.b + hh * a.sv.h;
  const int n_kv = a.causal ? qt + 1 : (len + kTileRows - 1) / kTileRows;
  const uint32_t tq = base, tg = base + kTileBytes;
  auto stage_of = [&](int step) {
    return base + 2 * kTileBytes + (step & 1) * 2 * kTileBytes;
  };
  auto issue = [&](int step) {   // step t reads KV tile t % n_kv
    const int kt = step % n_kv;
    const uint32_t dst = stage_of(step);
    hmmc::stage_tile<D>(dst, kb, a.sk.l, kt * kTileRows, len);
    hmmc::stage_tile<D>(dst + kTileBytes, vb, a.sv.l, kt * kTileRows, len);
  };
  hmmc::stage_tile<D>(tq, static_cast<const bf16*>(a.q) + b * a.sq.b +
                              hh * a.sq.h, a.sq.l, q0, len);
  hmmc::stage_tile<D>(tg, static_cast<const bf16*>(a.g) + b * a.sg.b +
                              hh * a.sg.h, a.sg.l, q0, len);
  issue(0);
  hmmc::cp_async_commit();

  const int r = q0 + 16 * warp + (lane >> 2);   // rows r and r + 8
  float m0 = -INFINITY, m1 = -INFINITY, l0 = 0.f, l1 = 0.f, d0 = 0.f,
        d1 = 0.f, inv0 = 0.f, inv1 = 0.f;
  float acc[kNT][4];
#pragma unroll
  for (int n = 0; n < kNT; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;

  for (int step = 0; step < 2 * n_kv; ++step) {
    if (step + 1 < 2 * n_kv) issue(step + 1);
    hmmc::cp_async_commit();
    hmmc::cp_async_wait<1>();
    __syncthreads();
    const int kt = step % n_kv, k0 = kt * kTileRows;
    const uint32_t tk = stage_of(step), tv = tk + kTileBytes;
    const bool diag = a.causal && kt == qt;
    float s[8][4], dp[8][4];
    tile_products<D>(tq, tg, tk, tv, 16 * warp, lane,
                     [&](int np) { return diag && np > warp; }, s, dp);
    // unscaled logits; -inf on the tiles that mask any (the causal
    // diagonal, the last tile of a ragged L)
    if (diag || k0 + kTileRows > len) {
#pragma unroll
      for (int n = 0; n < 8; ++n)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int j = k0 + 8 * n + 2 * (lane & 3) + e;
          if (j >= len || (a.causal && j > r)) s[n][e] = -INFINITY;
          if (j >= len || (a.causal && j > r + 8)) s[n][2 + e] = -INFINITY;
        }
    }
    if (step < n_kv) {
      // statistics: key 0 is in the first tile and kept for every row,
      // so the running max is finite from there on
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
      float t0 = 0.f, t1 = 0.f, u0 = 0.f, u1 = 0.f;
#pragma unroll
      for (int n = 0; n < 8; ++n)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const float p0 = hmmc::ex2(fmaf(s[n][e], kScaleLog2, -c0));
          const float p1 = hmmc::ex2(fmaf(s[n][2 + e], kScaleLog2,
                                          -c1));
          t0 += p0;
          t1 += p1;
          u0 = fmaf(dp[n][e], p0, u0);
          u1 = fmaf(dp[n][2 + e], p1, u1);
        }
      l0 = l0 * al0 + t0;   // this lane's columns, summed over the quad
      l1 = l1 * al1 + t1;   // after the pass
      d0 = d0 * al0 + u0;
      d1 = d1 * al1 + u1;
      if (step == n_kv - 1) {
        inv0 = 1.f / hmmc::quad_sum(l0);
        inv1 = 1.f / hmmc::quad_sum(l1);
        d0 = hmmc::quad_sum(d0) * inv0;
        d1 = hmmc::quad_sum(d1) * inv1;
      }
      __syncthreads();   // the stage is refilled two steps on
      continue;
    }
    // dS = P o (dP - D) * scale, in place of dP
    const float c0 = m0 * kScaleLog2, c1 = m1 * kScaleLog2;
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const float p0 =
            hmmc::ex2(fmaf(s[n][e], kScaleLog2, -c0)) * inv0;
        const float p1 =
            hmmc::ex2(fmaf(s[n][2 + e], kScaleLog2, -c1)) * inv1;
        dp[n][e] = p0 * (dp[n][e] - d0) * kScale;
        dp[n][2 + e] = p1 * (dp[n][2 + e] - d1) * kScale;
      }
    frag_product<D>(dp, tk, lane, [&](int j) { return diag && j > warp; },
                    acc);
    __syncthreads();
  }

  // statistics of rows r and r + 8 (zeros past L), one lane of the quad
  const int lp = static_cast<int>(stats_floats(len) / 3);
  float* st = stats + static_cast<long long>(head) * 3 * lp;
  if ((lane & 3) == 0) {
    const bool in0 = r < len, in1 = r + 8 < len;
    st[r] = in0 ? m0 : 0.f;
    st[lp + r] = in0 ? inv0 : 0.f;
    st[2 * lp + r] = in0 ? d0 : 0.f;
    st[r + 8] = in1 ? m1 : 0.f;
    st[lp + r + 8] = in1 ? inv1 : 0.f;
    st[2 * lp + r + 8] = in1 ? d1 : 0.f;
  }
  // only this warp reads its rows of the Q tile: stage dQ there
  const int rows = len - q0;
  bf16* dqb = static_cast<bf16*>(a.dq) + b * a.sdq.b + hh * a.sdq.h +
              q0 * a.sdq.l;
  hmmc::frags_to_tile<D>(smem, 16 * warp, acc, rows, lane);
  __syncwarp();
  hmmc::tile_rows_to_global<D>(smem, 16 * warp, dqb, a.sdq.l, rows, lane);
}

// Keys pass: CTA (KV tile, batch * head), 4 warps of 16 keys; shared
// memory the K and V tiles, then two stages of (Q tile, g tile, the
// tile's statistics). For each Q tile a warp computes S^T = k . q^T and
// dP^T = v . g^T for its keys, P^T and dS^T from the statistics, and
// accumulates dV = P^T g and dK = dS^T q in registers.
template <int D>
__global__ void __launch_bounds__(kWarpsBwd * 32)
attention_bwd_keys_kernel(Args a, const float* stats) {
  using bf16 = __nv_bfloat16;
  constexpr int kTileBytes = hmmc::tile_bytes<D>();
  constexpr int kNT = Row<D>::kNTiles;
  constexpr float kScale = Scale<D>::kScale, kScaleLog2 = Scale<D>::kLog2;
  constexpr int kStatBytes = 3 * kTileRows * 4;
  constexpr int kStage = 2 * kTileBytes + kStatBytes;
  extern __shared__ uint4 smem_raw[];
  char* smem = reinterpret_cast<char*>(smem_raw);
  const uint32_t base = hmmc::smem_u32(smem);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int len = a.len, head = blockIdx.x, kt = blockIdx.y;
  const int k0 = kt * kTileRows;
  const int b = head / a.heads, hh = head - b * a.heads;
  const bf16* qb = static_cast<const bf16*>(a.q) + b * a.sq.b + hh * a.sq.h;
  const bf16* gb = static_cast<const bf16*>(a.g) + b * a.sg.b + hh * a.sg.h;
  const int n_q = (len + kTileRows - 1) / kTileRows;
  const int lp = n_q * kTileRows;
  const float* st = stats + static_cast<long long>(head) * 3 * lp;
  const int first = a.causal ? kt : 0;   // causal: no query before the keys
  const uint32_t tk = base, tv = base + kTileBytes;
  auto stage_off = [&](int it) { return 2 * kTileBytes + (it & 1) * kStage; };
  auto issue = [&](int it) {
    const int qt = first + it;
    const uint32_t dst = base + stage_off(it);
    hmmc::stage_tile<D>(dst, qb, a.sq.l, qt * kTileRows, len);
    hmmc::stage_tile<D>(dst + kTileBytes, gb, a.sg.l, qt * kTileRows, len);
    // m, 1 / sum, D of the tile's 64 rows: 3 x 16 chunks of 16 bytes
    for (int c = threadIdx.x; c < 48; c += blockDim.x) {
      const int plane = c >> 4, chunk = c & 15;
      hmmc::cp_async16(dst + 2 * kTileBytes + plane * 256 + chunk * 16,
                       st + plane * lp + qt * kTileRows + chunk * 4);
    }
  };
  hmmc::stage_tile<D>(tk, static_cast<const bf16*>(a.k) + b * a.sk.b +
                              hh * a.sk.h, a.sk.l, k0, len);
  hmmc::stage_tile<D>(tv, static_cast<const bf16*>(a.v) + b * a.sv.b +
                              hh * a.sv.h, a.sv.l, k0, len);
  issue(0);
  hmmc::cp_async_commit();

  const int j = k0 + 16 * warp + (lane >> 2);   // keys j and j + 8
  float dv[kNT][4], dk[kNT][4];
#pragma unroll
  for (int n = 0; n < kNT; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) dv[n][e] = dk[n][e] = 0.f;

  const int n_it = n_q - first;
  for (int it = 0; it < n_it; ++it) {
    if (it + 1 < n_it) issue(it + 1);
    hmmc::cp_async_commit();
    hmmc::cp_async_wait<1>();
    __syncthreads();
    const int qt = first + it, q0 = qt * kTileRows;
    const uint32_t tq = base + stage_off(it), tg = tq + kTileBytes;
    const float* s_st =
        reinterpret_cast<const float*>(smem + stage_off(it) + 2 * kTileBytes);
    const bool diag = a.causal && qt == kt;   // query pairs np < warp all
                                              // lie before the keys
    float s[8][4], dp[8][4];   // S^T and dP^T: rows keys, columns queries
    tile_products<D>(tk, tv, tq, tg, 16 * warp, lane,
                     [&](int np) { return diag && np < warp; }, s, dp);
    // the tiles that mask any pair: the causal diagonal, a Q or KV tile
    // past L (whose statistics are zeros, or unwritten in the scratch)
    const bool edge = diag || q0 + kTileRows > len || k0 + kTileRows > len;
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int il = 8 * n + 2 * (lane & 3) + e, i = q0 + il;
        const float c = s_st[il] * kScaleLog2,
                    inv = s_st[kTileRows + il], d = s_st[2 * kTileRows + il];
        const bool keep0 =
            !edge || (i < len && j < len && (!a.causal || j <= i));
        const bool keep1 =
            !edge || (i < len && j + 8 < len && (!a.causal || j + 8 <= i));
        const float p0 =
            keep0 ? hmmc::ex2(fmaf(s[n][e], kScaleLog2, -c)) * inv
                  : 0.f;
        const float p1 =
            keep1 ? hmmc::ex2(fmaf(s[n][2 + e], kScaleLog2, -c)) * inv
                  : 0.f;
        s[n][e] = p0;
        s[n][2 + e] = p1;
        dp[n][e] = keep0 ? p0 * (dp[n][e] - d) * kScale : 0.f;
        dp[n][2 + e] = keep1 ? p1 * (dp[n][2 + e] - d) * kScale : 0.f;
      }
    frag_product<D>(s, tg, lane, [&](int jj) { return diag && jj < warp; },
                    dv);
    frag_product<D>(dp, tq, lane, [&](int jj) { return diag && jj < warp; },
                    dk);
    __syncthreads();   // the stage is refilled two tiles on
  }
  // only this warp reads its rows of the K and V tiles: stage dK, dV there
  const int rows = len - k0;
  bf16* dkb = static_cast<bf16*>(a.dk) + b * a.sdk.b + hh * a.sdk.h +
              k0 * a.sdk.l;
  bf16* dvb = static_cast<bf16*>(a.dv) + b * a.sdv.b + hh * a.sdv.h +
              k0 * a.sdv.l;
  hmmc::frags_to_tile<D>(smem, 16 * warp, dk, rows, lane);
  hmmc::frags_to_tile<D>(smem + kTileBytes, 16 * warp, dv, rows, lane);
  __syncwarp();
  hmmc::tile_rows_to_global<D>(smem, 16 * warp, dkb, a.sdk.l, rows, lane);
  hmmc::tile_rows_to_global<D>(smem + kTileBytes, 16 * warp, dvb, a.sdv.l,
                               rows, lane);
}

template <int D>   // Q, g, then 2 x (K, V)
constexpr size_t kSmemRows = 6 * hmmc::tile_bytes<D>();
template <int D>   // K, V, then 2 x (Q, g, statistics)
constexpr size_t kSmemKeys =
    2 * hmmc::tile_bytes<D>() +
    2 * (2 * hmmc::tile_bytes<D>() + 3 * kTileRows * 4);

template <int D>
cudaError_t launch_tiled(const Args& a, int batch, float* stats,
                         cudaStream_t stream) {
  static unsigned allowed_rows = 0, allowed_keys = 0;
  auto rows = attention_bwd_rows_kernel<D>;
  auto keys = attention_bwd_keys_kernel<D>;
  cudaError_t err = hmmc::allow_smem(rows, kSmemRows<D>, &allowed_rows);
  if (err != cudaSuccess) return err;
  err = hmmc::allow_smem(keys, kSmemKeys<D>, &allowed_keys);
  if (err != cudaSuccess) return err;
  const dim3 grid(batch * a.heads, (a.len + kTileRows - 1) / kTileRows);
  rows<<<grid, kWarpsBwd * 32, kSmemRows<D>, stream>>>(a, stats);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  keys<<<grid, kWarpsBwd * 32, kSmemKeys<D>, stream>>>(a, stats);
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
cudaError_t run(const Args& a, int dtype, int batch, float* stats,
                cudaStream_t st) {
  const bool tiled = a.len > short_max_len_bwd<D>(dtype);
  if (tiled && stats == nullptr) return cudaErrorInvalidValue;
  if (dtype == 0)
    return tiled ? launch_fp32_tiled<D>(a, batch, stats, st)
                 : dispatch_fp32<D>(a, batch, st);
  if (dtype == 1)
    return tiled ? launch_tiled<D>(a, batch, stats, st)
                 : dispatch_mma<D>(a, batch, st);
  return cudaErrorInvalidValue;
}

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
// dv, in that order (21 values). L above the short body's limit
// (hmmc_fused_attention_bwd_short_max_len) takes the tiled pair of
// kernels, which needs `stats`: fp32 scratch of
// hmmc_fused_attention_bwd_stats_floats(len, dtype, head_dim) floats per
// (batch, head), 16-byte aligned. Returns a cudaError_t as int
// (cudaErrorInvalidValue for any other head_dim).
int hmmc_fused_attention_bwd(const void* q, const void* k, const void* v,
                             const void* g, void* dq, void* dk, void* dv,
                             int dtype, int batch, int heads, int len,
                             int head_dim, const long long* strides,
                             float* stats, int causal, void* stream) {
  if (len < 1 || batch < 1 || heads < 1 || strides == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  Strides s[7];
  for (int i = 0; i < 7; ++i)
    s[i] = Strides{strides[3 * i], strides[3 * i + 1], strides[3 * i + 2]};
  const Args a{q,    k,    v,    g,    dq,   dk,   dv,  heads, len,
               causal, s[0], s[1], s[2], s[3], s[4], s[5], s[6]};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (head_dim) {
    case 64: return static_cast<int>(run<64>(a, dtype, batch, stats, st));
    case 80: return static_cast<int>(run<80>(a, dtype, batch, stats, st));
    case 96: return static_cast<int>(run<96>(a, dtype, batch, stats, st));
    case 128: return static_cast<int>(run<128>(a, dtype, batch, stats, st));
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// The longest sequence the short (one CTA per head) body takes at this
// dtype and head_dim (0 for a head_dim not built); longer ones take the
// tiled pair.
int hmmc_fused_attention_bwd_short_max_len(int dtype, int head_dim) {
  return short_max_len(dtype, head_dim);
}

// fp32 scratch floats per (batch, head) the tiled pair needs (0: short).
long long hmmc_fused_attention_bwd_stats_floats(int len, int dtype,
                                                int head_dim) {
  return len > short_max_len(dtype, head_dim) ? stats_floats(len) : 0;
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
