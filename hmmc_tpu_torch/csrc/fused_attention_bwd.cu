// Fused attention backward for short sequences (K2), CUDA C++ for sm_90a.
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
// tensor reaches device memory and there are no atomics: one CTA owns every
// row of a head, so results repeat bit for bit.
//
// What bounds it on an H100: q, k, v, g read once and dq, dk, dv written
// once are 7*B*H*L*64 elements; the five products are 10*B*H*L*L*64
// operations (causal: only the pairs a query needs), about 36 per byte at
// L = 50, far below the card's ~295 bf16 operations per byte. So the work
// is bound by device-memory bytes: in bf16, 0.1232 ms at the ViT-B/32 site
// [768, 12, 50], 0.0044 ms at the fine-tune's text site [64, 8, 32, causal]
// and 0.0016 ms at the temporal site [64, 8, 12] (3.35 TB/s).
//
// bf16 (the main path): `attention_bwd_mma_kernel`, one CTA of 4 warps per
// (batch, head). 16-byte cp.async copies stage the head's q, k, v and g as
// bf16 [Lp][64] tiles (Lp = L rounded up to 16, rows past L zero-filled),
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
// Per CTA (ptxas -v on sm_90a): shared memory 4 tiles x Lp x 128 bytes +
// 4 x Lp x (Lp + 8) x 2 bytes of P / dS = 69,632 bytes at L = 50,
// 204,800 at L = 128; 96 registers at NT = 4, 71-164 over NT = 1..8, no
// spills.
//
// fp32 (reference checks only): `attention_bwd_fp32_kernel`, the CUDA-core
// body of the first version: q, k, v, g staged as fp32, P and dS rows in
// shared memory, fmaf loops; L <= 112 (its staging fits 227 KB up to
// there). The tensor cores would take fp32 only as TF32 (~10 bits), which
// would break the fp32 tolerances (5e-5 against the plain version, 1e-3
// card against CPU), so fp32 stays on the CUDA cores.
//
// Layout: q, k, v, g, dq, dk, dv are [B, H, L, 64] with arbitrary batch /
// head / sequence strides and unit stride on the last axis, so the caller
// passes head views of a packed qkv projection and the incoming gradient as
// it arrives, without copies; in bf16 every pointer and stride must be
// 16-byte aligned (the wrapper checks). The kernel launches on the caller's
// stream, allocates nothing, and the entry point returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "attention_mma.cuh"

namespace {

using hmmc::kHeadDim;
using hmmc::kScale;
using hmmc::Strides;

constexpr int kMaxLenBf16 = 128;
constexpr int kMaxLenFp32 = 112;        // fp32 staging fits 227 KB
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

size_t smem_bytes_mma(int len) {
  const size_t lp = static_cast<size_t>((len + 15) & ~15);
  return 4 * lp * hmmc::kTileRowBytes +
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
template <int NT>
__global__ void __launch_bounds__(kWarpsBwd * 32)
attention_bwd_mma_kernel(Args a) {
  using bf16 = __nv_bfloat16;
  constexpr int kLp = 16 * NT;
  constexpr int kTile = kLp * hmmc::kTileRowBytes;
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
  hmmc::stage_head<4>(smem_base, kTile, src, row_stride, len);
  hmmc::cp_async_commit();
  hmmc::zero_pad_rows(smem, 4, kTile, len, kLp);
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
    for (int ks = 0; ks < kHeadDim / 16; ++ks) {
      uint32_t qa[4], ga[4];
      hmmc::ldsm_x4(hmmc::a_addr(tq, 16 * mt, ks, lane), qa);
      hmmc::ldsm_x4(hmmc::a_addr(tg, 16 * mt, ks, lane), ga);
#pragma unroll
      for (int np = 0; np < NT; ++np) {
        if (a.causal && np > mt) continue;   // keys all after the rows
        uint32_t kb[4], vb[4];
        hmmc::ldsm_x4(hmmc::b_addr(tk, 16 * np, ks, lane), kb);
        hmmc::mma_bf16(s[2 * np], qa, kb[0], kb[1]);
        hmmc::mma_bf16(s[2 * np + 1], qa, kb[2], kb[3]);
        hmmc::ldsm_x4(hmmc::b_addr(tv, 16 * np, ks, lane), vb);
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
    float acc[8][4];
#pragma unroll
    for (int n = 0; n < 8; ++n)
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
      for (int c = 0; c < kHeadDim / 16; ++c) {
        uint32_t kb[4];
        hmmc::ldsm_x4_t(hmmc::bt_addr(tk, 16 * j, c, lane), kb);
        hmmc::mma_bf16(acc[2 * c], hi, kb[0], kb[1]);
        hmmc::mma_bf16(acc[2 * c], lo, kb[0], kb[1]);
        hmmc::mma_bf16(acc[2 * c + 1], hi, kb[2], kb[3]);
        hmmc::mma_bf16(acc[2 * c + 1], lo, kb[2], kb[3]);
      }
    }
    // k and v are still read by the other warps: dQ leaves straight
    // from the fragments, 4 bytes a lane
#pragma unroll
    for (int n = 0; n < 8; ++n) {
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
    float dv[8][4], dk[8][4];
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) dv[n][e] = dk[n][e] = 0.f;
    // causal: P = dS = 0 for query tiles before jt
    for (int qt = a.causal ? jt : 0; qt < NT; ++qt) {
      uint32_t hi[4], lo[4];
      hmmc::ldsm_x4_t(at_addr(t_phi, kPS, qt, jt, lane), hi);
      hmmc::ldsm_x4_t(at_addr(t_plo, kPS, qt, jt, lane), lo);
#pragma unroll
      for (int c = 0; c < kHeadDim / 16; ++c) {
        uint32_t gb[4];
        hmmc::ldsm_x4_t(hmmc::bt_addr(tg, 16 * qt, c, lane), gb);
        hmmc::mma_bf16(dv[2 * c], hi, gb[0], gb[1]);
        hmmc::mma_bf16(dv[2 * c], lo, gb[0], gb[1]);
        hmmc::mma_bf16(dv[2 * c + 1], hi, gb[2], gb[3]);
        hmmc::mma_bf16(dv[2 * c + 1], lo, gb[2], gb[3]);
      }
      hmmc::ldsm_x4_t(at_addr(t_dhi, kPS, qt, jt, lane), hi);
      hmmc::ldsm_x4_t(at_addr(t_dlo, kPS, qt, jt, lane), lo);
#pragma unroll
      for (int c = 0; c < kHeadDim / 16; ++c) {
        uint32_t qb[4];
        hmmc::ldsm_x4_t(hmmc::bt_addr(tq, 16 * qt, c, lane), qb);
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
    hmmc::frags_to_tile(s_v, 16 * jt, dv, len, lane);
    hmmc::frags_to_tile(s_k, 16 * jt, dk, len, lane);
    __syncwarp();
    hmmc::tile_rows_to_global(s_v, 16 * jt, dvb, a.sdv.l, len, lane);
    hmmc::tile_rows_to_global(s_k, 16 * jt, dkb, a.sdk.l, len, lane);
  }
}

template <int NT>
cudaError_t launch_mma(const Args& a, int batch, cudaStream_t stream) {
  static unsigned allowed = 0;
  auto kernel = attention_bwd_mma_kernel<NT>;
  const size_t smem = smem_bytes_mma(a.len);
  const cudaError_t err = hmmc::allow_smem(kernel, smem, &allowed);
  if (err != cudaSuccess) return err;
  kernel<<<batch * a.heads, kWarpsBwd * 32, smem, stream>>>(a);
  return cudaGetLastError();
}

cudaError_t dispatch_mma(const Args& a, int batch, cudaStream_t stream) {
  switch ((a.len + 15) / 16) {
    case 1: return launch_mma<1>(a, batch, stream);
    case 2: return launch_mma<2>(a, batch, stream);
    case 3: return launch_mma<3>(a, batch, stream);
    case 4: return launch_mma<4>(a, batch, stream);
    case 5: return launch_mma<5>(a, batch, stream);
    case 6: return launch_mma<6>(a, batch, stream);
    case 7: return launch_mma<7>(a, batch, stream);
    default: return launch_mma<8>(a, batch, stream);
  }
}

// ---------------------------------------------------------------------------
// fp32: CUDA cores (reference checks only, see the header)
// ---------------------------------------------------------------------------

constexpr int kWarps = 8;
constexpr int kRows = 4;                // rows a warp handles at once
constexpr int kPad = kHeadDim + 4;      // 68 floats: per-lane float4 row reads
                                        // of 8 rows hit 32 distinct banks

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
template <int NT>
__global__ void __launch_bounds__(kWarps * 32) attention_bwd_fp32_kernel(Args a) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int len = a.len;
  const int lp = (len + 3) & ~3;
  float* s_q = smem;                        // [len][64]
  float* s_g = s_q + len * kHeadDim;        // [len][64]
  float* s_k = s_g + len * kHeadDim;        // [len][68]
  float* s_v = s_k + len * kPad;            // [len][68]
  float* s_p = s_v + len * kPad;            // [len][lp]
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
        const int l = idx / kHeadDim;
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
        const int l = idx / kHeadDim;
        const int d = idx - l * kHeadDim;
        s_q[l * kHeadDim + d] = tq[u];
        s_g[l * kHeadDim + d] = tg[u];
        s_k[l * kPad + d] = tk[u];
        s_v[l * kPad + d] = tv[u];
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
        const float4 kv = *reinterpret_cast<const float4*>(s_k + kj[t] * kPad + d);
        const float4 vv = *reinterpret_cast<const float4*>(s_v + kj[t] * kPad + d);
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

    // dQ = dS . k: each lane owns output columns 2*lane and 2*lane + 1
    const int jmax = a.causal ? min(len, i0 + kRows) : len;
    float2 acc[kRows];
#pragma unroll
    for (int r = 0; r < kRows; ++r) acc[r] = make_float2(0.f, 0.f);
    for (int j = 0; j < jmax; ++j) {
      const float2 kk =
          *reinterpret_cast<const float2*>(s_k + j * kPad + 2 * lane);
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        const float ds = s_ds[qi[r] * lp + j];
        acc[r].x = fmaf(ds, kk.x, acc[r].x);
        acc[r].y = fmaf(ds, kk.y, acc[r].y);
      }
    }
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      const int i = i0 + r;
      if (i < len) {
        float* out = dqb + i * a.sdq.l + 2 * lane;
        out[0] = acc[r].x;
        out[1] = acc[r].y;
      }
    }
  }
  __syncthreads();

  // ---- phase 2: key rows j0..j0+3 -> dV = P^T g, dK = dS^T q ---------------
  // j0 is a multiple of 4 and lp of 4, so the four P (dS) values of a query
  // row are one aligned float4, read by every lane at once (a broadcast)
  for (int j0 = warp * kRows; j0 < len; j0 += kWarps * kRows) {
    float2 adv[kRows], adk[kRows];
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      adv[r] = make_float2(0.f, 0.f);
      adk[r] = make_float2(0.f, 0.f);
    }
    // causal: P = dS = 0 for query rows i < j, so rows before j0 add nothing
    for (int i = a.causal ? j0 : 0; i < len; ++i) {
      const float4 p4 = *reinterpret_cast<const float4*>(s_p + i * lp + j0);
      const float4 d4 = *reinterpret_cast<const float4*>(s_ds + i * lp + j0);
      const float2 gg =
          *reinterpret_cast<const float2*>(s_g + i * kHeadDim + 2 * lane);
      const float2 qq =
          *reinterpret_cast<const float2*>(s_q + i * kHeadDim + 2 * lane);
      const float p[kRows] = {p4.x, p4.y, p4.z, p4.w};
      const float ds[kRows] = {d4.x, d4.y, d4.z, d4.w};
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        adv[r].x = fmaf(p[r], gg.x, adv[r].x);
        adv[r].y = fmaf(p[r], gg.y, adv[r].y);
        adk[r].x = fmaf(ds[r], qq.x, adk[r].x);
        adk[r].y = fmaf(ds[r], qq.y, adk[r].y);
      }
    }
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      const int j = j0 + r;
      if (j < len) {
        float* ov = dvb + j * a.sdv.l + 2 * lane;
        ov[0] = adv[r].x;
        ov[1] = adv[r].y;
        float* ok = dkb + j * a.sdk.l + 2 * lane;
        ok[0] = adk[r].x;
        ok[1] = adk[r].y;
      }
    }
  }
}

// dynamic shared memory of one fp32 CTA: q, g, k, v (padded rows), P, dS
size_t smem_bytes_fp32(int len) {
  const size_t l = static_cast<size_t>(len);
  const size_t lp = static_cast<size_t>((len + 3) & ~3);
  return sizeof(float) * (l * (2 * kHeadDim + 2 * kPad) + 2 * l * lp);
}

template <int NT>
cudaError_t launch_fp32(const Args& a, int batch, cudaStream_t stream) {
  static unsigned allowed = 0;
  const size_t smem = smem_bytes_fp32(a.len);
  auto kernel = attention_bwd_fp32_kernel<NT>;
  const cudaError_t err = hmmc::allow_smem(kernel, smem, &allowed);
  if (err != cudaSuccess) return err;
  kernel<<<batch * a.heads, kWarps * 32, smem, stream>>>(a);
  return cudaGetLastError();
}

cudaError_t dispatch_fp32(const Args& a, int batch, cudaStream_t stream) {
  switch ((a.len + 31) / 32) {
    case 1: return launch_fp32<1>(a, batch, stream);
    case 2: return launch_fp32<2>(a, batch, stream);
    case 3: return launch_fp32<3>(a, batch, stream);
    default: return launch_fp32<4>(a, batch, stream);
  }
}

}  // namespace

extern "C" {

// dtype: 0 = float32 (L <= 112), 1 = bfloat16 (L <= 128). strides: the
// batch, head and sequence strides (in elements) of q, k, v, g, dq, dk, dv,
// in that order (21 values). Returns a cudaError_t as int.
int hmmc_fused_attention_bwd(const void* q, const void* k, const void* v,
                             const void* g, void* dq, void* dk, void* dv,
                             int dtype, int batch, int heads, int len,
                             int head_dim, const long long* strides,
                             int causal, void* stream) {
  const int max_len = dtype == 1 ? kMaxLenBf16 : kMaxLenFp32;
  if (head_dim != kHeadDim || len < 1 || len > max_len || batch < 1 ||
      heads < 1 || strides == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  Strides s[7];
  for (int i = 0; i < 7; ++i)
    s[i] = Strides{strides[3 * i], strides[3 * i + 1], strides[3 * i + 2]};
  const Args a{q,    k,    v,    g,    dq,   dk,   dv,  heads, len,
               causal, s[0], s[1], s[2], s[3], s[4], s[5], s[6]};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return static_cast<int>(dispatch_fp32(a, batch, st));
  if (dtype == 1) return static_cast<int>(dispatch_mma(a, batch, st));
  return static_cast<int>(cudaErrorInvalidValue);
}

long long hmmc_fused_attention_bwd_smem_bytes(int len, int dtype) {
  return static_cast<long long>(dtype == 1 ? smem_bytes_mma(len)
                                           : smem_bytes_fp32(len));
}

const char* hmmc_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
