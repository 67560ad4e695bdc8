// Fused attention forward for short sequences (K1), CUDA C++ for sm_90a.
//
// Replaces the TPU kernel `_attention_kernel` launched by `_flash_forward`
// (hmmc_tpu/ops/pallas_attention.py). Same arithmetic, per (batch, head):
//   logits = (q . k^T in fp32) * head_dim^-0.5     [causal: keep cols <= rows]
//   P      = fp32 row softmax (max, exp, divide by the sum)
//   o      = (P rounded to v's dtype) . v, fp32 accumulation, stored in q's dtype
// No log-sum-exp is saved and no [L, L] tensor reaches device memory.
//
// What bounds it on an H100: q, k, v and o, counted once each, are
// 4*B*H*L*64 elements; the two products are 4*B*H*L*L*64 operations, about
// 25 per byte at L = 50, far below the card's ~295 bf16 operations per byte.
// So the work is bound by device-memory bytes: in bf16, 0.0704 ms at the
// ViT-B/32 site [768, 12, 50], 0.0200 ms at the text site [512, 8, 32,
// causal] and 0.0009 ms at the temporal site [64, 8, 12] (3.35 TB/s).
//
// bf16 (the main path): `attention_fwd_mma_kernel`. A CTA of 4 warps takes
// kHeadsPerCta = 2 consecutive (batch, head) pairs through a 2-stage ring:
// while it computes head i from one stage, 16-byte cp.async copies bring
// head i+1's q, k and v into the other. Of 1, 2, 4 and 8 heads per CTA, 2
// was the fastest at the ViT site (PERF.md). Each stage holds q, k, v as bf16
// [Lp][64] tiles (Lp = L rounded up to 16; rows past L zero-filled once),
// swizzled so that the copies and ldmatrix reads are conflict-free
// (attention_mma.cuh). Each warp owns 16 query rows: S = q . k^T runs on
// the tensor cores (mma.sync m16n8k16, bf16 in, fp32 accumulate) with the
// whole row of Lp <= 128 keys in registers; masked and padded keys go to
// -inf, the row max and sum are quad shuffles, the row is scaled by the
// reciprocal of its sum and rounded to bf16, and those fragments are the A
// operand of P . v (v through ldmatrix.trans). That is the TPU kernel's
// cast order (fp32 logits and softmax, normalise, round, fp32
// accumulation) with no online softmax. The exponential is __expf
// (ex2.approx of x log2 e) and the sum is inverted once per row: with the
// IEEE expf and a divide per element the softmax, not the bytes, bounded
// the kernel (0.125 against 0.086 ms at the ViT site, PERF.md). The output
// goes through the warp's own q rows in shared memory and leaves as
// 16-byte row stores.
// Per CTA (ptxas -v on sm_90a): shared memory 2 stages x 3 tiles x Lp x
// 128 bytes = 49,152 bytes at L = 50 (NT = 4, 4 CTAs an SM), 98,304 at
// L = 128; 79 registers at NT = 4, 43-133 over NT = 1..8, no spills.
//
// fp32 (reference checks only): `attention_fwd_fp32_kernel`, the CUDA-core
// body of the first version (one CTA per head, fp32 staging, fmaf loops).
// The tensor cores would take fp32 only as TF32, which keeps ~10 bits and
// would break the fp32 reference tolerances (2e-5 against the plain
// version, 1e-3 card against CPU), so fp32 stays on the CUDA cores.
//
// Layout: q, k, v, o are [B, H, L, 64] with arbitrary batch/head/sequence
// strides and unit stride on the last axis, so the caller can pass head
// views of a packed qkv projection without copying; in bf16 every pointer
// and stride must be 16-byte aligned (the wrapper checks). L <= 128.
// The kernel launches on the caller's stream, allocates nothing, and the
// entry point returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "attention_mma.cuh"

namespace {

using hmmc::kHeadDim;
using hmmc::kScale;
using hmmc::Strides;

constexpr int kMaxLen = 128;
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
};

// NT = Lp / 16 row (and key) tiles of 16.
template <int NT>
__global__ void __launch_bounds__(kMmaWarps * 32)
attention_fwd_mma_kernel(Args a) {
  constexpr int kLp = 16 * NT;
  constexpr int kTile = kLp * hmmc::kTileRowBytes;
  constexpr int kStage = 3 * kTile;   // q, k, v
  extern __shared__ uint4 smem_raw[];
  char* smem = reinterpret_cast<char*>(smem_raw);
  const uint32_t smem_base = hmmc::smem_u32(smem);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int len = a.len;

  hmmc::zero_pad_rows(smem, 6, kTile, len, kLp);

  const int first = blockIdx.x * kHeadsPerCta;
  const int last = min(first + kHeadsPerCta, a.heads_total);
  const long long row_stride[3] = {a.sq.l, a.sk.l, a.sv.l};
  auto issue = [&](int head, int stage) {
    const int b = head / a.heads, h = head - b * a.heads;
    const __nv_bfloat16* src[3] = {a.q + b * a.sq.b + h * a.sq.h,
                                   a.k + b * a.sk.b + h * a.sk.h,
                                   a.v + b * a.sv.b + h * a.sv.h};
    hmmc::stage_head<3>(smem_base + stage * kStage, kTile, src, row_stride,
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
      for (int ks = 0; ks < kHeadDim / 16; ++ks) {
        uint32_t qa[4];
        hmmc::ldsm_x4(hmmc::a_addr(tq, 16 * mt, ks, lane), qa);
#pragma unroll
        for (int np = 0; np < NT; ++np) {
          if (a.causal && np > mt) continue;   // keys all after the rows
          uint32_t kb[4];
          hmmc::ldsm_x4(hmmc::b_addr(tk, 16 * np, ks, lane), kb);
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
      const float inv0 = 1.f / hmmc::quad_sum(sum0);
      const float inv1 = 1.f / hmmc::quad_sum(sum1);

      // o = (P rounded to bf16) . v: the C fragments of key tiles 2j and
      // 2j + 1, divided and packed, are the A fragment of k-step j
      float o[8][4];
#pragma unroll
      for (int n = 0; n < 8; ++n)
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
        for (int dp = 0; dp < kHeadDim / 16; ++dp) {
          uint32_t vb[4];
          hmmc::ldsm_x4_t(hmmc::bt_addr(tv, 16 * j, dp, lane), vb);
          hmmc::mma_bf16(o[2 * dp], pa, vb[0], vb[1]);
          hmmc::mma_bf16(o[2 * dp + 1], pa, vb[2], vb[3]);
        }
      }

      // the warp's own q rows are free now: stage o there, store rows
      __syncwarp();
      hmmc::frags_to_tile(s_q, 16 * mt, o, len, lane);
      __syncwarp();
      hmmc::tile_rows_to_global(s_q, 16 * mt, ob, a.so.l, len, lane);
    }
    __syncthreads();   // the stage is refilled two heads on
  }
}

size_t smem_bytes_mma(int len) {
  const size_t lp = static_cast<size_t>((len + 15) & ~15);
  return 2 * 3 * lp * hmmc::kTileRowBytes;
}

template <int NT>
cudaError_t launch_mma(const Args& a, cudaStream_t stream) {
  static unsigned allowed = 0;
  auto kernel = attention_fwd_mma_kernel<NT>;
  const size_t smem = smem_bytes_mma(a.len);
  const cudaError_t err = hmmc::allow_smem(kernel, smem, &allowed);
  if (err != cudaSuccess) return err;
  const int grid = (a.heads_total + kHeadsPerCta - 1) / kHeadsPerCta;
  kernel<<<grid, kMmaWarps * 32, smem, stream>>>(a);
  return cudaGetLastError();
}

cudaError_t dispatch_mma(const Args& a, cudaStream_t stream) {
  switch ((a.len + 15) / 16) {
    case 1: return launch_mma<1>(a, stream);
    case 2: return launch_mma<2>(a, stream);
    case 3: return launch_mma<3>(a, stream);
    case 4: return launch_mma<4>(a, stream);
    case 5: return launch_mma<5>(a, stream);
    case 6: return launch_mma<6>(a, stream);
    case 7: return launch_mma<7>(a, stream);
    default: return launch_mma<8>(a, stream);
  }
}

// ---------------------------------------------------------------------------
// fp32: CUDA cores (reference checks only, see the header)
// ---------------------------------------------------------------------------

constexpr int kWarps = 4;
constexpr int kRows = 4;                // query rows a warp handles at once
constexpr int kKStride = kHeadDim + 4;  // 68 floats: a quarter-warp's float4
                                        // loads of 8 keys hit 32 distinct banks

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
template <int NT>
__global__ void __launch_bounds__(kWarps * 32)
attention_fwd_fp32_kernel(const float* __restrict__ q,
                          const float* __restrict__ k,
                          const float* __restrict__ v, float* __restrict__ o,
                          int heads, int len, Strides sq, Strides sk,
                          Strides sv, Strides so, int causal) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int lp = (len + 3) & ~3;
  float* s_q = smem;                         // [lp][64]
  float* s_k = s_q + lp * kHeadDim;          // [lp][68]
  float* s_v = s_k + lp * kKStride;          // [lp][64]
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
        const int l = idx / kHeadDim;
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
        const int l = idx / kHeadDim;
        const int d = idx - l * kHeadDim;
        s_q[l * kHeadDim + d] = tq[u];
        s_k[l * kKStride + d] = tk[u];
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
            *reinterpret_cast<const float4*>(s_k + kj[t] * kKStride + d);
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

    // o = P . v: each lane owns output columns 2*lane and 2*lane + 1
    const int jmax = causal ? min(len, i0 + kRows) : len;
    float2 out[kRows];
#pragma unroll
    for (int r = 0; r < kRows; ++r) out[r] = make_float2(0.f, 0.f);
    for (int j = 0; j < jmax; ++j) {
      const float2 vv =
          *reinterpret_cast<const float2*>(s_v + j * kHeadDim + 2 * lane);
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        const float p = p_row[r * lp + j];
        out[r].x = fmaf(p, vv.x, out[r].x);
        out[r].y = fmaf(p, vv.y, out[r].y);
      }
    }
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      const int i = i0 + r;
      if (i < len) {
        float* op = ob + i * so.l + 2 * lane;
        op[0] = out[r].x;
        op[1] = out[r].y;
      }
    }
    __syncwarp();
  }
}

// dynamic shared memory of one fp32 CTA: q, k (padded rows), v and the
// per-warp probability rows
size_t smem_bytes_fp32(int len) {
  const size_t lp = static_cast<size_t>((len + 3) & ~3);
  return sizeof(float) * (lp * (2 * kHeadDim + kKStride) + kWarps * kRows * lp);
}

template <int NT>
cudaError_t launch_fp32(const void* q, const void* k, const void* v, void* o,
                        int batch, int heads, int len, Strides sq, Strides sk,
                        Strides sv, Strides so, int causal,
                        cudaStream_t stream) {
  static unsigned allowed = 0;
  const size_t smem = smem_bytes_fp32(len);
  auto kernel = attention_fwd_fp32_kernel<NT>;
  const cudaError_t err = hmmc::allow_smem(kernel, smem, &allowed);
  if (err != cudaSuccess) return err;
  kernel<<<batch * heads, kWarps * 32, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(o), heads, len, sq,
      sk, sv, so, causal);
  return cudaGetLastError();
}

cudaError_t dispatch_fp32(const void* q, const void* k, const void* v,
                          void* o, int batch, int heads, int len, Strides sq,
                          Strides sk, Strides sv, Strides so, int causal,
                          cudaStream_t stream) {
  switch ((len + 31) / 32) {
    case 1:
      return launch_fp32<1>(q, k, v, o, batch, heads, len, sq, sk, sv, so,
                            causal, stream);
    case 2:
      return launch_fp32<2>(q, k, v, o, batch, heads, len, sq, sk, sv, so,
                            causal, stream);
    case 3:
      return launch_fp32<3>(q, k, v, o, batch, heads, len, sq, sk, sv, so,
                            causal, stream);
    default:
      return launch_fp32<4>(q, k, v, o, batch, heads, len, sq, sk, sv, so,
                            causal, stream);
  }
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16. Returns a cudaError_t as int.
int hmmc_fused_attention_fwd(const void* q, const void* k, const void* v,
                             void* o, int dtype, int batch, int heads,
                             int len, int head_dim, long long q_sb,
                             long long q_sh, long long q_sl, long long k_sb,
                             long long k_sh, long long k_sl, long long v_sb,
                             long long v_sh, long long v_sl, long long o_sb,
                             long long o_sh, long long o_sl, int causal,
                             void* stream) {
  if (head_dim != kHeadDim || len < 1 || len > kMaxLen || batch < 1 ||
      heads < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const Strides sq{q_sb, q_sh, q_sl}, sk{k_sb, k_sh, k_sl},
      sv{v_sb, v_sh, v_sl}, so{o_sb, o_sh, o_sl};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return static_cast<int>(dispatch_fp32(q, k, v, o, batch, heads, len, sq,
                                          sk, sv, so, causal, s));
  if (dtype == 1) {
    const Args a{static_cast<const __nv_bfloat16*>(q),
                 static_cast<const __nv_bfloat16*>(k),
                 static_cast<const __nv_bfloat16*>(v),
                 static_cast<__nv_bfloat16*>(o),
                 heads, len, causal, batch * heads,
                 sq, sk, sv, so};
    return static_cast<int>(dispatch_mma(a, s));
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

long long hmmc_fused_attention_smem_bytes(int len, int dtype) {
  return static_cast<long long>(dtype == 1 ? smem_bytes_mma(len)
                                           : smem_bytes_fp32(len));
}

// (batch, head) pairs one CTA takes in this dtype.
int hmmc_fused_attention_heads_per_cta(int dtype) {
  return dtype == 1 ? kHeadsPerCta : 1;
}

const char* hmmc_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
