// Fused attention backward for short sequences (K2), CUDA C++ for sm_90a.
//
// Replaces the TPU kernel `_attention_bwd_kernel` launched by
// `_flash_backward` (hmmc_tpu/ops/pallas_attention.py). Same arithmetic, per
// (batch, head), everything in fp32:
//   P  = row softmax((q . k^T) * head_dim^-0.5)   [causal: keep cols <= rows]
//        (P is NOT rounded to v's dtype here, though the forward rounds it)
//   dV = P^T g                dP = g . v^T
//   dS = P o (dP - rowsum(dP o P)) * head_dim^-0.5
//   dQ = dS . k               dK = dS^T . q
// with fp32 accumulation and dq, dk, dv stored in q's dtype. No [L, L]
// tensor reaches device memory.
//
// What bounds it on an H100: q, k, v, g read once and dq, dk, dv written
// once are 7*B*H*L*64 elements; the five products are 10*B*H*L*L*64
// operations (causal: only the pairs a query needs). At the ViT-B/32 site
// (L = 50, bf16) that is about 36 operations per byte, far below the card's
// ~295 bf16 operations per byte, so the work is bound by device-memory bytes.
// The design reads each input once and writes each output once: one CTA per
// (batch, head) stages q, k, v and g in shared memory as fp32, and keeps P
// and dS for the whole head in shared memory between two phases:
//   phase 1  each warp owns 4 query rows at a time: it recomputes the logits
//            and dP for them (lanes own keys), the softmax and dS, stores the
//            rows of P and dS in shared memory, and writes dQ for its rows;
//   phase 2  each warp owns 4 key rows at a time and sums dV and dK over the
//            query rows from the shared P and dS.
// No atomics, so results repeat from run to run. All products run on the
// CUDA cores in fp32, which makes this first version issue-bound rather than
// byte-bound; tensor cores come in a later version with the same data flow.
//
// Shared memory per CTA: q and g [L][64], k and v [L][68] (a lane reads a
// whole row as float4s, conflict-free), P and dS [L][Lp] with Lp = L
// rounded up to 4: 54,400 + 20,800 bytes at L = 50, and 218,624 bytes at
// L = 112, the largest length that fits the 227 KB a CTA may use.
//
// Layout: q, k, v, g, dq, dk, dv are [B, H, L, 64] with arbitrary batch /
// head / sequence strides and unit stride on the last axis, so the caller
// passes head views of a packed qkv projection and the incoming gradient as
// it arrives, without copies. The kernel launches on the caller's stream,
// allocates nothing, and the entry point returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kHeadDim = 64;
constexpr int kMaxLen = 112;            // fits 227 KB of shared memory
constexpr int kWarps = 8;
constexpr int kRows = 4;                // rows a warp handles at once
constexpr int kPad = kHeadDim + 4;      // 68 floats: per-lane float4 row reads
                                        // of 8 rows hit 32 distinct banks
constexpr float kScale = 0.125f;        // kHeadDim ** -0.5, exact

struct Strides {
  long long b, h, l;
};

template <typename T>
struct Cvt;

template <>
struct Cvt<float> {
  static __device__ __forceinline__ float load(float x) { return x; }
  static __device__ __forceinline__ float store(float x) { return x; }
};

template <>
struct Cvt<__nv_bfloat16> {
  static __device__ __forceinline__ float load(__nv_bfloat16 x) {
    return __bfloat162float(x);
  }
  static __device__ __forceinline__ __nv_bfloat16 store(float x) {
    return __float2bfloat16_rn(x);
  }
};

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

struct Args {
  const void *q, *k, *v, *g;
  void *dq, *dk, *dv;
  int heads, len, causal;
  Strides sq, sk, sv, sg, sdq, sdk, sdv;
};

// One CTA per (batch, head). NT = ceil(L / 32) key slots per lane.
template <typename T, int NT>
__global__ void __launch_bounds__(kWarps * 32) attention_bwd_kernel(Args a) {
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
  const T* qb = static_cast<const T*>(a.q) + b * a.sq.b + h * a.sq.h;
  const T* kb = static_cast<const T*>(a.k) + b * a.sk.b + h * a.sk.h;
  const T* vb = static_cast<const T*>(a.v) + b * a.sv.b + h * a.sv.h;
  const T* gb = static_cast<const T*>(a.g) + b * a.sg.b + h * a.sg.h;
  T* dqb = static_cast<T*>(a.dq) + b * a.sdq.b + h * a.sdq.h;
  T* dkb = static_cast<T*>(a.dk) + b * a.sdk.b + h * a.sdk.h;
  T* dvb = static_cast<T*>(a.dv) + b * a.sdv.b + h * a.sdv.h;

  // stage the head: consecutive threads read consecutive elements of a row;
  // kUnroll rounds of loads are issued before any is stored
  constexpr int kUnroll = 4;
  const int n = len * kHeadDim;
  for (int base = threadIdx.x; base < n; base += kUnroll * blockDim.x) {
    T tq[kUnroll], tk[kUnroll], tv[kUnroll], tg[kUnroll];
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
        s_q[l * kHeadDim + d] = Cvt<T>::load(tq[u]);
        s_g[l * kHeadDim + d] = Cvt<T>::load(tg[u]);
        s_k[l * kPad + d] = Cvt<T>::load(tk[u]);
        s_v[l * kPad + d] = Cvt<T>::load(tv[u]);
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
        T* out = dqb + i * a.sdq.l + 2 * lane;
        out[0] = Cvt<T>::store(acc[r].x);
        out[1] = Cvt<T>::store(acc[r].y);
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
        T* ov = dvb + j * a.sdv.l + 2 * lane;
        ov[0] = Cvt<T>::store(adv[r].x);
        ov[1] = Cvt<T>::store(adv[r].y);
        T* ok = dkb + j * a.sdk.l + 2 * lane;
        ok[0] = Cvt<T>::store(adk[r].x);
        ok[1] = Cvt<T>::store(adk[r].y);
      }
    }
  }
}

// dynamic shared memory of one CTA: q, g, k, v (padded rows), P and dS,
// all fp32
size_t smem_bytes(int len) {
  const size_t l = static_cast<size_t>(len);
  const size_t lp = static_cast<size_t>((len + 3) & ~3);
  return sizeof(float) * (l * (2 * kHeadDim + 2 * kPad) + 2 * l * lp);
}

template <typename T, int NT>
cudaError_t launch(const Args& a, int batch, cudaStream_t stream) {
  const size_t smem = smem_bytes(a.len);
  auto kernel = attention_bwd_kernel<T, NT>;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  kernel<<<batch * a.heads, kWarps * 32, smem, stream>>>(a);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(const Args& a, int batch, cudaStream_t stream) {
  switch ((a.len + 31) / 32) {
    case 1:
      return launch<T, 1>(a, batch, stream);
    case 2:
      return launch<T, 2>(a, batch, stream);
    case 3:
      return launch<T, 3>(a, batch, stream);
    default:
      return launch<T, 4>(a, batch, stream);
  }
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16. strides: the batch, head and sequence
// strides (in elements) of q, k, v, g, dq, dk, dv, in that order (21
// values). Returns a cudaError_t as int.
int hmmc_fused_attention_bwd(const void* q, const void* k, const void* v,
                             const void* g, void* dq, void* dk, void* dv,
                             int dtype, int batch, int heads, int len,
                             int head_dim, const long long* strides,
                             int causal, void* stream) {
  if (head_dim != kHeadDim || len < 1 || len > kMaxLen || batch < 1 ||
      heads < 1 || strides == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  Strides s[7];
  for (int i = 0; i < 7; ++i)
    s[i] = Strides{strides[3 * i], strides[3 * i + 1], strides[3 * i + 2]};
  const Args a{q,    k,    v,    g,    dq,   dk,   dv,  heads, len,
               causal, s[0], s[1], s[2], s[3], s[4], s[5], s[6]};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return static_cast<int>(dispatch<float>(a, batch, st));
  if (dtype == 1)
    return static_cast<int>(dispatch<__nv_bfloat16>(a, batch, st));
  return static_cast<int>(cudaErrorInvalidValue);
}

long long hmmc_fused_attention_bwd_smem_bytes(int len) {
  return static_cast<long long>(smem_bytes(len));
}

const char* hmmc_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
