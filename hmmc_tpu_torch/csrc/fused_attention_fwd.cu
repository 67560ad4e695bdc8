// Fused attention forward for short sequences (K1), CUDA C++ for sm_90a.
//
// Replaces the TPU kernel `_attention_kernel` launched by `_flash_forward`
// (hmmc_tpu/ops/pallas_attention.py). Same arithmetic, per (batch, head):
//   logits = (q . k^T in fp32) * head_dim^-0.5     [causal: keep cols <= rows]
//   P      = fp32 row softmax (max, exp, divide by the sum)
//   o      = (P rounded to v's dtype) . v, fp32 accumulation, stored in q's dtype
// No log-sum-exp is saved and no [L, L] tensor reaches device memory.
//
// What bounds it on an H100: counted once each, q, k, v and o are
// 4*B*H*L*64 elements; the two products are 4*B*H*L*L*64 operations. At the
// ViT-B/32 site (L = 50, bf16) that is about 25 operations per byte, far
// below the card's ~295 bf16 operations per byte, so the work is bound by
// device-memory bytes. The design reads each input exactly once: one CTA per
// (batch, head) stages the head's q, k and v in shared memory (as fp32) and
// keeps logits and probabilities in registers and a per-warp shared row, so
// the only device-memory traffic is the 4*B*H*L*64 elements themselves.
// Both products run on the CUDA cores in fp32 (4 query rows per warp share
// every k load), which makes this first version issue-bound rather than
// byte-bound at L = 50; moving the products to the tensor cores is the next
// step and needs no change to the data movement.
//
// Layout: q, k, v, o are [B, H, L, 64] with arbitrary batch/head/sequence
// strides and unit stride on the last axis, so the caller can pass head
// views of a packed qkv projection without copying. L <= 128.
// The kernel launches on the caller's stream, allocates nothing, and the
// entry point returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kHeadDim = 64;
constexpr int kMaxLen = 128;            // 4 key slots per lane
constexpr int kWarps = 4;
constexpr int kRows = 4;                // query rows a warp handles at once
constexpr int kKStride = kHeadDim + 4;  // 68 floats: a quarter-warp's float4
                                        // loads of 8 keys hit 32 distinct banks
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

// One CTA per (batch, head). NT = ceil(L / 32) key slots per lane.
template <typename T, int NT>
__global__ void __launch_bounds__(kWarps * 32)
attention_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, T* __restrict__ o, int heads,
                     int len, Strides sq, Strides sk, Strides sv, Strides so,
                     int causal) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int lp = (len + 3) & ~3;
  float* s_q = smem;                         // [lp][64]
  float* s_k = s_q + lp * kHeadDim;          // [lp][68]
  float* s_v = s_k + lp * kKStride;          // [lp][64]
  float* s_p = s_v + lp * kHeadDim;          // [kWarps][kRows][lp]

  const int b = blockIdx.x / heads;
  const int h = blockIdx.x - b * heads;
  const T* qb = q + b * sq.b + h * sq.h;
  const T* kb = k + b * sk.b + h * sk.h;
  const T* vb = v + b * sv.b + h * sv.h;
  T* ob = o + b * so.b + h * so.h;

  // stage the head: consecutive threads read consecutive elements of a row;
  // kUnroll rounds of loads are issued before any is stored, so a thread
  // keeps 3 * kUnroll device-memory reads in flight
  constexpr int kUnroll = 8;
  const int n = len * kHeadDim;
  for (int base = threadIdx.x; base < n; base += kUnroll * blockDim.x) {
    T tq[kUnroll], tk[kUnroll], tv[kUnroll];
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
        s_q[l * kHeadDim + d] = Cvt<T>::load(tq[u]);
        s_k[l * kKStride + d] = Cvt<T>::load(tk[u]);
        s_v[l * kHeadDim + d] = Cvt<T>::load(tv[u]);
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
        // P is rounded to v's dtype before the product
        if (j < len)
          p_row[r * lp + j] = Cvt<T>::load(Cvt<T>::store(acc[r][t] / sum));
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
        T* op = ob + i * so.l + 2 * lane;
        op[0] = Cvt<T>::store(out[r].x);
        op[1] = Cvt<T>::store(out[r].y);
      }
    }
    __syncwarp();
  }
}

// dynamic shared memory of one CTA: q, k (padded rows), v and the
// per-warp probability rows, all fp32
size_t smem_bytes(int len) {
  const size_t lp = static_cast<size_t>((len + 3) & ~3);
  return sizeof(float) * (lp * (2 * kHeadDim + kKStride) + kWarps * kRows * lp);
}

template <typename T, int NT>
cudaError_t launch(const void* q, const void* k, const void* v, void* o,
                   int batch, int heads, int len, Strides sq, Strides sk,
                   Strides sv, Strides so, int causal, cudaStream_t stream) {
  const size_t smem = smem_bytes(len);
  auto kernel = attention_fwd_kernel<T, NT>;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  kernel<<<batch * heads, kWarps * 32, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), heads, len, sq, sk, sv,
      so, causal);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(const void* q, const void* k, const void* v, void* o,
                     int batch, int heads, int len, Strides sq, Strides sk,
                     Strides sv, Strides so, int causal, cudaStream_t stream) {
  switch ((len + 31) / 32) {
    case 1:
      return launch<T, 1>(q, k, v, o, batch, heads, len, sq, sk, sv, so,
                          causal, stream);
    case 2:
      return launch<T, 2>(q, k, v, o, batch, heads, len, sq, sk, sv, so,
                          causal, stream);
    case 3:
      return launch<T, 3>(q, k, v, o, batch, heads, len, sq, sk, sv, so,
                          causal, stream);
    default:
      return launch<T, 4>(q, k, v, o, batch, heads, len, sq, sk, sv, so,
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
    return static_cast<int>(dispatch<float>(q, k, v, o, batch, heads, len,
                                            sq, sk, sv, so, causal, s));
  if (dtype == 1)
    return static_cast<int>(dispatch<__nv_bfloat16>(
        q, k, v, o, batch, heads, len, sq, sk, sv, so, causal, s));
  return static_cast<int>(cudaErrorInvalidValue);
}

long long hmmc_fused_attention_smem_bytes(int len) {
  return static_cast<long long>(smem_bytes(len));
}

const char* hmmc_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
