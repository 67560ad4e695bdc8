// R2: JPEG planes or RGB frames -> cv2's INTER_AREA short-side resize +
// centre crop, bit for bit as the installed cv2 (5.0.0) computes them.
//
// Replaces a host step, not a TPU kernel: the cv2 decode tail, resize and
// crop of hmmc_tpu/data/datasets.py:64-85 (_decode_aug), the pretrain's
// aug decode. nvJPEG hands over each frame's components as encoded; stage
// 0 (jpeg_planes.cuh, shared with R1) does what libjpeg does after its
// IDCT, ending CMYK and YCCK frames with OpenCV's icvCvt_CMYK2BGR. Then
// cv2.resize(INTER_AREA)'s path for the frame's geometry, with taps from
// the host (hmmc_tpu_torch/ops/resize_area.py: area_tables, the same double
// arithmetic as cv2's tables):
//   mode 0, integer factors: box sums, rounded (sum + 2) >> 2 at 2 x 2 and
//     rint(float(sum) * (1.f / area)) otherwise (a copy is the 1 x 1 box);
//   mode 1, area: fp32 sums in cv2's order, buf = sum(s * alpha) over a
//     row's column cell, then sum(beta * buf) over the row cell, every
//     product and sum rounded alone (__fmul_rn / __fadd_rn: no FMA), then
//     rounded half to even;
//   mode 2, linear (an axis upsamples): int32 horizontal taps (11-bit
//     weights), and cv2's SIMD vertical step: ((h0 >> 4) * b0 >> 16) +
//     ((h1 >> 4) * b1 >> 16), then (v + 2) >> 2.
// It equals the plain version (resize_area_reference after
// ycc_to_rgb_reference(cmyk="cv2")) bit for bit.
//
// Bound: bytes. A 640x360 frame -> 256 x 256 reads ~345 KB of planes
// (4:2:0) and writes 196 KB, for ~1.2 M multiply-adds (3 channels, ~2.4
// taps a pass), under the H100's integer and fp32 rates by a factor of
// ~50; the pretrain's 341x256 store frames are the copy path (8.2 K
// operations per row of output). Design: one launch per batch of frames; a
// CTA takes one frame (blockIdx.x) and a tile of output rows
// (blockIdx.y). Stage 0 turns the source rows and columns the tile needs
// into RGB in shared memory; stage 1 runs the horizontal pass for the
// cropped columns into a 4-byte tile (int32 or fp32 by mode); stage 2 the
// vertical pass into the [N, size, size, 3] output. A padded slot writes
// zeros.
//
// Descriptor (int64, on the device): G geometries of 10 words
//   {tables pointer, kh, kv, w, h, first staged column, end column, mode,
//    2 x 2 shift rounding, bits of 1.f / area}
// then N frames of 10 words (jpeg_planes.cuh). A geometry's int32 table is
//   [x_first(size), x_count(size), y_first(size), y_count(size),
//    x_w(size * kh), y_w(size * kv)]   (float bits in mode 1).

#include <cuda_runtime.h>

#include <cstdint>

#include "jpeg_planes.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kGeomWords = 10;

__device__ __forceinline__ unsigned char sat8(int v) {
  return static_cast<unsigned char>(v < 0 ? 0 : (v > 255 ? 255 : v));
}

__global__ void __launch_bounds__(kThreads)
resize_area_kernel(const long long* __restrict__ desc, int n_geom,
                   unsigned char* __restrict__ out, int size,
                   int tile_rows) {
  extern __shared__ __align__(16) unsigned char smem[];
  const long long* frame =
      desc + kGeomWords * n_geom
      + hmmc_planes::kFrameWords * static_cast<long long>(blockIdx.x);
  const int r0 = blockIdx.y * tile_rows;
  const int r1 = min(r0 + tile_rows, size);
  const int width3 = size * 3;
  unsigned char* dst = out + (static_cast<size_t>(blockIdx.x) * size + r0)
                       * width3;
  const int fmt = static_cast<int>(frame[3]);
  if (fmt < 0) {
    const int bytes = (r1 - r0) * width3;
    for (int i = threadIdx.x; i < bytes; i += blockDim.x) dst[i] = 0;
    return;
  }
  const long long* geom = desc + kGeomWords * frame[2];
  const int* tab = reinterpret_cast<const int*>(geom[0]);
  const int kh = static_cast<int>(geom[1]);
  const int kv = static_cast<int>(geom[2]);
  const int w = static_cast<int>(geom[3]);
  const int h = static_cast<int>(geom[4]);
  const int xs = static_cast<int>(geom[5]);
  const int n_cols = static_cast<int>(geom[6]) - xs;
  const int mode = static_cast<int>(geom[7]);
  const bool shift = geom[8] != 0;
  const float inv_area = __int_as_float(static_cast<int>(geom[9]));
  const int* x_first = tab;
  const int* x_count = tab + size;
  const int* y_first = tab + 2 * size;
  const int* y_count = tab + 3 * size;
  const int* x_w = tab + 4 * size;
  const int* y_w = x_w + size * kh;

  // source rows this tile reads (first and last are monotone in the row)
  const int ys = __ldg(y_first + r0);
  const int ye = min(__ldg(y_first + r1 - 1) + __ldg(y_count + r1 - 1), h);
  const int n_rows = ye - ys;
  unsigned char* src = smem;                            // [n_rows][n_cols][3]
  int* tmp = reinterpret_cast<int*>(
      smem + ((n_rows * n_cols * 3 + 15) & ~15));      // [n_rows][size][3]

  // stage 0: the staged source pixels as RGB (OpenCV's CMYK rule)
  hmmc_planes::stage_rgb<true>(frame, fmt, w, h, ys, n_rows, xs, n_cols,
                               src);
  __syncthreads();

  // stage 1, horizontal pass: staged rows x cropped columns
  const int items = n_rows * size;
  for (int i = threadIdx.x; i < items; i += blockDim.x) {
    const int rr = i / size;
    const int c = i - rr * size;
    const unsigned char* p =
        src + (rr * n_cols + __ldg(x_first + c) - xs) * 3;
    const int* k = x_w + c * kh;
    const int n = __ldg(x_count + c);
    int* q = tmp + (rr * size + c) * 3;
    if (mode == 1) {
      float s0 = 0.f, s1 = 0.f, s2 = 0.f;
      for (int t = 0; t < n; ++t) {
        const float a = __int_as_float(__ldg(k + t));
        s0 = __fadd_rn(s0, __fmul_rn(static_cast<float>(p[3 * t]), a));
        s1 = __fadd_rn(s1, __fmul_rn(static_cast<float>(p[3 * t + 1]), a));
        s2 = __fadd_rn(s2, __fmul_rn(static_cast<float>(p[3 * t + 2]), a));
      }
      q[0] = __float_as_int(s0);
      q[1] = __float_as_int(s1);
      q[2] = __float_as_int(s2);
    } else {
      int s0 = 0, s1 = 0, s2 = 0;
      for (int t = 0; t < n; ++t) {
        const int a = __ldg(k + t);
        s0 += static_cast<int>(p[3 * t]) * a;
        s1 += static_cast<int>(p[3 * t + 1]) * a;
        s2 += static_cast<int>(p[3 * t + 2]) * a;
      }
      q[0] = s0;
      q[1] = s1;
      q[2] = s2;
    }
  }
  __syncthreads();

  // stage 2, vertical pass: shared -> the output rows of this tile
  const int out_items = (r1 - r0) * width3;
  for (int i = threadIdx.x; i < out_items; i += blockDim.x) {
    const int rr = i / width3;
    const int cc = i - rr * width3;          // column * 3 + channel
    const int r = r0 + rr;
    const int first = __ldg(y_first + r);
    const int n = __ldg(y_count + r);
    const int* k = y_w + r * kv;
    int v;
    if (mode == 1) {
      float s = 0.f;
      for (int t = 0; t < n; ++t) {
        const int row = min(first + t, h - 1) - ys;
        s = __fadd_rn(s, __fmul_rn(__int_as_float(__ldg(k + t)),
                                   __int_as_float(tmp[row * width3 + cc])));
      }
      v = __float2int_rn(s);
    } else if (mode == 0) {
      int s = 0;
      for (int t = 0; t < n; ++t) s += tmp[(first + t - ys) * width3 + cc];
      v = shift ? (s + 2) >> 2
                : __float2int_rn(__fmul_rn(static_cast<float>(s), inv_area));
    } else {
      const int h0 = tmp[(first - ys) * width3 + cc] >> 4;
      const int h1 = tmp[(min(first + 1, h - 1) - ys) * width3 + cc] >> 4;
      v = (((h0 * __ldg(k)) >> 16) + ((h1 * __ldg(k + 1)) >> 16) + 2) >> 2;
    }
    dst[rr * width3 + cc] = sat8(v);
  }
}

int g_smem_set = 48 * 1024;  // dynamic shared memory the kernel may take

}  // namespace

extern "C" {

const char* hmmc_resize_area_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// desc: device int64 descriptor (above); out: device uint8
// [N, size, size, 3]; tile_rows output rows per CTA; smem_bytes = the most
// any tile stages.
int hmmc_resize_area(const long long* desc, int n_geom, int n_frames,
                     void* out, int size, int tile_rows, int smem_bytes,
                     void* stream) {
  if (n_frames <= 0) return 0;
  if (smem_bytes > g_smem_set) {
    const cudaError_t e = cudaFuncSetAttribute(
        resize_area_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        smem_bytes);
    if (e != cudaSuccess) return static_cast<int>(e);
    g_smem_set = smem_bytes;
  }
  const dim3 grid(n_frames, (size + tile_rows - 1) / tile_rows);
  resize_area_kernel<<<grid, kThreads, smem_bytes,
                       static_cast<cudaStream_t>(stream)>>>(
      desc, n_geom, static_cast<unsigned char*>(out), size, tile_rows);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
