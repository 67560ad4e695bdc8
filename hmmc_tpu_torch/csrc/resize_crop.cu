// R1: JPEG planes or RGB frames -> short-side bicubic resize + center crop,
// bit for bit as PIL (libjpeg's upsampling and colour conversion, then
// Pillow's 8-bit resampler, libImaging/Resample.c) computes them.
//
// Replaces a host step, not a TPU kernel: the PIL decode tail, resize and
// crop of hmmc_tpu/data/datasets.py:36-61 (_decode_eval). nvJPEG hands
// over each frame's components as encoded; this kernel does what libjpeg
// does after its IDCT (jdsample.c's upsampling at any of the samplings
// ops/resize_crop.py lists: the fancy triangular 3/4-1/4 filter along each
// halved axis for h2v2, h2v1 and h1v2, edges replicated, replication
// otherwise; jdcolor.c ycc_rgb_convert: 16-bit fixed point; no conversion
// for RGB-coded planes; for CMYK and YCCK planes, libjpeg's YCCK->CMYK and
// Pillow's CMYK->RGB), then
// Pillow's two passes (stage 0, the planes' conversion, is in
// jpeg_planes.cuh, shared with R2), with taps
// from the host (hmmc_tpu_torch/ops/resize_crop.py: pil_coeffs, the same
// double arithmetic as Pillow's precompute_coeffs, then its 22-bit fixed
// point). Integer arithmetic only: it equals the plain version
// (resize_crop_reference after ycc_to_rgb_reference) bit for bit.
//
// Bound: the int32 multiply-adds of the resize taps, closely followed by
// bytes. At the eval path's 341x256 -> 224, a frame needs ~1.47 M
// multiply-adds (3 channels, ~4.6 taps a pass) against ~250 KB moved (the
// staged planes read once, the crop written once), and the card's IMAD
// rate is half its FFMA rate: 0.067 against 0.057 ms per 768 frames at the
// H100's peaks. Design: one launch
// per batch of frames; a CTA takes one frame (blockIdx.x) and a tile of
// output rows (blockIdx.y). Stage 0 turns the source rows and columns the
// tile needs into RGB in shared memory (neighbouring threads read
// neighbouring bytes); stage 1 runs the horizontal pass for only the
// cropped output columns into a uint8 tile (Pillow's uint8 intermediate);
// stage 2 runs the vertical pass from shared memory straight into the
// [N, res, res, 3] output. A padded slot writes zeros.
//
// Descriptor (int64, on the device): G geometries of 8 words
//   {tables pointer, kh, kv, w, h, first staged column, end column, 0}
// then N frames of 10 words
//   {plane 0, pitch 0, geometry, format, plane 1, plane 2, pitch 1,
//    hf + 16 * vf, colour, plane 3}
// format: -1 padded slot, 0 interleaved RGB (plane 0), 3 grayscale
// (plane 0), any other three or four planes (0, 1, 2: Y, Cb, Cr; planes 1
// and 2 subsampled by hf horizontally and vf vertically). colour says what
// they hold (libjpeg's jpeg_color_space): 0 YCbCr, 1 RGB as coded (no
// conversion), 2 CMYK and 3 YCCK (plane 3, K, at full size with pitch 0),
// which end in Pillow's cmyk2rgb as Image.convert("RGB") does.
// A geometry's int32 table is
//   [x_first(res), x_count(res), y_first(res), y_count(res),
//    x_taps(res * kh), y_taps(res * kv)].

#include <cuda_runtime.h>

#include <cstdint>

#include "jpeg_planes.cuh"

namespace {

constexpr int kPrecisionBits = 22;
constexpr int kThreads = 256;
constexpr int kGeomWords = 8;

__device__ __forceinline__ unsigned char clip8(int v) {
  // Pillow's clip8: <= 0 -> 0, >= 256 << 22 -> 255, else v >> 22
  v >>= kPrecisionBits;
  return static_cast<unsigned char>(v < 0 ? 0 : (v > 255 ? 255 : v));
}

__global__ void __launch_bounds__(kThreads)
resize_crop_kernel(const long long* __restrict__ desc, int n_geom,
                   unsigned char* __restrict__ out, int res, int tile_rows) {
  extern __shared__ unsigned char smem[];
  const long long* frame =
      desc + kGeomWords * n_geom
      + hmmc_planes::kFrameWords * static_cast<long long>(blockIdx.x);
  const int r0 = blockIdx.y * tile_rows;
  const int r1 = min(r0 + tile_rows, res);
  const int width3 = res * 3;
  unsigned char* dst = out + (static_cast<size_t>(blockIdx.x) * res + r0)
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
  const int* x_first = tab;
  const int* x_count = tab + res;
  const int* y_first = tab + 2 * res;
  const int* y_count = tab + 3 * res;
  const int* x_taps = tab + 4 * res;
  const int* y_taps = x_taps + res * kh;

  // source rows this tile needs (first and last are monotone in the row)
  const int ys = __ldg(y_first + r0);
  const int n_rows = __ldg(y_first + r1 - 1) + __ldg(y_count + r1 - 1) - ys;
  unsigned char* src = smem;                       // [n_rows][n_cols][3]
  unsigned char* tmp = smem + n_rows * n_cols * 3; // [n_rows][res][3]

  // stage 0: the staged source pixels as RGB
  hmmc_planes::stage_rgb<false>(frame, fmt, w, h, ys, n_rows, xs, n_cols,
                                src);
  __syncthreads();

  // stage 1, horizontal pass: staged rows x cropped columns -> uint8
  const int items = n_rows * res;
  for (int i = threadIdx.x; i < items; i += blockDim.x) {
    const int rr = i / res;
    const int c = i - rr * res;
    const unsigned char* p =
        src + (rr * n_cols + __ldg(x_first + c) - xs) * 3;
    const int* k = x_taps + c * kh;
    const int n = __ldg(x_count + c);
    int s0 = 1 << (kPrecisionBits - 1), s1 = s0, s2 = s0;
    for (int t = 0; t < n; ++t) {
      const int wt = __ldg(k + t);
      s0 += static_cast<int>(p[3 * t]) * wt;
      s1 += static_cast<int>(p[3 * t + 1]) * wt;
      s2 += static_cast<int>(p[3 * t + 2]) * wt;
    }
    unsigned char* q = tmp + rr * width3 + c * 3;
    q[0] = clip8(s0);
    q[1] = clip8(s1);
    q[2] = clip8(s2);
  }
  __syncthreads();

  // stage 2, vertical pass: shared -> the output rows of this tile
  const int out_items = (r1 - r0) * res;
  for (int i = threadIdx.x; i < out_items; i += blockDim.x) {
    const int rr = i / res;
    const int c = i - rr * res;
    const int r = r0 + rr;
    const unsigned char* p = tmp + (__ldg(y_first + r) - ys) * width3 + c * 3;
    const int* k = y_taps + r * kv;
    const int n = __ldg(y_count + r);
    int s0 = 1 << (kPrecisionBits - 1), s1 = s0, s2 = s0;
    for (int t = 0; t < n; ++t) {
      const int wt = __ldg(k + t);
      const unsigned char* q = p + t * width3;
      s0 += static_cast<int>(q[0]) * wt;
      s1 += static_cast<int>(q[1]) * wt;
      s2 += static_cast<int>(q[2]) * wt;
    }
    unsigned char* o = dst + rr * width3 + c * 3;
    o[0] = clip8(s0);
    o[1] = clip8(s1);
    o[2] = clip8(s2);
  }
}

int g_smem_set = 48 * 1024;  // dynamic shared memory the kernel may take

}  // namespace

extern "C" {

const char* hmmc_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// desc: device int64 descriptor (above); out: device uint8 [N, res, res, 3];
// tile_rows output rows per CTA; smem_bytes = the most any tile stages.
int hmmc_resize_crop(const long long* desc, int n_geom, int n_frames,
                     void* out, int res, int tile_rows, int smem_bytes,
                     void* stream) {
  if (n_frames <= 0) return 0;
  if (smem_bytes > g_smem_set) {
    const cudaError_t e = cudaFuncSetAttribute(
        resize_crop_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        smem_bytes);
    if (e != cudaSuccess) return static_cast<int>(e);
    g_smem_set = smem_bytes;
  }
  const dim3 grid(n_frames, (res + tile_rows - 1) / tile_rows);
  resize_crop_kernel<<<grid, kThreads, smem_bytes,
                       static_cast<cudaStream_t>(stream)>>>(
      desc, n_geom, static_cast<unsigned char*>(out), res, tile_rows);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
