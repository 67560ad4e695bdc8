// Stage 0 of the frame kernels R1 (resize_crop.cu) and R2 (resize_area.cu):
// a decoded JPEG's planes, as nvJPEG leaves them, or interleaved RGB, turned
// into RGB for a window of source rows and columns in shared memory, as
// libjpeg does after its IDCT (jdsample.c's upsampling at any sampling of
// ops/resize_crop.py: the fancy triangular 3/4-1/4 filter along each
// halved axis for h2v2, h2v1 and h1v2, edges replicated, replication
// otherwise; jdcolor.c ycc_rgb_convert in 16-bit fixed point; no
// conversion for RGB-coded planes; for CMYK and YCCK planes libjpeg's
// YCCK->CMYK and then the decoder's CMYK->RGB: Pillow's for R1, OpenCV's
// for R2). Integer arithmetic only.
//
// A frame's descriptor row (10 int64 words):
//   {plane 0, pitch 0, geometry, format, plane 1, plane 2, pitch 1,
//    hf + 16 * vf, colour, plane 3}
// format: -1 padded slot, 0 interleaved RGB (plane 0), 3 grayscale
// (plane 0), any other three or four planes (0, 1, 2: Y, Cb, Cr; planes 1
// and 2 subsampled by hf horizontally and vf vertically). colour says what
// they hold (libjpeg's jpeg_color_space): 0 YCbCr, 1 RGB as coded (no
// conversion), 2 CMYK and 3 YCCK (plane 3, K, at full size with pitch 0).

#pragma once

#include <cstdint>

namespace hmmc_planes {

constexpr int kFrameWords = 10;

__device__ __forceinline__ unsigned char range_limit(int v) {
  return static_cast<unsigned char>(v < 0 ? 0 : (v > 255 ? 255 : v));
}

// libjpeg's upsampling (jdsample.c) of one chroma sample at full-resolution
// (x, y) for sampling factors (hf, vf) = (1 << hs, 1 << vs). h2v2, h2v1
// (chroma wider than 2) and h1v2 are fancy: 3/4 nearer + 1/4 farther
// sample along each halved axis, edges replicated, rounding 8 / 7 (h2v2)
// or 1 / 2 (one axis); every other sampling replicates.
__device__ __forceinline__ int upsample(const unsigned char* c,
                                        long long pitch, int cw, int ch,
                                        int hf, int vf, int hs, int vs,
                                        int x, int y) {
  const int cy = y >> vs;
  const int cx = x >> hs;
  const bool fancy_h = hf == 2 && vf <= 2 && cw > 2;
  const bool fancy_v = vf == 2 && (hf == 1 || fancy_h);
  const unsigned char* r0 = c + cy * pitch;
  if (!fancy_h && !fancy_v) return r0[cx];
  const int oy =
      fancy_v ? min(max((y & 1) ? cy + 1 : cy - 1, 0), ch - 1) : cy;
  const unsigned char* r1 = c + oy * pitch;
  const int near = fancy_v ? 3 * r0[cx] + r1[cx] : r0[cx];
  if (!fancy_h) return (near + ((y & 1) ? 2 : 1)) >> 2;
  const int ox = min(max((x & 1) ? cx + 1 : cx - 1, 0), cw - 1);
  if (!fancy_v) return (3 * near + r0[ox] + ((x & 1) ? 2 : 1)) >> 2;
  const int far = 3 * r0[ox] + r1[ox];
  return (3 * near + far + ((x & 1) ? 7 : 8)) >> 4;
}

// jdcolor.c ycc_rgb_convert with its tables' arithmetic written out
__device__ __forceinline__ void ycc_rgb(int y, int cb, int cr,
                                        unsigned char* out) {
  const int xb = cb - 128, xr = cr - 128;
  const int r = (91881 * xr + 32768) >> 16;
  const int b = (116130 * xb + 32768) >> 16;
  const int g = (-22554 * xb + 32768 + -46802 * xr) >> 16;
  out[0] = range_limit(y + r);
  out[1] = range_limit(y + g);
  out[2] = range_limit(y + b);
}

// CMYK -> RGB of one channel, k the stored fourth plane (Adobe's inverted
// K), ink the channel's C, M or Y: Pillow's cmyk2rgb, k - MULDIV255(ink,
// k), or with kCv2 OpenCV's icvCvt_CMYK2BGR, k - ((ink * k) >> 8)
template <bool kCv2>
__device__ __forceinline__ unsigned char ink_rgb(int ink, int k) {
  if (kCv2) return range_limit(k - ((ink * k) >> 8));
  const int t = ink * k + 128;
  return range_limit(k - (((t >> 8) + t) >> 8));
}

// the planes' values at one pixel -> RGB, by colour (see the descriptor)
template <bool kCv2>
__device__ __forceinline__ void to_rgb(int colour, int c0, int c1, int c2,
                                       int k, unsigned char* out) {
  if (colour == 1) {
    out[0] = static_cast<unsigned char>(c0);
    out[1] = static_cast<unsigned char>(c1);
    out[2] = static_cast<unsigned char>(c2);
    return;
  }
  if (colour == 2) {
    out[0] = ink_rgb<kCv2>(255 - c0, k);
    out[1] = ink_rgb<kCv2>(255 - c1, k);
    out[2] = ink_rgb<kCv2>(255 - c2, k);
    return;
  }
  ycc_rgb(c0, c1, c2, out);
  // YCCK: libjpeg's ycck_cmyk_convert stores 255 - rgb, which Pillow and
  // OpenCV read inverted, so the ink is the YCbCr conversion's rgb
  if (colour == 3) {
    out[0] = ink_rgb<kCv2>(out[0], k);
    out[1] = ink_rgb<kCv2>(out[1], k);
    out[2] = ink_rgb<kCv2>(out[2], k);
  }
}

// Stage the source rows [ys, ys + n_rows) and columns [xs, xs + n_cols)
// of one frame (its descriptor row ``frame``, format ``fmt``, size w x h)
// as RGB into ``src`` [n_rows][n_cols][3]; every thread of the block takes
// a share. The caller synchronises.
template <bool kCv2>
__device__ __forceinline__ void stage_rgb(const long long* frame, int fmt,
                                          int w, int h, int ys, int n_rows,
                                          int xs, int n_cols,
                                          unsigned char* src) {
  const unsigned char* p0 = reinterpret_cast<const unsigned char*>(frame[0]);
  const long long pitch0 = frame[1];
  if (fmt == 0) {
    const int row_bytes = n_cols * 3;
    const int items = n_rows * row_bytes;
    for (int i = threadIdx.x; i < items; i += blockDim.x) {
      const int rr = i / row_bytes;
      const int b = i - rr * row_bytes;
      src[i] = p0[static_cast<long long>(ys + rr) * pitch0 + xs * 3 + b];
    }
  } else {
    const unsigned char* pcb = reinterpret_cast<const unsigned char*>(frame[4]);
    const unsigned char* pcr = reinterpret_cast<const unsigned char*>(frame[5]);
    const unsigned char* pk = reinterpret_cast<const unsigned char*>(frame[9]);
    const long long pitch1 = frame[6];
    const int hf = static_cast<int>(frame[7] & 15);
    const int vf = static_cast<int>(frame[7] >> 4);
    const int colour = static_cast<int>(frame[8]);
    const int hs = hf >> 1, vs = vf >> 1;      // log2 of 1, 2, 4
    const int cw = fmt == 3 ? 0 : (w + hf - 1) >> hs;
    const int ch = fmt == 3 ? 0 : (h + vf - 1) >> vs;
    const int items = n_rows * n_cols;
    for (int i = threadIdx.x; i < items; i += blockDim.x) {
      const int rr = i / n_cols;
      const int y = ys + rr;
      const int x = xs + (i - rr * n_cols);
      const long long at = static_cast<long long>(y) * pitch0 + x;
      const int luma = p0[at];
      unsigned char* o = src + i * 3;
      if (fmt == 3) {
        o[0] = o[1] = o[2] = static_cast<unsigned char>(luma);
      } else {
        to_rgb<kCv2>(colour, luma,
               upsample(pcb, pitch1, cw, ch, hf, vf, hs, vs, x, y),
               upsample(pcr, pitch1, cw, ch, hf, vf, hs, vs, x, y),
               colour >= 2 ? pk[at] : 0, o);
      }
    }
  }
}

}  // namespace hmmc_planes
