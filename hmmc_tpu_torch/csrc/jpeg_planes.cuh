// Stage 0 of the frame kernels R1 (resize_crop.cu) and R2 (resize_area.cu):
// a decoded JPEG's planes, as nvJPEG leaves them, or interleaved RGB, staged
// into shared memory for a window of source rows and columns and turned into
// RGB there, as libjpeg does after its IDCT (jdsample.c's upsampling at any
// sampling of ops/resize_crop.py: the fancy triangular 3/4-1/4 filter along
// each halved axis for h2v2, h2v1 and h1v2, edges replicated, replication
// otherwise; jdcolor.c ycc_rgb_convert in 16-bit fixed point; no conversion
// for RGB-coded planes; for CMYK and YCCK planes libjpeg's YCCK->CMYK and
// then the decoder's CMYK->RGB: Pillow's for R1, OpenCV's for R2). Integer
// arithmetic only.
//
// Staging: each plane's window is copied as whole rows of 16-byte blocks
// with cp.async, a warp a row, a lane a block. A plane whose base and pitch
// are 16-byte aligned (nvJPEG's always are) lands as it is; any other (RGB
// views at a pitch of w * 3) lands with a per-row skew of (address mod 16)
// bytes, which readers add back: every block holds a byte of its row, so no
// copy leaves the row's page. The kernels issue the next window's copies
// before they convert the current one, into a second buffer, so the loads
// overlap the work. Conversion: 4:2:0 YCbCr with aligned planes (the
// decode path) goes 8 x 2 pixels a thread: the chroma words under them and
// their neighbours, libjpeg's fancy h2v2 filter in 16-bit lanes, the colour
// conversion, then saturated and packed (cvt.pack.sat) into one 64-bit
// store a plane and row. Every other layout goes pixel by pixel (a 2 x 2
// block at a time at h2v2). RGB lands as three byte planes, or
// interleaved (PRMT) into an output tile, which leaves in coalesced
// 16-byte stores.
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
constexpr int kThreads = 256;          // every frame kernel's CTA
constexpr int kWarps = kThreads / 32;
constexpr int kFmtRgb = 0;
constexpr int kFmtGray = 3;

__device__ __forceinline__ unsigned char range_limit(int v) {
  return static_cast<unsigned char>(v < 0 ? 0 : (v > 255 ? 255 : v));
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

// One frame's descriptor row, read once.
struct Frame {
  const unsigned char* p[4];   // plane 0 (Y, grey or RGB), Cb, Cr, K
  long long pitch0, pitch1;
  int fmt, hf, vf, hs, vs, colour, w, h, cw, ch;
  __device__ __forceinline__ bool chroma() const {
    return fmt > 0 && fmt != kFmtGray;
  }
};

__device__ __forceinline__ Frame load_frame(const long long* row, int w,
                                            int h) {
  Frame f;
  f.p[0] = reinterpret_cast<const unsigned char*>(row[0]);
  f.pitch0 = row[1];
  f.fmt = static_cast<int>(row[3]);
  f.p[1] = reinterpret_cast<const unsigned char*>(row[4]);
  f.p[2] = reinterpret_cast<const unsigned char*>(row[5]);
  f.pitch1 = row[6];
  f.hf = static_cast<int>(row[7] & 15);
  f.vf = static_cast<int>(row[7] >> 4);
  f.hs = f.hf >> 1;                       // log2 of 1, 2, 4
  f.vs = f.vf >> 1;
  f.colour = static_cast<int>(row[8]);
  f.p[3] = reinterpret_cast<const unsigned char*>(row[9]);
  f.w = w;
  f.h = h;
  f.cw = f.chroma() ? (w + f.hf - 1) >> f.hs : 0;
  f.ch = f.chroma() ? (h + f.vf - 1) >> f.vs : 0;
  return f;
}

// One staged plane: rows [r0, r0 + rows) and bytes [lo, hi) of the source
// plane at byte ``off`` of the buffer, a row every ``pitch`` bytes (a
// multiple of 16). Row i's bytes start at its skew, the address of byte lo
// mod 16: (skew0 + i * step) mod 16.
struct Span {
  int off, r0, rows, lo, hi, pitch, skew0, step;
};

struct Staged {
  Span s[4];
  int n;        // planes: 1 (RGB, grey), 3 (three planes), 4 (CMYK, YCCK)
};

__device__ __forceinline__ Span span_of(int off, const unsigned char* src,
                                        long long pitch, int r0, int r1,
                                        int b0, int b1) {
  Span s;
  s.off = off;
  s.r0 = r0;
  s.rows = r1 - r0;
  s.lo = b0;
  s.hi = b1;
  s.pitch = (b1 - b0 + 30) & ~15;
  s.skew0 = static_cast<int>(
      reinterpret_cast<uintptr_t>(src + r0 * pitch + b0) & 15);
  s.step = static_cast<int>(pitch & 15);
  return s;
}

// The planes that luma rows [y0, y1) and columns [x0, x1) (inside the
// frame, not empty) read, laid out one after another. A plane of R rows and
// S bytes takes at most R x (roundup(S, 16) + 16) bytes; chroma at most
// (R >> vs) + 4 rows of (S >> hs) + 7 bytes (ops/resize_crop.py's
// raw_bound sizes the buffers by these).
__device__ __forceinline__ Staged layout(const Frame& f, int y0, int y1,
                                         int x0, int x1) {
  Staged st;
  const int bpp = f.fmt == kFmtRgb ? 3 : 1;
  st.s[0] = span_of(0, f.p[0], f.pitch0, y0, y1, x0 * bpp, x1 * bpp);
  st.n = 1;
  if (!f.chroma()) return st;
  int off = st.s[0].rows * st.s[0].pitch;
  // the chroma under the window, the neighbour each side that the fancy
  // upsampling reads, and to the left the word before (the h2v2 path
  // reads chroma a word at a time)
  const int cy0 = max((y0 >> f.vs) - 1, 0);
  const int cy1 = min(((y1 - 1) >> f.vs) + 2, f.ch);
  const int cx0 = max((x0 >> f.hs) - 4, 0);
  const int cx1 = min(((x1 - 1) >> f.hs) + 2, f.cw);
  st.s[1] = span_of(off, f.p[1], f.pitch1, cy0, cy1, cx0, cx1);
  off += st.s[1].rows * st.s[1].pitch;
  st.s[2] = span_of(off, f.p[2], f.pitch1, cy0, cy1, cx0, cx1);
  off += st.s[2].rows * st.s[2].pitch;
  st.n = 3;
  if (f.colour >= 2) {
    st.s[3] = span_of(off, f.p[3], f.pitch0, y0, y1, x0, x1);
    st.n = 4;
  }
  return st;
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned s =
      static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(src));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int kPending>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kPending));
}

// Issue the copies of one staged plane into ``buf``: a warp a row, a lane
// a 16-byte block, from the aligned block that holds byte lo.
__device__ __forceinline__ void load_span(unsigned char* buf,
                                          const unsigned char* src,
                                          long long pitch, const Span& s) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int r = warp; r < s.rows; r += kWarps) {
    const unsigned char* g = src + (s.r0 + r) * pitch + s.lo;
    const int skew = static_cast<int>(reinterpret_cast<uintptr_t>(g) & 15);
    const int blocks = (skew + s.hi - s.lo + 15) >> 4;
    unsigned char* d = buf + s.off + r * s.pitch;
    for (int q = lane; q < blocks; q += 32)
      cp_async16(d + 16 * q, g - skew + 16 * q);
  }
}

// Issue every plane's copies of a window (the caller commits and waits).
__device__ __forceinline__ void stage(const Frame& f, const Staged& st,
                                      unsigned char* buf) {
  load_span(buf, f.p[0], f.pitch0, st.s[0]);
  if (st.n >= 3) {
    load_span(buf, f.p[1], f.pitch1, st.s[1]);
    load_span(buf, f.p[2], f.pitch1, st.s[2]);
  }
  if (st.n == 4) load_span(buf, f.p[3], f.pitch0, st.s[3]);
}

// A staged plane read back by source row and byte column.
struct View {
  const unsigned char* p;
  int pitch, r0, lo, skew0, step;
  __device__ __forceinline__ const unsigned char* row(int r) const {
    const int i = r - r0;
    return p + i * pitch + ((skew0 + i * step) & 15) - lo;
  }
  __device__ __forceinline__ int at(int r, int c) const { return row(r)[c]; }
};

__device__ __forceinline__ View view(const unsigned char* buf,
                                     const Span& s) {
  return View{buf + s.off, s.pitch, s.r0, s.lo, s.skew0, s.step};
}

// libjpeg's upsampling (jdsample.c) of one chroma sample at full-resolution
// (x, y): h2v2, h2v1 (chroma wider than 2) and h1v2 are fancy: 3/4 nearer
// + 1/4 farther sample along each halved axis, edges replicated, rounding
// 8 / 7 (h2v2) or 1 / 2 (one axis); every other sampling replicates.
__device__ __forceinline__ int upsample(const View& c, const Frame& f,
                                        bool fancy_h, bool fancy_v, int x,
                                        int y) {
  const int cy = y >> f.vs, cx = x >> f.hs;
  const int n0 = c.at(cy, cx);
  if (!fancy_h && !fancy_v) return n0;
  const int oy =
      fancy_v ? min(max((y & 1) ? cy + 1 : cy - 1, 0), f.ch - 1) : cy;
  const int near = fancy_v ? 3 * n0 + c.at(oy, cx) : n0;
  if (!fancy_h) return (near + ((y & 1) ? 2 : 1)) >> 2;
  const int ox = min(max((x & 1) ? cx + 1 : cx - 1, 0), f.cw - 1);
  if (!fancy_v) return (3 * near + c.at(cy, ox) + ((x & 1) ? 2 : 1)) >> 2;
  const int far = 3 * c.at(cy, ox) + c.at(oy, ox);
  return (3 * near + far + ((x & 1) ? 7 : 8)) >> 4;
}

// RGB as three byte planes, ``plane`` bytes apart: pixel (y, x) at row
// y - y0 (of ``pitch`` bytes) and column x - x0. The h2v2 path stores 8
// pixels at once, so x0 is a multiple of 8 and a row has room for the
// window's columns rounded out to multiples of 8.
struct PlanarSink {
  unsigned char* base;
  int plane, pitch, y0, x0;
  __device__ __forceinline__ void operator()(int y, int x,
                                             const unsigned char* rgb) const {
    unsigned char* p = base + (y - y0) * pitch + (x - x0);
    p[0] = rgb[0];
    p[plane] = rgb[1];
    p[2 * plane] = rgb[2];
  }
};

// RGB interleaved, as the output's rows: pixel (y, x) at row y - y0 (of
// ``pitch`` bytes) and byte 3 (x - x0); the same rules for x0 and the
// rows' room as PlanarSink.
struct InterleavedSink {
  unsigned char* base;
  int pitch, y0, x0;
  __device__ __forceinline__ void operator()(int y, int x,
                                             const unsigned char* rgb) const {
    unsigned char* p = base + (y - y0) * pitch + 3 * (x - x0);
    p[0] = rgb[0];
    p[1] = rgb[1];
    p[2] = rgb[2];
  }
};

// Two ints saturated to bytes b | a << 8, above them the low half of c.
__device__ __forceinline__ unsigned pack_sat2(int a, int b, unsigned c) {
  unsigned d;
  asm("cvt.pack.sat.u8.s32.b32 %0, %1, %2, %3;\n"
      : "=r"(d)
      : "r"(a), "r"(b), "r"(c));
  return d;
}

// Four ints saturated to the bytes of a word, v0 lowest.
__device__ __forceinline__ unsigned pack_sat4(int v0, int v1, int v2,
                                              int v3) {
  return pack_sat2(v1, v0, pack_sat2(v3, v2, 0u));
}

// Three words of R, G and B (4 pixels) -> their 12 interleaved bytes.
__device__ __forceinline__ uint3 interleave4(unsigned r, unsigned g,
                                             unsigned b) {
  return make_uint3(__byte_perm(__byte_perm(r, g, 0x1040), b, 0x3410),
                    __byte_perm(__byte_perm(g, b, 0x2051), r, 0x3610),
                    __byte_perm(__byte_perm(b, r, 0x3072), g, 0x3710));
}

__device__ __forceinline__ unsigned lds32(const unsigned char* p) {
  return *reinterpret_cast<const unsigned*>(p);
}

// libjpeg's h2v2 fancy filter for one plane of a unit of four chroma
// samples (4 x 2 blocks of luma, luma columns 8u .. 8u + 7): ``rows`` the
// staged rows above, at and below the samples (edges replicated), ``cx``
// = 4u the first sample's column, ``cw`` the plane's width. out[dy][w]
// holds two upsampled values in 16-bit lanes: w = 0, 1 even luma columns
// (lanes: samples 0, 2 / 1, 3), w = 2, 3 odd ones.
__device__ __forceinline__ void fancy_h2v2(const unsigned char* const* rows,
                                           int cx, int cw,
                                           unsigned (&out)[2][4]) {
  unsigned ce[3], co[3], le[3], ro[3];
#pragma unroll
  for (int r = 0; r < 3; ++r) {
    const unsigned w = lds32(rows[r]);
    // neighbours: L byte j = sample j - 1, R byte j = sample j + 1
    const unsigned l = cx > 0 ? __byte_perm(lds32(rows[r] - 4), w, 0x6543)
                              : __byte_perm(w, w, 0x2100);
    unsigned rt;
    if (cx + 4 < cw) {
      rt = __byte_perm(w, lds32(rows[r] + 4), 0x4321);
    } else {
      const int e = cw - 1 - cx;               // the last sample, 0 .. 3
      rt = __byte_perm(w, 0, e == 0 ? 0x0000 : e == 1 ? 0x1110
                                   : e == 2 ? 0x2221 : 0x3321);
    }
    ce[r] = __byte_perm(w, 0, 0x4240);          // samples 0, 2
    co[r] = __byte_perm(w, 0, 0x4341);          // samples 1, 3
    le[r] = __byte_perm(l, 0, 0x4240);          // samples -1, 1
    ro[r] = __byte_perm(rt, 0, 0x4341);         // samples 2, 4
  }
#pragma unroll
  for (int dy = 0; dy < 2; ++dy) {
    const int o = 2 * dy;                       // the farther row
    // 3 x nearer row + farther row, per lane (values < 1024)
    const unsigned ne = 3 * ce[1] + ce[o], no = 3 * co[1] + co[o];
    const unsigned fl = 3 * le[1] + le[o], fr = 3 * ro[1] + ro[o];
    // even luma column: (3 near + left + 8) >> 4, odd: (3 near + right
    // + 7) >> 4; sample j's right neighbour is j + 1's near and so on
    out[dy][0] = ((3 * ne + fl + 0x00080008u) >> 4) & 0x0fff0fffu;
    out[dy][1] = ((3 * no + ne + 0x00080008u) >> 4) & 0x0fff0fffu;
    out[dy][2] = ((3 * ne + no + 0x00070007u) >> 4) & 0x0fff0fffu;
    out[dy][3] = ((3 * no + fr + 0x00070007u) >> 4) & 0x0fff0fffu;
  }
}

// An aligned staged plane (no row skew beyond its first block's): row r
// at base + r * pitch, indexed by source column.
struct Rows {
  const unsigned char* base;
  int pitch;
  __device__ __forceinline__ const unsigned char* row(int r) const {
    return base + r * pitch;
  }
};

__device__ __forceinline__ Rows rows_of(const unsigned char* buf,
                                        const Span& s) {
  return Rows{buf + s.off - s.r0 * s.pitch + s.skew0 - s.lo, s.pitch};
}

// Eight pixels of a row, R, G and B as two words each, into a sink at
// column 8u: a 64-bit store a plane, or 24 interleaved bytes.
__device__ __forceinline__ void store8(const PlanarSink& o, int y, int u,
                                       const uint2& r, const uint2& g,
                                       const uint2& b) {
  unsigned char* d = o.base + (y - o.y0) * o.pitch + (8 * u - o.x0);
  *reinterpret_cast<uint2*>(d) = r;
  *reinterpret_cast<uint2*>(d + o.plane) = g;
  *reinterpret_cast<uint2*>(d + 2 * o.plane) = b;
}

__device__ __forceinline__ void store8(const InterleavedSink& o, int y,
                                       int u, const uint2& r, const uint2& g,
                                       const uint2& b) {
  uint2* d = reinterpret_cast<uint2*>(o.base + (y - o.y0) * o.pitch
                                      + 3 * (8 * u - o.x0));
  const uint3 lo = interleave4(r.x, g.x, b.x), hi = interleave4(r.y, g.y,
                                                                b.y);
  d[0] = make_uint2(lo.x, lo.y);
  d[1] = make_uint2(lo.z, hi.x);
  d[2] = make_uint2(hi.y, hi.z);
}

// 4:2:0 YCbCr from aligned planes, a unit of 8 x 2 luma pixels a thread
// (see the header note): the window's (block row, unit) pairs spread over
// every thread of the block. The sink's x0 is a multiple of 8.
template <class Sink>
__device__ __forceinline__ void convert_h2v2(const Frame& f,
                                             const Staged& st,
                                             const unsigned char* buf,
                                             int y0, int y1, int x0, int x1,
                                             const Sink& o) {
  const Rows vy = rows_of(buf, st.s[0]), vb = rows_of(buf, st.s[1]),
             vr = rows_of(buf, st.s[2]);
  const int u0 = x0 >> 3, nu = ((x1 - 1) >> 3) - u0 + 1;
  const int by0 = y0 >> 1, nb = ((y1 - 1) >> 1) - by0 + 1;
  for (int i = threadIdx.x; i < nu * nb; i += kThreads) {
    const int q = i / nu;
    const int by = by0 + q, u = u0 + i - q * nu;
    const int cx = 4 * u;
    const int cr[3] = {max(by - 1, 0), by, min(by + 1, f.ch - 1)};
    const unsigned char* bp[3] = {vb.row(cr[0]) + cx, vb.row(cr[1]) + cx,
                                  vb.row(cr[2]) + cx};
    const unsigned char* rp[3] = {vr.row(cr[0]) + cx, vr.row(cr[1]) + cx,
                                  vr.row(cr[2]) + cx};
    unsigned cb[2][4], crr[2][4];
    fancy_h2v2(bp, cx, f.cw, cb);
    fancy_h2v2(rp, cx, f.cw, crr);
#pragma unroll
    for (int dy = 0; dy < 2; ++dy) {
      const int y = 2 * by + dy;
      if (y < y0 || y >= y1) continue;
      const uint2 yw = *reinterpret_cast<const uint2*>(vy.row(y) + 8 * u);
      int r[8], g[8], b[8];
#pragma unroll
      for (int p = 0; p < 8; ++p) {
        // pixel p: sample j = p >> 1, luma column parity p & 1: word
        // 2 (p & 1) + (j & 1), lane j >> 1
        const int wi = (p & 1) * 2 + ((p >> 1) & 1);
        const int sh = (p >> 2) * 16;
        const int u_ = static_cast<int>((cb[dy][wi] >> sh) & 0xffff);
        const int v_ = static_cast<int>((crr[dy][wi] >> sh) & 0xffff);
        const int yy = static_cast<int>(
            ((p < 4 ? yw.x : yw.y) >> (8 * (p & 3))) & 0xff);
        // jdcolor.c's ycc_rgb_convert, its - 128 folded into the sums
        r[p] = yy + ((91881 * v_ - 91881 * 128 + 32768) >> 16);
        g[p] = yy + ((-22554 * u_ - 46802 * v_
                      + (22554 + 46802) * 128 + 32768) >> 16);
        b[p] = yy + ((116130 * u_ - 116130 * 128 + 32768) >> 16);
      }
      store8(o, y, u,
             make_uint2(pack_sat4(r[0], r[1], r[2], r[3]),
                        pack_sat4(r[4], r[5], r[6], r[7])),
             make_uint2(pack_sat4(g[0], g[1], g[2], g[3]),
                        pack_sat4(g[4], g[5], g[6], g[7])),
             make_uint2(pack_sat4(b[0], b[1], b[2], b[3]),
                        pack_sat4(b[4], b[5], b[6], b[7])));
    }
  }
}

// Turn the staged window (luma rows [y0, y1), columns [x0, x1), as
// ``layout`` gave it) into RGB through ``sink`` (PlanarSink or
// InterleavedSink); every thread of the block takes a share. The caller
// synchronises before (the copies landed) and after.
template <bool kCv2, class Sink>
__device__ __forceinline__ void convert(const Frame& f, const Staged& st,
                                        const unsigned char* buf, int y0,
                                        int y1, int x0, int x1,
                                        const Sink& sink) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const View v0 = view(buf, st.s[0]);
  unsigned char rgb[3];
  if (!f.chroma()) {
    const bool grey = f.fmt == kFmtGray;
    for (int y = y0 + warp; y < y1; y += kWarps) {
      const unsigned char* p = v0.row(y);
      for (int x = x0 + lane; x < x1; x += 32) {
        if (grey) {
          rgb[0] = rgb[1] = rgb[2] = p[x];
        } else {
          rgb[0] = p[3 * x];
          rgb[1] = p[3 * x + 1];
          rgb[2] = p[3 * x + 2];
        }
        sink(y, x, rgb);
      }
    }
    return;
  }
  const bool fancy_h = f.hf == 2 && f.vf <= 2 && f.cw > 2;
  const bool fancy_v = f.vf == 2 && (f.hf == 1 || fancy_h);
  // planes at 16-byte aligned bases and pitches: no row skew beyond the
  // window's own offset in its first block
  bool aligned = true;
#pragma unroll
  for (int i = 0; i < 3; ++i)
    aligned = aligned && st.s[i].step == 0
              && st.s[i].skew0 == (st.s[i].lo & 15);
  if (fancy_h && fancy_v && f.colour == 0 && aligned) {
    convert_h2v2(f, st, buf, y0, y1, x0, x1, sink);
    return;
  }
  const View v1 = view(buf, st.s[1]), v2 = view(buf, st.s[2]);
  const View v3 = view(buf, st.s[st.n == 4 ? 3 : 0]);   // K where staged
  const bool four = st.n == 4;
  if (fancy_h && fancy_v) {
    // h2v2: a 2 x 2 block of luma shares one chroma sample; the sample and
    // its 8 neighbours (edges replicated) give the four upsampled values
    for (int by = (y0 >> 1) + warp; by <= ((y1 - 1) >> 1); by += kWarps) {
      const int rows[3] = {max(by - 1, 0), by, min(by + 1, f.ch - 1)};
      for (int bx = (x0 >> 1) + lane; bx <= ((x1 - 1) >> 1); bx += 32) {
        const int cols[3] = {max(bx - 1, 0), bx, min(bx + 1, f.cw - 1)};
        int cb[3][3], cr[3][3];
#pragma unroll
        for (int i = 0; i < 3; ++i)
#pragma unroll
          for (int j = 0; j < 3; ++j) {
            cb[i][j] = v1.at(rows[i], cols[j]);
            cr[i][j] = v2.at(rows[i], cols[j]);
          }
#pragma unroll
        for (int dy = 0; dy < 2; ++dy)
#pragma unroll
          for (int dx = 0; dx < 2; ++dx) {
            const int y = 2 * by + dy, x = 2 * bx + dx;
            if (y < y0 || y >= y1 || x < x0 || x >= x1) continue;
            const int oy = 2 * dy, ox = 2 * dx;    // the farther neighbours
            const int rnd = dx ? 7 : 8;
            const int u = (3 * (3 * cb[1][1] + cb[oy][1])
                           + 3 * cb[1][ox] + cb[oy][ox] + rnd) >> 4;
            const int v = (3 * (3 * cr[1][1] + cr[oy][1])
                           + 3 * cr[1][ox] + cr[oy][ox] + rnd) >> 4;
            to_rgb<kCv2>(f.colour, v0.at(y, x), u, v,
                         four ? v3.at(y, x) : 0, rgb);
            sink(y, x, rgb);
          }
      }
    }
    return;
  }
  for (int y = y0 + warp; y < y1; y += kWarps)
    for (int x = x0 + lane; x < x1; x += 32) {
      to_rgb<kCv2>(f.colour, v0.at(y, x),
                   upsample(v1, f, fancy_h, fancy_v, x, y),
                   upsample(v2, f, fancy_h, fancy_v, x, y),
                   four ? v3.at(y, x) : 0, rgb);
      sink(y, x, rgb);
    }
}

// Zero ``rows`` rows of ``bytes`` bytes in global memory, ``gpitch`` apart:
// a padded slot's output.
__device__ __forceinline__ void zero_rows(unsigned char* dst,
                                          long long gpitch, int rows,
                                          int bytes) {
  if (gpitch == bytes && (reinterpret_cast<uintptr_t>(dst) & 15) == 0
      && (rows * bytes) % 16 == 0) {
    uint4* d = reinterpret_cast<uint4*>(dst);
    for (int i = threadIdx.x; i < rows * bytes / 16; i += kThreads)
      d[i] = make_uint4(0, 0, 0, 0);
    return;
  }
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int r = warp; r < rows; r += kWarps)
    for (int b = lane; b < bytes; b += 32) dst[r * gpitch + b] = 0;
}

// 16 bytes of a shared-memory row from byte ``at`` (any alignment; reads
// the aligned words around them).
__device__ __forceinline__ uint4 lds128_at(const unsigned char* row,
                                           int at) {
  if ((at & 15) == 0) return *reinterpret_cast<const uint4*>(row + at);
  const unsigned* w = reinterpret_cast<const unsigned*>(row + (at & ~3));
  const unsigned s = 8 * (at & 3);
  const unsigned w0 = w[0], w1 = w[1], w2 = w[2], w3 = w[3], w4 = w[4];
  return make_uint4(__funnelshift_r(w0, w1, s), __funnelshift_r(w1, w2, s),
                    __funnelshift_r(w2, w3, s), __funnelshift_r(w3, w4, s));
}

// The output rows from an interleaved tile: ``rows`` rows of ``bytes``
// bytes, from byte ``at`` of each tile row (``pitch`` bytes apart) to
// global rows ``gpitch`` bytes apart; consecutive threads on consecutive
// 16-byte pieces where the rows allow it (one aligned piece after another
// on the global side), else a warp a row, byte by byte. The tile keeps 16
// bytes beyond its last row for the unaligned reads.
__device__ __forceinline__ void store_rows(unsigned char* dst,
                                           long long gpitch,
                                           const unsigned char* src,
                                           int pitch, int at, int rows,
                                           int bytes) {
  if ((bytes & 15) == 0 && (gpitch & 15) == 0
      && (reinterpret_cast<uintptr_t>(dst) & 15) == 0) {
    const int per_row = bytes >> 4;
    for (int i = threadIdx.x; i < rows * per_row; i += kThreads) {
      const int r = i / per_row, q = i - r * per_row;
      *reinterpret_cast<uint4*>(dst + r * gpitch + 16 * q) =
          lds128_at(src + r * pitch, at + 16 * q);
    }
    return;
  }
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int r = warp; r < rows; r += kWarps)
    for (int b = lane; b < bytes; b += 32)
      dst[r * gpitch + b] = src[r * pitch + at + b];
}

}  // namespace hmmc_planes
