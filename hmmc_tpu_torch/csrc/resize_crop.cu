// R1: JPEG planes or RGB frames -> short-side bicubic resize + center crop,
// bit for bit as PIL (libjpeg's upsampling and colour conversion, then
// Pillow's 8-bit resampler, libImaging/Resample.c) computes them.
//
// Replaces a host step, not a TPU kernel: the PIL decode tail, resize and
// crop of hmmc_tpu/data/datasets.py:36-61 (_decode_eval). nvJPEG hands over
// each frame's components as encoded; stage 0 (jpeg_planes.cuh, shared with
// R2) does what libjpeg does after its IDCT, ending CMYK and YCCK frames
// with Pillow's cmyk2rgb. Then Pillow's two passes, horizontal into a uint8
// intermediate and vertical, with taps from the host (ops/resize_crop.py:
// pil_coeffs, Pillow's double arithmetic and 22-bit fixed point). It equals
// the plain version (resize_crop_reference after ycc_to_rgb_reference) bit
// for bit.
//
// Bound: bytes. At the eval path's 341x256 -> 224 a frame moves ~250 KB
// (the planes the crop reads, once, and the crop written once) for ~1.47 M
// multiply-adds of the taps (3 channels, ~4.6 taps a pass). The taps are
// exact integers, so they run on the int8 tensor cores: 768 frames take
// 0.058 ms at 3.35 TB/s against 0.0011 ms of int8 operations at 1979 TOPS.
//
// Design. Taps on the tensor cores, exactly: a tap t (22 fractional bits,
// in [-2^23, 2^23)) is three byte limbs, t = t0 + 2^8 t1 + 2^16 t2 with t0,
// t1 unsigned and t2 signed, so a pass is three banded integer matrix
// products (mma.sync m16n8k32, .u8 x .u8 and .s8 x .u8, int32 sums, exact),
// and S0 + (S1 << 8) + (S2 << 16) + 2^21 is Pillow's sum bit for bit (the
// true sum fits in int32, so wrap-around cannot matter; S0 starts at
// 2^21). In both passes A is the tap band of 16 outputs (K a multiple of
// 32 source columns or rows from the band's base) and B is 8 columns of
// pixels: the horizontal pass's D is (output column, source row), two rows
// of a column a lane, stored as one 16-bit word into a ring of
// intermediate rows kept column-major (so the vertical pass's B, four rows
// of a column, is one 32-bit load); the vertical pass's D is (output row,
// output column), two columns of three channels a lane, three 16-bit
// stores into an interleaved output tile. The host lays the limbs out as
// the fragments the lanes load (ops/resize_crop.py: mma_tables).
// Persistent CTAs walk the (frame, strip of 16-column tiles, band of
// 16-row m-tiles) work list; a CTA goes down its item in chunks of 16
// source rows: stage 0 stages the chunk's planes (the next chunk's copies
// are issued first, into the second buffer) and converts them into three
// RGB byte planes while the horizontal pass adds the previous chunk to the
// ring (two RGB buffers, one barrier interval for both). Once
// the ring holds the rows a band of 16 output rows reads, the vertical
// pass fills the output tile, which leaves in coalesced 16-byte stores.
// Every source row is converted and filtered once (no halo); a CTA at the
// path's geometry takes ~77 KB and 128 registers a thread, two to an SM
// (at 80 registers, three fit and spill, and run slower). A padded slot
// writes zeros.
//
// Descriptor (int64, on the device; the C entry passes its head to the
// kernel by value): a head of 16 words
//   {n_geom, n_frames, res, strip_ct, n_strips, band_mt, n_bands, ring,
//    ring_pitch, rgb_pitch, raw_bytes, rgb_bytes, tile_pitch, 0, 0, 0}
// then G geometries of 8 words {tables pointer, w, h, ks_h, ks_v, 0, 0, 0}
// then N frames of 10 words (jpeg_planes.cuh). An item is (frame, strip of
// strip_ct 16-column tiles, band of band_mt 16-row m-tiles). A geometry's
// table (int32, n_t = ceil(res / 16) tiles each way):
//   [kb_h(n_t), xend_h(n_t), kb_v(n_t), ylo(n_t), yhi(n_t), pad to 4,
//    ah(n_t x ks_h x 3 limbs x 32 lanes x 4 words),
//    av(n_t x ks_v x 3 limbs x 32 lanes x 4 words)]
// kb_h / kb_v: the first source column / row of each band (a multiple of
// 4); xend_h: the end of the columns a column tile's taps reach; ylo, yhi:
// the source rows an m-tile's taps reach.

#include <cuda_runtime.h>

#include <cstdint>

#include "jpeg_planes.cuh"

namespace {

using hmmc_planes::kThreads;
using hmmc_planes::kWarps;
using hmmc_planes::lds32;

constexpr int kPrecisionBits = 22;
constexpr int kChunk = 16;          // source rows staged and filtered at once
constexpr int kHeadWords = 16;
constexpr int kGeomWords = 8;
constexpr int kMaxDevices = 64;

// The launch's head (the descriptor's first 16 words), passed by value: it
// stays in the kernel's parameter space, read where it is used.
struct Params {
  const long long* geoms;
  const long long* frames;
  unsigned char* out;
  int n_items, res, n_t, strip_ct, n_strips, band_mt, n_bands, ring,
      ring_pitch, rgb_pitch, raw_bytes, rgb_bytes, tile_pitch;
};

// A geometry: its table and sizes. The table's parts by tile index:
// kb_h [0, n_t), xend_h [n_t, 2 n_t), kb_v, ylo, yhi, then the fragments.
struct Geom {
  const int* tab;
  int w, h, ks_h, ks_v;
};

__device__ __forceinline__ Geom read_geom(const Params& P, long long index) {
  const long long* g = P.geoms + kGeomWords * index;
  return Geom{reinterpret_cast<const int*>(g[0]), static_cast<int>(g[1]),
              static_cast<int>(g[2]), static_cast<int>(g[3]),
              static_cast<int>(g[4])};
}

__device__ __forceinline__ int tab_at(const Params& P, const Geom& g,
                                      int part, int i) {
  return __ldg(g.tab + part * P.n_t + i);
}

enum { kKbH = 0, kXendH = 1, kKbV = 2, kYlo = 3, kYhi = 4 };

__device__ __forceinline__ const uint4* frag_h(const Params& P,
                                               const Geom& g) {
  return reinterpret_cast<const uint4*>(g.tab + ((5 * P.n_t + 3) & ~3));
}

__device__ __forceinline__ const uint4* frag_v(const Params& P,
                                               const Geom& g) {
  return frag_h(P, g) + P.n_t * g.ks_h * 96;
}

// One work item: a frame's m-tiles [i0, i1) and column tiles [j0, j1), the
// source columns [xo, xe) it converts (xo 16-aligned), its chunks' first
// row (origin) and how many chunks it stages (0: a padded slot).
struct Work {
  int frame, i0, i1, j0, j1, xo, xe, origin, chunks, geom;
};

__device__ __forceinline__ const long long* frame_row(const Params& P,
                                                      int frame) {
  return P.frames + hmmc_planes::kFrameWords * static_cast<long long>(frame);
}

__device__ __forceinline__ Work make_work(const Params& P, int item) {
  const int per_frame = P.n_strips * P.n_bands;
  Work k;
  k.frame = item / per_frame;
  const int rem = item - k.frame * per_frame;
  const int strip = rem / P.n_bands;
  const int band = rem - strip * P.n_bands;
  k.j0 = strip * P.strip_ct;
  k.j1 = min(k.j0 + P.strip_ct, P.n_t);
  k.i0 = band * P.band_mt;
  k.i1 = min(k.i0 + P.band_mt, P.n_t);
  const long long* row = frame_row(P, k.frame);
  k.chunks = 0;
  k.geom = static_cast<int>(row[2]);
  if (row[3] < 0) return k;
  const Geom g = read_geom(P, k.geom);
  k.xo = tab_at(P, g, kKbH, k.j0) & ~15;
  k.xe = min(tab_at(P, g, kXendH, k.j1 - 1), g.w);
  k.origin = tab_at(P, g, kYlo, k.i0) & ~3;
  k.chunks = (tab_at(P, g, kYhi, k.i1 - 1) - k.origin + kChunk - 1) / kChunk;
  return k;
}

// Issue the copies of chunk c of ``item`` into ``raw``.
__device__ __forceinline__ void issue_chunk(const Params& P, int item, int c,
                                            unsigned char* raw) {
  const Work k = make_work(P, item);
  const Geom g = read_geom(P, k.geom);
  const int y0 = k.origin + c * kChunk, y1 = min(y0 + kChunk, g.h);
  if (y0 >= y1) return;
  const hmmc_planes::Frame f =
      hmmc_planes::load_frame(frame_row(P, k.frame), g.w, g.h);
  hmmc_planes::stage(f, hmmc_planes::layout(f, y0, y1, k.xo, k.xe), raw);
}

// Advance the staging cursor (item, c of its ``chunks``) to the next chunk
// this CTA stages: the next chunk of the item, else chunk 0 of its next
// item that is not a padded slot.
__device__ __forceinline__ void next_chunk(const Params& P, int& item, int& c,
                                           int& chunks) {
  if (++c < chunks) return;
  c = 0;
  for (item += gridDim.x; item < P.n_items; item += gridDim.x) {
    chunks = make_work(P, item).chunks;
    if (chunks) return;
  }
}

__device__ __forceinline__ void mma_uu(int (&d)[4], const unsigned (&a)[4],
                                       unsigned b0, unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.u8.u8.s32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void mma_us(int (&d)[4], const unsigned (&a)[4],
                                       unsigned b0, unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.u8.s8.s32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void mma_su(int (&d)[4], const unsigned (&a)[4],
                                       unsigned b0, unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.u8.s32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Pillow's clip8 of the limbs' sums (S0 started at 2^21): the sum wraps
// as int32 would, and the true value fits.
__device__ __forceinline__ int limb_sum(const int (&s)[3][4], int q) {
  return static_cast<int>(static_cast<unsigned>(s[0][q])
                          + (static_cast<unsigned>(s[1][q]) << 8)
                          + (static_cast<unsigned>(s[2][q]) << 16))
         >> kPrecisionBits;
}

// Two outputs of a lane, clipped as clip8, as a 16-bit word: lo first.
__device__ __forceinline__ unsigned short clip_pair(const int (&s)[3][4],
                                                    int lo, int hi) {
  return static_cast<unsigned short>(
      hmmc_planes::pack_sat2(limb_sum(s, hi), limb_sum(s, lo), 0u));
}

__device__ __forceinline__ void limb_mma(int (&acc)[3][4], const uint4& a0,
                                         const uint4& a1, const uint4& a2,
                                         unsigned b0, unsigned b1) {
  const unsigned x0[4] = {a0.x, a0.y, a0.z, a0.w};
  const unsigned x1[4] = {a1.x, a1.y, a1.z, a1.w};
  const unsigned x2[4] = {a2.x, a2.y, a2.z, a2.w};
  mma_uu(acc[0], x0, b0, b1);
  mma_uu(acc[1], x1, b0, b1);
  mma_su(acc[2], x2, b0, b1);
}

// Horizontal pass of one chunk (source rows row0 .. row0 + 15): rgb [3
// planes][16 rows][rgb_pitch] from column xo -> ring [3][strip columns]
// [ring_pitch], row r at slot r mod ring. A warp takes a column tile, its
// first k-step's tap fragments in registers, against both 8-row halves of
// the chunk in three channels.
__device__ __forceinline__ void hpass(const Params& L, const Geom& g,
                                      const Work& k, int row0,
                                      const unsigned char* rgb,
                                      unsigned char* ring, int strip_cols) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int gi = lane >> 2, t = lane & 3;
  const int P = L.rgb_pitch, RP = L.ring_pitch;
  int slot[2];
  slot[0] = row0 % L.ring + 2 * t;
  if (slot[0] >= L.ring) slot[0] -= L.ring;
  slot[1] = slot[0] + 8;
  if (slot[1] >= L.ring) slot[1] -= L.ring;
  // tiles from the last warp down: the first warps take the conversion's
  // remainder in the same interval (convert_chunk)
  for (int jl = kWarps - 1 - warp; jl < k.j1 - k.j0; jl += kWarps) {
    const int j = k.j0 + jl;
    const uint4* af = frag_h(L, g) + j * g.ks_h * 96 + lane;
    const uint4 f0 = __ldg(af), f1 = __ldg(af + 32), f2 = __ldg(af + 64);
    const unsigned char* p = rgb + gi * P + (tab_at(L, g, kKbH, j) - k.xo)
                             + 4 * t;
    unsigned char* col = ring + (jl * 16 + gi) * RP;
#pragma unroll
    for (int c = 0; c < 3; ++c)
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const unsigned char* q = p + (c * kChunk + 8 * half) * P;
        int acc[3][4] = {{1 << (kPrecisionBits - 1), 1 << (kPrecisionBits - 1),
                          1 << (kPrecisionBits - 1), 1 << (kPrecisionBits - 1)},
                         {0, 0, 0, 0}, {0, 0, 0, 0}};
        limb_mma(acc, f0, f1, f2, lds32(q), lds32(q + 16));
        for (int s = 1; s < g.ks_h; ++s) {
          const uint4* as = af + s * 96;
          limb_mma(acc, __ldg(as), __ldg(as + 32), __ldg(as + 64),
                   lds32(q + 32 * s), lds32(q + 32 * s + 16));
        }
        // D: (column gi, rows 2t, 2t + 1), (column gi + 8, the same rows)
        unsigned char* cc = col + c * strip_cols * RP + slot[half];
        *reinterpret_cast<unsigned short*>(cc) = clip_pair(acc, 0, 1);
        *reinterpret_cast<unsigned short*>(cc + 8 * RP) = clip_pair(acc, 2, 3);
      }
  }
}

// Vertical pass of m-tile i: the ring -> the output tile, 16 rows of
// interleaved RGB tile_pitch bytes apart (from the strip's first column).
// A warp takes 8-column
// n-tiles, the three channels at once (nine independent products); the
// m-tile's first k-step tap fragments stay in registers.
__device__ __forceinline__ void vpass(const Params& L, const Geom& g,
                                      const Work& k, int i,
                                      const unsigned char* ring,
                                      unsigned char* tile, int strip_cols) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int gi = lane >> 2, t = lane & 3;
  const int R = L.ring, RP = L.ring_pitch, TP = L.tile_pitch;
  const int kb = tab_at(L, g, kKbV, i) % R;
  const uint4* af = frag_v(L, g) + i * g.ks_v * 96 + lane;
  const uint4 f0 = __ldg(af), f1 = __ldg(af + 32), f2 = __ldg(af + 64);
  for (int jl = warp; jl < 2 * (k.j1 - k.j0); jl += kWarps) {
    const unsigned char* col = ring + (jl * 8 + gi) * RP;
    int acc[3][3][4];
#pragma unroll
    for (int c = 0; c < 3; ++c)
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        acc[c][0][q] = 1 << (kPrecisionBits - 1);
        acc[c][1][q] = acc[c][2][q] = 0;
      }
    for (int s = 0; s < g.ks_v; ++s) {
      int o0 = kb + 32 * s + 4 * t;
      if (o0 >= R) o0 -= R;
      int o1 = kb + 32 * s + 16 + 4 * t;
      if (o1 >= R) o1 -= R;
      uint4 x0 = f0, x1 = f1, x2 = f2;
      if (s > 0) {
        const uint4* as = af + s * 96;
        x0 = __ldg(as);
        x1 = __ldg(as + 32);
        x2 = __ldg(as + 64);
      }
#pragma unroll
      for (int c = 0; c < 3; ++c) {
        const unsigned char* cc = col + c * strip_cols * RP;
        limb_mma(acc[c], x0, x1, x2, lds32(cc + o0), lds32(cc + o1));
      }
    }
    // D: (row gi, columns 2t, 2t + 1), (row gi + 8, the same columns):
    // six interleaved bytes a row, three 16-bit stores
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      unsigned short* o = reinterpret_cast<unsigned short*>(
          tile + (gi + 8 * h) * TP + 24 * jl + 6 * t);
      const int q = 2 * h;
      o[0] = static_cast<unsigned short>(hmmc_planes::pack_sat2(
          limb_sum(acc[1], q), limb_sum(acc[0], q), 0u));
      o[1] = static_cast<unsigned short>(hmmc_planes::pack_sat2(
          limb_sum(acc[0], q + 1), limb_sum(acc[2], q), 0u));
      o[2] = static_cast<unsigned short>(hmmc_planes::pack_sat2(
          limb_sum(acc[2], q + 1), limb_sum(acc[1], q + 1), 0u));
    }
  }
}

// Stage 0 of chunk c of item k: its staged planes (raw) -> the three RGB
// planes (rgb), rows from the chunk's first. Not inlined: in line with the
// horizontal pass of the same interval its registers spill at 128 a thread
// and R1 ran slower.
__device__ __noinline__ void convert_chunk(const Params& P, const Geom& g,
                                              const Work& k, int c,
                                              const unsigned char* raw,
                                              unsigned char* rgb) {
  const int y0 = k.origin + c * kChunk, y1 = min(y0 + kChunk, g.h);
  if (y0 >= y1) return;
  const hmmc_planes::Frame f =
      hmmc_planes::load_frame(frame_row(P, k.frame), g.w, g.h);
  hmmc_planes::convert<false>(
      f, hmmc_planes::layout(f, y0, y1, k.xo, k.xe), raw, y0, y1, k.xo,
      k.xe,
      hmmc_planes::PlanarSink{rgb, kChunk * P.rgb_pitch, P.rgb_pitch, y0,
                              k.xo});
}

__global__ void __launch_bounds__(kThreads, 2)
resize_crop_kernel(const __grid_constant__ Params P) {
  extern __shared__ __align__(16) unsigned char smem[];
  unsigned char* const raw0 = smem;              // two staging buffers
  unsigned char* const rgb0 = smem + 2 * P.raw_bytes;   // two RGB buffers,
  unsigned char* const ring = rgb0 + 2 * P.rgb_bytes;   // the free one also
  const int strip_cols = 16 * P.strip_ct;                // the output tile
  const long long out_row = 3LL * P.res;

  // the staging cursor: the chunk whose copies were issued last; ``buf``
  // the staging buffer of the next chunk to convert
  int p_item = static_cast<int>(blockIdx.x) - static_cast<int>(gridDim.x);
  int p_c = 0, p_chunks = 0;
  next_chunk(P, p_item, p_c, p_chunks);
  if (p_item < P.n_items) issue_chunk(P, p_item, p_c, raw0);
  hmmc_planes::cp_async_commit();
  int buf = 0;

  // Wait for the next chunk's planes (issuing the one after) and make them,
  // and everything written before, visible to the block.
  auto stage_next = [&]() {
    next_chunk(P, p_item, p_c, p_chunks);
    if (p_item < P.n_items)
      issue_chunk(P, p_item, p_c, raw0 + (buf ^ 1) * P.raw_bytes);
    hmmc_planes::cp_async_commit();
    hmmc_planes::cp_async_wait<1>();
    __syncthreads();
  };

  for (int item = blockIdx.x; item < P.n_items; item += gridDim.x) {
    const Work k = make_work(P, item);
    const int r0 = 16 * k.i0, c0 = 16 * k.j0;
    const int cols = min(16 * k.j1, P.res) - c0;
    unsigned char* dst = P.out
                         + (static_cast<long long>(k.frame) * P.res + r0)
                           * out_row + 3 * c0;
    if (k.chunks == 0) {                            // padded slot: zeros
      hmmc_planes::zero_rows(dst, out_row, min(16 * k.i1, P.res) - r0,
                             3 * cols);
      continue;
    }
    const Geom g = read_geom(P, k.geom);
    // A software pipeline over the item's chunks: chunk 0 is converted
    // alone, then each interval converts chunk ``conv`` into one RGB
    // buffer while the horizontal pass filters chunk ``filt`` = conv - 1
    // from the other; two barriers an interval.
    stage_next();
    convert_chunk(P, g, k, 0, raw0 + buf * P.raw_bytes, rgb0);
    buf ^= 1;
    __syncthreads();     // chunk 0's staging buffer is the next one to fill
    int conv = 1, filt = 0;
    for (int i = k.i0; i < k.i1; ++i) {
      const int need =
          (tab_at(P, g, kYhi, i) - k.origin + kChunk - 1) / kChunk;
      for (; filt < need; ++filt) {
        if (conv < k.chunks) {
          stage_next();
          convert_chunk(P, g, k, conv, raw0 + buf * P.raw_bytes,
                        rgb0 + (conv & 1) * P.rgb_bytes);
        } else {
          __syncthreads();
        }
        hpass(P, g, k, k.origin + filt * kChunk,
              rgb0 + (filt & 1) * P.rgb_bytes, ring, strip_cols);
        __syncthreads();
        if (conv < k.chunks) {
          ++conv;
          buf ^= 1;
        }
      }
      // the buffer of the chunk filtered last is free until the next
      // interval converts into it
      unsigned char* tile = rgb0 + ((filt - 1) & 1) * P.rgb_bytes;
      vpass(P, g, k, i, ring, tile, strip_cols);
      __syncthreads();
      hmmc_planes::store_rows(dst + (16 * (i - k.i0)) * out_row, out_row,
                              tile, P.tile_pitch, 0, min(16, P.res - 16 * i),
                              3 * cols);
      __syncthreads();
    }
  }
  hmmc_planes::cp_async_wait<0>();
}

// per device: the dynamic shared memory the kernel may take, the SM count
// and the CTAs an SM fits at the last size asked for
struct DeviceState {
  int smem_set, sms, occ_smem, occ_ctas;
};
DeviceState g_device[kMaxDevices];

int persistent_ctas(int smem_bytes, int* ctas) {
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return static_cast<int>(e);
  if (dev >= kMaxDevices) return static_cast<int>(cudaErrorInvalidDevice);
  DeviceState& s = g_device[dev];
  if (smem_bytes > s.smem_set) {
    e = cudaFuncSetAttribute(resize_crop_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             smem_bytes);
    if (e != cudaSuccess) return static_cast<int>(e);
    s.smem_set = smem_bytes;
  }
  if (s.sms == 0) {
    e = cudaDeviceGetAttribute(&s.sms, cudaDevAttrMultiProcessorCount, dev);
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  if (s.occ_ctas == 0 || s.occ_smem != smem_bytes) {
    int n = 0;
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &n, resize_crop_kernel, kThreads, smem_bytes);
    if (e != cudaSuccess) return static_cast<int>(e);
    if (n <= 0) return static_cast<int>(cudaErrorLaunchOutOfResources);
    s.occ_smem = smem_bytes;
    s.occ_ctas = n;
  }
  *ctas = s.sms * s.occ_ctas;
  return 0;
}

}  // namespace

extern "C" {

const char* hmmc_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// CTAs of the persistent grid on the current device at ``smem_bytes``.
int hmmc_resize_crop_ctas(int smem_bytes, int* ctas) {
  return persistent_ctas(smem_bytes, ctas);
}

// desc: device int64 descriptor (above); head: its first 16 words on the
// host; n_items work items; out: device uint8 [N, res, res, 3]; grid: the
// CTAs launched (at most one an item).
int hmmc_resize_crop(const long long* desc, const long long* head,
                     int n_items, int smem_bytes, void* out, void* stream,
                     int* grid) {
  *grid = 0;
  if (n_items <= 0) return 0;
  int ctas = 0;
  const int err = persistent_ctas(smem_bytes, &ctas);
  if (err != 0) return err;
  Params p;
  p.geoms = desc + kHeadWords;
  p.frames = p.geoms + kGeomWords * head[0];
  p.out = static_cast<unsigned char*>(out);
  p.n_items = n_items;
  p.res = static_cast<int>(head[2]);
  p.n_t = (p.res + 15) >> 4;
  p.strip_ct = static_cast<int>(head[3]);
  p.n_strips = static_cast<int>(head[4]);
  p.band_mt = static_cast<int>(head[5]);
  p.n_bands = static_cast<int>(head[6]);
  p.ring = static_cast<int>(head[7]);
  p.ring_pitch = static_cast<int>(head[8]);
  p.rgb_pitch = static_cast<int>(head[9]);
  p.raw_bytes = static_cast<int>(head[10]);
  p.rgb_bytes = static_cast<int>(head[11]);
  p.tile_pitch = static_cast<int>(head[12]);
  *grid = ctas < n_items ? ctas : n_items;
  resize_crop_kernel<<<*grid, kThreads, smem_bytes,
                       static_cast<cudaStream_t>(stream)>>>(p);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
