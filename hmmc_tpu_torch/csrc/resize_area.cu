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
//   mode 3, copy (the size does not change): the crop of the converted
//     frame;
//   mode 0, integer factors: box sums, rounded (sum + 2) >> 2 at 2 x 2 and
//     rint(float(sum) * (1.f / area)) otherwise;
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
// Bound: bytes. The pretrain's 341x256 store frames take the copy path:
// 768 frames read 31 MB of 4:2:0 planes and write 151 MB of crops, 0.068
// ms at 3.35 TB/s; a 640x360 frame -> 256 x 256 (area) reads ~345 KB and
// writes 196 KB for ~1.2 M multiply-adds, under the H100's integer and
// fp32 rates by a factor of ~50. Design: persistent CTAs walk the (frame,
// band of tiles of output rows) work list, a band's tiles in turn; stage 0
// stages the planes a tile reads (the next tile's copies are issued first,
// into the second buffer). On the copy path stage 0 converts straight into
// the tile's output rows, interleaved RGB in shared memory: no pass, no
// 4-byte intermediate (30-row tiles: 15 x 33 units of 8 x 2 pixels fill
// two passes of the 256 threads). On the other paths it converts into
// three RGB byte planes, the horizontal pass fills three planes of 4-byte
// sums (int32, or fp32 on the area path) for the cropped columns, and the
// vertical pass the output tile. The tile leaves in coalesced 16-byte
// stores. A padded slot writes zeros.
//
// Descriptor (int64, on the device; the C entry passes its head to the
// kernel by value): a head of 16 words
//   {n_geom, n_frames, size, tile_rows, n_tiles, rows (the most source rows
//    a tile reads), rgb_pitch, raw_bytes, rgb_bytes, tmp_bytes, tile_pitch,
//    band_tiles, n_bands, 0, 0, 0}
// then G geometries of 12 words
//   {tables pointer, kh, kv, w, h, first staged column, end column, mode,
//    2 x 2 shift rounding, bits of 1.f / area, 0, 0}
// then N frames of 10 words (jpeg_planes.cuh). A geometry's int32 table is
//   [x_first(size), x_count(size), y_first(size), y_count(size),
//    x_w(size * kh), y_w(size * kv)]   (float bits in mode 1).

#include <cuda_runtime.h>

#include <cstdint>

#include "jpeg_planes.cuh"

namespace {

using hmmc_planes::kThreads;
using hmmc_planes::kWarps;

constexpr int kHeadWords = 16;
constexpr int kGeomWords = 12;
constexpr int kCopy = 3;
constexpr int kMaxDevices = 64;

__device__ __forceinline__ unsigned char sat8(int v) {
  return static_cast<unsigned char>(v < 0 ? 0 : (v > 255 ? 255 : v));
}

// The launch's head (the descriptor's first 16 words), passed by value: it
// stays in the kernel's parameter space, read where it is used.
struct Params {
  const long long* geoms;
  const long long* frames;
  unsigned char* out;
  int n_items, size, tile_rows, n_tiles, rows, rgb_pitch, raw_bytes,
      rgb_bytes, tmp_bytes, tile_pitch, band_tiles, n_bands;
};

// A geometry's words: its table (x_first, x_count, y_first, y_count by
// output index, then x_w and y_w) and sizes.
struct Geom {
  const int* tab;
  int kh, kv, w, h, xs, xe, mode;
};

__device__ __forceinline__ Geom read_geom(const Params& L, long long index) {
  const long long* g = L.geoms + kGeomWords * index;
  return Geom{reinterpret_cast<const int*>(g[0]), static_cast<int>(g[1]),
              static_cast<int>(g[2]), static_cast<int>(g[3]),
              static_cast<int>(g[4]), static_cast<int>(g[5]),
              static_cast<int>(g[6]), static_cast<int>(g[7])};
}

enum { kXFirst = 0, kXCount = 1, kYFirst = 2, kYCount = 3 };

__device__ __forceinline__ int tab_at(const Params& L, const Geom& g,
                                      int part, int i) {
  return __ldg(g.tab + part * L.size + i);
}

// One work item: tiles [t0, t1) of a frame (padded: the frame's row holds
// format -1).
struct Work {
  int frame, t0, t1, geom;
  bool padded;
};

// A tile's output rows [r0, r1) and the source rows [ys, ye) they read.
struct Tile {
  int r0, r1, ys, ye;
};

__device__ __forceinline__ const long long* frame_row(const Params& L,
                                                      int frame) {
  return L.frames + hmmc_planes::kFrameWords * static_cast<long long>(frame);
}

__device__ __forceinline__ Work make_work(const Params& L, int item) {
  Work k;
  k.frame = item / L.n_bands;
  k.t0 = (item - k.frame * L.n_bands) * L.band_tiles;
  k.t1 = min(k.t0 + L.band_tiles, L.n_tiles);
  const long long* row = frame_row(L, k.frame);
  k.geom = static_cast<int>(row[2]);
  k.padded = row[3] < 0;
  return k;
}

__device__ __forceinline__ Tile tile_rows(const Params& L, const Geom& g,
                                          int tile) {
  Tile t;
  t.r0 = tile * L.tile_rows;
  t.r1 = min(t.r0 + L.tile_rows, L.size);
  t.ys = tab_at(L, g, kYFirst, t.r0);
  t.ye = min(tab_at(L, g, kYFirst, t.r1 - 1) + tab_at(L, g, kYCount, t.r1 - 1),
             g.h);
  return t;
}

// Issue the copies of the c-th tile of ``item`` into ``raw``.
__device__ __forceinline__ void issue_tile(const Params& L, int item, int c,
                                           unsigned char* raw) {
  const Work k = make_work(L, item);
  const Geom g = read_geom(L, k.geom);
  const Tile t = tile_rows(L, g, k.t0 + c);
  const hmmc_planes::Frame f =
      hmmc_planes::load_frame(frame_row(L, k.frame), g.w, g.h);
  hmmc_planes::stage(f, hmmc_planes::layout(f, t.ys, t.ye, g.xs, g.xe), raw);
}

// Advance the staging cursor (item, c of its ``tiles``) to the next tile
// this CTA stages: the item's next, else the first of its next item that
// is not a padded slot.
__device__ __forceinline__ void next_tile(const Params& L, int& item, int& c,
                                          int& tiles) {
  if (++c < tiles) return;
  c = 0;
  for (item += gridDim.x; item < L.n_items; item += gridDim.x) {
    const Work k = make_work(L, item);
    tiles = k.padded ? 0 : k.t1 - k.t0;
    if (tiles) return;
  }
}

// Horizontal pass: the tile's staged rows x the cropped columns, from the
// three RGB planes [rows][rgb_pitch] (column 0 = source column xs & ~15)
// into three planes of 4-byte sums [rows][size]. A thread a column, down
// the rows.
__device__ __forceinline__ void hpass(const Params& L, const Geom& g,
                                      int n_rows, const unsigned char* rgb,
                                      int* tmp) {
  const int P = L.rgb_pitch, plane = L.rows * P;
  const int tplane = L.rows * L.size;
  const int* xw = g.tab + 4 * L.size;
  for (int c = threadIdx.x; c < L.size; c += kThreads) {
    const int first = tab_at(L, g, kXFirst, c) - (g.xs & ~15);
    const int n = tab_at(L, g, kXCount, c);
    const int* k = xw + c * g.kh;
    for (int rr = 0; rr < n_rows; ++rr) {
      const unsigned char* p = rgb + rr * P + first;
      int* q = tmp + rr * L.size + c;
      if (g.mode == 1) {
        float s0 = 0.f, s1 = 0.f, s2 = 0.f;
        for (int t = 0; t < n; ++t) {
          const float a = __int_as_float(__ldg(k + t));
          s0 = __fadd_rn(s0, __fmul_rn(static_cast<float>(p[t]), a));
          s1 = __fadd_rn(s1, __fmul_rn(static_cast<float>(p[plane + t]), a));
          s2 = __fadd_rn(s2,
                         __fmul_rn(static_cast<float>(p[2 * plane + t]), a));
        }
        q[0] = __float_as_int(s0);
        q[tplane] = __float_as_int(s1);
        q[2 * tplane] = __float_as_int(s2);
      } else {
        int s0 = 0, s1 = 0, s2 = 0;
        for (int t = 0; t < n; ++t) {
          const int a = __ldg(k + t);
          s0 += static_cast<int>(p[t]) * a;
          s1 += static_cast<int>(p[plane + t]) * a;
          s2 += static_cast<int>(p[2 * plane + t]) * a;
        }
        q[0] = s0;
        q[tplane] = s1;
        q[2 * tplane] = s2;
      }
    }
  }
}

// Vertical pass: output rows [r0, r1) of the tile -> ``tile``, interleaved
// RGB rows tile_pitch bytes apart. A row at a time, a thread a column.
__device__ __forceinline__ void vpass(const Params& L, const Geom& g,
                                      const Work& k, const Tile& tr,
                                      const int* tmp, unsigned char* tile) {
  const long long* gw = L.geoms + kGeomWords * k.geom;
  const bool shift = gw[8] != 0;
  const float inv_area = __int_as_float(static_cast<int>(gw[9]));
  const int* yw = g.tab + 4 * L.size + L.size * g.kh;
  const int tplane = L.rows * L.size;
  for (int rr = 0; rr < tr.r1 - tr.r0; ++rr) {
    const int r = tr.r0 + rr;
    const int first = tab_at(L, g, kYFirst, r);
    const int n = tab_at(L, g, kYCount, r);
    const int* w = yw + r * g.kv;
    for (int c = threadIdx.x; c < L.size; c += kThreads) {
      unsigned char* o = tile + rr * L.tile_pitch + 3 * c;
#pragma unroll
      for (int ch = 0; ch < 3; ++ch) {
        const int* q = tmp + ch * tplane + c;
        int v;
        if (g.mode == 1) {
          float s = 0.f;
          for (int t = 0; t < n; ++t) {
            const int row = min(first + t, g.h - 1) - tr.ys;
            s = __fadd_rn(s, __fmul_rn(__int_as_float(__ldg(w + t)),
                                       __int_as_float(q[row * L.size])));
          }
          v = __float2int_rn(s);
        } else if (g.mode == 0) {
          int s = 0;
          for (int t = 0; t < n; ++t) s += q[(first + t - tr.ys) * L.size];
          v = shift ? (s + 2) >> 2
                    : __float2int_rn(__fmul_rn(static_cast<float>(s),
                                               inv_area));
        } else {
          const int h0 = q[(first - tr.ys) * L.size] >> 4;
          const int h1 = q[(min(first + 1, g.h - 1) - tr.ys) * L.size] >> 4;
          v = (((h0 * __ldg(w)) >> 16) + ((h1 * __ldg(w + 1)) >> 16) + 2)
              >> 2;
        }
        o[ch] = sat8(v);
      }
    }
  }
}

__global__ void __launch_bounds__(kThreads, 2)
resize_area_kernel(const __grid_constant__ Params L) {
  extern __shared__ __align__(16) unsigned char smem[];
  unsigned char* raw[2] = {smem, smem + L.raw_bytes};
  unsigned char* rgb = smem + 2 * L.raw_bytes;
  int* tmp = reinterpret_cast<int*>(rgb + L.rgb_bytes);
  unsigned char* tile = reinterpret_cast<unsigned char*>(tmp)
                        + L.tmp_bytes;
  const int row_bytes = 3 * L.size;

  // the staging cursor: the tile whose copies were issued last
  int p_item = static_cast<int>(blockIdx.x) - static_cast<int>(gridDim.x);
  int p_c = 0, p_tiles = 0;
  next_tile(L, p_item, p_c, p_tiles);
  if (p_item < L.n_items) issue_tile(L, p_item, p_c, raw[0]);
  hmmc_planes::cp_async_commit();
  int buf = 0;

  for (int item = blockIdx.x; item < L.n_items; item += gridDim.x) {
    const Work k = make_work(L, item);
    unsigned char* out = L.out + static_cast<long long>(k.frame) * L.size
                                 * row_bytes;
    if (k.padded) {
      const int r0 = k.t0 * L.tile_rows;
      hmmc_planes::zero_rows(out + r0 * row_bytes, row_bytes,
                             min(k.t1 * L.tile_rows, L.size) - r0,
                             row_bytes);
      continue;
    }
    const Geom g = read_geom(L, k.geom);
    const int xo = g.xs & ~15;     // the planes' first column (8-aligned)
    for (int c = 0; c < k.t1 - k.t0; ++c) {
      next_tile(L, p_item, p_c, p_tiles);
      if (p_item < L.n_items) issue_tile(L, p_item, p_c, raw[buf ^ 1]);
      hmmc_planes::cp_async_commit();
      hmmc_planes::cp_async_wait<1>();
      __syncthreads();
      const Tile tr = tile_rows(L, g, k.t0 + c);
      {
        const hmmc_planes::Frame f =
            hmmc_planes::load_frame(frame_row(L, k.frame), g.w, g.h);
        const hmmc_planes::Staged st =
            hmmc_planes::layout(f, tr.ys, tr.ye, g.xs, g.xe);
        if (g.mode == kCopy)
          hmmc_planes::convert<true>(
              f, st, raw[buf], tr.ys, tr.ye, g.xs, g.xe,
              hmmc_planes::InterleavedSink{tile, L.tile_pitch, tr.ys, xo});
        else
          hmmc_planes::convert<true>(
              f, st, raw[buf], tr.ys, tr.ye, g.xs, g.xe,
              hmmc_planes::PlanarSink{rgb, L.rows * L.rgb_pitch,
                                      L.rgb_pitch, tr.ys, xo});
      }
      if (g.mode != kCopy) {
        __syncthreads();
        hpass(L, g, tr.ye - tr.ys, rgb, tmp);
        __syncthreads();
        vpass(L, g, k, tr, tmp, tile);
      }
      __syncthreads();
      hmmc_planes::store_rows(out + tr.r0 * row_bytes, row_bytes, tile,
                              L.tile_pitch,
                              g.mode == kCopy ? 3 * (g.xs - xo) : 0,
                              tr.r1 - tr.r0, row_bytes);
      __syncthreads();
      buf ^= 1;
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
    e = cudaFuncSetAttribute(resize_area_kernel,
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
        &n, resize_area_kernel, kThreads, smem_bytes);
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

const char* hmmc_resize_area_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// CTAs of the persistent grid on the current device at ``smem_bytes``.
int hmmc_resize_area_ctas(int smem_bytes, int* ctas) {
  return persistent_ctas(smem_bytes, ctas);
}

// desc: device int64 descriptor (above); head: its first 16 words on the
// host; n_items work items; out: device uint8 [N, size, size, 3]; grid: the
// CTAs launched (at most one an item).
int hmmc_resize_area(const long long* desc, const long long* head,
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
  p.size = static_cast<int>(head[2]);
  p.tile_rows = static_cast<int>(head[3]);
  p.n_tiles = static_cast<int>(head[4]);
  p.rows = static_cast<int>(head[5]);
  p.rgb_pitch = static_cast<int>(head[6]);
  p.raw_bytes = static_cast<int>(head[7]);
  p.rgb_bytes = static_cast<int>(head[8]);
  p.tmp_bytes = static_cast<int>(head[9]);
  p.tile_pitch = static_cast<int>(head[10]);
  p.band_tiles = static_cast<int>(head[11]);
  p.n_bands = static_cast<int>(head[12]);
  *grid = ctas < n_items ? ctas : n_items;
  resize_area_kernel<<<*grid, kThreads, smem_bytes,
                       static_cast<cudaStream_t>(stream)>>>(p);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
