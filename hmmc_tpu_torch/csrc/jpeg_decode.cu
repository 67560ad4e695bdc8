// Batched JPEG decode on the card with nvJPEG, for the eval decode path
// (hmmc_tpu_torch/data/jpeg.py). Replaces the host PIL / libjpeg decode of
// hmmc_tpu/data/datasets.py:36-51 and native/hmmc_jpeg.cpp up to the IDCT:
// nvJPEG returns each frame's components as encoded
// (NVJPEG_OUTPUT_UNCHANGED: three planes, the second and third at their
// subsampled size; four, the fourth a CMYK or YCCK frame's K; or Y alone),
// and R1 (resize_crop.cu) does libjpeg's chroma upsampling and colour
// conversion before PIL's resize and crop. nvJPEG's own RGB output is not
// used: its chroma upsampling is not libjpeg's, and it knows neither the
// Adobe marker's RGB-coded frames nor PIL's CMYK conversion.
//
// Routes, all on the card:
//   0 hardware   NVJPEG_BACKEND_HARDWARE (the JPEG engines), one batched
//                call for every frame nvjpegDecodeBatchedSupported accepts;
//   1 hybrid     NVJPEG_BACKEND_GPU_HYBRID, one batched call for the rest
//                (every frame where the card exposes no JPEG engine: the
//                hardware handle then fails to create and is left null);
//   2 single     a frame of a batch that failed, decoded alone
//                (nvjpegDecode; the stream is synchronised after each, as
//                the next one reuses the state's staging buffers);
//  -1 failed     a blob whose header does not parse, or that fails alone
//                too: the wrapper zero-fills it and counts it.
// The probe reports each frame's components and plane sizes; the wrapper
// picks R1's format from them (or raises for a layout R1 does not take)
// and allocates the output planes (row pitches given). Every nvJPEG status
// is checked; a failing one is returned to the wrapper, which raises with
// its name. All work goes on the caller's stream.

#include <cuda_runtime.h>
#include <nvjpeg.h>

#include <vector>

namespace {

struct Batched {
  nvjpegJpegState_t state = nullptr;
  int batch = -1;  // the batch size the state was initialised for
};

struct Ctx {
  nvjpegHandle_t hw = nullptr;   // null: no JPEG engine on this card
  nvjpegHandle_t gpu = nullptr;
  Batched groups[2];             // by route
  nvjpegJpegState_t single = nullptr;   // single-frame retries (gpu)
  nvjpegJpegStream_t stream = nullptr;  // header parse for the hw check
};

#define HMMC_TRY(expr)                                   \
  do {                                                   \
    const nvjpegStatus_t s_ = (expr);                    \
    if (s_ != NVJPEG_STATUS_SUCCESS) return (int)s_;     \
  } while (0)

bool per_frame_fault(nvjpegStatus_t s) {
  return s == NVJPEG_STATUS_BAD_JPEG || s == NVJPEG_STATUS_JPEG_NOT_SUPPORTED ||
         s == NVJPEG_STATUS_INCOMPLETE_BITSTREAM ||
         s == NVJPEG_STATUS_EXECUTION_FAILED ||
         s == NVJPEG_STATUS_IMPLEMENTATION_NOT_SUPPORTED;
}

// one batched call over the frames of `route`; on a failing batch every
// frame is retried alone (route 2), and those that still fail are marked -1
int decode_group(Ctx* ctx, int route, const unsigned char* const* data,
                 const size_t* lengths, int n, int* routes,
                 const int* ncomp, unsigned char* const* dst0,
                 unsigned char* const* dst1, unsigned char* const* dst2,
                 unsigned char* const* dst3, const int* pitch0,
                 const int* pitch1, cudaStream_t stream) {
  std::vector<const unsigned char*> d;
  std::vector<size_t> len;
  std::vector<nvjpegImage_t> img;
  std::vector<int> which;
  for (int i = 0; i < n; ++i) {
    if (routes[i] != route) continue;
    nvjpegImage_t im = {};
    im.channel[0] = dst0[i];
    im.pitch[0] = static_cast<size_t>(pitch0[i]);
    if (ncomp[i] >= 3) {
      im.channel[1] = dst1[i];
      im.channel[2] = dst2[i];
      im.pitch[1] = im.pitch[2] = static_cast<size_t>(pitch1[i]);
    }
    if (ncomp[i] == 4) {  // K at full size, Y's pitch
      im.channel[3] = dst3[i];
      im.pitch[3] = static_cast<size_t>(pitch0[i]);
    }
    d.push_back(data[i]);
    len.push_back(lengths[i]);
    img.push_back(im);
    which.push_back(i);
  }
  const int k = static_cast<int>(which.size());
  if (k == 0) return 0;
  const nvjpegHandle_t handle = route == 0 ? ctx->hw : ctx->gpu;
  const nvjpegOutputFormat_t fmt = NVJPEG_OUTPUT_UNCHANGED;
  Batched* b = &ctx->groups[route];
  if (b->state == nullptr) HMMC_TRY(nvjpegJpegStateCreate(handle, &b->state));
  if (b->batch != k) {
    HMMC_TRY(nvjpegDecodeBatchedInitialize(handle, b->state, k, 1, fmt));
    b->batch = k;
  }
  const nvjpegStatus_t s = nvjpegDecodeBatched(handle, b->state, d.data(),
                                               len.data(), img.data(), stream);
  if (s == NVJPEG_STATUS_SUCCESS) return 0;
  if (!per_frame_fault(s)) return static_cast<int>(s);
  b->batch = -1;  // "also use to reset failed batches"
  for (int j = 0; j < k; ++j) {
    const nvjpegStatus_t t = nvjpegDecode(ctx->gpu, ctx->single, d[j], len[j],
                                          fmt, &img[j], stream);
    if (t == NVJPEG_STATUS_SUCCESS) {
      routes[which[j]] = 2;
      // nvjpegDecode returns before its copies to the card have run, and
      // the next frame's host phase refills the same state's staging
      // buffers: wait for this frame first
      if (cudaStreamSynchronize(stream) != cudaSuccess) {
        return NVJPEG_STATUS_EXECUTION_FAILED;
      }
    } else if (per_frame_fault(t)) {
      routes[which[j]] = -1;
    } else {
      return static_cast<int>(t);
    }
  }
  return 0;
}

}  // namespace

extern "C" {

const char* hmmc_jpeg_status_string(int s) {
  switch (s) {
    case NVJPEG_STATUS_SUCCESS: return "NVJPEG_STATUS_SUCCESS";
    case NVJPEG_STATUS_NOT_INITIALIZED: return "NVJPEG_STATUS_NOT_INITIALIZED";
    case NVJPEG_STATUS_INVALID_PARAMETER:
      return "NVJPEG_STATUS_INVALID_PARAMETER";
    case NVJPEG_STATUS_BAD_JPEG: return "NVJPEG_STATUS_BAD_JPEG";
    case NVJPEG_STATUS_JPEG_NOT_SUPPORTED:
      return "NVJPEG_STATUS_JPEG_NOT_SUPPORTED";
    case NVJPEG_STATUS_ALLOCATOR_FAILURE:
      return "NVJPEG_STATUS_ALLOCATOR_FAILURE";
    case NVJPEG_STATUS_EXECUTION_FAILED:
      return "NVJPEG_STATUS_EXECUTION_FAILED";
    case NVJPEG_STATUS_ARCH_MISMATCH: return "NVJPEG_STATUS_ARCH_MISMATCH";
    case NVJPEG_STATUS_INTERNAL_ERROR: return "NVJPEG_STATUS_INTERNAL_ERROR";
    case NVJPEG_STATUS_IMPLEMENTATION_NOT_SUPPORTED:
      return "NVJPEG_STATUS_IMPLEMENTATION_NOT_SUPPORTED";
    case NVJPEG_STATUS_INCOMPLETE_BITSTREAM:
      return "NVJPEG_STATUS_INCOMPLETE_BITSTREAM";
    default: return "unknown nvJPEG status";
  }
}

// A context on the current device. *hardware = 1 where the hardware
// backend created (the card exposes its JPEG engines), else 0.
int hmmc_jpeg_create(void** out, int* hardware) {
  Ctx* ctx = new Ctx();
  int err = (int)nvjpegCreateEx(NVJPEG_BACKEND_GPU_HYBRID, nullptr, nullptr,
                                0, &ctx->gpu);
  if (!err) err = (int)nvjpegJpegStateCreate(ctx->gpu, &ctx->single);
  if (!err) err = (int)nvjpegJpegStreamCreate(ctx->gpu, &ctx->stream);
  if (err) {
    delete ctx;
    return err;
  }
  const nvjpegStatus_t s = nvjpegCreateEx(NVJPEG_BACKEND_HARDWARE, nullptr,
                                          nullptr, 0, &ctx->hw);
  if (s == NVJPEG_STATUS_ARCH_MISMATCH ||
      s == NVJPEG_STATUS_IMPLEMENTATION_NOT_SUPPORTED ||
      s == NVJPEG_STATUS_NOT_INITIALIZED) {
    ctx->hw = nullptr;  // no JPEG engine here: the hybrid route
  } else if (s != NVJPEG_STATUS_SUCCESS) {
    delete ctx;
    return (int)s;
  }
  *hardware = ctx->hw != nullptr;
  *out = ctx;
  return 0;
}

// Header parse of n blobs: per frame width, height, the second and third
// planes' width and height (-1 where they differ in size), the number of components and
// the route (0 hardware, 1 hybrid, -1 a header that does not parse).
int hmmc_jpeg_probe(void* vctx, const unsigned char* const* data,
                    const size_t* lengths, int n, int* widths, int* heights,
                    int* cwidths, int* cheights, int* ncomp, int* routes) {
  Ctx* ctx = static_cast<Ctx*>(vctx);
  for (int i = 0; i < n; ++i) {
    int nc = 0;
    nvjpegChromaSubsampling_t sub = NVJPEG_CSS_UNKNOWN;
    int w[NVJPEG_MAX_COMPONENT] = {0}, h[NVJPEG_MAX_COMPONENT] = {0};
    const nvjpegStatus_t s = nvjpegGetImageInfo(ctx->gpu, data[i], lengths[i],
                                                &nc, &sub, w, h);
    widths[i] = heights[i] = cwidths[i] = cheights[i] = 0;
    ncomp[i] = nc;
    if (s != NVJPEG_STATUS_SUCCESS || w[0] <= 0 || h[0] <= 0) {
      routes[i] = -1;
      continue;
    }
    widths[i] = w[0];
    heights[i] = h[0];
    if (nc == 3 || nc == 4) {
      const bool same = w[1] == w[2] && h[1] == h[2];
      cwidths[i] = same ? w[1] : -1;
      cheights[i] = same ? h[1] : -1;
    }
    routes[i] = 1;
    if (ctx->hw != nullptr &&
        nvjpegJpegStreamParseHeader(ctx->hw, data[i], lengths[i],
                                    ctx->stream) == NVJPEG_STATUS_SUCCESS) {
      int unsupported = 1;
      HMMC_TRY(nvjpegDecodeBatchedSupported(ctx->hw, ctx->stream,
                                            &unsupported));
      if (unsupported == 0) routes[i] = 0;
    }
  }
  return 0;
}

// Decode every frame with routes[i] >= 0 into its planes on `stream`:
// dst0 (Y) with pitch0, for 3 or 4 components dst1, dst2 (Cb, Cr) with
// pitch1, and for 4 dst3 (K) with pitch0. Frames decoded alone become 2,
// frames that fail -1.
int hmmc_jpeg_decode(void* vctx, const unsigned char* const* data,
                     const size_t* lengths, int n, int* routes,
                     const int* ncomp, unsigned char* const* dst0,
                     unsigned char* const* dst1, unsigned char* const* dst2,
                     unsigned char* const* dst3, const int* pitch0,
                     const int* pitch1, void* stream) {
  Ctx* ctx = static_cast<Ctx*>(vctx);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  for (int route = ctx->hw != nullptr ? 0 : 1; route < 2; ++route) {
    const int e = decode_group(ctx, route, data, lengths, n, routes, ncomp,
                               dst0, dst1, dst2, dst3, pitch0, pitch1, st);
    if (e) return e;
  }
  return 0;
}

}  // extern "C"
