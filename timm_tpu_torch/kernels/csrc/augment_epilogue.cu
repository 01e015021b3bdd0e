// One-pass device augment epilogue for NVIDIA Hopper (sm_90a).
//
// Replaces the Pallas `_epilogue_kernel` of
// timm_tpu/kernels/augment_epilogue.py:55 (its pallas_call at :109). Per
// image b of a (B, H, W, C) uint8 batch, with b' = B - 1 - b its mixup
// partner:
//   x  = u8[b] / 255,   erased with b's 'const' boxes   (fill = re_mean[c])
//   xf = u8[b'] / 255,  erased with b''s own boxes
//   y  = use_cutmix[b] ? (inside bbox[b] ? xf : x) : x lam[b] + xf (1 - lam[b])
//   out = cast((y - mean[c]) / std[c])
// Identity rides in the values: lam = 1 with use_cutmix = 0 is x itself,
// zero boxes and K = 0 erase nothing, and the middle row of an odd batch is
// its own partner. Boxes are (top, left, eh, ew) for erasing and
// (yl, yh, xl, xh) for the cutmix paste.
//
// Rounding. The JAX program and its numpy oracle round after every
// operation: /255 and /std are true divisions, x lam + xf (1 - lam) is two
// products and a sum. Every one is written with its round-to-nearest
// intrinsic (__fdiv_rn, __fmul_rn, __fadd_rn, __fsub_rn), so nvcc neither
// turns a division into a reciprocal product nor contracts into an FMA; the
// cast is __float2half_rn / __float2bfloat16_rn.
//
// Layout. The TPU kernel takes one image per grid step, its own row and the
// flipped row through two BlockSpecs, with W-tiled mean/std rows in VMEM.
// Here the batch is one flat index space: a thread owns VEC consecutive
// bytes of one image (VEC = 4 when H*W*C is a multiple of 4 and the image
// is 4-byte aligned, else 1), reads them and the partner's bytes at the
// same offset, derives (h, w, c) from the flat offset, and writes VEC
// outputs with one vector store. The per-image scalars and boxes are a few
// bytes per image, read through the L1 cache; mean, std and the fill travel
// in the kernel's parameters.
//
// Bound. Streaming: each uint8 byte is read once from device memory (the
// partner read hits the same bytes, from L2 when the batch is small enough)
// and each output written once, 5 B per element for fp32 out and 3 B for
// fp16/bf16, against about 20 operations per element: device memory
// bandwidth bounds it. A grid-stride loop keeps enough blocks on every SM;
// nothing is reused, so no shared memory is used.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxChannels = 4;
// int32 indexing: the flat index plus one grid stride stays below 2^31
constexpr long long kMaxElements = 1LL << 30;

struct EpilogueArgs {
  const uint8_t* image;
  void* out;
  const float* lam;
  const void* use_cutmix;  // bool (1 byte) or int32 per image
  int cutmix_is_bool;
  const int* bbox;       // (B, 4): yl, yh, xl, xh
  const int* erase_box;  // (B, K, 4): top, left, eh, ew; null when K = 0
  int batch, height, width, channels, boxes;
  int hwc;  // elements per image
  float mean[kMaxChannels], std[kMaxChannels], fill[kMaxChannels];
};

__device__ __forceinline__ bool in_erase_box(const int* box, int h, int w) {
  const int top = box[0], left = box[1], eh = box[2], ew = box[3];
  return h >= top && h < top + eh && w >= left && w < left + ew;
}

// v[c] with constant indices only: a dynamic index into the parameter
// struct would copy it to local memory
__device__ __forceinline__ float channel(const float (&v)[kMaxChannels], int c) {
  return c == 0 ? v[0] : c == 1 ? v[1] : c == 2 ? v[2] : v[3];
}

template <typename OutT>
__device__ __forceinline__ OutT cast_out(float v);
template <>
__device__ __forceinline__ float cast_out<float>(float v) { return v; }
template <>
__device__ __forceinline__ __half cast_out<__half>(float v) { return __float2half_rn(v); }
template <>
__device__ __forceinline__ __nv_bfloat16 cast_out<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

template <typename T, int N>
struct alignas(sizeof(T) * N) Vec {
  T v[N];
};

template <typename OutT, int VEC>
__global__ void __launch_bounds__(256) augment_epilogue_kernel(EpilogueArgs a) {
  const int groups_per_image = a.hwc / VEC;
  const int total = groups_per_image * a.batch;
  const int stride = gridDim.x * blockDim.x;
  for (int g = blockIdx.x * blockDim.x + threadIdx.x; g < total; g += stride) {
    const int b = g / groups_per_image;
    const int offset = (g - b * groups_per_image) * VEC;
    const int bf = a.batch - 1 - b;
    const Vec<uint8_t, VEC> own =
        *reinterpret_cast<const Vec<uint8_t, VEC>*>(a.image + static_cast<size_t>(b) * a.hwc + offset);
    const Vec<uint8_t, VEC> partner =
        *reinterpret_cast<const Vec<uint8_t, VEC>*>(a.image + static_cast<size_t>(bf) * a.hwc + offset);
    const float lam = a.lam[b];
    const float one_minus_lam = __fsub_rn(1.f, lam);
    const bool cut = a.cutmix_is_bool ? static_cast<const uint8_t*>(a.use_cutmix)[b] != 0
                                      : static_cast<const int*>(a.use_cutmix)[b] != 0;
    const int* bbox = a.bbox + 4 * b;
    const int yl = bbox[0], yh = bbox[1], xl = bbox[2], xh = bbox[3];
    const int* own_boxes = a.erase_box + static_cast<size_t>(b) * a.boxes * 4;
    const int* partner_boxes = a.erase_box + static_cast<size_t>(bf) * a.boxes * 4;

    int c = offset % a.channels;
    int pixel = offset / a.channels;
    int w = pixel % a.width;
    int h = pixel / a.width;
    Vec<OutT, VEC> result;
#pragma unroll
    for (int j = 0; j < VEC; ++j) {
      float x = __fdiv_rn(static_cast<float>(own.v[j]), 255.f);
      float xf = __fdiv_rn(static_cast<float>(partner.v[j]), 255.f);
      for (int k = 0; k < a.boxes; ++k) {
        if (in_erase_box(own_boxes + 4 * k, h, w)) x = channel(a.fill, c);
        // the partner is the ERASED flipped row: its own boxes
        if (in_erase_box(partner_boxes + 4 * k, h, w)) xf = channel(a.fill, c);
      }
      float y;
      if (cut) {
        y = (h >= yl && h < yh && w >= xl && w < xh) ? xf : x;
      } else {
        y = __fadd_rn(__fmul_rn(x, lam), __fmul_rn(xf, one_minus_lam));
      }
      result.v[j] = cast_out<OutT>(__fdiv_rn(__fsub_rn(y, channel(a.mean, c)), channel(a.std, c)));
      if (++c == a.channels) {
        c = 0;
        if (++w == a.width) {
          w = 0;
          ++h;
        }
      }
    }
    *reinterpret_cast<Vec<OutT, VEC>*>(static_cast<OutT*>(a.out) + static_cast<size_t>(b) * a.hwc +
                                       offset) = result;
  }
}

template <typename OutT, int VEC>
cudaError_t launch(const EpilogueArgs& a, cudaStream_t stream) {
  constexpr int kThreads = 256;
  int device = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return err;
  // 8 blocks of 256 threads fill an SM's 2048 threads
  const long long groups = static_cast<long long>(a.hwc / VEC) * a.batch;
  const long long want = (groups + kThreads - 1) / kThreads;
  const long long cap = static_cast<long long>(sms) * 8;
  const int blocks = static_cast<int>(want < cap ? want : cap);
  augment_epilogue_kernel<OutT, VEC><<<blocks, kThreads, 0, stream>>>(a);
  return cudaGetLastError();
}

template <typename OutT>
cudaError_t launch_vec(const EpilogueArgs& a, int vec, cudaStream_t stream) {
  return vec == 4 ? launch<OutT, 4>(a, stream) : launch<OutT, 1>(a, stream);
}

}  // namespace

extern "C" {

// out[b] = epilogue(image[b], image[B-1-b]) for a contiguous (B, H, W, C)
// uint8 image, C <= 4; out is contiguous of the same shape, out_dtype 0 =
// fp32, 1 = fp16, 2 = bf16. mean, std and fill are host arrays of C floats.
// vec is 4 (H*W*C a multiple of 4, image 4-byte aligned) or 1. Returns 0,
// -1 for bad arguments, or a cudaError_t.
int timm_augment_epilogue(const uint8_t* image, void* out, int out_dtype, const float* lam,
                          const void* use_cutmix, int cutmix_is_bool, const int* bbox,
                          const int* erase_box, int batch, int height, int width, int channels,
                          int boxes, const float* mean, const float* std, const float* fill,
                          int vec, void* stream) {
  if (image == nullptr || out == nullptr || lam == nullptr || use_cutmix == nullptr ||
      bbox == nullptr || mean == nullptr || std == nullptr || fill == nullptr ||
      channels < 1 || channels > kMaxChannels || batch < 0 || height < 0 || width < 0 ||
      boxes < 0 || (boxes > 0 && erase_box == nullptr) || (vec != 1 && vec != 4)) {
    return -1;
  }
  const long long hwc = static_cast<long long>(height) * width * channels;
  if (hwc * batch > kMaxElements || hwc % vec != 0) return -1;
  if (hwc * batch == 0) return 0;
  EpilogueArgs a{image, out, lam, use_cutmix, cutmix_is_bool, bbox, erase_box,
                 batch, height, width, channels, boxes, static_cast<int>(hwc), {}, {}, {}};
  for (int c = 0; c < channels; ++c) {
    a.mean[c] = mean[c];
    a.std[c] = std[c];
    a.fill[c] = fill[c];
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (out_dtype) {
    case 0: return static_cast<int>(launch_vec<float>(a, vec, s));
    case 1: return static_cast<int>(launch_vec<__half>(a, vec, s));
    case 2: return static_cast<int>(launch_vec<__nv_bfloat16>(a, vec, s));
    default: return -1;
  }
}

const char* timm_augment_epilogue_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
