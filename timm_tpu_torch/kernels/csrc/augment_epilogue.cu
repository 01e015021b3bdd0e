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
// cast is __float2half_rn / __float2bfloat16_rn. The k / 255 table below
// holds the division's own results, so the output is the plain version's
// bit for bit.
//
// What bounds it. Each uint8 byte is read once from device memory (the
// partner read hits the same bytes, from L2 when the batch is small) and
// each output written once: 5 B per element for fp32 out. At 3.35 TB/s that
// leaves some 45 thread instructions per element on an H100. The previous
// design (csrc/previous/augment_epilogue.cu) spent them on three IEEE
// divisions per element, five integer divisions per group, erase boxes
// re-read from memory per element and, worst, a per-channel constant picked
// by a branch per element that splits a warp three ways (an element's
// channel differs from lane to lane). The design:
//   * grid (blocks over one image, B): the image comes from blockIdx.y; a
//     block strides over its image in tiles, and a thread derives (h, w, c)
//     once per 4-byte chunk (one division by W * C, one by the constant C)
//     and steps it per element;
//   * a per-block table of k / 255 for k = 0..255 in shared memory
//     (__fdiv_rn, the values the division gives) replaces the two
//     divisions by 255; a cutmix row selects x or xf, any other row blends,
//     and every element keeps exactly one __fdiv_rn, by std;
//   * (mean, std, fill) per channel sit in shared memory as one float4,
//     read by index without a branch;
//   * the K erase boxes of the image and of its partner are staged in
//     shared memory and each read once per chunk, the chunk's elements
//     tested against it together;
//   * every load of a warp is contiguous and every store is too: a thread
//     takes 4-byte chunks t, t + 256, t + 512, t + 768 of a tile (16 bytes
//     a thread, four 16-byte fp32 stores) when H*W*C is a multiple of 16,
//     one 4-byte chunk when it is a multiple of 4, else one byte; all of a
//     thread's loads are issued before its arithmetic.
// The per-image scalars and boxes are a few bytes per image, read once per
// block.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxChannels = 4;
// int32 indexing within an image and over the batch
constexpr long long kMaxElements = 1LL << 30;
constexpr int kMaxBatch = 65535;  // gridDim.y
constexpr int kMaxBoxes = 1024;   // erase boxes an image: 32 KB of shared memory for two images

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

// A box as the half-open ranges [y0, y1) x [x0, x1); erase boxes arrive as
// (top, left, eh, ew)
struct Box {
  int y0, y1, x0, x1;
};

__device__ __forceinline__ Box erase_box_at(const int* box) {
  return Box{box[0], box[0] + box[2], box[1], box[1] + box[3]};
}

__device__ __forceinline__ bool inside(const Box& r, int h, int w) {
  return (h >= r.y0) & (h < r.y1) & (w >= r.x0) & (w < r.x1);
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

// Which of a chunk's N elements, at (h[e], w[e]), the erase boxes of the
// image (bit e of *own) and of its partner (of *partner) cover: the K boxes
// of each sit in shared memory (the image's, then the partner's), each read
// once a chunk.
template <int N>
__device__ __forceinline__ void erased_bits(const Box* boxes, int count, const int (&h)[N],
                                            const int (&w)[N], unsigned* own, unsigned* partner) {
  *own = 0u;
  *partner = 0u;
  for (int k = 0; k < count; ++k) {
    const Box ob = boxes[k], pb = boxes[count + k];
#pragma unroll
    for (int e = 0; e < N; ++e) {
      *own |= static_cast<unsigned>(inside(ob, h[e], w[e])) << e;
      *partner |= static_cast<unsigned>(inside(pb, h[e], w[e])) << e;
    }
  }
}

// Grid (blocks over one image, B): a block takes image blockIdx.y and
// strides over it in tiles of kThreads * CH chunks of VEC bytes; thread t
// holds chunks t, t + kThreads, ... of a tile, so every load (VEC bytes a
// thread) and every store (VEC outputs a thread) of a warp is contiguous.
template <typename OutT, int VEC, int CH>
__global__ void __launch_bounds__(kThreads) augment_epilogue_kernel(EpilogueArgs a) {
  __shared__ float unit[256];  // k / 255
  // (mean, std, fill) per channel: an element's channel differs from lane to
  // lane, and a shared-memory read by index does not branch
  __shared__ float4 per_channel[kMaxChannels];
  extern __shared__ Box box_smem[];  // the image's K erase boxes, then its partner's
  const int b = blockIdx.y;
  const int bf = a.batch - 1 - b;
  const float lam = a.lam[b];
  const bool cut = a.cutmix_is_bool ? static_cast<const uint8_t*>(a.use_cutmix)[b] != 0
                                    : static_cast<const int*>(a.use_cutmix)[b] != 0;
  for (int k = threadIdx.x; k < 256; k += kThreads) unit[k] = __fdiv_rn(static_cast<float>(k), 255.f);
  if (threadIdx.x < a.channels) {
    const int c = threadIdx.x;
    per_channel[c] = make_float4(channel(a.mean, c), channel(a.std, c), channel(a.fill, c), 0.f);
  }
  for (int i = threadIdx.x; i < 2 * a.boxes; i += kThreads) {
    const int which = i / a.boxes, k = i - which * a.boxes;
    box_smem[i] = erase_box_at(a.erase_box + (static_cast<size_t>(which ? bf : b) * a.boxes + k) * 4);
  }
  __syncthreads();
  const float one_minus_lam = __fsub_rn(1.f, lam);
  const Box paste_box{a.bbox[4 * b], a.bbox[4 * b + 1], a.bbox[4 * b + 2], a.bbox[4 * b + 3]};
  const uint8_t* own_image = a.image + static_cast<size_t>(b) * a.hwc;
  const uint8_t* partner_image = a.image + static_cast<size_t>(bf) * a.hwc;
  OutT* out = static_cast<OutT*>(a.out) + static_cast<size_t>(b) * a.hwc;
  const unsigned row = a.width * a.channels;

  const int chunks = a.hwc / VEC;
  for (int base = blockIdx.x * kThreads * CH; base < chunks; base += gridDim.x * kThreads * CH) {
    // every load of the tile first, then the arithmetic
    Vec<uint8_t, VEC> own[CH], partner[CH];
#pragma unroll
    for (int j = 0; j < CH; ++j) {
      const int ci = base + j * kThreads + threadIdx.x;
      if (ci < chunks) {
        own[j] = reinterpret_cast<const Vec<uint8_t, VEC>*>(own_image)[ci];
        partner[j] = reinterpret_cast<const Vec<uint8_t, VEC>*>(partner_image)[ci];
      }
    }
#pragma unroll
    for (int j = 0; j < CH; ++j) {
      const int ci = base + j * kThreads + threadIdx.x;
      if (ci >= chunks) break;
      const unsigned offset = ci * VEC;
      int h = offset / row;
      const unsigned in_row = offset - h * row;
      int w;
      switch (a.channels) {  // constant divisors: a multiply and a shift
        case 1: w = in_row; break;
        case 2: w = in_row / 2u; break;
        case 3: w = in_row / 3u; break;
        default: w = in_row / 4u; break;
      }
      // the chunk's coordinates, stepped element by element
      int hs[VEC], ws[VEC], cs[VEC];
      int c = in_row - w * a.channels;
#pragma unroll
      for (int e = 0; e < VEC; ++e) {
        hs[e] = h;
        ws[e] = w;
        cs[e] = c;
        ++c;
        const int next_pixel = c == a.channels;
        c = next_pixel ? 0 : c;
        w += next_pixel;
        const int next_row = w == a.width;
        w = next_row ? 0 : w;
        h += next_row;
      }
      unsigned own_bits, partner_bits;
      erased_bits<VEC>(box_smem, a.boxes, hs, ws, &own_bits, &partner_bits);
      Vec<OutT, VEC> result;
#pragma unroll
      for (int e = 0; e < VEC; ++e) {
        const float4 mc = per_channel[cs[e]];
        // the partner is the ERASED flipped row: its own boxes
        const float x = (own_bits >> e) & 1u ? mc.z : unit[own[j].v[e]];
        const float xf = (partner_bits >> e) & 1u ? mc.z : unit[partner[j].v[e]];
        // cutmix pastes the partner inside its box; otherwise blend
        const float y = cut ? (inside(paste_box, hs[e], ws[e]) ? xf : x)
                            : __fadd_rn(__fmul_rn(x, lam), __fmul_rn(xf, one_minus_lam));
        result.v[e] = cast_out<OutT>(__fdiv_rn(__fsub_rn(y, mc.x), mc.y));
      }
      reinterpret_cast<Vec<OutT, VEC>*>(out)[ci] = result;
    }
  }
}

// VEC bytes a chunk, CH chunks a thread: (4, 4) is 16 bytes a thread with
// four 16-byte fp32 stores, (4, 1) 4 bytes, (1, 1) one byte
template <typename OutT, int VEC, int CH>
cudaError_t launch(const EpilogueArgs& a, cudaStream_t stream) {
  int device = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return err;
  // about 8 blocks of 256 threads an SM over the whole batch, each block
  // striding over its image; no more blocks than an image has tiles for
  const long long tiles = (a.hwc / VEC + kThreads * CH - 1) / (kThreads * CH);
  const long long want = (static_cast<long long>(sms) * 8 + a.batch - 1) / a.batch;
  const dim3 grid(static_cast<unsigned>(tiles < want ? tiles : want), a.batch);
  augment_epilogue_kernel<OutT, VEC, CH><<<grid, kThreads, 2 * a.boxes * sizeof(Box), stream>>>(a);
  return cudaGetLastError();
}

template <typename OutT>
cudaError_t launch_vec(const EpilogueArgs& a, int vec, cudaStream_t stream) {
  switch (vec) {
    case 16: return launch<OutT, 4, 4>(a, stream);
    case 4: return launch<OutT, 4, 1>(a, stream);
    default: return launch<OutT, 1, 1>(a, stream);
  }
}

}  // namespace

extern "C" {

// out[b] = epilogue(image[b], image[B-1-b]) for a contiguous (B, H, W, C)
// uint8 image, C <= 4, B <= 65535; out is contiguous of the same shape,
// out_dtype 0 = fp32, 1 = fp16, 2 = bf16. mean, std and fill are host arrays
// of C floats. vec is 16 or 4 (H*W*C a multiple of it, image and out
// aligned to 16 or 4 bytes) or 1. Returns 0, -1 for bad arguments, or a
// cudaError_t.
int timm_augment_epilogue(const uint8_t* image, void* out, int out_dtype, const float* lam,
                          const void* use_cutmix, int cutmix_is_bool, const int* bbox,
                          const int* erase_box, int batch, int height, int width, int channels,
                          int boxes, const float* mean, const float* std, const float* fill,
                          int vec, void* stream) {
  if (image == nullptr || out == nullptr || lam == nullptr || use_cutmix == nullptr ||
      bbox == nullptr || mean == nullptr || std == nullptr || fill == nullptr ||
      channels < 1 || channels > kMaxChannels || batch < 0 || batch > kMaxBatch || height < 0 ||
      width < 0 || boxes < 0 || boxes > kMaxBoxes || (boxes > 0 && erase_box == nullptr) ||
      (vec != 1 && vec != 4 && vec != 16)) {
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
