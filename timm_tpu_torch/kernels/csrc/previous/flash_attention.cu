// The previous design of the port's forward flash attention, kept only as a
// yardstick: chip_smoke.py builds it beside ../flash_attention.cu and times
// both on the same inputs (`previous_ms`), so a redesign's gain is measured
// on one metric in one run. Nothing in timm_tpu_torch loads it. Its C
// interface is ../flash_attention.cu's.
//
// Design. One thread block of 4 warps per (batch, head, tile of BQ = 64 query
// rows); the block walks the keys in tiles of BK = 64 staged in shared
// memory with plain 16-byte loads. Both products of a tile (S = Q K^T and
// O += P V) run on the tensor cores through WMMA (16x16x16 fragments, fp32
// accumulate) for bf16 and fp16; fp32 inputs use FMA loops (no TF32). S, P
// and the fp32 accumulator O live in shared memory, with four barriers a key
// tile; each warp owns every fourth row of the online softmax and reads the
// key mask from device memory per row. Rounding points: those of
// ../flash_attention.cu, with p rounded against the running max of the
// 64-key tiles seen so far. A fully masked row comes out as the sum of v
// over its N keys divided by round_up(N, 64) (bf16, fp16) or round_up(N, 32)
// (fp32).
//
// The launcher allocates nothing: the caller passes the output buffer.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;  // 4 warps
constexpr int kWarps = kThreads / 32;
constexpr float kMaskValue = -1e30f;

template <typename T>
__device__ __forceinline__ float to_float(T x);
template <>
__device__ __forceinline__ float to_float<float>(float x) { return x; }
template <>
__device__ __forceinline__ float to_float<__half>(__half x) { return __half2float(x); }
template <>
__device__ __forceinline__ float to_float<__nv_bfloat16>(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T>
__device__ __forceinline__ T from_float(float x);
template <>
__device__ __forceinline__ float from_float<float>(float x) { return x; }
template <>
__device__ __forceinline__ __half from_float<__half>(float x) { return __float2half_rn(x); }
template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float x) { return __float2bfloat16_rn(x); }

// Tile shape per element type. fp32 tiles are smaller so that D = 256 fits
// in shared memory.
template <typename T>
struct TileRows {
  static constexpr int BQ = 64;
  static constexpr int BK = 64;
};
template <>
struct TileRows<float> {
  static constexpr int BQ = 32;
  static constexpr int BK = 32;
};

// Shared-memory layout. Every row is padded by 16 bytes against bank
// conflicts; every section is a multiple of 128 bytes so that each WMMA
// fragment pointer stays 32-byte aligned.
template <typename T, int D>
struct Layout {
  static constexpr int BQ = TileRows<T>::BQ;
  static constexpr int BK = TileRows<T>::BK;
  static constexpr int LD = D + 16 / sizeof(T);     // Q, K, V rows (T)
  static constexpr int LDS = BK + 4;                // S rows (fp32)
  static constexpr int LDP = BK + 16 / sizeof(T);   // P rows (T)
  static constexpr int LDO = D + 4;                 // O rows (fp32)
  static constexpr size_t q_off = 0;
  static constexpr size_t k_off = q_off + sizeof(T) * BQ * LD;
  static constexpr size_t v_off = k_off + sizeof(T) * BK * LD;
  static constexpr size_t s_off = v_off + sizeof(T) * BK * LD;
  static constexpr size_t p_off = s_off + sizeof(float) * BQ * LDS;
  static constexpr size_t o_off = p_off + sizeof(T) * BQ * LDP;
  static constexpr size_t m_off = o_off + sizeof(float) * BQ * LDO;
  static constexpr size_t l_off = m_off + sizeof(float) * BQ;
  static constexpr size_t bytes = l_off + sizeof(float) * BQ;
  static_assert(k_off % 128 == 0 && v_off % 128 == 0 && s_off % 128 == 0, "alignment");
  static_assert(p_off % 128 == 0 && o_off % 128 == 0 && m_off % 128 == 0, "alignment");
};

struct Params {
  const void* q;
  const void* k;
  const void* v;
  const unsigned char* mask;  // (B, N) key-padding mask, 1 = valid key; may be null
  void* o;
  int H, N;
  long long q_sb, q_sh, q_sn;
  long long k_sb, k_sh, k_sn;
  long long v_sb, v_sh, v_sn;
  long long o_sb, o_sh, o_sn;
  long long mask_sb;
  float scale;  // already rounded to T by the caller
};

// Copy rows [row0, row0 + R) of a (N, D) slab into shared memory with 16-byte
// vector loads; rows at or beyond N are zero-filled. When `scale` is given,
// each element becomes T(float(x) * scale), the TPU kernel's q pre-scaling.
template <typename T, int D, int R, int LD, bool kScale>
__device__ __forceinline__ void load_rows(T* dst, const T* src, long long stride_n, int row0, int n,
                                          float scale) {
  constexpr int kVec = 16 / sizeof(T);
  constexpr int kChunks = D / kVec;
  for (int i = threadIdx.x; i < R * kChunks; i += kThreads) {
    const int r = i / kChunks;
    const int c = (i % kChunks) * kVec;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (row0 + r < n) {
      val = *reinterpret_cast<const uint4*>(src + (row0 + r) * stride_n + c);
      if (kScale) {
        T* e = reinterpret_cast<T*>(&val);
#pragma unroll
        for (int j = 0; j < kVec; ++j) e[j] = from_float<T>(to_float<T>(e[j]) * scale);
      }
    }
    *reinterpret_cast<uint4*>(dst + r * LD + c) = val;
  }
}

// S = Q K^T for one tile: tensor cores for 16-bit types.
template <typename T, int D>
__device__ __forceinline__ void tile_scores(const T* qs, const T* ks, float* ss) {
  using L = Layout<T, D>;
  using namespace nvcuda;
  const int warp = threadIdx.x / 32;
  constexpr int kTilesN = L::BK / 16;
  constexpr int kTiles = (L::BQ / 16) * kTilesN;
  for (int t = warp; t < kTiles; t += kWarps) {
    const int ti = t / kTilesN, tj = t % kTilesN;
    wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc;
    wmma::fill_fragment(acc, 0.0f);
#pragma unroll
    for (int k0 = 0; k0 < D; k0 += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, T, wmma::row_major> a;
      wmma::fragment<wmma::matrix_b, 16, 16, 16, T, wmma::col_major> b;
      wmma::load_matrix_sync(a, qs + ti * 16 * L::LD + k0, L::LD);
      wmma::load_matrix_sync(b, ks + tj * 16 * L::LD + k0, L::LD);
      wmma::mma_sync(acc, a, b, acc);
    }
    wmma::store_matrix_sync(ss + ti * 16 * L::LDS + tj * 16, acc, L::LDS, wmma::mem_row_major);
  }
}

// fp32 inputs: FMA loops, so no operand is rounded to TF32.
template <int D>
__device__ __forceinline__ void tile_scores_fp32(const float* qs, const float* ks, float* ss) {
  using L = Layout<float, D>;
  for (int i = threadIdx.x; i < L::BQ * L::BK; i += kThreads) {
    const int r = i / L::BK, c = i % L::BK;
    float acc = 0.0f;
#pragma unroll 8
    for (int k = 0; k < D; ++k) acc = fmaf(qs[r * L::LD + k], ks[c * L::LD + k], acc);
    ss[r * L::LDS + c] = acc;
  }
}

// O += P V for one tile: tensor cores for 16-bit types.
template <typename T, int D>
__device__ __forceinline__ void tile_accumulate(const T* ps, const T* vs, float* os) {
  using L = Layout<T, D>;
  using namespace nvcuda;
  const int warp = threadIdx.x / 32;
  constexpr int kTilesN = D / 16;
  constexpr int kTiles = (L::BQ / 16) * kTilesN;
  for (int t = warp; t < kTiles; t += kWarps) {
    const int ti = t / kTilesN, tj = t % kTilesN;
    wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc;
    float* o_tile = os + ti * 16 * L::LDO + tj * 16;
    wmma::load_matrix_sync(acc, o_tile, L::LDO, wmma::mem_row_major);
#pragma unroll
    for (int k0 = 0; k0 < L::BK; k0 += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, T, wmma::row_major> a;
      wmma::fragment<wmma::matrix_b, 16, 16, 16, T, wmma::row_major> b;
      wmma::load_matrix_sync(a, ps + ti * 16 * L::LDP + k0, L::LDP);
      wmma::load_matrix_sync(b, vs + k0 * L::LD + tj * 16, L::LD);
      wmma::mma_sync(acc, a, b, acc);
    }
    wmma::store_matrix_sync(o_tile, acc, L::LDO, wmma::mem_row_major);
  }
}

template <int D>
__device__ __forceinline__ void tile_accumulate_fp32(const float* ps, const float* vs, float* os) {
  using L = Layout<float, D>;
  for (int i = threadIdx.x; i < L::BQ * D; i += kThreads) {
    const int r = i / D, d = i % D;
    float acc = os[r * L::LDO + d];
#pragma unroll 8
    for (int c = 0; c < L::BK; ++c) acc = fmaf(ps[r * L::LDP + c], vs[c * L::LD + d], acc);
    os[r * L::LDO + d] = acc;
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads) flash_fwd_kernel(const Params p) {
  using L = Layout<T, D>;
  constexpr int BQ = L::BQ, BK = L::BK;
  extern __shared__ __align__(128) unsigned char smem[];
  T* qs = reinterpret_cast<T*>(smem + L::q_off);
  T* ks = reinterpret_cast<T*>(smem + L::k_off);
  T* vs = reinterpret_cast<T*>(smem + L::v_off);
  float* ss = reinterpret_cast<float*>(smem + L::s_off);
  T* ps = reinterpret_cast<T*>(smem + L::p_off);
  float* os = reinterpret_cast<float*>(smem + L::o_off);
  float* row_m = reinterpret_cast<float*>(smem + L::m_off);
  float* row_l = reinterpret_cast<float*>(smem + L::l_off);

  const int q0 = blockIdx.x * BQ;
  const int h = blockIdx.y;
  const long long b = blockIdx.z;
  const int n = p.N;
  const T* q = static_cast<const T*>(p.q) + b * p.q_sb + h * p.q_sh;
  const T* k = static_cast<const T*>(p.k) + b * p.k_sb + h * p.k_sh;
  const T* v = static_cast<const T*>(p.v) + b * p.v_sb + h * p.v_sh;
  const unsigned char* mask = p.mask ? p.mask + b * p.mask_sb : nullptr;

  load_rows<T, D, BQ, L::LD, true>(qs, q, p.q_sn, q0, n, p.scale);
  for (int i = threadIdx.x; i < BQ * L::LDO; i += kThreads) os[i] = 0.0f;
  for (int i = threadIdx.x; i < BQ; i += kThreads) {
    row_m[i] = kMaskValue;
    row_l[i] = 0.0f;
  }

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  for (int kv0 = 0; kv0 < n; kv0 += BK) {
    load_rows<T, D, BK, L::LD, false>(ks, k, p.k_sn, kv0, n, 0.0f);
    load_rows<T, D, BK, L::LD, false>(vs, v, p.v_sn, kv0, n, 0.0f);
    __syncthreads();

    if constexpr (sizeof(T) == 4) {
      tile_scores_fp32<D>(reinterpret_cast<const float*>(qs), reinterpret_cast<const float*>(ks), ss);
    } else {
      tile_scores<T, D>(qs, ks, ss);
    }
    __syncthreads();

    // Online softmax: each warp owns rows warp, warp + 4, ...
    for (int r = warp; r < BQ; r += kWarps) {
      float s[BK / 32];
      float mx = kMaskValue;
#pragma unroll
      for (int j = 0; j < BK / 32; ++j) {
        const int key = kv0 + lane + 32 * j;
        const bool valid = key < n && (mask == nullptr || mask[key] != 0);
        s[j] = valid ? ss[r * L::LDS + lane + 32 * j] : kMaskValue;
        mx = fmaxf(mx, s[j]);
      }
#pragma unroll
      for (int off = 16; off > 0; off /= 2) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_old = row_m[r];
      const float m_new = fmaxf(m_old, mx);
      const float alpha = expf(m_old - m_new);
      float sum = 0.0f;
#pragma unroll
      for (int j = 0; j < BK / 32; ++j) {
        const float pj = expf(s[j] - m_new);
        ps[r * L::LDP + lane + 32 * j] = from_float<T>(pj);
        sum += pj;
      }
#pragma unroll
      for (int off = 16; off > 0; off /= 2) sum += __shfl_xor_sync(0xffffffffu, sum, off);
      for (int d = lane; d < D; d += 32) os[r * L::LDO + d] *= alpha;
      __syncwarp();
      if (lane == 0) {
        row_m[r] = m_new;
        row_l[r] = row_l[r] * alpha + sum;
      }
    }
    __syncthreads();

    if constexpr (sizeof(T) == 4) {
      tile_accumulate_fp32<D>(reinterpret_cast<const float*>(ps), reinterpret_cast<const float*>(vs), os);
    } else {
      tile_accumulate<T, D>(ps, vs, os);
    }
    __syncthreads();
  }

  T* o = static_cast<T*>(p.o) + b * p.o_sb + h * p.o_sh;
  for (int i = threadIdx.x; i < BQ * D; i += kThreads) {
    const int r = i / D, d = i % D;
    if (q0 + r < n) {
      o[(q0 + r) * p.o_sn + d] = from_float<T>(os[r * L::LDO + d] / fmaxf(row_l[r], 1e-30f));
    }
  }
}

template <typename T, int D>
int launch(const Params& p, int batch, cudaStream_t stream) {
  using L = Layout<T, D>;
  const cudaError_t attr = cudaFuncSetAttribute(
      flash_fwd_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(L::bytes));
  if (attr != cudaSuccess) return static_cast<int>(attr);
  const dim3 grid((p.N + L::BQ - 1) / L::BQ, p.H, batch);
  flash_fwd_kernel<T, D><<<grid, kThreads, L::bytes, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch_dim(int head_dim, const Params& p, int batch, cudaStream_t stream) {
  switch (head_dim) {
    case 32: return launch<T, 32>(p, batch, stream);
    case 64: return launch<T, 64>(p, batch, stream);
    case 128: return launch<T, 128>(p, batch, stream);
    case 256: return launch<T, 256>(p, batch, stream);
    default: return -1;
  }
}

template <typename T>
long long smem_for_dim(int head_dim) {
  switch (head_dim) {
    case 32: return Layout<T, 32>::bytes;
    case 64: return Layout<T, 64>::bytes;
    case 128: return Layout<T, 128>::bytes;
    case 256: return Layout<T, 256>::bytes;
    default: return -1;
  }
}

}  // namespace

// dtype: 0 = float32, 1 = float16, 2 = bfloat16. Strides are in elements;
// the last dimension of q, k, v and o must be contiguous and every row must
// start on a 16-byte boundary. Returns the cudaError_t of the launch, or -1
// for a head dim or dtype this library was not built for.
extern "C" int timm_flash_attention_fwd(
    int dtype, int head_dim,
    const void* q, const void* k, const void* v, const void* mask, void* o,
    int batch, int heads, int seq,
    long long q_sb, long long q_sh, long long q_sn,
    long long k_sb, long long k_sh, long long k_sn,
    long long v_sb, long long v_sh, long long v_sn,
    long long o_sb, long long o_sh, long long o_sn,
    long long mask_sb, float scale, void* stream) {
  Params p;
  p.q = q;
  p.k = k;
  p.v = v;
  p.mask = static_cast<const unsigned char*>(mask);
  p.o = o;
  p.H = heads;
  p.N = seq;
  p.q_sb = q_sb; p.q_sh = q_sh; p.q_sn = q_sn;
  p.k_sb = k_sb; p.k_sh = k_sh; p.k_sn = k_sn;
  p.v_sb = v_sb; p.v_sh = v_sh; p.v_sn = v_sn;
  p.o_sb = o_sb; p.o_sh = o_sh; p.o_sn = o_sn;
  p.mask_sb = mask_sb;
  p.scale = scale;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0: return dispatch_dim<float>(head_dim, p, batch, s);
    case 1: return dispatch_dim<__half>(head_dim, p, batch, s);
    case 2: return dispatch_dim<__nv_bfloat16>(head_dim, p, batch, s);
    default: return -1;
  }
}

extern "C" const char* timm_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// Dynamic shared memory one block takes, in bytes, or -1 when unsupported.
extern "C" long long timm_flash_attention_smem_bytes(int dtype, int head_dim) {
  switch (dtype) {
    case 0: return smem_for_dim<float>(head_dim);
    case 1: return smem_for_dim<__half>(head_dim);
    case 2: return smem_for_dim<__nv_bfloat16>(head_dim);
    default: return -1;
  }
}
