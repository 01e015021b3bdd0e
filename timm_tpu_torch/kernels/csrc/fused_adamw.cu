// One-pass fused AdamW + EMA update for NVIDIA Hopper (sm_90a).
//
// Replaces the Pallas `_kernel` of timm_tpu/kernels/fused_adamw.py:54 (its
// pallas_call at :120), which mirrors optax's chain
//   scale_by_adam -> add_decayed_weights(mask) -> scale_by_learning_rate
//   -> apply_updates, plus the EMA lerp,
// operation for operation. Per element, with g' = g * grad_scale:
//   m' = (1-b1) g' + b1 m          b1 rounded to bf16 when m is bf16
//   v' = (1-b2) g'^2 + b2 v
//   u  = (m'/bc1) / (sqrt(v'/bc2) + eps)   [+ wd p on decayed elements]
//   p' = p + (-lr) u
//   e' = e d + p' (1-d)
// with bc = 1 - b^(count+1) in fp32 from the pre-increment count, m' stored
// rounded to m's dtype after m'/bc1 has used the fp32 value. Every product,
// sum, quotient and square root is written with its round-to-nearest
// intrinsic, so nvcc contracts nothing into an FMA and each rounding point
// is the one the unfused chain has.
//
// Layout. The TPU kernel runs one pallas_call per parameter leaf, each leaf
// padded to (rows, 128) tiles. Here the optimizer keeps p, g, m, v and ema
// as flat buffers that the parameters and their gradients are views into,
// the leaves that take weight decay first: one launch covers every leaf,
// and the per-leaf decay mask is one boundary `n_decay`. The buffers are
// padded to a multiple of 4 elements (padding is zero in p, g, m, v and
// stays zero), so each thread moves 16-byte vectors of p, g, v and ema.
//
// Guard. The optimizer's non-finite guard needs the old state kept when the
// step is bad, which an in-place kernel cannot select afterwards: the kernel
// reads the device flag `ok` and returns at once when it is 0. The step
// count lives on the device and is read here, so no value crosses to the
// host.
//
// Run-time scalars. lr and the EMA decay d are one fp32 element each in
// device memory, read by every block as the TPU kernel reads
// [lr, 1-b1^t, 1-b2^t, ema_decay] from SMEM: a CUDA graph that captured a
// launch then takes each replay's values, which the host writes there
// before the replay. 1 - d is formed here in fp32 (round to nearest), as
// the host formed it before. b1, b2, eps and the weight decay are constants
// of the optimizer and stay launch values.
//
// Bound. The update streams every byte once: it reads p, g, m, v, ema and
// writes p, m, v, ema, 36 B per parameter with an fp32 m and 32 B with a
// bf16 m, about 25 operations per parameter: far below the card's
// operations-per-byte balance, so device memory bandwidth bounds it. The
// design answer is a grid-stride loop over 16-byte vectors with enough
// blocks on every SM to keep the memory system busy; nothing is reused, so
// no shared memory is used.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

struct AdamwArgs {
  float* p;
  const float* g;
  void* m;  // float or __nv_bfloat16
  float* v;
  float* ema;  // null: no EMA
  long long n_vec;  // number of 4-element vectors
  long long n_decay;  // elements [0, n_decay) take weight decay
  float b1, one_minus_b1, b1_bf16, b2, one_minus_b2, eps, wd;
  const float* lr;  // one element
  const float* ema_decay;  // one element; null without EMA
  const int* count;  // pre-increment step count
  const float* grad_scale;  // null: 1
  const unsigned char* ok;  // null: always update
};

template <bool kBf16Mu, bool kEma>
__global__ void __launch_bounds__(256) fused_adamw_kernel(AdamwArgs a) {
  if (a.ok != nullptr && a.ok[0] == 0) return;
  const float count_inc = static_cast<float>(a.count[0] + 1);
  const float bc1 = __fsub_rn(1.f, powf(a.b1, count_inc));
  const float bc2 = __fsub_rn(1.f, powf(a.b2, count_inc));
  const float scale = a.grad_scale != nullptr ? a.grad_scale[0] : 1.f;
  const float neg_lr = -a.lr[0];
  const float decay = kEma ? a.ema_decay[0] : 0.f;
  const float one_minus_decay = __fsub_rn(1.f, decay);
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long i = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
       i < a.n_vec; i += stride) {
    float4 p4 = reinterpret_cast<const float4*>(a.p)[i];
    const float4 g4 = reinterpret_cast<const float4*>(a.g)[i];
    float4 v4 = reinterpret_cast<const float4*>(a.v)[i];
    float4 e4;
    if (kEma) e4 = reinterpret_cast<const float4*>(a.ema)[i];
    float m_in[4];
    if (kBf16Mu) {
      const uint2 raw = reinterpret_cast<const uint2*>(a.m)[i];
      const __nv_bfloat162 lo = *reinterpret_cast<const __nv_bfloat162*>(&raw.x);
      const __nv_bfloat162 hi = *reinterpret_cast<const __nv_bfloat162*>(&raw.y);
      m_in[0] = __low2float(lo);
      m_in[1] = __high2float(lo);
      m_in[2] = __low2float(hi);
      m_in[3] = __high2float(hi);
    } else {
      const float4 m4 = reinterpret_cast<const float4*>(a.m)[i];
      m_in[0] = m4.x;
      m_in[1] = m4.y;
      m_in[2] = m4.z;
      m_in[3] = m4.w;
    }
    float* pp = reinterpret_cast<float*>(&p4);
    const float* gg = reinterpret_cast<const float*>(&g4);
    float* vv = reinterpret_cast<float*>(&v4);
    float* ee = reinterpret_cast<float*>(&e4);
    float m_out[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const float g = __fmul_rn(gg[j], scale);
      // b1 * m: with a bf16 m, b1 is rounded to bf16 and the product of two
      // bf16 values is exact in fp32; XLA keeps it unrounded under jit, so
      // it is not rounded here either
      const float bm = __fmul_rn(kBf16Mu ? a.b1_bf16 : a.b1, m_in[j]);
      const float m_new = __fadd_rn(__fmul_rn(a.one_minus_b1, g), bm);
      const float v_new = __fadd_rn(__fmul_rn(a.one_minus_b2, __fmul_rn(g, g)),
                                    __fmul_rn(a.b2, vv[j]));
      const float m_hat = __fdiv_rn(m_new, bc1);
      const float v_hat = __fdiv_rn(v_new, bc2);
      float u = __fdiv_rn(m_hat, __fadd_rn(__fsqrt_rn(v_hat), a.eps));
      if (4 * i + j < a.n_decay) u = __fadd_rn(u, __fmul_rn(a.wd, pp[j]));
      const float p_new = __fadd_rn(pp[j], __fmul_rn(neg_lr, u));
      pp[j] = p_new;
      vv[j] = v_new;
      m_out[j] = m_new;
      if (kEma) ee[j] = __fadd_rn(__fmul_rn(ee[j], decay), __fmul_rn(p_new, one_minus_decay));
    }
    reinterpret_cast<float4*>(a.p)[i] = p4;
    reinterpret_cast<float4*>(a.v)[i] = v4;
    if (kEma) reinterpret_cast<float4*>(a.ema)[i] = e4;
    if (kBf16Mu) {
      const __nv_bfloat162 lo = __floats2bfloat162_rn(m_out[0], m_out[1]);
      const __nv_bfloat162 hi = __floats2bfloat162_rn(m_out[2], m_out[3]);
      uint2 raw;
      raw.x = *reinterpret_cast<const unsigned int*>(&lo);
      raw.y = *reinterpret_cast<const unsigned int*>(&hi);
      reinterpret_cast<uint2*>(a.m)[i] = raw;
    } else {
      reinterpret_cast<float4*>(a.m)[i] = make_float4(m_out[0], m_out[1], m_out[2], m_out[3]);
    }
  }
}

template <bool kBf16Mu, bool kEma>
cudaError_t launch(const AdamwArgs& a, cudaStream_t stream) {
  constexpr int kThreads = 256;
  int device = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return err;
  // 8 blocks of 256 threads fill an SM's 2048 threads
  const long long want = (a.n_vec + kThreads - 1) / kThreads;
  const long long cap = static_cast<long long>(sms) * 8;
  const int blocks = static_cast<int>(want < cap ? (want > 0 ? want : 1) : cap);
  fused_adamw_kernel<kBf16Mu, kEma><<<blocks, kThreads, 0, stream>>>(a);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// In place on p, m, v and ema (n elements each, n a multiple of 4, 16-byte
// aligned; m 8-byte aligned when bf16). g, lr, ema_decay, count, grad_scale
// and ok are read only; lr and ema_decay (needed with ema) are device
// pointers to one fp32 element. Returns 0, -1 for bad arguments, or a
// cudaError_t.
int timm_fused_adamw(float* p, const float* g, void* m, int mu_bf16, float* v, float* ema,
                     long long n, long long n_decay, float b1, float one_minus_b1,
                     float b1_bf16, float b2, float one_minus_b2, float eps, float wd,
                     const float* lr, const float* ema_decay, const int* count,
                     const float* grad_scale, const unsigned char* ok, void* stream) {
  if (n % 4 != 0 || n_decay < 0 || n_decay > n || p == nullptr || g == nullptr ||
      m == nullptr || v == nullptr || lr == nullptr || count == nullptr ||
      (ema != nullptr && ema_decay == nullptr)) {
    return -1;
  }
  if (n == 0) return 0;
  AdamwArgs a{p, g, m, v, ema, n / 4, n_decay, b1, one_minus_b1, b1_bf16, b2,
              one_minus_b2, eps, wd, lr, ema_decay, count, grad_scale, ok};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (mu_bf16) {
    err = ema != nullptr ? launch<true, true>(a, s) : launch<true, false>(a, s);
  } else {
    err = ema != nullptr ? launch<false, true>(a, s) : launch<false, false>(a, s);
  }
  return static_cast<int>(err);
}

const char* timm_fused_adamw_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
