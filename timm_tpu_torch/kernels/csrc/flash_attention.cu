// Forward flash attention for NVIDIA Hopper (sm_90a), bound to Python with ctypes.
//
// Replaces the TPU kernel timm_tpu/kernels/flash_attention.py:_fwd_kernel
// (launched by _flash_fwd_impl). Rounding points kept from it:
//   * q * scale is rounded to the input type before the first product;
//   * scores are accumulated in fp32;
//   * masked keys and the ragged key tail beyond N are set to -1e30;
//   * a running (max, denominator, accumulator) is kept in fp32 per query row;
//   * p is rounded to v's type before the product with v;
//   * the output acc / max(l, 1e-30) is rounded to q's type (a row whose keys
//     are all masked: acc / round_up(N, block_k), below).
// Where p is rounded differs. The TPU kernel takes one key block of
// block_k = min(512, max(128, next_pow2(N))) keys, so for N <= 512 it
// rounds p against the row's final max. This kernel walks keys in tiles of
// BK (64; 32 at D = 256) and rounds p against the running max of the tiles
// seen so far, rescaling the fp32 sum by alpha afterwards, as any
// multi-block flash kernel does. Why: a warp holds its tile's scores in
// registers (BK / 2 floats a thread); the whole key range of N = 197 would
// take 128 and leave none for the accumulator. Both stay within the 2e-2
// parity tolerance.
// A query row whose keys are all masked keeps max -1e30, and so does the TPU
// kernel's: there every key slot of its padded key range gets p = 1, so the
// row comes out as the sum of v over its N keys (padded slots hold v = 0)
// divided by round_up(N, block_k). This kernel computes fewer slots
// (round_up(N, 8) for bf16 and fp16, round_up(N, 32) for fp32), whose v sum
// is the same, and its epilogue divides such a row, found by its max, by
// the TPU kernel's round_up(N, block_k) instead of its own sum of p. The
// plain version gives the same. The ViT token pad never produces such a
// row: the class token is always a valid key; NaFlex batches will.
//
// bf16 and fp16: a register-resident FA2-style kernel. A block of NW warps
// takes BQ = 16 NW query rows of one (batch, head); each warp owns 16 of
// them. Q rides in the first cp.async copy group; after the first barrier
// each warp scales its own rows in shared memory (q * scale rounded to T)
// and, where registers allow, loads its Q fragments into registers with
// ldmatrix once; otherwise it re-reads them from shared memory each tile.
// Both products are mma.sync.m16n8k16 (row.col, fp32 accumulate): S stays in
// accumulator registers; the online softmax keeps max and sum for the
// thread's two rows and reduces over the quad with shuffles; e^x is taken as
// 2^(x log2 e) on the special-function unit (ex2.approx, 2 ulp), from an
// argument s - m that is already a difference, so equal scores give exactly
// 1; P is packed to the input type straight from S's accumulators into PV's
// A operand; O is an fp32 accumulator in registers, rescaled there. K and V
// tiles go global -> shared with 16-byte cp.async copies into an NS-stage
// ring, one barrier per tile; rows are padded by 16 bytes so ldmatrix
// (.trans for V) is free of bank conflicts. The key-padding mask of a tile is
// read once per tile per warp and held as two ballot words; a full tile with
// no mask runs straight-line code with no checks at all. The ragged tail runs
// only the 8-key column blocks that hold a key below N and only the 16-key PV
// steps up to it; a warp whose rows all lie at or beyond N does no products.
// O is staged through the warp's own Q rows so the store to (B, N, H, D) is
// 16 bytes a thread.
//
// Shapes. q holds Nq rows a (batch, head) and k, v and the key-padding mask
// Nk, which may differ (the 'map' pool's latent queries attend to N tokens).
// The head dim D is any multiple of 8 up to 256: the kernel is built for the
// padded dims DP in {32, 48, 64, 80, 96, 128, 160, 192, 256} and a call runs
// on the smallest DP >= D (so400m's 72 on 80, ViT-H/14's 80 as it is). The
// copies zero-fill columns D .. DP of Q, K and V in shared memory (cp.async
// with a source size of 0: nothing beyond D is read), so the pad adds
// nothing to a score; only D columns of O are stored.
//
// Block shapes (Config16), by DP. DP <= 64: 8 warps, so 128 query rows share each
// K/V tile (half the L2 re-reads of 4 warps), a 3-stage ring, and a cap of
// 128 registers so that 2 blocks fit an SM; at D = 64, Q fragments held in
// registers would spill under that cap, so Q is re-read from shared memory
// (4 ldmatrix a tile beside the 32 of K and V); DP = 32 and 48 hold Q in
// registers. DP = 80 to 192: 4 warps, 2 stages, Q in registers. DP = 256: 4
// warps, key tiles of 32, Q in shared memory.
//
// fp32: the shared-memory kernel of the previous design
// (csrc/previous/flash_attention.cu), kept apart below and chosen by dtype: CUDA-core FMA loops, so no input is rounded to TF32.
//
// What bounds it on an H100. At the ViT-B/16 shape (N = 197, D = 64, bf16)
// the kernel must read q, k, v and write o once: 4 * N * D * 2 bytes per
// (batch, head) against 4 * N^2 * D operations, N/2 = 98 operations per byte,
// under the ~295 bf16 operations per byte at which the tensor cores become
// the limit. So the least time is the bytes over 3.35 TB/s. What holds this
// kernel above it is latency more than any one unit: with 2 blocks of 8 warps
// an SM, a block's copies for its first tiles and its arithmetic overlap
// little, and each K/V element crosses shared memory into registers once per
// warp (ldmatrix). TMA, wgmma and warp specialisation are later work.
//
// The launcher allocates nothing: the caller passes the output buffer.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int kThreads = 128;  // the fp32 kernel: 4 warps
constexpr int kWarps = kThreads / 32;
constexpr float kMaskValue = -1e30f;

struct Params {
  const void* q;
  const void* k;
  const void* v;
  const unsigned char* mask;  // (B, Nk) key-padding mask, 1 = valid key; may be null
  void* o;
  int H, Nq, Nk;
  int D;  // the head dim; the kernel is built for DP >= D and zero-fills columns D..DP
  long long q_sb, q_sh, q_sn;
  long long k_sb, k_sh, k_sn;
  long long v_sb, v_sh, v_sn;
  long long o_sb, o_sh, o_sn;
  long long mask_sb;
  float scale;  // already rounded to T by the caller
};

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

// The denominator of a query row whose keys are all masked: the key slots
// the TPU kernel computes, N rounded up to its key block
// min(512, max(128, next_pow2(N))).
__device__ __forceinline__ float tpu_key_slots(int n) {
  int block = 128;
  while (block < n && block < 512) block *= 2;
  return static_cast<float>((n + block - 1) / block * block);
}

// Copy rows [row0, row0 + R) of a (N, d) slab into shared memory as DP
// columns with 16-byte vector loads; rows at or beyond N and columns at or
// beyond d are zero-filled. When `kScale`, each element becomes
// T(float(x) * scale), the TPU kernel's q pre-scaling.
template <typename T, int DP, int R, int LD, bool kScale>
__device__ __forceinline__ void load_rows(T* dst, const T* src, long long stride_n, int row0, int n,
                                          int d, float scale) {
  constexpr int kVec = 16 / sizeof(T);
  constexpr int kChunks = DP / kVec;
  for (int i = threadIdx.x; i < R * kChunks; i += kThreads) {
    const int r = i / kChunks;
    const int c = (i % kChunks) * kVec;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (row0 + r < n && c < d) {
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

// ===== bf16 / fp16: registers, mma.sync, cp.async ==========================

// Block shape of the 16-bit kernel: NW warps of 16 query rows each, key
// tiles of BK rows in an NS-stage cp.async ring, at least MINB blocks an SM
// (a register cap for ptxas), and the warp's Q fragments held in registers
// for the whole key loop (QR) or re-read from shared memory each tile.
template <int D, int NW_, int NS_, int MINB_, bool QR_>
struct Tile16 {
  static constexpr int NW = NW_, NS = NS_, MINB = MINB_;
  static constexpr int kBlock = NW * 32;
  static constexpr int BQ = NW * 16;
  static constexpr int BK = D == 256 ? 32 : 64;
  static constexpr int LD = D + 8;           // row pitch in elements: 16 bytes of padding
  static constexpr bool kQInRegs = QR_;
  static constexpr int q_bytes = BQ * LD * 2;
  static constexpr int kv_bytes = BK * LD * 2;  // one stage of K or of V
  static constexpr int bytes = q_bytes + 2 * NS * kv_bytes;
};

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared; zero-filled when !valid (src is then not read)
__device__ __forceinline__ void cp_async_16(uint32_t dst, const void* src, bool valid) {
  const int src_bytes = valid ? 16 : 0;
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src), "r"(src_bytes));
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }

// wait until at most N of this thread's most recent copy groups are pending
template <int N>
__device__ __forceinline__ void cp_async_wait() { asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory"); }

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

// c += a b for one 16x8x16 tile: a row-major (4 regs), b col-major (2 regs)
template <typename T>
__device__ __forceinline__ void mma_16816(float (&c)[4], const uint32_t (&a)[4], uint32_t b0, uint32_t b1);

template <>
__device__ __forceinline__ void mma_16816<__nv_bfloat16>(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

template <>
__device__ __forceinline__ void mma_16816<__half>(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                                  uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.f16.f16.f32 {%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// two floats rounded to T, the lower column in the low half
template <typename T>
__device__ __forceinline__ uint32_t pack2(float lo, float hi);

template <>
__device__ __forceinline__ uint32_t pack2<__nv_bfloat16>(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

template <>
__device__ __forceinline__ uint32_t pack2<__half>(float lo, float hi) {
  const __half2 v = __floats2half2_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// 2^x on the special-function unit (2 ulp), flushing results below 2^-126
// to zero; e^x is taken as 2^(x log2 e) on an argument x = s - m that is
// already a difference, so equal scores give exactly 1
__device__ __forceinline__ float exp2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

constexpr float kLog2e = 1.4426950408889634f;

// Fragment layout of mma.m16n8k16 for lane = 4 g + t: the accumulator of an
// 8-column block holds (row g, cols 2t, 2t+1) in [0], [1] and (row g + 8,
// the same cols) in [2], [3].
//
// One key tile for one warp: S = Q K^T, the online softmax update, O += P V.
// kGuard = false is a full tile with no key mask: no validity checks and
// straight-line code. Otherwise keys at or beyond N and masked keys take
// -1e30; only the nb 8-key column blocks that hold a key below N and the ns
// 16-key PV steps up to it run.
template <typename T, int D, typename L, bool kGuard>
__device__ __forceinline__ void attend_tile(const T* qw, const T* kt, const T* vt, const uint32_t (&qf)[L::kQInRegs ? D / 16 : 1][4],
                                            float (&o)[D / 8][4], float (&m)[2], float (&l)[2], int nvalid,
                                            uint32_t valid_even, uint32_t valid_odd) {
  constexpr int BK = L::BK, LD = L::LD;
  constexpr int NB = BK / 8;   // 8-key column blocks of S in a tile
  constexpr int NKS = D / 16;  // k-steps of S = Q K^T
  constexpr int ND = D / 8;    // 8-column blocks of O
  const int lane = threadIdx.x % 32;
  const int t4 = lane & 3;
  const int nb = kGuard ? (nvalid + 7) / 8 : NB;
  const int ns = kGuard ? (nvalid + 15) / 16 : NB / 2;

  // S = (q scale) K^T
  float s[NB][4];
#pragma unroll
  for (int j = 0; j < NB; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
#pragma unroll
  for (int kk = 0; kk < NKS; ++kk) {
    uint32_t a[4];
    if constexpr (L::kQInRegs) {
      a[0] = qf[kk][0];
      a[1] = qf[kk][1];
      a[2] = qf[kk][2];
      a[3] = qf[kk][3];
    } else {
      ldmatrix_x4(a, smem_addr(qw + (lane & 15) * LD + kk * 16 + (lane >> 4) * 8));
    }
#pragma unroll
    for (int jj = 0; jj < NB / 2; ++jj) {
      if (!kGuard || 2 * jj < nb) {
        // keys 16 jj .. 16 jj + 15, columns 16 kk .. 16 kk + 15
        uint32_t bk[4];
        const int key = jj * 16 + (lane & 7) + ((lane >> 4) << 3);
        const int col = kk * 16 + ((lane >> 3) & 1) * 8;
        ldmatrix_x4(bk, smem_addr(kt + key * LD + col));
        mma_16816<T>(s[2 * jj], a, bk[0], bk[1]);
        if (!kGuard || 2 * jj + 1 < nb) mma_16816<T>(s[2 * jj + 1], a, bk[2], bk[3]);
      }
    }
  }

  // online softmax over the tile, rows g and g + 8
  float mx[2] = {kMaskValue, kMaskValue};
#pragma unroll
  for (int j = 0; j < NB; ++j) {
    if (!kGuard || j < nb) {
      if (kGuard) {
        const int bit = 4 * j + t4;
        if (!((valid_even >> bit) & 1u)) s[j][0] = s[j][2] = kMaskValue;
        if (!((valid_odd >> bit) & 1u)) s[j][1] = s[j][3] = kMaskValue;
      }
      mx[0] = fmaxf(mx[0], fmaxf(s[j][0], s[j][1]));
      mx[1] = fmaxf(mx[1], fmaxf(s[j][2], s[j][3]));
    }
  }
  float alpha[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
    const float m_new = fmaxf(m[r], mx[r]);
    alpha[r] = exp2_approx((m[r] - m_new) * kLog2e);
    m[r] = m_new;
  }
  float rs[2] = {0.f, 0.f};
#pragma unroll
  for (int j = 0; j < NB; ++j) {
    if (!kGuard || j < nb) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        s[j][e] = exp2_approx((s[j][e] - m[e >> 1]) * kLog2e);
        rs[e >> 1] += s[j][e];
      }
    }
  }
  l[0] = l[0] * alpha[0] + rs[0];
  l[1] = l[1] * alpha[1] + rs[1];
#pragma unroll
  for (int j = 0; j < ND; ++j) {
    o[j][0] *= alpha[0];
    o[j][1] *= alpha[0];
    o[j][2] *= alpha[1];
    o[j][3] *= alpha[1];
  }

  // O += P V, P rounded to T straight from the S accumulators
#pragma unroll
  for (int st = 0; st < NB / 2; ++st) {
    if (!kGuard || st < ns) {
      const uint32_t a[4] = {pack2<T>(s[2 * st][0], s[2 * st][1]), pack2<T>(s[2 * st][2], s[2 * st][3]),
                             pack2<T>(s[2 * st + 1][0], s[2 * st + 1][1]),
                             pack2<T>(s[2 * st + 1][2], s[2 * st + 1][3])};
#pragma unroll
      for (int jd = 0; jd < ND / 2; ++jd) {
        // keys 16 st .. 16 st + 15, columns 16 jd .. 16 jd + 15 of V
        uint32_t bv[4];
        const int key = st * 16 + (lane & 7) + ((lane >> 3) & 1) * 8;
        const int col = jd * 16 + (lane >> 4) * 8;
        ldmatrix_x4_trans(bv, smem_addr(vt + key * LD + col));
        mma_16816<T>(o[2 * jd], a, bv[0], bv[1]);
        mma_16816<T>(o[2 * jd + 1], a, bv[2], bv[3]);
      }
    }
  }
}

// D here is the padded head dim DP (a multiple of 16, the mma k-step); the
// caller's head dim p.D <= DP is a multiple of 8. Columns p.D .. DP of Q, K
// and V are zero-filled in shared memory by the copies themselves (cp.async
// with a source size of 0), so they add nothing to the scores; only p.D
// columns of O are stored.
template <typename T, int D, typename L>
__global__ void __launch_bounds__(L::kBlock, L::MINB) flash_fwd_kernel(const Params p) {
  constexpr int BQ = L::BQ, BK = L::BK, LD = L::LD, NS = L::NS;
  constexpr int NKS = D / 16;     // k-steps of S = Q K^T
  constexpr int ND = D / 8;       // 8-column blocks of O
  constexpr int kChunks = D / 8;  // 16-byte chunks in a row
  extern __shared__ __align__(128) unsigned char smem[];
  T* qs = reinterpret_cast<T*>(smem);
  T* ks = reinterpret_cast<T*>(smem + L::q_bytes);
  T* vs = reinterpret_cast<T*>(smem + L::q_bytes + NS * L::kv_bytes);

  const int q0 = blockIdx.x * BQ;
  const int h = blockIdx.y;
  const long long b = blockIdx.z;
  const int nq = p.Nq, nk = p.Nk, dh = p.D;
  const T* q = static_cast<const T*>(p.q) + b * p.q_sb + h * p.q_sh;
  const T* k = static_cast<const T*>(p.k) + b * p.k_sb + h * p.k_sh;
  const T* v = static_cast<const T*>(p.v) + b * p.v_sb + h * p.v_sh;
  const unsigned char* mask = p.mask ? p.mask + b * p.mask_sb : nullptr;
  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  const int g = lane >> 2, t4 = lane & 3;
  const int ntiles = (nk + BK - 1) / BK;

  // copies key tile `tile` into ring stage tile % NS; every call commits one
  // copy group, empty past the last tile, so the group count stays regular
  auto load_kv = [&](int tile) {
    if (tile < ntiles) {
      const int kv0 = tile * BK;
      T* kd = ks + (tile % NS) * BK * LD;
      T* vd = vs + (tile % NS) * BK * LD;
#pragma unroll
      for (int it = 0; it < (BK * kChunks + L::kBlock - 1) / L::kBlock; ++it) {
        const int i = it * L::kBlock + tid;
        if (i < BK * kChunks) {
          const int r = i / kChunks, c = (i % kChunks) * 8;
          const bool valid = kv0 + r < nk && c < dh;
          const long long row = valid ? kv0 + r : 0;
          const int col = valid ? c : 0;
          cp_async_16(smem_addr(kd + r * LD + c), k + row * p.k_sn + col, valid);
          cp_async_16(smem_addr(vd + r * LD + c), v + row * p.v_sn + col, valid);
        }
      }
    }
    cp_async_commit();
  };

  // Q rides in the first copy group; each warp scales its own rows after
  // the first barrier
#pragma unroll
  for (int it = 0; it < (BQ * kChunks + L::kBlock - 1) / L::kBlock; ++it) {
    const int i = it * L::kBlock + tid;
    if (i < BQ * kChunks) {
      const int r = i / kChunks, c = (i % kChunks) * 8;
      const bool valid = q0 + r < nq && c < dh;
      const long long row = valid ? q0 + r : 0;
      cp_async_16(smem_addr(qs + r * LD + c), q + row * p.q_sn + (valid ? c : 0), valid);
    }
  }
#pragma unroll
  for (int t = 0; t < NS - 1; ++t) load_kv(t);

  const int row0 = q0 + warp * 16;  // the warp's first query row
  const bool active = row0 < nq;
  T* qw = qs + warp * 16 * LD;
  uint32_t qf[L::kQInRegs ? NKS : 1][4];
  float o[ND][4];
#pragma unroll
  for (int j = 0; j < ND; ++j) o[j][0] = o[j][1] = o[j][2] = o[j][3] = 0.f;
  float m[2] = {kMaskValue, kMaskValue};  // running max of rows g, g + 8
  float l[2] = {0.f, 0.f};                // this thread's part of their sums

  for (int tile = 0; tile < ntiles; ++tile) {
    const int kv0 = tile * BK;
    const int nvalid = min(BK, nk - kv0);
    const bool guard = mask != nullptr || nvalid < BK;
    // validity of the tile's keys, once a tile: lane L holds keys kv0 + 2L
    // and kv0 + 2L + 1; bit 4j + t of each word is then the key pair of
    // thread t in column block j
    uint32_t valid_even = 0xffffffffu, valid_odd = 0xffffffffu;
    if (guard) {
      const int key = kv0 + 2 * lane;
      bool even = 2 * lane < BK && key < nk;
      bool odd = 2 * lane + 1 < BK && key + 1 < nk;
      if (mask != nullptr) {
        even = even && mask[key] != 0;
        odd = odd && mask[key + 1] != 0;
      }
      valid_even = __ballot_sync(0xffffffffu, even);
      valid_odd = __ballot_sync(0xffffffffu, odd);
    }
    cp_async_wait<NS - 2>();
    __syncthreads();  // the tile's K/V (and Q) landed; the stage of tile - 1 is free
    load_kv(tile + NS - 1);
    if (!active) continue;
    if (tile == 0) {
      // q * scale rounded to T, the TPU kernel's pre-scaling, in place (the
      // zero-filled pad columns stay zero)
#pragma unroll
      for (int i = lane; i < 16 * kChunks; i += 32) {
        uint4* chunk = reinterpret_cast<uint4*>(qw + (i / kChunks) * LD + (i % kChunks) * 8);
        uint4 val = *chunk;
        T* e = reinterpret_cast<T*>(&val);
#pragma unroll
        for (int j = 0; j < 8; ++j) e[j] = from_float<T>(to_float<T>(e[j]) * p.scale);
        *chunk = val;
      }
      __syncwarp();
      if constexpr (L::kQInRegs) {
#pragma unroll
        for (int kk = 0; kk < NKS; ++kk)
          ldmatrix_x4(qf[kk], smem_addr(qw + (lane & 15) * LD + kk * 16 + (lane >> 4) * 8));
      }
    }
    const T* kt = ks + (tile % NS) * BK * LD;
    const T* vt = vs + (tile % NS) * BK * LD;
    if (guard) {
      attend_tile<T, D, L, true>(qw, kt, vt, qf, o, m, l, nvalid, valid_even, valid_odd);
    } else {
      attend_tile<T, D, L, false>(qw, kt, vt, qf, o, m, l, nvalid, valid_even, valid_odd);
    }
  }
  if (!active) return;

  // out = acc / max(l, 1e-30) (a fully masked row: acc / the TPU kernel's
  // key slots), staged in the warp's own Q rows, then stored 16 bytes a
  // thread, the first p.D columns only
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
    l[r] = m[r] == kMaskValue ? tpu_key_slots(nk) : fmaxf(l[r], 1e-30f);
  }
  __syncwarp();  // at D = 256 the warp read Q from these rows
#pragma unroll
  for (int j = 0; j < ND; ++j) {
    *reinterpret_cast<uint32_t*>(qw + g * LD + j * 8 + 2 * t4) = pack2<T>(o[j][0] / l[0], o[j][1] / l[0]);
    *reinterpret_cast<uint32_t*>(qw + (g + 8) * LD + j * 8 + 2 * t4) =
        pack2<T>(o[j][2] / l[1], o[j][3] / l[1]);
  }
  __syncwarp();
  T* out = static_cast<T*>(p.o) + b * p.o_sb + h * p.o_sh;
#pragma unroll
  for (int i = lane; i < 16 * kChunks; i += 32) {
    const int r = i / kChunks, c = (i % kChunks) * 8;
    if (row0 + r < nq && c < dh) {
      *reinterpret_cast<uint4*>(out + (row0 + r) * p.o_sn + c) = *reinterpret_cast<const uint4*>(qw + r * LD + c);
    }
  }
}

// ===== fp32: shared memory, CUDA-core FMAs (no TF32) =======================

template <int D>
struct TileF32 {
  static constexpr int BQ = 32;
  static constexpr int BK = 32;
  static constexpr int LD = D + 4;    // Q, K, V rows, padded by 16 bytes
  static constexpr int LDS = BK + 4;  // S and P rows
  static constexpr int LDO = D + 4;   // O rows
  static constexpr size_t q_off = 0;
  static constexpr size_t k_off = q_off + sizeof(float) * BQ * LD;
  static constexpr size_t v_off = k_off + sizeof(float) * BK * LD;
  static constexpr size_t s_off = v_off + sizeof(float) * BK * LD;
  static constexpr size_t o_off = s_off + sizeof(float) * BQ * LDS;
  static constexpr size_t m_off = o_off + sizeof(float) * BQ * LDO;
  static constexpr size_t l_off = m_off + sizeof(float) * BQ;
  static constexpr size_t bytes = l_off + sizeof(float) * BQ;
  static_assert(k_off % 16 == 0 && v_off % 16 == 0 && s_off % 16 == 0 && o_off % 16 == 0, "alignment");
};

template <int D>
__global__ void __launch_bounds__(kThreads) flash_fwd_kernel_fp32(const Params p) {
  using L = TileF32<D>;
  constexpr int BQ = L::BQ, BK = L::BK;
  extern __shared__ __align__(128) unsigned char smem[];
  float* qs = reinterpret_cast<float*>(smem + L::q_off);
  float* ks = reinterpret_cast<float*>(smem + L::k_off);
  float* vs = reinterpret_cast<float*>(smem + L::v_off);
  float* ss = reinterpret_cast<float*>(smem + L::s_off);  // S, then P in place
  float* os = reinterpret_cast<float*>(smem + L::o_off);
  float* row_m = reinterpret_cast<float*>(smem + L::m_off);
  float* row_l = reinterpret_cast<float*>(smem + L::l_off);

  const int q0 = blockIdx.x * BQ;
  const int h = blockIdx.y;
  const long long b = blockIdx.z;
  const int nq = p.Nq, nk = p.Nk, dh = p.D;
  const float* q = static_cast<const float*>(p.q) + b * p.q_sb + h * p.q_sh;
  const float* k = static_cast<const float*>(p.k) + b * p.k_sb + h * p.k_sh;
  const float* v = static_cast<const float*>(p.v) + b * p.v_sb + h * p.v_sh;
  const unsigned char* mask = p.mask ? p.mask + b * p.mask_sb : nullptr;

  load_rows<float, D, BQ, L::LD, true>(qs, q, p.q_sn, q0, nq, dh, p.scale);
  for (int i = threadIdx.x; i < BQ * L::LDO; i += kThreads) os[i] = 0.0f;
  for (int i = threadIdx.x; i < BQ; i += kThreads) {
    row_m[i] = kMaskValue;
    row_l[i] = 0.0f;
  }

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  for (int kv0 = 0; kv0 < nk; kv0 += BK) {
    load_rows<float, D, BK, L::LD, false>(ks, k, p.k_sn, kv0, nk, dh, 0.0f);
    load_rows<float, D, BK, L::LD, false>(vs, v, p.v_sn, kv0, nk, dh, 0.0f);
    __syncthreads();

    for (int i = threadIdx.x; i < BQ * BK; i += kThreads) {
      const int r = i / BK, c = i % BK;
      float acc = 0.0f;
#pragma unroll 8
      for (int d = 0; d < D; ++d) acc = fmaf(qs[r * L::LD + d], ks[c * L::LD + d], acc);
      ss[r * L::LDS + c] = acc;
    }
    __syncthreads();

    // online softmax: each warp owns rows warp, warp + 4, ...; one key a lane
    for (int r = warp; r < BQ; r += kWarps) {
      const int key = kv0 + lane;
      const bool valid = key < nk && (mask == nullptr || mask[key] != 0);
      const float s = valid ? ss[r * L::LDS + lane] : kMaskValue;
      float mx = s;
#pragma unroll
      for (int off = 16; off > 0; off /= 2) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_old = row_m[r];
      const float m_new = fmaxf(m_old, mx);
      const float alpha = expf(m_old - m_new);
      const float pj = expf(s - m_new);
      ss[r * L::LDS + lane] = pj;
      float sum = pj;
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

    for (int i = threadIdx.x; i < BQ * D; i += kThreads) {
      const int r = i / D, d = i % D;
      float acc = os[r * L::LDO + d];
#pragma unroll 8
      for (int c = 0; c < BK; ++c) acc = fmaf(ss[r * L::LDS + c], vs[c * L::LD + d], acc);
      os[r * L::LDO + d] = acc;
    }
    __syncthreads();
  }

  float* o = static_cast<float*>(p.o) + b * p.o_sb + h * p.o_sh;
  const float masked_row_l = tpu_key_slots(nk);
  for (int i = threadIdx.x; i < BQ * D; i += kThreads) {
    const int r = i / D, d = i % D;
    const float l = row_m[r] == kMaskValue ? masked_row_l : fmaxf(row_l[r], 1e-30f);
    if (q0 + r < nq && d < dh) o[(q0 + r) * p.o_sn + d] = os[r * L::LDO + d] / l;
  }
}

// ===== launch ==============================================================

// The 16-bit kernel's block shape for each head dim. Up to D = 64: 8 warps
// (128 query rows share each K/V tile), a 3-stage ring and at most 128
// registers, so 2 blocks fit an SM; above, 4 warps and 2 stages.
template <int D>
using Config16 = std::conditional_t<(D <= 64), Tile16<D, 8, 3, 2, (D < 64)>, Tile16<D, 4, 2, 1, (D < 256)>>;

template <typename T, int D>
struct Kernel {
  static constexpr int BQ = Config16<D>::BQ;
  static constexpr int bytes = Config16<D>::bytes;
  static constexpr int threads = Config16<D>::kBlock;
};
template <int D>
struct Kernel<float, D> {
  static constexpr int BQ = TileF32<D>::BQ;
  static constexpr int bytes = static_cast<int>(TileF32<D>::bytes);
  static constexpr int threads = kThreads;
};

template <typename T, int D>
int launch(const Params& p, int batch, cudaStream_t stream) {
  using K = Kernel<T, D>;
  if (p.Nq == 0 || p.Nk == 0 || batch == 0 || p.H == 0) return 0;
  const dim3 grid((p.Nq + K::BQ - 1) / K::BQ, p.H, batch);
  cudaError_t attr = cudaSuccess;
  if constexpr (std::is_same<T, float>::value) {
    if (K::bytes > 48 * 1024)
      attr = cudaFuncSetAttribute(flash_fwd_kernel_fp32<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, K::bytes);
    if (attr == cudaSuccess) flash_fwd_kernel_fp32<D><<<grid, kThreads, K::bytes, stream>>>(p);
  } else {
    if (K::bytes > 48 * 1024)
      attr = cudaFuncSetAttribute(flash_fwd_kernel<T, D, Config16<D>>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                  K::bytes);
    if (attr == cudaSuccess) flash_fwd_kernel<T, D, Config16<D>><<<grid, K::threads, K::bytes, stream>>>(p);
  }
  if (attr != cudaSuccess) return static_cast<int>(attr);
  return static_cast<int>(cudaGetLastError());
}

// The built head dims: a head dim d (a multiple of 8 up to 256) runs on the
// smallest of them that is >= d, its columns beyond d zero-filled. Every
// multiple of 16 up to 96 is built (the ViT family's 48, 72 -> 80, 88 -> 96),
// then 128, 160, 192 and 256.
int padded_head_dim(int d) {
  if (d <= 0 || d > 256 || d % 8 != 0) return -1;
  constexpr int kBuilt[] = {32, 48, 64, 80, 96, 128, 160, 192, 256};
  for (int dp : kBuilt)
    if (d <= dp) return dp;
  return -1;
}

template <typename T>
int dispatch_dim(int head_dim, const Params& p, int batch, cudaStream_t stream) {
  switch (padded_head_dim(head_dim)) {
    case 32: return launch<T, 32>(p, batch, stream);
    case 48: return launch<T, 48>(p, batch, stream);
    case 64: return launch<T, 64>(p, batch, stream);
    case 80: return launch<T, 80>(p, batch, stream);
    case 96: return launch<T, 96>(p, batch, stream);
    case 128: return launch<T, 128>(p, batch, stream);
    case 160: return launch<T, 160>(p, batch, stream);
    case 192: return launch<T, 192>(p, batch, stream);
    case 256: return launch<T, 256>(p, batch, stream);
    default: return -1;
  }
}

template <typename T>
long long smem_for_dim(int head_dim) {
  switch (padded_head_dim(head_dim)) {
    case 32: return Kernel<T, 32>::bytes;
    case 48: return Kernel<T, 48>::bytes;
    case 64: return Kernel<T, 64>::bytes;
    case 80: return Kernel<T, 80>::bytes;
    case 96: return Kernel<T, 96>::bytes;
    case 128: return Kernel<T, 128>::bytes;
    case 160: return Kernel<T, 160>::bytes;
    case 192: return Kernel<T, 192>::bytes;
    case 256: return Kernel<T, 256>::bytes;
    default: return -1;
  }
}

}  // namespace

// dtype: 0 = float32, 1 = float16, 2 = bfloat16. q and o hold seq_q rows a
// (batch, head), k, v and the mask seq_k. Strides are in elements; the last
// dimension of q, k, v and o must be contiguous and every row must start on
// a 16-byte boundary. Returns the cudaError_t of the launch, or -1 for a
// head dim (not a multiple of 8 up to 256) or dtype this library does not
// take.
extern "C" int timm_flash_attention_fwd(
    int dtype, int head_dim,
    const void* q, const void* k, const void* v, const void* mask, void* o,
    int batch, int heads, int seq_q, int seq_k,
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
  p.Nq = seq_q;
  p.Nk = seq_k;
  p.D = head_dim;
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
