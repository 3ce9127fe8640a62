// Flash attention forward and backward for Hopper (sm_90a), with plain C
// entry points.
//
// Replaces the three TPU kernels of photon_tpu/ops/flash_attention.py:
//   K1 _fwd_kernel     (:93,  launched by _fwd at :207)  -> fwd_wgmma_kernel (bf16),
//                                                           fwd_kernel (fp32)
//   K2 _bwd_dq_kernel  (:231, launched by _bwd at :365)  -> bwd_dq_wgmma_kernel (bf16),
//                                                           bwd_dq_kernel (fp32)
//   K3 _bwd_dkv_kernel (:280, launched by _bwd at :392)  -> bwd_dkv_wgmma_kernel (bf16),
//                                                           bwd_dkv_kernel (fp32)
// Each computes what its TPU kernel computes (FlashAttention-2):
//   K1: O = softmax(Q K^T * scale + bias, masked) V as an online softmax over
//       key tiles, plus the row log-sum-exp LSE = m + log(l);
//   K2: P = exp(S - LSE), dP = dO V^T, dS = P * (dP - Delta) * scale,
//       dQ = sum_k dS K;
//   K3: dV = sum P^T dO, dK = sum dS^T Q, with one CTA per kv storage row
//       that sweeps the group's q heads and their q tiles (no repeated kv,
//       no reduction across CTAs, no atomics: the same bits on every run).
// Delta = rowsum(dO * O) is computed by the caller, as the JAX package does.
//
// Masking and numerics follow the TPU kernels exactly: a key at position kp
// is visible to a query at qp iff kp <= qp + offset (causal; offset = S_k -
// S_q by default, q_start - k_start for ring chunks), ALiBi adds
// -slope[h] * (qp + offset - kp), masked scores are NEG_INF = -1e30 (finite,
// so no inf - inf), p is forced to 0 while a row's running max is still
// NEG_INF, l == 0 -> 1 at finalize, and the backward guards rows whose LSE is
// NEG_INF. In K1, P is rounded to V's dtype before P V (JAX :133); in K2, dS
// is rounded to K's dtype before dS K (JAX :265); K3 keeps P and dS in fp32,
// as JAX's dkv kernel does (on tensor cores as a bf16 hi + lo pair). Every
// product accumulates in fp32.
//
// What bounds them: at the training shape (B=16, S=2048, H=12, D=64, causal,
// bf16) each kernel is bound by operations (~100-200 GFLOP against ~0.2 GB
// of operands), so bf16 runs on tensor cores.
//   * K1 (fwd_wgmma_kernel) is built the way Hopper reaches its tensor-core
//     rate: a CTA of two consumer warpgroups (64 query rows each, 128 in
//     all) and one producer warp (its warpgroup's registers lowered by
//     setmaxnreg and handed to the consumers). The producer loads Q once
//     and then K and V tiles of 128 keys by TMA into a ring of stages in
//     shared memory (4 at D=64, 2 at D=128; 128-byte swizzle, full and
//     empty mbarriers per stage). Each consumer computes S = Q K^T with
//     wgmma from shared memory (Q and K both K-major), the online softmax in
//     registers with scale * log2(e) folded into the one fma that feeds
//     each exp2 (on unmasked tiles), and O += P V
//     with wgmma taking P from registers (rounded to V's dtype, as the TPU
//     kernel does) and V from shared memory as an MN-major operand (the
//     transpose bit: V is never transposed by hand). The two consumers take
//     turns to issue their products (ping-pong), so that one's softmax runs
//     while the other's products hold the tensor cores. Only tiles that cross
//     the diagonal, the ragged end or a ring offset are masked. The CTAs are
//     persistent (one an SM) and take (q tile, batch, head) items round
//     robin, with Q double-buffered so that the next item's loads overlap
//     this one's epilogue; items come in chunks of heads whose K and V fit in
//     L2 together, the longest causal q tiles first within a chunk.
//   * K2 (bwd_dq_wgmma_kernel) is K1's design over the same work items (128
//     query rows of one (batch, head), longest causal q tiles first): the
//     producer loads the item's Q and dO once (double-buffered), then K and
//     V tiles (128 keys at D=64, 64 at D=128) through the ring; each
//     consumer warpgroup computes S = Q K^T and dP = dO V^T from shared
//     memory, P and dS in registers (LSE read in log2 units, so one fma
//     feeds each exp2), and dQ += dS K with dS from registers (rounded to
//     K's dtype) and K as an MN-major operand: no transposed copy of K.
//   * K3 (bwd_dkv_wgmma_kernel) makes the key tile the M dimension, so no
//     operand is transposed by hand: a work item is 128 keys of one
//     (batch, kv head), 64 to a consumer warpgroup, with K and V loaded
//     once (double-buffered). The producer streams (Q, dO) tiles of 128
//     query rows (64 at D=128) through the ring, starting at the first q tile that sees the
//     item's keys and sweeping the group's q heads in JAX's order, with the
//     tile's LSE and Delta copied 4 bytes at a time by cp.async (their rows
//     need not be 16-byte aligned). Each consumer computes S^T = K Q^T and
//     dP^T = V dO^T from shared memory, P^T and dS^T in registers (LSE and
//     Delta by column), and dV += P^T dO, dK += dS^T Q with dO and Q as
//     MN-major operands. P^T and dS^T enter as a bf16 pair hi + lo, so they
//     keep ~16 bits as the TPU kernel's fp32 does, at 1.5x the products.
//     Items come lowest k tile first (under causality they sweep the most
//     q tiles). One CTA owns each item: the same bits on every run.
//     Both take K1's register balance, its turns between the two consumer
//     warpgroups (a turn covers one tile's last product and the next tile's
//     first two) and its masking rule.
// fp32 inputs (the fp32 gates) run on CUDA cores: 64 x 64 tiles in fp32
// shared memory, 256 threads, each owning a 4 x 4 block of a tile product
// fed by 16-byte shared-memory loads. All stop the causal loops at the
// diagonal tile, so the masked half of the work is skipped.
//
// Layout: q/k/v are [B, S, H, D] tensors addressed through their batch,
// sequence and head strides (the dim axis is dense), so the q/k/v views of
// a fused QKV projection are read without a copy; the bf16 kernels' TMA
// tensor maps are encoded over those strides (and over dO), which TMA wants
// 16-byte aligned (the wrapper checks). O, dO, dQ, dK, dV are dense [B, S,
// H, D]; LSE and Delta are fp32 [B, H, S_q], in natural-log units, read
// from any offset. D is 64 or 128.
//
// The tensor maps are encoded with the driver's cuTensorMapEncodeTiled,
// reached through the runtime (cudaGetDriverEntryPoint), so the library
// needs no -lcuda.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC -o libphoton_flash.so flash_attention.cu

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>

namespace {

constexpr int kThreads = 256;  // 16 x 16 threads
constexpr int kTile = 64;      // query rows and keys per tile
constexpr int kPad = 4;        // row padding (floats): conflict-free float4 walks
constexpr int kLdp = kTile + kPad;
constexpr float kNegInf = -1e30f;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}
// x rounded to T and widened back (the JAX kernels' .astype before a product)
template <typename T> __device__ __forceinline__ float round_to(float x) {
  return to_f(from_f<T>(x));
}

struct Args {
  const void* q; int64_t q_sb, q_ss, q_sh;
  const void* k; int64_t k_sb, k_ss, k_sh;
  const void* v; int64_t v_sb, v_ss, v_sh;
  const void* dout;     // [B, S_q, H, D] dense (backward)
  const float* slopes;  // [H] fp32, or null (no ALiBi)
  const float* delta;   // [B, H, S_q] (backward)
  float* lse;           // [B, H, S_q]: written by K1, read by K2/K3
  void* o;              // [B, S_q, H, D] dense (K1)
  void* dq;             // [B, S_q, H, D] dense (K2)
  void* dk;             // [B, S_k, H_kv, D] dense (K3)
  void* dv;
  int B, H, H_kv, S_q, S_k, causal, offset;
  float scale;
};

// Rows row0 .. row0+63 of a [S, D] slice (row stride in elements, dim dense)
// into dst[64][D + kPad] as fp32; rows at or past n_valid read as 0.
template <typename T, int D>
__device__ __forceinline__ void load_tile(float* dst, const T* src, int64_t row_stride,
                                          int row0, int n_valid) {
  constexpr int kVec = 16 / sizeof(T);
  constexpr int kPerRow = D / kVec;
  for (int i = threadIdx.x; i < kTile * kPerRow; i += kThreads) {
    const int r = i / kPerRow;
    const int c = (i % kPerRow) * kVec;
    float* d = dst + r * (D + kPad) + c;
    if (row0 + r < n_valid) {
      const uint4 raw = *reinterpret_cast<const uint4*>(src + (int64_t)(row0 + r) * row_stride + c);
      const T* e = reinterpret_cast<const T*>(&raw);
#pragma unroll
      for (int x = 0; x < kVec; ++x) d[x] = to_f(e[x]);
    } else {
#pragma unroll
      for (int x = 0; x < kVec; ++x) d[x] = 0.f;
    }
  }
}

// c[i][j] += sum_d A[a0 + 16 i][d] * B[b0 + 16 j][d]: both operands row-major
// [64][D + kPad]; threads of a quarter-warp share a0 and take 8 consecutive
// b0, so the A loads broadcast and the B loads hit 32 distinct banks.
template <int D>
__device__ __forceinline__ void mm_nt(const float* A, const float* B, int a0, int b0,
                                      float c[4][4]) {
  constexpr int kLd = D + kPad;
#pragma unroll 2
  for (int d = 0; d < D; d += 4) {
    float4 a[4], b[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) a[i] = *reinterpret_cast<const float4*>(A + (a0 + 16 * i) * kLd + d);
#pragma unroll
    for (int j = 0; j < 4; ++j) b[j] = *reinterpret_cast<const float4*>(B + (b0 + 16 * j) * kLd + d);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        float s = c[i][j];
        s = fmaf(a[i].x, b[j].x, s);
        s = fmaf(a[i].y, b[j].y, s);
        s = fmaf(a[i].z, b[j].z, s);
        s = fmaf(a[i].w, b[j].w, s);
        c[i][j] = s;
      }
    }
  }
}

// c[i][g * 4 + e] += sum_x P[x][p0 + i] * V[x][g * 64 + v0 + e] over the 64
// rows x: P is [64][kLdp], V is [64][D + kPad]; a thread owns 4 consecutive
// output rows and D / 16 columns (4 per 64-column group).
template <int D>
__device__ __forceinline__ void mm_tn(const float* P, const float* V, int p0, int v0,
                                      float c[4][D / 16]) {
  constexpr int kLd = D + kPad;
  constexpr int kGroups = D / 64;
#pragma unroll 4
  for (int x = 0; x < kTile; ++x) {
    const float4 p = *reinterpret_cast<const float4*>(P + x * kLdp + p0);
    const float pv[4] = {p.x, p.y, p.z, p.w};
#pragma unroll
    for (int g = 0; g < kGroups; ++g) {
      const float4 v = *reinterpret_cast<const float4*>(V + x * kLd + g * 64 + v0);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        c[i][g * 4 + 0] = fmaf(pv[i], v.x, c[i][g * 4 + 0]);
        c[i][g * 4 + 1] = fmaf(pv[i], v.y, c[i][g * 4 + 1]);
        c[i][g * 4 + 2] = fmaf(pv[i], v.z, c[i][g * 4 + 2]);
        c[i][g * 4 + 3] = fmaf(pv[i], v.w, c[i][g * 4 + 3]);
      }
    }
  }
}

// Rows r0 .. r0+3 (columns as in mm_tn) of acc, scaled by 1 / den[i], into a
// dense [.., row_stride] output; rows at or past n_valid are not written.
template <typename T, int D>
__device__ __forceinline__ void store_rows(T* dst, int64_t row_stride, int r0, int n_valid,
                                           int v0, const float acc[4][D / 16],
                                           const float den[4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    if (r0 + i >= n_valid) continue;
    T* row = dst + (int64_t)(r0 + i) * row_stride;
#pragma unroll
    for (int g = 0; g < D / 64; ++g) {
#pragma unroll
      for (int e = 0; e < 4; ++e) row[g * 64 + v0 + e] = from_f<T>(acc[i][g * 4 + e] / den[i]);
    }
  }
}

// Visibility of (query qp, key kp), and the scaled, biased score.
__device__ __forceinline__ float score(const Args& a, float dot, float slope, int qp, int kp) {
  const bool ok = qp < a.S_q && kp < a.S_k && (!a.causal || kp <= qp + a.offset);
  float s = dot * a.scale;
  if (a.slopes != nullptr) s -= slope * (float)(qp + a.offset - kp);
  return ok ? s : kNegInf;
}

// One past the last key any query of the tile of `rows` rows starting at q0
// can see.
__device__ __forceinline__ int kv_end(const Args& a, int q0, int rows = kTile) {
  if (!a.causal) return a.S_k;
  const int q_last = min(q0 + rows, a.S_q) - 1;
  return max(0, min(a.S_k, q_last + a.offset + 1));
}

// ---------------------------------------------------------------------------
// K1: forward. grid (ceil(S_q / 64), H, B).
// ---------------------------------------------------------------------------
template <typename T, int D>
__global__ void __launch_bounds__(kThreads) fwd_kernel(const Args a) {
  constexpr int kLd = D + kPad;
  extern __shared__ float4 smem4[];
  float* q_s = reinterpret_cast<float*>(smem4);
  float* k_s = q_s + kTile * kLd;
  float* v_s = k_s + kTile * kLd;
  float* p_s = v_s + kTile * kLd;   // [key][query row]
  float* m_s = p_s + kTile * kLdp;
  float* l_s = m_s + kTile;
  float* alpha_s = l_s + kTile;

  const int tid = threadIdx.x, tr = tid >> 4, tc = tid & 15;
  const int q0 = blockIdx.x * kTile, h = blockIdx.y, b = blockIdx.z;
  const int kvh = h / (a.H / a.H_kv);
  const T* qp = static_cast<const T*>(a.q) + b * a.q_sb + h * a.q_sh;
  const T* kp = static_cast<const T*>(a.k) + b * a.k_sb + kvh * a.k_sh;
  const T* vp = static_cast<const T*>(a.v) + b * a.v_sb + kvh * a.v_sh;
  const float slope = a.slopes != nullptr ? a.slopes[h] : 0.f;

  load_tile<T, D>(q_s, qp, a.q_ss, q0, a.S_q);
  if (tid < kTile) {
    m_s[tid] = kNegInf;
    l_s[tid] = 0.f;
  }
  float acc[4][D / 16];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < D / 16; ++c) acc[i][c] = 0.f;

  const int end = kv_end(a, q0);
  for (int k0 = 0; k0 < end; k0 += kTile) {
    __syncthreads();  // the previous tile's readers are done
    load_tile<T, D>(k_s, kp, a.k_ss, k0, a.S_k);
    load_tile<T, D>(v_s, vp, a.v_ss, k0, a.S_k);
    __syncthreads();
    float s[4][4] = {};
    mm_nt<D>(q_s, k_s, tr, tc, s);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = tr + 16 * i;
      float mx = kNegInf;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        s[i][j] = score(a, s[i][j], slope, q0 + r, k0 + tc + 16 * j);
        mx = fmaxf(mx, s[i][j]);
      }
      // the 16 threads holding row r are one half-warp (same tr)
#pragma unroll
      for (int o = 8; o > 0; o >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
      const float m_old = m_s[r];
      const float m_new = fmaxf(m_old, mx);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        // a row with no visible key yet keeps m at NEG_INF: force p to 0
        const float p = (m_new > 0.5f * kNegInf) ? expf(s[i][j] - m_new) : 0.f;
        sum += p;
        p_s[(tc + 16 * j) * kLdp + r] = round_to<T>(p);
      }
#pragma unroll
      for (int o = 8; o > 0; o >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, o);
      __syncwarp();
      if (tc == 0) {
        const float alpha = expf(m_old - m_new);
        alpha_s[r] = alpha;
        l_s[r] = l_s[r] * alpha + sum;
        m_s[r] = m_new;
      }
    }
    __syncthreads();
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float al = alpha_s[tr * 4 + i];
#pragma unroll
      for (int c = 0; c < D / 16; ++c) acc[i][c] *= al;
    }
    mm_tn<D>(p_s, v_s, tr * 4, tc * 4, acc);
  }
  __syncthreads();

  float den[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float l = l_s[tr * 4 + i];
    den[i] = (l == 0.f) ? 1.f : l;  // a row that saw no key writes 0
  }
  T* o = static_cast<T*>(a.o) + (((int64_t)b * a.S_q + q0) * a.H + h) * D;
  store_rows<T, D>(o, (int64_t)a.H * D, tr * 4, a.S_q - q0, tc * 4, acc, den);
  if (tc == 0) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = tr * 4 + i;
      if (q0 + r < a.S_q) {
        const float l = l_s[r];
        a.lse[((int64_t)b * a.H + h) * a.S_q + q0 + r] = m_s[r] + logf(l == 0.f ? 1.f : l);
      }
    }
  }
}

// ---------------------------------------------------------------------------
// K2: dQ. grid (ceil(S_q / 64), H, B).
// ---------------------------------------------------------------------------
template <typename T, int D>
__global__ void __launch_bounds__(kThreads) bwd_dq_kernel(const Args a) {
  constexpr int kLd = D + kPad;
  extern __shared__ float4 smem4[];
  float* q_s = reinterpret_cast<float*>(smem4);
  float* do_s = q_s + kTile * kLd;
  float* k_s = do_s + kTile * kLd;
  float* v_s = k_s + kTile * kLd;
  float* ds_s = v_s + kTile * kLd;  // [key][query row]
  float* lse_s = ds_s + kTile * kLdp;
  float* dl_s = lse_s + kTile;

  const int tid = threadIdx.x, tr = tid >> 4, tc = tid & 15;
  const int q0 = blockIdx.x * kTile, h = blockIdx.y, b = blockIdx.z;
  const int kvh = h / (a.H / a.H_kv);
  const T* qp = static_cast<const T*>(a.q) + b * a.q_sb + h * a.q_sh;
  const T* kp = static_cast<const T*>(a.k) + b * a.k_sb + kvh * a.k_sh;
  const T* vp = static_cast<const T*>(a.v) + b * a.v_sb + kvh * a.v_sh;
  const T* dop = static_cast<const T*>(a.dout) + ((int64_t)b * a.S_q * a.H + h) * D;
  const float slope = a.slopes != nullptr ? a.slopes[h] : 0.f;
  const int64_t row_bh = ((int64_t)b * a.H + h) * a.S_q;

  load_tile<T, D>(q_s, qp, a.q_ss, q0, a.S_q);
  load_tile<T, D>(do_s, dop, (int64_t)a.H * D, q0, a.S_q);
  if (tid < kTile) {
    const bool in = q0 + tid < a.S_q;
    lse_s[tid] = in ? a.lse[row_bh + q0 + tid] : kNegInf;
    dl_s[tid] = in ? a.delta[row_bh + q0 + tid] : 0.f;
  }
  float acc[4][D / 16];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < D / 16; ++c) acc[i][c] = 0.f;

  const int end = kv_end(a, q0);
  for (int k0 = 0; k0 < end; k0 += kTile) {
    __syncthreads();
    load_tile<T, D>(k_s, kp, a.k_ss, k0, a.S_k);
    load_tile<T, D>(v_s, vp, a.v_ss, k0, a.S_k);
    __syncthreads();
    float s[4][4] = {}, dp[4][4] = {};
    mm_nt<D>(q_s, k_s, tr, tc, s);
    mm_nt<D>(do_s, v_s, tr, tc, dp);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = tr + 16 * i;
      const float lse = lse_s[r];
      const float dl = dl_s[r];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float x = score(a, s[i][j], slope, q0 + r, k0 + tc + 16 * j);
        // guard fully-masked rows (lse == NEG_INF): exp(s - lse) would be 1
        const float p = (lse > 0.5f * kNegInf) ? expf(x - lse) : 0.f;
        ds_s[(tc + 16 * j) * kLdp + r] = round_to<T>(p * (dp[i][j] - dl) * a.scale);
      }
    }
    __syncthreads();
    mm_tn<D>(ds_s, k_s, tr * 4, tc * 4, acc);
  }
  const float one[4] = {1.f, 1.f, 1.f, 1.f};
  T* dq = static_cast<T*>(a.dq) + (((int64_t)b * a.S_q + q0) * a.H + h) * D;
  store_rows<T, D>(dq, (int64_t)a.H * D, tr * 4, a.S_q - q0, tc * 4, acc, one);
}

// ---------------------------------------------------------------------------
// K3: dK, dV. grid (ceil(S_k / 64), H_kv, B); each CTA sweeps the group's q
// heads and, for each, the q tiles that can see its keys.
// ---------------------------------------------------------------------------
template <typename T, int D>
__global__ void __launch_bounds__(kThreads) bwd_dkv_kernel(const Args a) {
  constexpr int kLd = D + kPad;
  extern __shared__ float4 smem4[];
  float* k_s = reinterpret_cast<float*>(smem4);
  float* v_s = k_s + kTile * kLd;
  float* q_s = v_s + kTile * kLd;
  float* do_s = q_s + kTile * kLd;
  float* pt_s = do_s + kTile * kLd;   // [query row][key]
  float* dst_s = pt_s + kTile * kLdp;  // [query row][key]
  float* lse_s = dst_s + kTile * kLdp;
  float* dl_s = lse_s + kTile;

  const int tid = threadIdx.x, tr = tid >> 4, tc = tid & 15;
  const int k0 = blockIdx.x * kTile, kvh = blockIdx.y, b = blockIdx.z;
  const int group = a.H / a.H_kv;
  const T* kp = static_cast<const T*>(a.k) + b * a.k_sb + kvh * a.k_sh;
  const T* vp = static_cast<const T*>(a.v) + b * a.v_sb + kvh * a.v_sh;

  load_tile<T, D>(k_s, kp, a.k_ss, k0, a.S_k);
  load_tile<T, D>(v_s, vp, a.v_ss, k0, a.S_k);
  float dk[4][D / 16], dv[4][D / 16];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < D / 16; ++c) dk[i][c] = dv[i][c] = 0.f;

  const int n_q = (a.S_q + kTile - 1) / kTile;
  for (int g = 0; g < group; ++g) {
    const int h = kvh * group + g;
    const T* qp = static_cast<const T*>(a.q) + b * a.q_sb + h * a.q_sh;
    const T* dop = static_cast<const T*>(a.dout) + ((int64_t)b * a.S_q * a.H + h) * D;
    const float slope = a.slopes != nullptr ? a.slopes[h] : 0.f;
    const int64_t row_bh = ((int64_t)b * a.H + h) * a.S_q;
    for (int t = 0; t < n_q; ++t) {
      const int q0 = t * kTile;
      if (k0 >= kv_end(a, q0)) continue;  // no query of this tile sees these keys
      __syncthreads();
      load_tile<T, D>(q_s, qp, a.q_ss, q0, a.S_q);
      load_tile<T, D>(do_s, dop, (int64_t)a.H * D, q0, a.S_q);
      if (tid < kTile) {
        const bool in = q0 + tid < a.S_q;
        lse_s[tid] = in ? a.lse[row_bh + q0 + tid] : kNegInf;
        dl_s[tid] = in ? a.delta[row_bh + q0 + tid] : 0.f;
      }
      __syncthreads();
      // transposed tiles: rows are keys (tr + 16 i), columns query rows (tc + 16 j)
      float st[4][4] = {}, dpt[4][4] = {};
      mm_nt<D>(k_s, q_s, tr, tc, st);
      mm_nt<D>(v_s, do_s, tr, tc, dpt);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int r = tc + 16 * j;
        const float lse = lse_s[r];
        const float dl = dl_s[r];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int key = tr + 16 * i;
          const float x = score(a, st[i][j], slope, q0 + r, k0 + key);
          const float p = (lse > 0.5f * kNegInf) ? expf(x - lse) : 0.f;
          pt_s[r * kLdp + key] = p;
          dst_s[r * kLdp + key] = p * (dpt[i][j] - dl) * a.scale;
        }
      }
      __syncthreads();
      mm_tn<D>(pt_s, do_s, tr * 4, tc * 4, dv);
      mm_tn<D>(dst_s, q_s, tr * 4, tc * 4, dk);
    }
  }
  const float one[4] = {1.f, 1.f, 1.f, 1.f};
  const int64_t off = (((int64_t)b * a.S_k + k0) * a.H_kv + kvh) * D;
  store_rows<T, D>(static_cast<T*>(a.dk) + off, (int64_t)a.H_kv * D, tr * 4, a.S_k - k0, tc * 4,
                   dk, one);
  store_rows<T, D>(static_cast<T*>(a.dv) + off, (int64_t)a.H_kv * D, tr * 4, a.S_k - k0, tc * 4,
                   dv, one);
}

// ---------------------------------------------------------------------------
// bf16 on Hopper: wgmma + TMA. A wgmma accumulator (m64nN) gives thread (warp
// w, lane = 4 g + t) of the warpgroup, for each 8-column chunk n, rows 16 w +
// g (entries 4n, 4n+1) and 16 w + g + 8 (4n+2, 4n+3) at columns 8n + 2t, 8n +
// 2t + 1: the layout of mma.sync's accumulator, so the chunks 2j and 2j+1 of
// a product are k-step j's A fragment of the next one (FlashAttention-2's
// register reuse).
// ---------------------------------------------------------------------------

typedef __nv_bfloat16 bf16;

__device__ __forceinline__ uint32_t pack2(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}

__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

// ---------------------------------------------------------------------------
// K1 for bf16 on Hopper: wgmma + TMA, a producer warp (in a warpgroup of
// its own, for setmaxnreg) and two consumer warpgroups. A work item is 128
// query rows of one (batch, head); persistent CTAs, one an SM, take the
// items in the order fwd_work gives.
// ---------------------------------------------------------------------------

constexpr int kWgRows = 64;                // query rows of a consumer warpgroup
constexpr int kFwdRows = 2 * kWgRows;      // query rows of a CTA
constexpr int kFwdKeys = 128;              // keys of a K/V tile
constexpr int kWgThreads = 128;            // threads of a warpgroup
constexpr int kFwdThreads = 3 * kWgThreads;  // two consumer warpgroups + the producer warpgroup
constexpr int kPanel = 64;                 // bf16 columns in one 128-byte swizzled row
constexpr int kSwRow = 128;                // bytes of a swizzled row
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

template <int D>
struct FwdCfg {
  static constexpr int kPanels = D / kPanel;      // TMA boxes per row
  static constexpr int kStages = D == 64 ? 4 : 2;  // K/V ring depth
  static constexpr int kQPanel = kFwdRows * kSwRow;
  static constexpr int kKvPanel = kFwdKeys * kSwRow;
  static constexpr int kQBytes = kPanels * kQPanel;
  static constexpr int kKvBytes = kPanels * kKvPanel;  // one K or one V tile
  // two Q buffers, the K/V ring, 1024 bytes to align the tiles (128-byte
  // swizzle atoms), barriers
  static constexpr int kSmem = 2 * kQBytes + 2 * kStages * kKvBytes + 1024 + 256;
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, int bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}

__device__ __forceinline__ uint64_t global_ns() {
  uint64_t t;
  asm volatile("mov.u64 %0, %%globaltimer;\n" : "=l"(t));
  return t;
}

// Wait until the barrier's phase differs from `parity`. A wait that lasts
// seconds is a bug; trap (a launch error) rather than hang the card.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint64_t t0 = 0;
  for (uint32_t spin = 0;; ++spin) {
    uint32_t done;
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
    if (done) return;
    if ((spin & 1023) == 0) {
      const uint64_t now = global_ns();
      if (t0 == 0) t0 = now;
      else if (now - t0 > 4000000000ull) __trap();
    }
  }
}

// One TMA box of a 4-D map (dim 0 is D; dims 1-3 hold S, H and B in the
// order of their strides, given by `pm`: S at dim pm & 3, H at (pm >> 2) & 3).
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                         int col, int row, int h, int b, int pm) {
  const int ps = pm & 3, ph = (pm >> 2) & 3;
  const int c1 = ps == 1 ? row : ph == 1 ? h : b;
  const int c2 = ps == 2 ? row : ph == 2 ? h : b;
  const int c3 = ps == 3 ? row : ph == 3 ? h : b;
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(col), "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

// wgmma shared-memory descriptor of a 128-byte-swizzled tile (1024-byte
// aligned atoms of 8 rows x 128 bytes): the stride between 8-row groups is
// 1024 bytes. The leading offset is unused by every product here (each
// reads one atom column), and set to the same value.
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)(1024 >> 4) << 16) |
         ((uint64_t)(1024 >> 4) << 32) | (1ull << 62);
}

__device__ __forceinline__ void wg_fence() { asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory"); }
__device__ __forceinline__ void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wg_wait0() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// keep the compiler from moving accumulator accesses across a wgmma
template <int N>
__device__ __forceinline__ void fence_regs(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

#define WG_D8(i)                                                                       \
  "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3]), "+f"(d[i + 4]), "+f"(d[i + 5]), \
      "+f"(d[i + 6]), "+f"(d[i + 7])

// d (64 x 128, fp32) (+)= A (64 x 16, smem, K-major) B (16 x 128, smem, K-major)
__device__ __forceinline__ void wgmma_ss(float (&d)[64], uint64_t da, uint64_t db, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, "
      "%19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, "
      "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, "
      "%53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, 0, 0;\n}\n"
      : WG_D8(0), WG_D8(8), WG_D8(16), WG_D8(24), WG_D8(32), WG_D8(40), WG_D8(48), WG_D8(56)
      : "l"(da), "l"(db), "r"(acc));
}

// the same at n64: d (64 x 64, fp32) (+)= A (64 x 16) B (16 x 64), both from smem
__device__ __forceinline__ void wgmma_ss(float (&d)[32], uint64_t da, uint64_t db, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, "
      "%19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 0;\n}\n"
      : WG_D8(0), WG_D8(8), WG_D8(16), WG_D8(24)
      : "l"(da), "l"(db), "r"(acc));
}

// d (64 x 64, fp32) += A (64 x 16, registers) B (16 x 64, smem, MN-major)
__device__ __forceinline__ void wgmma_rs(float (&d)[32], const uint32_t a[4], uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, "
      "%19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : WG_D8(0), WG_D8(8), WG_D8(16), WG_D8(24)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

#undef WG_D8

// K1's work items are (q tile, batch, head). They are ordered in chunks of
// `group_bh` (batch, head) pairs whose K and V fit in L2 together; within a
// chunk, the longest causal q tiles come first. Persistent CTAs take the
// items round robin, so one item's epilogue overlaps the next one's loads.
__device__ __forceinline__ void fwd_work(int w, int n_qt, int n_bh, int group_bh, int& qt,
                                         int& bh) {
  const int per_chunk = n_qt * group_bh;
  const int chunk = w / per_chunk;
  const int r = w - chunk * per_chunk;
  const int gc = min(group_bh, n_bh - chunk * group_bh);
  qt = n_qt - 1 - r / gc;
  bh = chunk * group_bh + r % gc;
}

// The two consumer warpgroups take turns to issue their products
// (ping-pong) through the pair of barriers at `bar`, each of which counts
// the other warpgroup's 128 threads. Warpgroup 1 passes first, so 0 goes
// first; every thread takes and passes each turn, so no branch sits
// inside a wgmma stage, and each warpgroup takes the same number of turns.
struct Turns {
  uint32_t bar;
  int wg;
  uint32_t n = 0;  // turns taken: the parity of the next
  __device__ __forceinline__ void take() { mbar_wait(bar + 8 * wg, n++ & 1); }
  __device__ __forceinline__ void pass() { mbar_arrive(bar + 8 * (wg ^ 1)); }
};

// 2^x on the MUFU unit (flushes denormal results to 0: a probability below
// 2^-126 of the row's largest adds nothing in fp32)
__device__ __forceinline__ float fast_exp2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

template <int D>
__global__ void __launch_bounds__(kFwdThreads, 1)
    fwd_wgmma_kernel(const __grid_constant__ CUtensorMap q_map,
                     const __grid_constant__ CUtensorMap k_map,
                     const __grid_constant__ CUtensorMap v_map, const Args a, const int perm,
                     const int group_bh) {
  using C = FwdCfg<D>;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t q_s = (smem_u32(smem_raw) + 1023u) & ~1023u;  // two Q buffers
  const uint32_t k_s = q_s + 2 * C::kQBytes;             // stage s at + s * kKvBytes
  const uint32_t v_s = k_s + C::kStages * C::kKvBytes;
  // barriers: full[kStages], empty[kStages], q_full[2], q_empty[2], turn[2]
  const uint32_t bar = v_s + C::kStages * C::kKvBytes;
  const uint32_t q_full = bar + 16 * C::kStages, q_empty = q_full + 16, turn = q_empty + 16;

  const int n_bh = a.B * a.H;
  const int n_qt = (a.S_q + kFwdRows - 1) / kFwdRows;
  const int n_work = n_qt * n_bh;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;

  if (threadIdx.x == 0) {
    for (int s = 0; s < C::kStages; ++s) {
      mbar_init(bar + 8 * s, 1);                  // full: the producer's expect_tx
      mbar_init(bar + 8 * (C::kStages + s), 8);   // empty: one arrival per consumer warp
    }
    for (int j = 0; j < 2; ++j) {
      mbar_init(q_full + 8 * j, 1);
      mbar_init(q_empty + 8 * j, 8);
      mbar_init(turn + 8 * j, kWgThreads);  // every thread of the other warpgroup
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp >= 8) {
    // producer warpgroup: it gives its registers to the consumers (ptxas
    // budgets 168 a thread for 384 threads; 4 warps x (168 - 24) = 8 warps x
    // (240 - 168), so both requests are met), and one thread of its first
    // warp issues every copy
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n");
    if (warp == 8 && lane == 0) {
      int it = 0;  // K/V tiles issued so far: the ring position
      for (int w = blockIdx.x, j = 0; w < n_work; w += gridDim.x, ++j) {
        int qt, bh;
        fwd_work(w, n_qt, n_bh, group_bh, qt, bh);
        const int h = bh % a.H, b = bh / a.H, kvh = h / (a.H / a.H_kv);
        const int q0 = qt * kFwdRows;
        const uint32_t qb = q_s + (j & 1) * C::kQBytes, qf = q_full + 8 * (j & 1);
        mbar_wait(q_empty + 8 * (j & 1), ((j >> 1) & 1) ^ 1);
        mbar_expect_tx(qf, C::kQBytes);
#pragma unroll
        for (int p = 0; p < C::kPanels; ++p)
          tma_load(qb + p * C::kQPanel, &q_map, qf, p * kPanel, q0, h, b, perm & 15);
        const int n_tiles = (kv_end(a, q0, kFwdRows) + kFwdKeys - 1) / kFwdKeys;
        for (int i = 0; i < n_tiles; ++i, ++it) {
          const int s = it % C::kStages;
          mbar_wait(bar + 8 * (C::kStages + s), ((it / C::kStages) & 1) ^ 1);
          const uint32_t full = bar + 8 * s;
          mbar_expect_tx(full, 2 * C::kKvBytes);
#pragma unroll
          for (int p = 0; p < C::kPanels; ++p) {
            const uint32_t off = s * C::kKvBytes + p * C::kKvPanel;
            tma_load(k_s + off, &k_map, full, p * kPanel, i * kFwdKeys, kvh, b, (perm >> 4) & 15);
            tma_load(v_s + off, &v_map, full, p * kPanel, i * kFwdKeys, kvh, b, (perm >> 8) & 15);
          }
        }
      }
    }
  } else {
    // consumers: warpgroup wg owns query rows wq0 .. wq0 + 63 of each item
    asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n");
    const int wg = warp / 4, w = warp % 4, g = lane / 4, t = lane % 4;
    const float c2 = a.scale * kLog2e;  // scores in log2 units: one exp2 per score
    const bool alibi = a.slopes != nullptr;
    // The two warpgroups take turns to issue their products (ping-pong): a
    // turn covers P V of one tile and Q K^T of the next, so one warpgroup's
    // softmax runs while the other's products hold the tensor cores. Every
    // thread passes the turn, so no branch sits inside a wgmma stage; tiles
    // a warpgroup skips still take and pass their turns, to keep the count.
    Turns turns{turn, wg};
    if (wg == 1) turns.pass();  // warpgroup 0 goes first
    int it = 0;
    for (int wi = blockIdx.x, j = 0; wi < n_work; wi += gridDim.x, ++j) {
      int qt, bh;
      fwd_work(wi, n_qt, n_bh, group_bh, qt, bh);
      const int h = bh % a.H, b = bh / a.H;
      const int q0 = qt * kFwdRows;
      const int n_tiles = (kv_end(a, q0, kFwdRows) + kFwdKeys - 1) / kFwdKeys;
      const int wq0 = q0 + wg * kWgRows;
      const int wg_end = wq0 < a.S_q ? kv_end(a, wq0, kWgRows) : 0;
      const int r0 = wq0 + w * 16 + g;  // this thread's rows: r0 and r0 + 8
      const float sl2 = alibi ? a.slopes[h] * kLog2e : 0.f;
      const uint32_t qb = q_s + (j & 1) * C::kQBytes;
      float o[C::kPanels][32];
#pragma unroll
      for (int p = 0; p < C::kPanels; ++p)
#pragma unroll
        for (int i = 0; i < 32; ++i) o[p][i] = 0.f;
      float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};  // l: this thread's columns only

      mbar_wait(q_full + 8 * (j & 1), (j >> 1) & 1);
      for (int i = 0; i < n_tiles; ++i, ++it) {
        const int s = it % C::kStages;
        const int k0 = i * kFwdKeys;
        mbar_wait(bar + 8 * s, (it / C::kStages) & 1);
        if (i == 0) turns.take();
        if (k0 < wg_end) {
          float sc[64];
          wg_fence();
#pragma unroll
          for (int kk = 0; kk < D / 16; ++kk) {
            const uint32_t col = (kk % 4) * 32;
            wgmma_ss(sc, sw128_desc(qb + (kk / 4) * C::kQPanel + wg * kWgRows * kSwRow + col),
                     sw128_desc(k_s + s * C::kKvBytes + (kk / 4) * C::kKvPanel + col), kk > 0);
          }
          wg_commit();
          turns.pass();
          wg_wait0();
          fence_regs(sc);

          // scaled, biased logits in log2 units; the mask only on tiles that
          // cross the diagonal, the ragged end or a ring offset, as one
          // compare against each row's last visible key (no per-score branch)
          const bool edge =
              (a.causal && k0 + kFwdKeys - 1 > wq0 + a.offset) || k0 + kFwdKeys > a.S_k;
          float mx[2] = {kNegInf, kNegInf};
          float ks = 1.f;  // the exp's factor on sc: c2 where the scores stay unscaled
          if (!edge && !alibi && c2 > 0.f) {
#pragma unroll
            for (int x = 0; x < 64; ++x) mx[(x >> 1) & 1] = fmaxf(mx[(x >> 1) & 1], sc[x]);
            mx[0] *= c2;  // the scaled maximum, as c2 > 0
            mx[1] *= c2;
            ks = c2;
          } else {
            int last[2];
            float base[2];
#pragma unroll
            for (int r = 0; r < 2; ++r) {
              const int qp = r0 + 8 * r + a.offset;
              last[r] = a.causal ? min(qp, a.S_k - 1) : a.S_k - 1;
              base[r] = (float)(qp - k0 - 2 * t);  // ALiBi distance of this thread's column 0
            }
#pragma unroll
            for (int n = 0; n < 16; ++n)
#pragma unroll
              for (int e = 0; e < 4; ++e) {
                const int r = e >> 1, c = n * 8 + (e & 1);  // column within the thread's keys
                float x = sc[4 * n + e] * c2;
                if (alibi) x = fmaf(sl2, (float)c - base[r], x);  // -slope (qp + offset - kp)
                x = k0 + 2 * t + c > last[r] ? kNegInf : x;
                sc[4 * n + e] = x;
                mx[r] = fmaxf(mx[r], x);
              }
          }
          float alpha[2], m_new[2], m_use[2];
#pragma unroll
          for (int r = 0; r < 2; ++r) {
            m_new[r] = fmaxf(m[r], quad_max(mx[r]));
            alpha[r] = fast_exp2(m[r] - m_new[r]);
            // a row with no visible key yet keeps m at NEG_INF; its scores are
            // all NEG_INF, so exp2 against 0 gives p = 0, as the TPU kernel forces
            m_use[r] = m_new[r] > 0.5f * kNegInf ? m_new[r] : 0.f;
          }
          float sum[2] = {0.f, 0.f};
#pragma unroll
          for (int x = 0; x < 64; ++x) {
            const float p = fast_exp2(fmaf(sc[x], ks, -m_use[(x >> 1) & 1]));
            sc[x] = p;
            sum[(x >> 1) & 1] += p;
          }
#pragma unroll
          for (int r = 0; r < 2; ++r) {
            l[r] = l[r] * alpha[r] + sum[r];
            m[r] = m_new[r];
          }
#pragma unroll
          for (int p = 0; p < C::kPanels; ++p)
#pragma unroll
            for (int n = 0; n < 8; ++n) {
              o[p][4 * n + 0] *= alpha[0];
              o[p][4 * n + 1] *= alpha[0];
              o[p][4 * n + 2] *= alpha[1];
              o[p][4 * n + 3] *= alpha[1];
            }
          // P rounded to V's dtype, as the TPU kernel does, as A fragments
          uint32_t pa[8][4];
#pragma unroll
          for (int jj = 0; jj < 8; ++jj) {
            pa[jj][0] = pack2(sc[8 * jj + 0], sc[8 * jj + 1]);
            pa[jj][1] = pack2(sc[8 * jj + 2], sc[8 * jj + 3]);
            pa[jj][2] = pack2(sc[8 * jj + 4], sc[8 * jj + 5]);
            pa[jj][3] = pack2(sc[8 * jj + 6], sc[8 * jj + 7]);
          }
          turns.take();
#pragma unroll
          for (int p = 0; p < C::kPanels; ++p) fence_regs(o[p]);
          wg_fence();
#pragma unroll
          for (int jj = 0; jj < 8; ++jj)
#pragma unroll
            for (int p = 0; p < C::kPanels; ++p)
              wgmma_rs(o[p], pa[jj],
                       sw128_desc(v_s + s * C::kKvBytes + p * C::kKvPanel + jj * 16 * kSwRow));
          wg_commit();
          wg_wait0();
#pragma unroll
          for (int p = 0; p < C::kPanels; ++p) fence_regs(o[p]);
        } else {
          turns.pass();
          turns.take();
        }
        if (i == n_tiles - 1) turns.pass();  // the turn holds on to the next tile's Q K^T
        if (lane == 0) mbar_arrive(bar + 8 * (C::kStages + s));  // this warp is done with stage s
      }
      if (lane == 0) mbar_arrive(q_empty + 8 * (j & 1));  // and with this item's Q

      float den[2], inv[2];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const float lr = quad_sum(l[r]);
        den[r] = lr == 0.f ? 1.f : lr;  // a row that saw no key writes 0
        inv[r] = __frcp_rn(den[r]);
      }
      bf16* op = static_cast<bf16*>(a.o) + ((int64_t)b * a.S_q * a.H + h) * D;
      const int64_t row_stride = (int64_t)a.H * D;
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int row = r0 + 8 * half;
        if (row >= a.S_q) continue;
        bf16* dst = op + (int64_t)row * row_stride + 2 * t;
#pragma unroll
        for (int p = 0; p < C::kPanels; ++p)
#pragma unroll
          for (int n = 0; n < 8; ++n)
            *reinterpret_cast<uint32_t*>(dst + p * kPanel + n * 8) = pack2(
                o[p][4 * n + 2 * half] * inv[half], o[p][4 * n + 2 * half + 1] * inv[half]);
        if (t == 0) {
          // natural-log units, as K2 and K3 read it: m is in log2 units
          const float mr = m[half];
          a.lse[((int64_t)b * a.H + h) * a.S_q + row] =
              mr > 0.5f * kNegInf ? mr * kLn2 + logf(den[half]) : kNegInf;
        }
      }
    }
  }
}

typedef CUresult (*EncodeTiledFn)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                   const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                   const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                   CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// The driver's cuTensorMapEncodeTiled, reached through the runtime.
EncodeTiledFn encode_tiled() {
  static EncodeTiledFn fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
    cudaError_t err =
        cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &q);
#else
    cudaError_t err = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &q);
#endif
    if (err == cudaSuccess && q == cudaDriverEntryPointSuccess) fn = reinterpret_cast<EncodeTiledFn>(p);
  }
  return fn;
}

// A 4-D bf16 map over a [B, S, H, D] tensor with the given element strides,
// boxes of 64 columns x `rows` rows, 128-byte swizzle, zeros past the end.
// Dims 1-3 take S, H and B in the order of their strides; *pm says where S
// and H went (as tma_load reads it).
int make_map(CUtensorMap* map, int* pm, const void* base, int d, int s, int h, int b, int64_t ss,
             int64_t sh, int64_t sb, int rows) {
  EncodeTiledFn fn = encode_tiled();
  if (fn == nullptr) return (int)cudaErrorNotSupported;
  struct Dim { cuuint64_t n; int64_t stride; int which; } dim[3] = {{(cuuint64_t)s, ss, 0},
                                                                    {(cuuint64_t)h, sh, 1},
                                                                    {(cuuint64_t)b, sb, 2}};
  for (int i = 1; i < 3; ++i)  // insertion sort by stride, stable
    for (int j = i; j > 0 && dim[j].stride < dim[j - 1].stride; --j) {
      const Dim x = dim[j];
      dim[j] = dim[j - 1];
      dim[j - 1] = x;
    }
  cuuint64_t dims[4] = {(cuuint64_t)d, dim[0].n, dim[1].n, dim[2].n};
  cuuint64_t strides[3];
  cuuint32_t box[4] = {(cuuint32_t)kPanel, 1, 1, 1};
  cuuint32_t estr[4] = {1, 1, 1, 1};
  *pm = 0;
  for (int i = 0; i < 3; ++i) {
    strides[i] = (cuuint64_t)dim[i].stride * 2;
    if (dim[i].which == 0) {
      box[i + 1] = (cuuint32_t)rows;
      *pm |= i + 1;
    } else if (dim[i].which == 1) {
      *pm |= (i + 1) << 2;
    }
  }
  const CUresult r = fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(base), dims,
                        strides, box, estr, CU_TENSOR_MAP_INTERLEAVE_NONE,
                        CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                        CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : (int)cudaErrorInvalidValue;
}

// The maps of q, k and v, with boxes of q_rows and kv_rows rows, and (when
// do_map is given) of the dense dO with boxes of q_rows rows; *perm packs
// where S and H went in each, 4 bits a map in that order.
int make_maps(const Args& a, int d, int q_rows, int kv_rows, CUtensorMap* q_map,
              CUtensorMap* k_map, CUtensorMap* v_map, CUtensorMap* do_map, int* perm) {
  int pq, pk, pv, pd = 0, err;
  if ((err = make_map(q_map, &pq, a.q, d, a.S_q, a.H, a.B, a.q_ss, a.q_sh, a.q_sb, q_rows))) return err;
  if ((err = make_map(k_map, &pk, a.k, d, a.S_k, a.H_kv, a.B, a.k_ss, a.k_sh, a.k_sb, kv_rows))) return err;
  if ((err = make_map(v_map, &pv, a.v, d, a.S_k, a.H_kv, a.B, a.v_ss, a.v_sh, a.v_sb, kv_rows))) return err;
  if (do_map != nullptr &&
      (err = make_map(do_map, &pd, a.dout, d, a.S_q, a.H, a.B, (int64_t)a.H * d, d,
                      (int64_t)a.S_q * a.H * d, q_rows)))
    return err;
  *perm = pq | pk << 4 | pv << 8 | pd << 12;
  return 0;
}

// What a persistent launch needs: the kernel's dynamic shared memory asked
// for, and its grid, one CTA an SM (at most one a work item).
int persistent_setup(const void* kernel, int smem, int n_work, int* ctas) {
  cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return (int)e;
  int dev = 0, n_sm = 0;
  if ((e = cudaGetDevice(&dev)) != cudaSuccess) return (int)e;
  if ((e = cudaDeviceGetAttribute(&n_sm, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess)
    return (int)e;
  *ctas = std::min(n_work, n_sm);
  return 0;
}

// (batch, head) pairs per L2 chunk of the work order, when the operands each
// pair's items share take `bytes`: at most 16 MiB of them a chunk
int l2_chunk(int64_t bytes, int n_pairs) {
  return (int)std::max<int64_t>(1, std::min<int64_t>((16ll << 20) / bytes, n_pairs));
}

template <int D>
int launch_fwd_wgmma(const Args& a, cudaStream_t stream) {
  CUtensorMap qm, km, vm;
  int perm, ctas, err;
  if ((err = make_maps(a, D, kFwdRows, kFwdKeys, &qm, &km, &vm, nullptr, &perm))) return err;
  const int n_work = (a.S_q + kFwdRows - 1) / kFwdRows * a.B * a.H;
  if ((err = persistent_setup(reinterpret_cast<const void*>(fwd_wgmma_kernel<D>), FwdCfg<D>::kSmem,
                              n_work, &ctas)))
    return err;
  fwd_wgmma_kernel<D><<<ctas, kFwdThreads, FwdCfg<D>::kSmem, stream>>>(
      qm, km, vm, a, perm, l2_chunk((int64_t)a.S_k * D * 2 * 2, a.B * a.H));  // K and V
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// K2 and K3 for bf16 on Hopper, on K1's machinery: TMA loads into rings of
// mbarrier-guarded stages, a producer warpgroup (one warp issues, its
// registers handed to the consumers by setmaxnreg), two consumer warpgroups
// of 64 rows each taking turns on the tensor cores, persistent CTAs. No
// operand is transposed by hand: where a product contracts over a tile's
// rows (dS K in K2; P^T dO and dS^T Q in K3), wgmma reads the tile as an
// MN-major B operand (the transpose bit), as K1 reads V.
// ---------------------------------------------------------------------------

// K2: a work item is 128 query rows of one (batch, head), as in K1; K and V
// stream through the ring in tiles of kKeys keys.
template <int D>
struct DqCfg {
  static constexpr int kPanels = D / kPanel;
  static constexpr int kKeys = D == 64 ? 128 : 64;   // at D=128 dQ's 64 registers leave less room
  static constexpr int kStages = D == 64 ? 4 : 3;    // K/V ring depth
  static constexpr int kQPanel = kFwdRows * kSwRow;
  static constexpr int kQBytes = kPanels * kQPanel;  // one Q or one dO tile
  static constexpr int kKvPanel = kKeys * kSwRow;
  static constexpr int kKvBytes = kPanels * kKvPanel;  // one K or one V tile
  // two (Q, dO) buffers, the K/V ring, alignment, barriers
  static constexpr int kSmem = 4 * kQBytes + 2 * kStages * kKvBytes + 1024 + 256;
};

// K3: a work item is 128 keys of one (batch, kv head); (Q, dO) tiles of kRows
// query rows stream through the ring with their rows' LSE and Delta.
template <int D>
struct DkvCfg {
  static constexpr int kPanels = D / kPanel;
  // query rows of a Q/dO tile: at D=128, dK and dV hold 128 fp32 registers
  // a thread, which leaves room for S^T and dP^T of 64 rows only
  static constexpr int kRows = D == 64 ? 128 : 64;
  static constexpr int kStages = D == 64 ? 4 : 2;    // Q/dO ring depth
  static constexpr int kKvPanel = kFwdKeys * kSwRow;
  static constexpr int kKvBytes = kPanels * kKvPanel;  // one K or one V tile of an item
  static constexpr int kQPanel = kRows * kSwRow;
  static constexpr int kQBytes = kPanels * kQPanel;    // one Q or one dO tile
  // two (K, V) buffers, the Q/dO ring, alignment, the ring's LSE and Delta, barriers
  static constexpr int kSmem =
      4 * kKvBytes + 2 * kStages * kQBytes + 1024 + 2 * kStages * kRows * 4 + 256;
};

// 4 bytes from global to shared memory by cp.async; with n == 0 nothing is
// read and the 4 bytes are zeros. LSE and Delta rows start anywhere (S_q
// need not be a multiple of 4), which TMA's 16-byte rule would refuse.
__device__ __forceinline__ void cp_async4(uint32_t dst, const float* src, int n) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst), "l"(src), "r"(n)
               : "memory");
}

// arrive on `bar` once this thread's earlier cp.async copies have landed
// (the arrival is counted in the barrier's expected count: noinc)
__device__ __forceinline__ void cp_async_arrive(uint32_t bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n" ::"r"(bar) : "memory");
}

// A row's LSE in log2 units, as P = exp2(S * scale * log2(e) + bias - LSE2)
// reads it. A row that saw no key (LSE == NEG_INF) gets +1e30, so its p is
// exp2(-huge) = 0: the TPU kernels' guard, with no branch per score.
__device__ __forceinline__ float lse_log2(float lse) {
  return lse > 0.5f * kNegInf ? lse * kLog2e : -kNegInf;
}

// The first q tile (of `rows` rows) with a query that sees key k0.
__device__ __forceinline__ int first_q_tile(const Args& a, int k0, int rows) {
  const int q = k0 - a.offset;  // the first query position that sees k0
  return !a.causal || q <= 0 ? 0 : q / rows;
}

template <int D>
__global__ void __launch_bounds__(kFwdThreads, 1)
    bwd_dq_wgmma_kernel(const __grid_constant__ CUtensorMap q_map,
                        const __grid_constant__ CUtensorMap k_map,
                        const __grid_constant__ CUtensorMap v_map,
                        const __grid_constant__ CUtensorMap do_map, const Args a, const int perm,
                        const int group_bh) {
  using C = DqCfg<D>;
  constexpr int kN = C::kKeys / 2;  // accumulator registers of S and of dP
  extern __shared__ uint8_t smem_raw[];
  const uint32_t q_s = (smem_u32(smem_raw) + 1023u) & ~1023u;  // buffer j: Q, then dO
  const uint32_t k_s = q_s + 4 * C::kQBytes;                   // stage s at + s * kKvBytes
  const uint32_t v_s = k_s + C::kStages * C::kKvBytes;
  // barriers: full[kStages], empty[kStages], q_full[2], q_empty[2], turn[2]
  const uint32_t bar = v_s + C::kStages * C::kKvBytes;
  const uint32_t q_full = bar + 16 * C::kStages, q_empty = q_full + 16, turn = q_empty + 16;

  const int n_bh = a.B * a.H;
  const int n_qt = (a.S_q + kFwdRows - 1) / kFwdRows;
  const int n_work = n_qt * n_bh;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;

  if (threadIdx.x == 0) {
    for (int s = 0; s < C::kStages; ++s) {
      mbar_init(bar + 8 * s, 1);
      mbar_init(bar + 8 * (C::kStages + s), 8);
    }
    for (int j = 0; j < 2; ++j) {
      mbar_init(q_full + 8 * j, 1);
      mbar_init(q_empty + 8 * j, 8);
      mbar_init(turn + 8 * j, kWgThreads);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp >= 8) {
    // producer warpgroup: the register balance of K1 (same thread counts)
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n");
    if (warp == 8 && lane == 0) {
      int it = 0;
      for (int w = blockIdx.x, j = 0; w < n_work; w += gridDim.x, ++j) {
        int qt, bh;
        fwd_work(w, n_qt, n_bh, group_bh, qt, bh);
        const int h = bh % a.H, b = bh / a.H, kvh = h / (a.H / a.H_kv);
        const int q0 = qt * kFwdRows;
        const uint32_t qb = q_s + (j & 1) * 2 * C::kQBytes, qf = q_full + 8 * (j & 1);
        mbar_wait(q_empty + 8 * (j & 1), ((j >> 1) & 1) ^ 1);
        mbar_expect_tx(qf, 2 * C::kQBytes);
#pragma unroll
        for (int p = 0; p < C::kPanels; ++p) {
          tma_load(qb + p * C::kQPanel, &q_map, qf, p * kPanel, q0, h, b, perm & 15);
          tma_load(qb + C::kQBytes + p * C::kQPanel, &do_map, qf, p * kPanel, q0, h, b,
                   (perm >> 12) & 15);
        }
        const int n_tiles = (kv_end(a, q0, kFwdRows) + C::kKeys - 1) / C::kKeys;
        for (int i = 0; i < n_tiles; ++i, ++it) {
          const int s = it % C::kStages;
          mbar_wait(bar + 8 * (C::kStages + s), ((it / C::kStages) & 1) ^ 1);
          const uint32_t full = bar + 8 * s;
          mbar_expect_tx(full, 2 * C::kKvBytes);
#pragma unroll
          for (int p = 0; p < C::kPanels; ++p) {
            const uint32_t off = s * C::kKvBytes + p * C::kKvPanel;
            tma_load(k_s + off, &k_map, full, p * kPanel, i * C::kKeys, kvh, b, (perm >> 4) & 15);
            tma_load(v_s + off, &v_map, full, p * kPanel, i * C::kKeys, kvh, b, (perm >> 8) & 15);
          }
        }
      }
    }
  } else {
    // consumers: warpgroup wg owns query rows wq0 .. wq0 + 63 of each item
    asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n");
    const int wg = warp / 4, w = warp % 4, g = lane / 4, t = lane % 4;
    const float c2 = a.scale * kLog2e;
    const bool alibi = a.slopes != nullptr;
    // K1's turns: a turn covers dS K of one tile and Q K^T, dO V^T of the next
    Turns turns{turn, wg};
    if (wg == 1) turns.pass();
    int it = 0;
    for (int wi = blockIdx.x, j = 0; wi < n_work; wi += gridDim.x, ++j) {
      int qt, bh;
      fwd_work(wi, n_qt, n_bh, group_bh, qt, bh);
      const int h = bh % a.H, b = bh / a.H;
      const int q0 = qt * kFwdRows;
      const int n_tiles = (kv_end(a, q0, kFwdRows) + C::kKeys - 1) / C::kKeys;
      const int wq0 = q0 + wg * kWgRows;
      const int wg_end = wq0 < a.S_q ? kv_end(a, wq0, kWgRows) : 0;
      const int r0 = wq0 + w * 16 + g;  // this thread's rows: r0 and r0 + 8
      const float sl2 = alibi ? a.slopes[h] * kLog2e : 0.f;
      float lse2[2], dl[2];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int row = r0 + 8 * r;
        const int64_t at = ((int64_t)b * a.H + h) * a.S_q + row;
        lse2[r] = lse_log2(row < a.S_q ? a.lse[at] : kNegInf);
        dl[r] = row < a.S_q ? a.delta[at] : 0.f;
      }
      const uint32_t qb = q_s + (j & 1) * 2 * C::kQBytes, dob = qb + C::kQBytes;
      float dq[C::kPanels][32];
#pragma unroll
      for (int p = 0; p < C::kPanels; ++p)
#pragma unroll
        for (int x = 0; x < 32; ++x) dq[p][x] = 0.f;

      mbar_wait(q_full + 8 * (j & 1), (j >> 1) & 1);
      for (int i = 0; i < n_tiles; ++i, ++it) {
        const int s = it % C::kStages;
        const int k0 = i * C::kKeys;
        const uint32_t kb = k_s + s * C::kKvBytes, vb = v_s + s * C::kKvBytes;
        mbar_wait(bar + 8 * s, (it / C::kStages) & 1);
        if (i == 0) turns.take();
        if (k0 < wg_end) {
          float sc[kN], dp[kN];
          wg_fence();
#pragma unroll
          for (int kk = 0; kk < D / 16; ++kk) {
            const uint32_t col = (kk / 4) * C::kQPanel + wg * kWgRows * kSwRow + (kk % 4) * 32;
            const uint32_t kcol = (kk / 4) * C::kKvPanel + (kk % 4) * 32;
            wgmma_ss(sc, sw128_desc(qb + col), sw128_desc(kb + kcol), kk > 0);
            wgmma_ss(dp, sw128_desc(dob + col), sw128_desc(vb + kcol), kk > 0);
          }
          wg_commit();
          turns.pass();
          wg_wait0();
          fence_regs(sc);
          fence_regs(dp);

          // P = exp2(S * scale * log2 e + bias - LSE2) and dS = P (dP - Delta)
          // scale, in place of S; the mask only on tiles that cross the
          // diagonal, the ragged end or a ring offset (K1's rule)
          const bool edge =
              (a.causal && k0 + C::kKeys - 1 > wq0 + a.offset) || k0 + C::kKeys > a.S_k;
          if (!edge && !alibi) {
#pragma unroll
            for (int x = 0; x < kN; ++x) {
              const int r = (x >> 1) & 1;
              const float p = fast_exp2(fmaf(sc[x], c2, -lse2[r]));
              sc[x] = p * (dp[x] - dl[r]) * a.scale;
            }
          } else {
            int last[2];
            float base[2];
#pragma unroll
            for (int r = 0; r < 2; ++r) {
              const int qp = r0 + 8 * r + a.offset;
              last[r] = a.causal ? min(qp, a.S_k - 1) : a.S_k - 1;
              base[r] = (float)(qp - k0 - 2 * t);  // ALiBi distance of this thread's column 0
            }
#pragma unroll
            for (int n = 0; n < kN / 4; ++n)
#pragma unroll
              for (int e = 0; e < 4; ++e) {
                const int r = e >> 1, c = n * 8 + (e & 1);
                float x = sc[4 * n + e] * c2;
                if (alibi) x = fmaf(sl2, (float)c - base[r], x);
                x = k0 + 2 * t + c > last[r] ? kNegInf : x;
                const float p = fast_exp2(x - lse2[r]);
                sc[4 * n + e] = p * (dp[4 * n + e] - dl[r]) * a.scale;
              }
          }
          // dS rounded to K's dtype, as the TPU kernel does, as A fragments
          uint32_t da[C::kKeys / 16][4];
#pragma unroll
          for (int jj = 0; jj < C::kKeys / 16; ++jj)
#pragma unroll
            for (int x = 0; x < 4; ++x) da[jj][x] = pack2(sc[8 * jj + 2 * x], sc[8 * jj + 2 * x + 1]);
          turns.take();
#pragma unroll
          for (int p = 0; p < C::kPanels; ++p) fence_regs(dq[p]);
          wg_fence();
#pragma unroll
          for (int jj = 0; jj < C::kKeys / 16; ++jj)
#pragma unroll
            for (int p = 0; p < C::kPanels; ++p)
              wgmma_rs(dq[p], da[jj], sw128_desc(kb + p * C::kKvPanel + jj * 16 * kSwRow));
          wg_commit();
          wg_wait0();
#pragma unroll
          for (int p = 0; p < C::kPanels; ++p) fence_regs(dq[p]);
        } else {
          turns.pass();
          turns.take();
        }
        if (i == n_tiles - 1) turns.pass();
        if (lane == 0) mbar_arrive(bar + 8 * (C::kStages + s));
      }
      if (lane == 0) mbar_arrive(q_empty + 8 * (j & 1));

      bf16* dqp = static_cast<bf16*>(a.dq) + ((int64_t)b * a.S_q * a.H + h) * D;
      const int64_t row_stride = (int64_t)a.H * D;
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int row = r0 + 8 * half;
        if (row >= a.S_q) continue;
        bf16* dst = dqp + (int64_t)row * row_stride + 2 * t;
#pragma unroll
        for (int p = 0; p < C::kPanels; ++p)
#pragma unroll
          for (int n = 0; n < 8; ++n)
            *reinterpret_cast<uint32_t*>(dst + p * kPanel + n * 8) =
                pack2(dq[p][4 * n + 2 * half], dq[p][4 * n + 2 * half + 1]);
      }
    }
  }
}

// K3. Its work items are (k tile of 128 keys, batch, kv head), in K1's L2
// chunks (of the pairs whose group's Q and dO fit in L2 together) but with
// the lowest k tiles first: under causality they sweep the most q tiles.
template <int D>
__global__ void __launch_bounds__(kFwdThreads, 1)
    bwd_dkv_wgmma_kernel(const __grid_constant__ CUtensorMap q_map,
                         const __grid_constant__ CUtensorMap k_map,
                         const __grid_constant__ CUtensorMap v_map,
                         const __grid_constant__ CUtensorMap do_map, const Args a, const int perm,
                         const int group_bh) {
  using C = DkvCfg<D>;
  constexpr int kN = C::kRows / 2;  // accumulator registers of S^T and of dP^T
  constexpr int kSteps = C::kRows / 16;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t k_s = base;                           // buffer j at + j * kKvBytes
  const uint32_t v_s = k_s + 2 * C::kKvBytes;
  const uint32_t q_s = v_s + 2 * C::kKvBytes;          // stage s at + s * kQBytes
  const uint32_t do_s = q_s + C::kStages * C::kQBytes;
  const uint32_t rows_s = do_s + C::kStages * C::kQBytes;  // stage s: LSE[kRows], Delta[kRows]
  const float* rows_p = reinterpret_cast<const float*>(smem_raw + (rows_s - smem_u32(smem_raw)));
  // barriers: full[kStages], empty[kStages], kv_full[2], kv_empty[2], turn[2]
  const uint32_t bar = rows_s + C::kStages * 2 * C::kRows * 4;
  const uint32_t kv_full = bar + 16 * C::kStages, kv_empty = kv_full + 16, turn = kv_empty + 16;

  const int group = a.H / a.H_kv;
  const int n_bkv = a.B * a.H_kv;
  const int n_kt = (a.S_k + kFwdKeys - 1) / kFwdKeys;
  const int n_qt = (a.S_q + C::kRows - 1) / C::kRows;
  const int n_work = n_kt * n_bkv;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;

  if (threadIdx.x == 0) {
    for (int s = 0; s < C::kStages; ++s) {
      mbar_init(bar + 8 * s, 1 + 32);  // the expect_tx, and the producer warp's cp.async copies
      mbar_init(bar + 8 * (C::kStages + s), 8);
    }
    for (int j = 0; j < 2; ++j) {
      mbar_init(kv_full + 8 * j, 1);
      mbar_init(kv_empty + 8 * j, 8);
      mbar_init(turn + 8 * j, kWgThreads);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp >= 8) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n");
    if (warp == 8) {
      // lane 0 issues the TMA copies; every lane copies LSE and Delta rows
      int it = 0;
      for (int w = blockIdx.x, j = 0; w < n_work; w += gridDim.x, ++j) {
        int kt, bkv;
        fwd_work(w, n_kt, n_bkv, group_bh, kt, bkv);
        kt = n_kt - 1 - kt;
        const int kvh = bkv % a.H_kv, b = bkv / a.H_kv;
        const int k0 = kt * kFwdKeys;
        mbar_wait(kv_empty + 8 * (j & 1), ((j >> 1) & 1) ^ 1);
        if (lane == 0) {
          const uint32_t kvf = kv_full + 8 * (j & 1);
          mbar_expect_tx(kvf, 2 * C::kKvBytes);
#pragma unroll
          for (int p = 0; p < C::kPanels; ++p) {
            const uint32_t off = (j & 1) * C::kKvBytes + p * C::kKvPanel;
            tma_load(k_s + off, &k_map, kvf, p * kPanel, k0, kvh, b, (perm >> 4) & 15);
            tma_load(v_s + off, &v_map, kvf, p * kPanel, k0, kvh, b, (perm >> 8) & 15);
          }
        }
        const int t0 = first_q_tile(a, k0, C::kRows);
        for (int gi = 0; gi < group; ++gi) {
          const int h = kvh * group + gi;  // JAX's qrow order
          const int64_t row_bh = ((int64_t)b * a.H + h) * a.S_q;
          for (int tq = t0; tq < n_qt; ++tq, ++it) {
            const int s = it % C::kStages;
            const int q0 = tq * C::kRows;
            const uint32_t full = bar + 8 * s;
            mbar_wait(bar + 8 * (C::kStages + s), ((it / C::kStages) & 1) ^ 1);
            if (lane == 0) {
              mbar_expect_tx(full, 2 * C::kQBytes);
#pragma unroll
              for (int p = 0; p < C::kPanels; ++p) {
                const uint32_t off = s * C::kQBytes + p * C::kQPanel;
                tma_load(q_s + off, &q_map, full, p * kPanel, q0, h, b, perm & 15);
                tma_load(do_s + off, &do_map, full, p * kPanel, q0, h, b, (perm >> 12) & 15);
              }
            }
            // rows past S_q read as 0 (their scores are masked)
            const uint32_t dst = rows_s + s * 2 * C::kRows * 4;
            for (int r = lane; r < C::kRows; r += 32) {
              const int in = q0 + r < a.S_q;
              const int64_t at = row_bh + (in ? q0 + r : 0);
              cp_async4(dst + r * 4, a.lse + at, in ? 4 : 0);
              cp_async4(dst + (C::kRows + r) * 4, a.delta + at, in ? 4 : 0);
            }
            cp_async_arrive(full);
          }
        }
      }
    }
  } else {
    // consumers: warpgroup wg owns keys wk0 .. wk0 + 63 of each item
    asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n");
    const int wg = warp / 4, w = warp % 4, g = lane / 4, t = lane % 4;
    const float c2 = a.scale * kLog2e;
    const bool alibi = a.slopes != nullptr;
    // K1's turns: a turn covers dV, dK of one tile and S^T, dP^T of the next
    Turns turns{turn, wg};
    if (wg == 1) turns.pass();
    int it = 0;
    for (int wi = blockIdx.x, j = 0; wi < n_work; wi += gridDim.x, ++j) {
      int kt, bkv;
      fwd_work(wi, n_kt, n_bkv, group_bh, kt, bkv);
      kt = n_kt - 1 - kt;
      const int kvh = bkv % a.H_kv, b = bkv / a.H_kv;
      const int wk0 = kt * kFwdKeys + wg * kWgRows;
      const int kr = wk0 + w * 16 + g;  // this thread's keys: kr and kr + 8
      const int t0 = first_q_tile(a, kt * kFwdKeys, C::kRows);
      const int n_tiles = group * max(0, n_qt - t0);
      const uint32_t kb = k_s + (j & 1) * C::kKvBytes + wg * kWgRows * kSwRow;
      const uint32_t vb = v_s + (j & 1) * C::kKvBytes + wg * kWgRows * kSwRow;
      float dk[C::kPanels][32], dv[C::kPanels][32];
#pragma unroll
      for (int p = 0; p < C::kPanels; ++p)
#pragma unroll
        for (int x = 0; x < 32; ++x) dk[p][x] = dv[p][x] = 0.f;

      mbar_wait(kv_full + 8 * (j & 1), (j >> 1) & 1);
      for (int i = 0; i < n_tiles; ++i, ++it) {
        const int h = kvh * group + i / (n_qt - t0);
        const int q0 = (t0 + i % (n_qt - t0)) * C::kRows;
        const int s = it % C::kStages;
        const uint32_t qb = q_s + s * C::kQBytes, dob = do_s + s * C::kQBytes;
        mbar_wait(bar + 8 * s, (it / C::kStages) & 1);
        if (i == 0) turns.take();
        if (wk0 < a.S_k && (!a.causal || wk0 <= q0 + C::kRows - 1 + a.offset)) {
          float st[kN], dpt[kN];
          wg_fence();
#pragma unroll
          for (int kk = 0; kk < D / 16; ++kk) {
            const uint32_t kcol = (kk / 4) * C::kKvPanel + (kk % 4) * 32;
            const uint32_t qcol = (kk / 4) * C::kQPanel + (kk % 4) * 32;
            wgmma_ss(st, sw128_desc(kb + kcol), sw128_desc(qb + qcol), kk > 0);
            wgmma_ss(dpt, sw128_desc(vb + kcol), sw128_desc(dob + qcol), kk > 0);
          }
          wg_commit();
          turns.pass();
          wg_wait0();
          fence_regs(st);
          fence_regs(dpt);

          // P^T and dS^T in place of S^T and dP^T: rows are keys, columns
          // query rows, so LSE and Delta go by column; the mask only on tiles
          // that cross the diagonal, a ring offset or the ragged end of q
          const float* lse_p = rows_p + s * 2 * C::kRows + 2 * t;
          const float* dl_p = lse_p + C::kRows;
          const bool edge =
              (a.causal && wk0 + kWgRows - 1 > q0 + a.offset) || q0 + C::kRows > a.S_q;
          if (!edge && !alibi) {
#pragma unroll
            for (int n = 0; n < kN / 4; ++n) {
              const float2 l = *reinterpret_cast<const float2*>(lse_p + 8 * n);
              const float2 d = *reinterpret_cast<const float2*>(dl_p + 8 * n);
              const float l2[2] = {lse_log2(l.x), lse_log2(l.y)}, dd[2] = {d.x, d.y};
#pragma unroll
              for (int e = 0; e < 4; ++e) {
                const float p = fast_exp2(fmaf(st[4 * n + e], c2, -l2[e & 1]));
                st[4 * n + e] = p;
                dpt[4 * n + e] = p * (dpt[4 * n + e] - dd[e & 1]) * a.scale;
              }
            }
          } else {
            const float sl2 = alibi ? a.slopes[h] * kLog2e : 0.f;
            // rel[r]: this thread's first column that sees key row r, which is
            // also where that row's ALiBi distance is 0
            int rel[2];
#pragma unroll
            for (int r = 0; r < 2; ++r) rel[r] = kr + 8 * r - a.offset - q0 - 2 * t;
            const int n_col = a.S_q - q0 - 2 * t;  // columns at or past this are past S_q
#pragma unroll
            for (int n = 0; n < kN / 4; ++n) {
              const float2 l = *reinterpret_cast<const float2*>(lse_p + 8 * n);
              const float2 d = *reinterpret_cast<const float2*>(dl_p + 8 * n);
              const float l2[2] = {lse_log2(l.x), lse_log2(l.y)}, dd[2] = {d.x, d.y};
#pragma unroll
              for (int e = 0; e < 4; ++e) {
                const int r = e >> 1, c = n * 8 + (e & 1);
                float x = st[4 * n + e] * c2;
                if (alibi) x = fmaf(sl2, (float)(rel[r] - c), x);  // -slope (qp + offset - kp)
                x = c >= n_col || (a.causal && c < rel[r]) ? kNegInf : x;
                const float p = fast_exp2(x - l2[e & 1]);
                st[4 * n + e] = p;
                dpt[4 * n + e] = p * (dpt[4 * n + e] - dd[e & 1]) * a.scale;
              }
            }
          }
          // P^T and dS^T stay fp32 in meaning, as in the TPU kernel: each
          // enters its product as bf16 hi + lo (lo = the rounding error of
          // hi), both into the same fp32 accumulator. hi is widened back
          // from its packed pair by shifts: conversions run at a quarter of
          // the fp32 rate, and this phase is on the critical path.
          uint32_t ph[kSteps][4], pl[kSteps][4], sh[kSteps][4], sl[kSteps][4];
#pragma unroll
          for (int jj = 0; jj < kSteps; ++jj)
#pragma unroll
            for (int x = 0; x < 4; ++x) {
              const float p0 = st[8 * jj + 2 * x], p1 = st[8 * jj + 2 * x + 1];
              const float d0 = dpt[8 * jj + 2 * x], d1 = dpt[8 * jj + 2 * x + 1];
              ph[jj][x] = pack2(p0, p1);
              pl[jj][x] = pack2(p0 - __uint_as_float(ph[jj][x] << 16),
                                p1 - __uint_as_float(ph[jj][x] & 0xffff0000u));
              sh[jj][x] = pack2(d0, d1);
              sl[jj][x] = pack2(d0 - __uint_as_float(sh[jj][x] << 16),
                                d1 - __uint_as_float(sh[jj][x] & 0xffff0000u));
            }
          turns.take();
#pragma unroll
          for (int p = 0; p < C::kPanels; ++p) {
            fence_regs(dk[p]);
            fence_regs(dv[p]);
          }
          wg_fence();
#pragma unroll
          for (int jj = 0; jj < kSteps; ++jj)
#pragma unroll
            for (int p = 0; p < C::kPanels; ++p) {
              const uint32_t row = p * C::kQPanel + jj * 16 * kSwRow;
              wgmma_rs(dv[p], ph[jj], sw128_desc(dob + row));
              wgmma_rs(dv[p], pl[jj], sw128_desc(dob + row));
              wgmma_rs(dk[p], sh[jj], sw128_desc(qb + row));
              wgmma_rs(dk[p], sl[jj], sw128_desc(qb + row));
            }
          wg_commit();
          wg_wait0();
#pragma unroll
          for (int p = 0; p < C::kPanels; ++p) {
            fence_regs(dk[p]);
            fence_regs(dv[p]);
          }
        } else {
          turns.pass();
          turns.take();
        }
        if (i == n_tiles - 1) turns.pass();
        if (lane == 0) mbar_arrive(bar + 8 * (C::kStages + s));
      }
      if (lane == 0) mbar_arrive(kv_empty + 8 * (j & 1));

      const int64_t off = ((int64_t)b * a.S_k * a.H_kv + kvh) * D;
      const int64_t row_stride = (int64_t)a.H_kv * D;
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int row = kr + 8 * half;
        if (row >= a.S_k) continue;
        bf16* dkp = static_cast<bf16*>(a.dk) + off + (int64_t)row * row_stride + 2 * t;
        bf16* dvp = static_cast<bf16*>(a.dv) + off + (int64_t)row * row_stride + 2 * t;
#pragma unroll
        for (int p = 0; p < C::kPanels; ++p)
#pragma unroll
          for (int n = 0; n < 8; ++n) {
            const int x = 4 * n + 2 * half;
            *reinterpret_cast<uint32_t*>(dkp + p * kPanel + n * 8) = pack2(dk[p][x], dk[p][x + 1]);
            *reinterpret_cast<uint32_t*>(dvp + p * kPanel + n * 8) = pack2(dv[p][x], dv[p][x + 1]);
          }
      }
    }
  }
}

template <int D>
int launch_bwd_dq_wgmma(const Args& a, cudaStream_t stream) {
  CUtensorMap qm, km, vm, dm;
  int perm, ctas, err;
  if ((err = make_maps(a, D, kFwdRows, DqCfg<D>::kKeys, &qm, &km, &vm, &dm, &perm))) return err;
  const int n_work = (a.S_q + kFwdRows - 1) / kFwdRows * a.B * a.H;
  if ((err = persistent_setup(reinterpret_cast<const void*>(bwd_dq_wgmma_kernel<D>),
                              DqCfg<D>::kSmem, n_work, &ctas)))
    return err;
  bwd_dq_wgmma_kernel<D><<<ctas, kFwdThreads, DqCfg<D>::kSmem, stream>>>(
      qm, km, vm, dm, a, perm, l2_chunk((int64_t)a.S_k * D * 2 * 2, a.B * a.H));  // K and V
  return (int)cudaGetLastError();
}

template <int D>
int launch_bwd_dkv_wgmma(const Args& a, cudaStream_t stream) {
  using C = DkvCfg<D>;
  CUtensorMap qm, km, vm, dm;
  int perm, ctas, err;
  if ((err = make_maps(a, D, C::kRows, kFwdKeys, &qm, &km, &vm, &dm, &perm))) return err;
  const int n_work = (a.S_k + kFwdKeys - 1) / kFwdKeys * a.B * a.H_kv;
  if ((err = persistent_setup(reinterpret_cast<const void*>(bwd_dkv_wgmma_kernel<D>), C::kSmem,
                              n_work, &ctas)))
    return err;
  const int64_t qdo_bytes = (int64_t)(a.H / a.H_kv) * a.S_q * D * 2 * 2;  // the group's Q and dO
  bwd_dkv_wgmma_kernel<D><<<ctas, kFwdThreads, C::kSmem, stream>>>(
      qm, km, vm, dm, a, perm, l2_chunk(qdo_bytes, a.B * a.H_kv));
  return (int)cudaGetLastError();
}

// bf16: K1, K2 and K3 on wgmma + TMA
template <int D>
int launch_bf16(int which, const Args& a, cudaStream_t stream) {
  return which == 0 ? launch_fwd_wgmma<D>(a, stream)
       : which == 1 ? launch_bwd_dq_wgmma<D>(a, stream)
                    : launch_bwd_dkv_wgmma<D>(a, stream);
}

constexpr int smem_floats(int which, int D) {
  // which: 0 = K1, 1 = K2, 2 = K3
  return which == 0 ? 3 * kTile * (D + kPad) + kTile * kLdp + 3 * kTile
       : which == 1 ? 4 * kTile * (D + kPad) + kTile * kLdp + 2 * kTile
                    : 4 * kTile * (D + kPad) + 2 * kTile * kLdp + 2 * kTile;
}

template <typename T, int D>
int launch(int which, const Args& a, cudaStream_t stream) {
  const int smem = smem_floats(which, D) * (int)sizeof(float);
  void (*kernel)(const Args) = which == 0 ? fwd_kernel<T, D>
                             : which == 1 ? bwd_dq_kernel<T, D> : bwd_dkv_kernel<T, D>;
  // above 48 KB a kernel's dynamic shared memory must be asked for first
  cudaError_t err = cudaFuncSetAttribute(reinterpret_cast<const void*>(kernel),
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  const int rows = which == 2 ? a.S_k : a.S_q;
  const dim3 grid((rows + kTile - 1) / kTile, which == 2 ? a.H_kv : a.H, a.B);
  kernel<<<grid, kThreads, smem, stream>>>(a);
  return (int)cudaGetLastError();
}

int dispatch(int which, int dtype, int head_dim, const Args& a, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0 && head_dim == 64) return launch<float, 64>(which, a, s);
  if (dtype == 0 && head_dim == 128) return launch<float, 128>(which, a, s);
  if (dtype == 1 && head_dim == 64) return launch_bf16<64>(which, a, s);
  if (dtype == 1 && head_dim == 128) return launch_bf16<128>(which, a, s);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// One entry for the three kernels. which: 0 = forward (K1), 1 = dQ (K2),
// 2 = dK/dV (K3). dtype: 0 = float32, 1 = bfloat16. head_dim: 64 or 128.
// strides: the batch, sequence and head strides (elements) of q, k, v, in
// that order (9 values). dims: B, H, H_kv, S_q, S_k, causal, offset.
// Pointers a kernel does not use may be null. Returns a cudaError_t (0 on
// success) from the launch.
int photon_flash_launch(int which, int dtype, int head_dim,
                        const void* q, const void* k, const void* v, const int64_t* strides,
                        const void* dout, const float* slopes, const float* delta, float* lse,
                        void* o, void* dq, void* dk, void* dv,
                        const int* dims, float scale, void* stream) {
  Args a{q, strides[0], strides[1], strides[2],
         k, strides[3], strides[4], strides[5],
         v, strides[6], strides[7], strides[8],
         dout, slopes, delta, lse, o, dq, dk, dv,
         dims[0], dims[1], dims[2], dims[3], dims[4], dims[5], dims[6], scale};
  if (which < 0 || which > 2) return (int)cudaErrorInvalidValue;
  return dispatch(which, dtype, head_dim, a, stream);
}

const char* photon_flash_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
