// Flash attention forward and backward for Hopper (sm_90a), with plain C
// entry points.
//
// Replaces the three TPU kernels of photon_tpu/ops/flash_attention.py:
//   K1 _fwd_kernel     (:93,  launched by _fwd at :207)  -> fwd_kernel
//   K2 _bwd_dq_kernel  (:231, launched by _bwd at :365)  -> bwd_dq_kernel
//   K3 _bwd_dkv_kernel (:280, launched by _bwd at :392)  -> bwd_dkv_kernel
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
// of operands), so bf16 runs on tensor cores: every tile product is an
// mma.sync.m16n8k16 (bf16 in, fp32 accumulate), 4 warps a CTA, each owning
// 16 rows of a 64 x 64 tile, with scores and probabilities kept in
// registers in the accumulator layout, which is also the next product's A
// layout. fp32 inputs (the fp32 gates) run on CUDA cores: 64 x 64 tiles in
// fp32 shared memory, 256 threads, each owning a 4 x 4 block of a tile
// product fed by 16-byte shared-memory loads. Both stop the causal loops at
// the diagonal tile, so the masked half of the work is skipped. wgmma, TMA
// and a producer warp are later work.
//
// Layout: q/k/v are [B, S, H, D] tensors addressed through their batch,
// sequence and head strides (the dim axis is dense), so the q/k/v views of
// a fused QKV projection are read without a copy. O, dO, dQ, dK, dV are
// dense [B, S, H, D]; LSE and Delta are fp32 [B, H, S_q]. D is 64 or 128.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC -o libphoton_flash.so flash_attention.cu

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

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

// One past the last key any query of the tile starting at q0 can see.
__device__ __forceinline__ int kv_end(const Args& a, int q0) {
  if (!a.causal) return a.S_k;
  const int q_last = min(q0 + kTile, a.S_q) - 1;
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
// bf16 on tensor cores: the same three kernels with every tile product as
// mma.sync.m16n8k16 (bf16 operands, fp32 accumulation). 4 warps a CTA, each
// owning 16 of the 64 rows of its tile; scores, probabilities and gradients
// stay in registers in the mma accumulator layout, which is also the layout
// of the next product's A operand (FlashAttention-2's register reuse), so
// only the tiles read from device memory pass through shared memory.
// Thread (g = lane / 4, t = lane % 4) holds, for an accumulator of 16 rows x
// 8 columns, rows g and g + 8 at columns 2t and 2t + 1.
// ---------------------------------------------------------------------------

constexpr int kMmaThreads = 128;
constexpr int kLdt = kTile + 8;  // bf16 row length of a transposed tile

typedef __nv_bfloat16 bf16;

__device__ __forceinline__ uint32_t ld32(const bf16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

__device__ __forceinline__ uint32_t pack2(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// c += A (16 x 16, row) * B (16 x 8, col), bf16 in, fp32 accumulate
__device__ __forceinline__ void mma16816(float c[4], const uint32_t a[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Rows row0 .. row0+63 of a [S, D] bf16 slice into dst[64][D + 8]
// (zeros past n_valid); with kT, transposed into dst[D][kLdt].
template <int D, bool kT>
__device__ __forceinline__ void load_bf16(bf16* dst, const bf16* src, int64_t row_stride,
                                          int row0, int n_valid) {
  constexpr int kPerRow = D / 8;
  for (int i = threadIdx.x; i < kTile * kPerRow; i += kMmaThreads) {
    const int r = i / kPerRow;
    const int c = (i % kPerRow) * 8;
    uint4 raw = make_uint4(0u, 0u, 0u, 0u);
    if (row0 + r < n_valid)
      raw = *reinterpret_cast<const uint4*>(src + (int64_t)(row0 + r) * row_stride + c);
    if (kT) {
      const bf16* e = reinterpret_cast<const bf16*>(&raw);
#pragma unroll
      for (int x = 0; x < 8; ++x) dst[(c + x) * kLdt + r] = e[x];
    } else {
      *reinterpret_cast<uint4*>(dst + r * (D + 8) + c) = raw;
    }
  }
}

// acc[n] (16 x 64 in 8-column tiles) += A B^T over all of D, for A rows
// r0 .. r0+15 of a row-major [64][D + 8] tile and B a row-major [64][D + 8]
// tile: acc[r][j] = sum_d A[r][d] * B[j][d]
template <int D>
__device__ __forceinline__ void mma_nt(float acc[8][4], const bf16* a, int r0, const bf16* b,
                                       int g, int t) {
  constexpr int kLd = D + 8;
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    const bf16* ar = a + (r0 + g) * kLd + kk * 16 + 2 * t;
    const uint32_t af[4] = {ld32(ar), ld32(ar + 8 * kLd), ld32(ar + 8), ld32(ar + 8 * kLd + 8)};
#pragma unroll
    for (int n = 0; n < 8; ++n) {
      const bf16* br = b + (n * 8 + g) * kLd + kk * 16 + 2 * t;
      mma16816(acc[n], af, ld32(br), ld32(br + 8));
    }
  }
}

// The A fragment of k-step j (columns 16j .. 16j+15) of a 16 x 64
// accumulator, rounded to bf16; with kLo, the rounding error of that
// (x - bf16(x)) rounded in turn, so that hi + lo carries ~16 bits
template <bool kLo = false>
__device__ __forceinline__ void acc_to_a(uint32_t a[4], const float x[8][4], int j) {
  float v[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const float y = x[2 * j + (i >> 2)][i & 3];
    v[i] = kLo ? y - round_to<bf16>(y) : y;
  }
  a[0] = pack2(v[0], v[1]);
  a[1] = pack2(v[2], v[3]);
  a[2] = pack2(v[4], v[5]);
  a[3] = pack2(v[6], v[7]);
}

// acc[n] (16 x D) += A (16 x 64, k-step fragments) * B, B given transposed
// as bt[D][kLdt]: acc[r][d] = sum_x A[r][x] * bt[d][x]
template <int D>
__device__ __forceinline__ void mma_tn_step(float acc[D / 8][4], const uint32_t a[4],
                                            const bf16* bt, int j, int g, int t) {
#pragma unroll
  for (int n = 0; n < D / 8; ++n) {
    const bf16* row = bt + (n * 8 + g) * kLdt + j * 16 + 2 * t;
    mma16816(acc[n], a, ld32(row), ld32(row + 8));
  }
}

// Rows r (acc[.][0..1]) and r + 8 (acc[.][2..3]) of a 16 x D accumulator,
// scaled by 1 / den, into a dense bf16 [.., row_stride] output.
template <int D>
__device__ __forceinline__ void store_acc(bf16* dst, int64_t row_stride, int r, int n_valid,
                                          int t, const float acc[D / 8][4], float den0,
                                          float den1) {
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int row = r + 8 * half;
    if (row >= n_valid) continue;
    const float den = half ? den1 : den0;
    bf16* p = dst + (int64_t)row * row_stride + 2 * t;
#pragma unroll
    for (int n = 0; n < D / 8; ++n)
      *reinterpret_cast<uint32_t*>(p + n * 8) =
          pack2(acc[n][2 * half] / den, acc[n][2 * half + 1] / den);
  }
}

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}

__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

// K1 on tensor cores. grid (ceil(S_q / 64), H, B).
template <int D>
__global__ void __launch_bounds__(kMmaThreads) fwd_mma_kernel(const Args a) {
  constexpr int kLd = D + 8;
  extern __shared__ float4 smem4[];
  bf16* q_s = reinterpret_cast<bf16*>(smem4);
  bf16* k_s = q_s + kTile * kLd;
  bf16* vt_s = k_s + kTile * kLd;  // [D][key]

  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5, g = lane >> 2, t = lane & 3;
  const int q0 = blockIdx.x * kTile, h = blockIdx.y, b = blockIdx.z;
  const int kvh = h / (a.H / a.H_kv);
  const bf16* qp = static_cast<const bf16*>(a.q) + b * a.q_sb + h * a.q_sh;
  const bf16* kp = static_cast<const bf16*>(a.k) + b * a.k_sb + kvh * a.k_sh;
  const bf16* vp = static_cast<const bf16*>(a.v) + b * a.v_sb + kvh * a.v_sh;
  const float slope = a.slopes != nullptr ? a.slopes[h] : 0.f;
  const int r0 = q0 + w * 16 + g;  // this thread's rows: r0 and r0 + 8

  load_bf16<D, false>(q_s, qp, a.q_ss, q0, a.S_q);
  float o[D / 8][4] = {};
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};

  const int end = kv_end(a, q0);
  for (int k0 = 0; k0 < end; k0 += kTile) {
    __syncthreads();
    load_bf16<D, false>(k_s, kp, a.k_ss, k0, a.S_k);
    load_bf16<D, true>(vt_s, vp, a.v_ss, k0, a.S_k);
    __syncthreads();
    float s[8][4] = {};
    mma_nt<D>(s, q_s, w * 16, k_s, g, t);
    float mx[2] = {kNegInf, kNegInf};
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        s[n][e] = score(a, s[n][e], slope, r0 + 8 * (e >> 1), k0 + n * 8 + 2 * t + (e & 1));
        mx[e >> 1] = fmaxf(mx[e >> 1], s[n][e]);
      }
    float alpha[2], sum[2] = {0.f, 0.f}, m_new[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      m_new[i] = fmaxf(m[i], quad_max(mx[i]));
      alpha[i] = expf(m[i] - m_new[i]);
    }
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float mn = m_new[e >> 1];
        // a row with no visible key yet keeps m at NEG_INF: force p to 0
        s[n][e] = (mn > 0.5f * kNegInf) ? expf(s[n][e] - mn) : 0.f;
        sum[e >> 1] += s[n][e];
      }
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      l[i] = l[i] * alpha[i] + quad_sum(sum[i]);
      m[i] = m_new[i];
    }
#pragma unroll
    for (int n = 0; n < D / 8; ++n) {
      o[n][0] *= alpha[0];
      o[n][1] *= alpha[0];
      o[n][2] *= alpha[1];
      o[n][3] *= alpha[1];
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      uint32_t pa[4];
      acc_to_a(pa, s, j);  // P rounded to V's dtype, as the TPU kernel does
      mma_tn_step<D>(o, pa, vt_s, j, g, t);
    }
  }
  const float den0 = l[0] == 0.f ? 1.f : l[0], den1 = l[1] == 0.f ? 1.f : l[1];
  bf16* op = static_cast<bf16*>(a.o) + (((int64_t)b * a.S_q + q0) * a.H + h) * D;
  store_acc<D>(op, (int64_t)a.H * D, w * 16 + g, a.S_q - q0, t, o, den0, den1);
  if (t == 0) {
    const int64_t base = ((int64_t)b * a.H + h) * a.S_q;
    if (r0 < a.S_q) a.lse[base + r0] = m[0] + logf(den0);
    if (r0 + 8 < a.S_q) a.lse[base + r0 + 8] = m[1] + logf(den1);
  }
}

// K2 on tensor cores. grid (ceil(S_q / 64), H, B).
template <int D>
__global__ void __launch_bounds__(kMmaThreads) bwd_dq_mma_kernel(const Args a) {
  constexpr int kLd = D + 8;
  extern __shared__ float4 smem4[];
  bf16* q_s = reinterpret_cast<bf16*>(smem4);
  bf16* do_s = q_s + kTile * kLd;
  bf16* k_s = do_s + kTile * kLd;
  bf16* v_s = k_s + kTile * kLd;
  bf16* kt_s = v_s + kTile * kLd;  // [D][key]

  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5, g = lane >> 2, t = lane & 3;
  const int q0 = blockIdx.x * kTile, h = blockIdx.y, b = blockIdx.z;
  const int kvh = h / (a.H / a.H_kv);
  const bf16* qp = static_cast<const bf16*>(a.q) + b * a.q_sb + h * a.q_sh;
  const bf16* kp = static_cast<const bf16*>(a.k) + b * a.k_sb + kvh * a.k_sh;
  const bf16* vp = static_cast<const bf16*>(a.v) + b * a.v_sb + kvh * a.v_sh;
  const bf16* dop = static_cast<const bf16*>(a.dout) + ((int64_t)b * a.S_q * a.H + h) * D;
  const float slope = a.slopes != nullptr ? a.slopes[h] : 0.f;
  const int r0 = q0 + w * 16 + g;
  const int64_t base = ((int64_t)b * a.H + h) * a.S_q;
  float lse[2], dl[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const bool in = r0 + 8 * i < a.S_q;
    lse[i] = in ? a.lse[base + r0 + 8 * i] : kNegInf;
    dl[i] = in ? a.delta[base + r0 + 8 * i] : 0.f;
  }

  load_bf16<D, false>(q_s, qp, a.q_ss, q0, a.S_q);
  load_bf16<D, false>(do_s, dop, (int64_t)a.H * D, q0, a.S_q);
  float dq[D / 8][4] = {};

  const int end = kv_end(a, q0);
  for (int k0 = 0; k0 < end; k0 += kTile) {
    __syncthreads();
    load_bf16<D, false>(k_s, kp, a.k_ss, k0, a.S_k);
    load_bf16<D, false>(v_s, vp, a.v_ss, k0, a.S_k);
    load_bf16<D, true>(kt_s, kp, a.k_ss, k0, a.S_k);
    __syncthreads();
    float s[8][4] = {}, dp[8][4] = {};
    mma_nt<D>(s, q_s, w * 16, k_s, g, t);
    mma_nt<D>(dp, do_s, w * 16, v_s, g, t);
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int i = e >> 1;
        const float x = score(a, s[n][e], slope, r0 + 8 * i, k0 + n * 8 + 2 * t + (e & 1));
        // guard fully-masked rows (lse == NEG_INF): exp(s - lse) would be 1
        const float p = (lse[i] > 0.5f * kNegInf) ? expf(x - lse[i]) : 0.f;
        s[n][e] = p * (dp[n][e] - dl[i]) * a.scale;
      }
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      uint32_t da[4];
      acc_to_a(da, s, j);  // dS rounded to K's dtype, as the TPU kernel does
      mma_tn_step<D>(dq, da, kt_s, j, g, t);
    }
  }
  bf16* dqp = static_cast<bf16*>(a.dq) + (((int64_t)b * a.S_q + q0) * a.H + h) * D;
  store_acc<D>(dqp, (int64_t)a.H * D, w * 16 + g, a.S_q - q0, t, dq, 1.f, 1.f);
}

// K3 on tensor cores. grid (ceil(S_k / 64), H_kv, B). P and dS enter their
// products as a bf16 pair hi + lo (hi = bf16(x), lo = bf16(x - hi)): the
// TPU kernel keeps them in fp32, and the pair carries ~16 bits of mantissa.
template <int D>
__global__ void __launch_bounds__(kMmaThreads) bwd_dkv_mma_kernel(const Args a) {
  constexpr int kLd = D + 8;
  extern __shared__ float4 smem4[];
  bf16* k_s = reinterpret_cast<bf16*>(smem4);
  bf16* v_s = k_s + kTile * kLd;
  bf16* q_s = v_s + kTile * kLd;
  bf16* do_s = q_s + kTile * kLd;
  bf16* qt_s = do_s + kTile * kLd;  // [D][query row]
  bf16* dot_s = qt_s + D * kLdt;    // [D][query row]
  float* lse_s = reinterpret_cast<float*>(dot_s + D * kLdt);
  float* dl_s = lse_s + kTile;

  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5, g = lane >> 2, t = lane & 3;
  const int k0 = blockIdx.x * kTile, kvh = blockIdx.y, b = blockIdx.z;
  const int group = a.H / a.H_kv;
  const bf16* kp = static_cast<const bf16*>(a.k) + b * a.k_sb + kvh * a.k_sh;
  const bf16* vp = static_cast<const bf16*>(a.v) + b * a.v_sb + kvh * a.v_sh;
  const int kr = k0 + w * 16 + g;  // this thread's keys: kr and kr + 8

  load_bf16<D, false>(k_s, kp, a.k_ss, k0, a.S_k);
  load_bf16<D, false>(v_s, vp, a.v_ss, k0, a.S_k);
  float dk[D / 8][4] = {}, dv[D / 8][4] = {};

  const int n_q = (a.S_q + kTile - 1) / kTile;
  for (int gi = 0; gi < group; ++gi) {
    const int h = kvh * group + gi;
    const bf16* qp = static_cast<const bf16*>(a.q) + b * a.q_sb + h * a.q_sh;
    const bf16* dop = static_cast<const bf16*>(a.dout) + ((int64_t)b * a.S_q * a.H + h) * D;
    const float slope = a.slopes != nullptr ? a.slopes[h] : 0.f;
    const int64_t base = ((int64_t)b * a.H + h) * a.S_q;
    for (int tq = 0; tq < n_q; ++tq) {
      const int q0 = tq * kTile;
      if (k0 >= kv_end(a, q0)) continue;  // no query of this tile sees these keys
      __syncthreads();
      load_bf16<D, false>(q_s, qp, a.q_ss, q0, a.S_q);
      load_bf16<D, false>(do_s, dop, (int64_t)a.H * D, q0, a.S_q);
      load_bf16<D, true>(qt_s, qp, a.q_ss, q0, a.S_q);
      load_bf16<D, true>(dot_s, dop, (int64_t)a.H * D, q0, a.S_q);
      if (threadIdx.x < kTile) {
        const bool in = q0 + threadIdx.x < a.S_q;
        lse_s[threadIdx.x] = in ? a.lse[base + q0 + threadIdx.x] : kNegInf;
        dl_s[threadIdx.x] = in ? a.delta[base + q0 + threadIdx.x] : 0.f;
      }
      __syncthreads();
      // transposed tiles: rows are keys, columns query rows; st becomes
      // P^T and dpt dS^T in place
      float st[8][4] = {}, dpt[8][4] = {};
      mma_nt<D>(st, k_s, w * 16, q_s, g, t);
      mma_nt<D>(dpt, v_s, w * 16, do_s, g, t);
#pragma unroll
      for (int n = 0; n < 8; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int c = n * 8 + 2 * t + (e & 1);  // query row within the tile
          const float x = score(a, st[n][e], slope, q0 + c, kr + 8 * (e >> 1));
          const float lse = lse_s[c];
          st[n][e] = (lse > 0.5f * kNegInf) ? expf(x - lse) : 0.f;
          dpt[n][e] = st[n][e] * (dpt[n][e] - dl_s[c]) * a.scale;
        }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        uint32_t hi[4], lo[4];
        acc_to_a(hi, st, j);
        acc_to_a<true>(lo, st, j);
        mma_tn_step<D>(dv, hi, dot_s, j, g, t);
        mma_tn_step<D>(dv, lo, dot_s, j, g, t);
        acc_to_a(hi, dpt, j);
        acc_to_a<true>(lo, dpt, j);
        mma_tn_step<D>(dk, hi, qt_s, j, g, t);
        mma_tn_step<D>(dk, lo, qt_s, j, g, t);
      }
    }
  }
  const int64_t off = (((int64_t)b * a.S_k + k0) * a.H_kv + kvh) * D;
  store_acc<D>(static_cast<bf16*>(a.dk) + off, (int64_t)a.H_kv * D, w * 16 + g, a.S_k - k0, t,
               dk, 1.f, 1.f);
  store_acc<D>(static_cast<bf16*>(a.dv) + off, (int64_t)a.H_kv * D, w * 16 + g, a.S_k - k0, t,
               dv, 1.f, 1.f);
}

constexpr int mma_smem_bytes(int which, int D) {
  // bf16 tiles: row-major [64][D + 8], transposed [D][kLdt]; K3 adds fp32 LSE/Delta
  return which == 0 ? (2 * kTile * (D + 8) + D * kLdt) * 2
       : which == 1 ? (4 * kTile * (D + 8) + D * kLdt) * 2
                    : (4 * kTile * (D + 8) + 2 * D * kLdt) * 2 + 2 * kTile * 4;
}

template <int D>
int launch_mma(int which, const Args& a, cudaStream_t stream) {
  const int smem = mma_smem_bytes(which, D);
  void (*kernel)(const Args) = which == 0 ? fwd_mma_kernel<D>
                             : which == 1 ? bwd_dq_mma_kernel<D> : bwd_dkv_mma_kernel<D>;
  cudaError_t err = cudaFuncSetAttribute(reinterpret_cast<const void*>(kernel),
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  const int rows = which == 2 ? a.S_k : a.S_q;
  const dim3 grid((rows + kTile - 1) / kTile, which == 2 ? a.H_kv : a.H, a.B);
  kernel<<<grid, kMmaThreads, smem, stream>>>(a);
  return (int)cudaGetLastError();
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
  if (dtype == 1 && head_dim == 64) return launch_mma<64>(which, a, s);
  if (dtype == 1 && head_dim == 128) return launch_mma<128>(which, a, s);
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
