// Ragged paged attention for Hopper (sm_90a), with a plain C entry point.
//
// Replaces the TPU kernel photon_tpu/ops/ragged_paged_attention.py::_rpa_kernel
// (launched by ragged_paged_attention at :244). It computes the same function:
// each (slot, kv head) walks its live pool blocks through the block table with
// an online softmax in fp32; scores are scaled, biased by ALiBi
// (-slope * (q_pos - k_pos)) when slopes are given, and masked by the one rule
// k_pos <= q_pos (causality, ragged length and stale/trash blocks at once). A
// row that sees no key writes 0. Query head h reads kv head h / group.
//
// What bounds it: memory. A call reads n_ctx * bs * H_kv * Dh * 2 bytes of K
// and V per slot (plus q and out) and does 4 flops per (query, key, head, dim),
// far below the card's ~295 flops/byte balance point. The design therefore
// reads each needed K/V byte once per CTA and nothing else:
//   * the block table is read inside the kernel, so no gathered copy of the
//     live blocks is ever written to device memory;
//   * the pool is addressed through its strides and a layer index, so the
//     per-layer view of the [NB+1, L, bs, H_kv, Dh] pool is never copied;
//   * the key walk stops at the largest query position of the tile: keys past
//     it are masked for every row, so their blocks are not read;
//   * one CTA serves every query head of a kv-head group (GQA rows share one
//     K/V tile in shared memory), and query rows are tiled 16 to a CTA so a
//     long prompt chunk spreads over many SMs.
// This first version uses CUDA cores and 16-byte loads; wgmma, TMA and a
// split-K decode (for the T = 1 call, whose grid is n_slots x H_kv CTAs) are
// later work.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC -o libphoton_rpa.so ragged_paged_attention.cu

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kRows = 16;                         // query rows per CTA
constexpr int kKeys = 32;                         // keys per tile: one per lane
constexpr int kLanesPerRow = kThreads / kRows;    // accumulator threads per row
constexpr float kNegInf = -1e30f;                 // finite: no inf - inf NaNs

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// One 16-byte load of kVec elements, widened to fp32.
template <typename T, int kVec>
__device__ __forceinline__ void load_vec(const T* src, float* dst) {
  const uint4 raw = *reinterpret_cast<const uint4*>(src);
  const T* e = reinterpret_cast<const T*>(&raw);
#pragma unroll
  for (int i = 0; i < kVec; ++i) dst[i] = to_f(e[i]);
}

struct Params {
  const void* q;       // [B, T, H, D]; head and dim dense, batch/token strided
  int64_t q_sb, q_st;
  const void* k;       // pool base; element (blk, layer, off, head, d)
  const void* v;
  int64_t p_sblk, p_slayer, p_soff, p_shead;
  int layer;
  const int* rows;     // [B, n_ctx] block table slice, row stride rows_sb
  int64_t rows_sb;
  const int* pos;      // [B, T] absolute query positions
  int64_t pos_sb, pos_st;
  const float* slopes; // [H] fp32, or null (no ALiBi)
  void* out;           // [B, T, H, D] dense
  int B, T, H, H_kv, n_ctx, bs;
  float scale;
};

template <typename T, int D>
__global__ void __launch_bounds__(kThreads) rpa_kernel(const Params p) {
  constexpr int kVec = 16 / sizeof(T);
  constexpr int kCols = D / kLanesPerRow;  // accumulator columns per thread
  static_assert(D % kVec == 0 && D % kLanesPerRow == 0, "bad head dim");

  __shared__ float q_s[kRows][D + 1];   // +1: conflict-free column walks
  __shared__ float k_s[kKeys][D + 1];
  __shared__ float v_s[kKeys][D];
  __shared__ float p_s[kRows][kKeys + 1];
  __shared__ float m_s[kRows], l_s[kRows], alpha_s[kRows], slope_s[kRows];
  __shared__ int qpos_s[kRows];
  __shared__ int maxpos_s;

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int b = blockIdx.z;
  const int kh = blockIdx.y;
  const int group = p.H / p.H_kv;
  const int row0 = blockIdx.x * kRows;             // rows are t * group + g
  const int n_rows = min(kRows, p.T * group - row0);

  const T* q = static_cast<const T*>(p.q);
  const int64_t kv_base = (int64_t)p.layer * p.p_slayer + (int64_t)kh * p.p_shead;
  const T* kp = static_cast<const T*>(p.k) + kv_base;
  const T* vp = static_cast<const T*>(p.v) + kv_base;
  const int* rows = p.rows + (int64_t)b * p.rows_sb;

  if (tid < kRows) {
    int qp = -1;  // padding rows of the tile see no key
    float sl = 0.f;
    if (tid < n_rows) {
      const int r = row0 + tid;
      qp = p.pos[(int64_t)b * p.pos_sb + (int64_t)(r / group) * p.pos_st];
      if (p.slopes != nullptr) sl = p.slopes[kh * group + r % group];
    }
    qpos_s[tid] = qp;
    slope_s[tid] = sl;
    m_s[tid] = kNegInf;
    l_s[tid] = 0.f;
  }
  for (int i = tid; i < kRows * (D / kVec); i += kThreads) {
    const int r = i / (D / kVec);
    const int c = (i % (D / kVec)) * kVec;
    float x[kVec];
    if (r < n_rows) {
      const int rr = row0 + r;
      const int64_t h = kh * group + rr % group;
      load_vec<T, kVec>(q + (int64_t)b * p.q_sb + (int64_t)(rr / group) * p.q_st + h * D + c, x);
    } else {
#pragma unroll
      for (int e = 0; e < kVec; ++e) x[e] = 0.f;
    }
#pragma unroll
    for (int e = 0; e < kVec; ++e) q_s[r][c + e] = x[e];
  }
  __syncthreads();
  if (tid == 0) {
    int mx = -1;
    for (int r = 0; r < n_rows; ++r) mx = max(mx, qpos_s[r]);
    maxpos_s = mx;
  }
  __syncthreads();
  // keys past the tile's largest position are masked for every row
  const int kv_end = min(p.n_ctx * p.bs, maxpos_s + 1);

  const int my_row = tid / kLanesPerRow;
  const int my_col = tid % kLanesPerRow;
  float acc[kCols];
#pragma unroll
  for (int c = 0; c < kCols; ++c) acc[c] = 0.f;

  for (int k0 = 0; k0 < kv_end; k0 += kKeys) {
    // K/V tile: each key's block comes from this slot's table entry
    for (int i = tid; i < kKeys * (D / kVec); i += kThreads) {
      const int kk = i / (D / kVec);
      const int c = (i % (D / kVec)) * kVec;
      const int key = k0 + kk;
      float kx[kVec], vx[kVec];
      if (key < kv_end) {
        const int64_t blk = rows[key / p.bs];
        const int64_t off = blk * p.p_sblk + (int64_t)(key % p.bs) * p.p_soff + c;
        load_vec<T, kVec>(kp + off, kx);
        load_vec<T, kVec>(vp + off, vx);
      } else {
#pragma unroll
        for (int e = 0; e < kVec; ++e) kx[e] = vx[e] = 0.f;
      }
#pragma unroll
      for (int e = 0; e < kVec; ++e) {
        k_s[kk][c + e] = kx[e];
        v_s[kk][c + e] = vx[e];
      }
    }
    __syncthreads();

    // scores and the online-softmax update: warp w takes rows w, w+4, ..;
    // lane j scores key k0 + j
    for (int r = warp; r < kRows; r += kWarps) {
      const int key = k0 + lane;
      const int qp = qpos_s[r];
      float s = kNegInf;
      if (r < n_rows && key < kv_end && key <= qp) {
        float dot = 0.f;
#pragma unroll 16
        for (int d = 0; d < D; ++d) dot += q_s[r][d] * k_s[lane][d];
        s = dot * p.scale;
        if (p.slopes != nullptr) s -= slope_s[r] * (float)(qp - key);
      }
      float mx = s;
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
      const float m_old = m_s[r];
      const float m_new = fmaxf(m_old, mx);
      // a row with no visible key yet keeps m at kNegInf: force p to 0
      const float pr = (m_new > 0.5f * kNegInf) ? expf(s - m_new) : 0.f;
      float sum = pr;
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, o);
      p_s[r][lane] = pr;
      __syncwarp();
      if (lane == 0) {
        const float alpha = expf(m_old - m_new);
        alpha_s[r] = alpha;
        l_s[r] = l_s[r] * alpha + sum;
        m_s[r] = m_new;
      }
    }
    __syncthreads();

    // acc = acc * alpha + P V for this thread's row and columns
    const float alpha = alpha_s[my_row];
#pragma unroll
    for (int c = 0; c < kCols; ++c) acc[c] *= alpha;
    for (int kk = 0; kk < kKeys; ++kk) {
      const float pk = p_s[my_row][kk];
#pragma unroll
      for (int c = 0; c < kCols; ++c) acc[c] += pk * v_s[kk][my_col + c * kLanesPerRow];
    }
    __syncthreads();
  }

  if (my_row < n_rows) {
    const float l = l_s[my_row];
    const float l_safe = (l == 0.f) ? 1.f : l;  // a row that saw no key writes 0
    const int rr = row0 + my_row;
    const int64_t h = kh * group + rr % group;
    T* dst = static_cast<T*>(p.out) + (((int64_t)b * p.T + rr / group) * p.H + h) * D;
#pragma unroll
    for (int c = 0; c < kCols; ++c) dst[my_col + c * kLanesPerRow] = from_f<T>(acc[c] / l_safe);
  }
}

template <typename T, int D>
int launch(const Params& p, cudaStream_t stream) {
  const int group = p.H / p.H_kv;
  const dim3 grid((p.T * group + kRows - 1) / kRows, p.H_kv, p.B);
  rpa_kernel<T, D><<<grid, kThreads, 0, stream>>>(p);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16. head_dim: 64 or 128. Strides are in
// elements. Returns a cudaError_t (0 on success) from the launch.
int photon_rpa_launch(int dtype, int head_dim,
                      const void* q, int64_t q_sb, int64_t q_st,
                      const void* k, const void* v,
                      int64_t p_sblk, int64_t p_slayer, int64_t p_soff, int64_t p_shead,
                      int layer,
                      const int* rows, int64_t rows_sb,
                      const int* pos, int64_t pos_sb, int64_t pos_st,
                      const float* slopes, void* out,
                      int B, int T, int H, int H_kv, int n_ctx, int bs,
                      float scale, void* stream) {
  const Params p{q, q_sb, q_st, k, v, p_sblk, p_slayer, p_soff, p_shead, layer,
                 rows, rows_sb, pos, pos_sb, pos_st, slopes, out,
                 B, T, H, H_kv, n_ctx, bs, scale};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0 && head_dim == 64) return launch<float, 64>(p, s);
  if (dtype == 0 && head_dim == 128) return launch<float, 128>(p, s);
  if (dtype == 1 && head_dim == 64) return launch<__nv_bfloat16, 64>(p, s);
  if (dtype == 1 && head_dim == 128) return launch<__nv_bfloat16, 128>(p, s);
  return (int)cudaErrorInvalidValue;
}

const char* photon_rpa_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
