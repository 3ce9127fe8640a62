// Ragged paged attention for Hopper (sm_90a), with a plain C entry point.
//
// Replaces the TPU kernel photon_tpu/ops/ragged_paged_attention.py::_rpa_kernel
// (launched by ragged_paged_attention at :244). It computes the same function:
// each (slot, kv head) walks its live pool blocks through the block table with
// an online softmax in fp32; scores are scaled, biased by ALiBi
// (-slope * (q_pos - k_pos)) when slopes are given, and masked by the one rule
// k_pos <= q_pos (causality, ragged length and stale/trash blocks at once);
// P is rounded to V's dtype before P V (JAX :168). A row that sees no key
// writes 0. Query head h reads kv head h / group; a (slot, kv head) serves its
// group's rows t * group + g from one K/V tile.
//
// What bounds it: memory in decode and speculative verify (a call reads
// n_ctx * bs * H_kv * Dh * 2 bytes of K and V per slot for 4 flops per
// (query, key, head, dim)), and operations for a long prompt chunk. Every
// regime reads only the needed K/V bytes, straight from the pool: the block
// table is read inside the kernel (no gathered copy), the pool is addressed
// through its strides and a layer index (no per-layer copy), and the key
// walk stops at the largest query position of the tile. K/V tiles of 64 keys
// (four 16-token pool blocks) are gathered by 16-byte cp.async into a ring in
// shared memory, in their own dtype. The host picks the regime from shapes
// it knows (T and the T * group rows per (slot, kv head)), never from device
// data:
//   * split-K (rpa_split_kernel + rpa_combine_kernel; T = 1, GQA decode
//     included, and every fp32 call): grid (key split, row tile x kv
//     head, slot), so a decode step's few long slots spread over the card; a
//     CTA takes 4 rows (decode) or 16. Each of the 4 warps walks its own 16
//     keys of every tile with its own softmax state on CUDA cores (lane = key
//     x half of Dh for the scores, lane = Dh / 32 columns for P V); the warps
//     merge in shared memory and the CTA writes fp32 partials (m in log2
//     units, l, acc). Splits that start past the slot's largest position
//     write an empty partial (m = NEG_INF, l = 0). The combine kernel merges
//     the partials in split order: no atomics, the same bits on every run.
//     Double-buffered ring.
//   * verify (rpa_verify_kernel + rpa_combine_kernel; bf16, T > 1 and
//     T * group <= 64: speculative verify, short prompt chunks): the split-K
//     grid and partials with a 16-row q tile on tensor cores. Each warp
//     computes S = Q K^T for its 16 keys of a tile with mma.sync.m16n8k16
//     (bf16 in, fp32 accumulate; Q held as A fragments, loaded once by
//     ldmatrix), masks and biases per (row, key), keeps its own online
//     softmax in registers, and feeds P, packed to bf16, as the A fragment of
//     P V with V through ldmatrix.trans. So the work per key no longer grows
//     with the row count, as the CUDA-core scores and per-key shuffles of
//     split-K did. mma.sync and not wgmma: wgmma takes 64-row tiles, and a
//     verify has 8-16 rows a (slot, kv head), so three quarters or more of
//     each tile would be padding; the call is bound by bytes, not by the
//     tensor cores' rate. What Hopper gives here is more of the walk in
//     flight: a ring of 4 stages at Dh 64 (76 KB, three CTAs an SM) and 3 at
//     Dh 128 (109 KB, two an SM), so a 256-key split has its whole walk, or
//     all but one tile, in flight at once. The stages are filled by cp.async
//     gathers through the block table, not TMA: a tensor map's box would
//     cover one 16-token pool block of one head (2-4 KB), so a tile needs
//     four boxes and four table reads either way; without a swizzle the
//     boxes land on unpadded rows whose ldmatrix reads conflict (a 128-byte
//     swizzle cannot span Dh 128's 256-byte rows in one box); and the map
//     would be encoded on the host for every call's pool view.
//   * chunk (rpa_chunk_kernel; bf16, T * group > 64): 64-row q tiles, 4
//     warps of 16 rows on mma.sync.m16n8k16, operands by ldmatrix (V through
//     its transposing form), scores and P in registers, heaviest tiles
//     launched first. Double-buffered ring.
// Scores are kept in log2 units (scale * log2 e folded in), so each
// probability is one exp2f.
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC -o libphoton_rpa.so ragged_paged_attention.cu

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kTileKeys = 64;   // keys of a K/V tile
constexpr int kChunkRows = 64;  // query rows of a chunk CTA
constexpr float kNegInf = -1e30f;  // finite: no inf - inf NaNs
constexpr float kLog2e = 1.4426950408889634f;

typedef __nv_bfloat16 bf16;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(bf16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ bf16 from_f<bf16>(float x) { return __float2bfloat16(x); }

// x rounded to T and widened back (the TPU kernel's p.astype(v.dtype))
template <typename T> __device__ __forceinline__ float round_to(float x) {
  return to_f(from_f<T>(x));
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared, asynchronously; zeros when !valid
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_u32(dst)), "l"(src),
               "r"(valid ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }
template <int N> __device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
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
  float* part_m;       // split-K scratch: [B, H_kv, T * group, n_split]
  float* part_l;
  float* part_acc;     // [B, H_kv, T * group, n_split, D]
  int B, T, H, H_kv, n_ctx, bs, n_split, split_keys;
  float scale;
};

// Keys k0 .. k0+63 of this slot's walk, K and V, into ks/vs [64][kLd]
// through the block table; keys at or past key_end read as zeros.
template <typename T, int D, int kLd>
__device__ __forceinline__ void load_kv_tile(T* ks, T* vs, const T* kp, const T* vp,
                                             const int* rows, const Params& p, int k0,
                                             int key_end) {
  constexpr int kVec = 16 / sizeof(T);
  constexpr int kPerRow = D / kVec;
  for (int i = threadIdx.x; i < kTileKeys * kPerRow; i += kThreads) {
    const int kk = i / kPerRow, c = (i % kPerRow) * kVec;
    const int key = k0 + kk;
    const bool valid = key < key_end;
    int64_t off = 0;
    if (valid) off = (int64_t)rows[key / p.bs] * p.p_sblk + (int64_t)(key % p.bs) * p.p_soff + c;
    cp_async16(ks + kk * kLd + c, kp + off, valid);
    cp_async16(vs + kk * kLd + c, vp + off, valid);
  }
}

// ---------------------------------------------------------------------------
// split-K on CUDA cores. grid (n_split, ceil(T * group / kRows) * H_kv, B);
// kRows is 4 (decode: T * group <= 4, so few registers and more CTAs an SM)
// or 16.
// ---------------------------------------------------------------------------
template <typename T, int D, int kRows>
__host__ __device__ constexpr int split_smem_bytes() {
  return kRows * D * 4 + 2 * 2 * kTileKeys * (D + 16 / (int)sizeof(T)) * (int)sizeof(T);
}

template <typename T, int D, int kRows>
__global__ void __launch_bounds__(kThreads) rpa_split_kernel(const Params p) {
  constexpr int kVec = 16 / sizeof(T);
  constexpr int kLd = D + kVec;     // one 16-byte chunk of padding: conflict-free row walks
  constexpr int kCols = D / 32;     // P V columns per lane
  constexpr int kStage = 2 * kTileKeys * kLd;
  static_assert(split_smem_bytes<T, D, kRows>() >= (kWarps * kRows * (D + 2)) * 4 + kRows * D * 4,
                "the warps' merge must fit in the K/V ring");
  extern __shared__ float4 smem4[];
  float* q_s = reinterpret_cast<float*>(smem4);  // [kRows][D] fp32
  T* kv = reinterpret_cast<T*>(q_s + kRows * D);
  __shared__ int qpos_s[kRows];
  __shared__ float slope_s[kRows];

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int split = blockIdx.x;
  const int kh = blockIdx.y % p.H_kv, row0 = (blockIdx.y / p.H_kv) * kRows;
  const int b = blockIdx.z;
  const int group = p.H / p.H_kv;
  const int n_all = p.T * group;
  const int n_rows = min(kRows, n_all - row0);

  const T* q = static_cast<const T*>(p.q);
  if (tid < kRows) {
    int qp = -1;  // padding rows see no key
    float sl = 0.f;
    if (tid < n_rows) {
      const int r = row0 + tid;
      qp = p.pos[(int64_t)b * p.pos_sb + (int64_t)(r / group) * p.pos_st];
      if (p.slopes != nullptr) sl = p.slopes[kh * group + r % group] * kLog2e;
    }
    qpos_s[tid] = qp;
    slope_s[tid] = sl;
  }
  for (int i = tid; i < kRows * D; i += kThreads) {
    const int r = i / D, d = i % D;
    float x = 0.f;
    if (r < n_rows) {
      const int rr = row0 + r;
      x = to_f(q[(int64_t)b * p.q_sb + (int64_t)(rr / group) * p.q_st +
                 (int64_t)(kh * group + rr % group) * D + d]);
    }
    q_s[i] = x;
  }
  __syncthreads();
  int max_pos = -1;
#pragma unroll
  for (int r = 0; r < kRows; ++r) max_pos = max(max_pos, qpos_s[r]);
  // keys past the tile's largest position are masked for every row
  const int kv_end = min(p.n_ctx * p.bs, max_pos + 1);
  const int lo = split * p.split_keys, hi = min(lo + p.split_keys, kv_end);
  const int64_t prow = ((int64_t)b * p.H_kv + kh) * n_all + row0;  // partial row of r = 0

  if (lo >= hi) {  // nothing to see in this split: an empty partial
    for (int i = tid; i < n_rows * D; i += kThreads)
      p.part_acc[((prow + i / D) * p.n_split + split) * D + i % D] = 0.f;
    if (tid < n_rows) {
      p.part_m[(prow + tid) * p.n_split + split] = kNegInf;
      p.part_l[(prow + tid) * p.n_split + split] = 0.f;
    }
    return;
  }

  const int64_t kv_base = (int64_t)p.layer * p.p_slayer + (int64_t)kh * p.p_shead;
  const T* kp = static_cast<const T*>(p.k) + kv_base;
  const T* vp = static_cast<const T*>(p.v) + kv_base;
  const int* rows = p.rows + (int64_t)b * p.rows_sb;
  const float c2 = p.scale * kLog2e;
  const bool alibi = p.slopes != nullptr;
  const int key_l = lane & 15, half = lane >> 4;  // scores: this lane's key, half of D

  float m[kRows], l[kRows], acc[kRows][kCols];
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    m[r] = kNegInf;
    l[r] = 0.f;
#pragma unroll
    for (int c = 0; c < kCols; ++c) acc[r][c] = 0.f;
  }

  const int n_tiles = (hi - lo + kTileKeys - 1) / kTileKeys;
  load_kv_tile<T, D, kLd>(kv, kv + kTileKeys * kLd, kp, vp, rows, p, lo, hi);
  cp_commit();
  for (int i = 0; i < n_tiles; ++i) {
    if (i + 1 < n_tiles) {
      T* nxt = kv + ((i + 1) & 1) * kStage;
      load_kv_tile<T, D, kLd>(nxt, nxt + kTileKeys * kLd, kp, vp, rows, p, lo + (i + 1) * kTileKeys,
                              hi);
      cp_commit();
      cp_wait<1>();
    } else {
      cp_wait<0>();
    }
    __syncthreads();
    const T* ks = kv + (i & 1) * kStage;
    const T* vs = ks + kTileKeys * kLd;
    const int kk = warp * 16 + key_l;
    const int key = lo + i * kTileKeys + kk;
    const T* krow = ks + kk * kLd + half * (D / 2);

    // this warp's 16 keys against every row: online softmax per warp
    float pb[kRows];
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      pb[r] = 0.f;
      if (r < n_rows) {
        const float* qr = q_s + r * D + half * (D / 2);
        float dot = 0.f;
#pragma unroll
        for (int d = 0; d < D / 2; d += kVec) {
          const uint4 raw = *reinterpret_cast<const uint4*>(krow + d);
          const T* e = reinterpret_cast<const T*>(&raw);
#pragma unroll
          for (int x = 0; x < kVec; ++x) dot = fmaf(qr[d + x], to_f(e[x]), dot);
        }
        dot += __shfl_xor_sync(0xffffffffu, dot, 16);
        const int qp = qpos_s[r];
        float x = dot * c2;
        if (alibi) x -= slope_s[r] * (float)(qp - key);
        if (key >= hi || key > qp) x = kNegInf;
        float mx = x;
#pragma unroll
        for (int o = 8; o > 0; o >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
        const float m_new = fmaxf(m[r], mx);
        const float alpha = exp2f(m[r] - m_new);
        // a row with no visible key yet keeps m at NEG_INF: force p to 0
        const float pr = (m_new > 0.5f * kNegInf) ? exp2f(x - m_new) : 0.f;
        float ps = pr;
#pragma unroll
        for (int o = 8; o > 0; o >>= 1) ps += __shfl_xor_sync(0xffffffffu, ps, o);
        l[r] = l[r] * alpha + ps;
        m[r] = m_new;
#pragma unroll
        for (int c = 0; c < kCols; ++c) acc[r][c] *= alpha;
        pb[r] = round_to<T>(pr);  // P in V's dtype, as the TPU kernel
      }
    }
    // acc += P V over the warp's 16 keys; lane owns columns lane * kCols ..
#pragma unroll 4
    for (int j = 0; j < 16; ++j) {
      const T* vr = vs + (warp * 16 + j) * kLd + lane * kCols;
      float v[kCols];
#pragma unroll
      for (int c = 0; c < kCols; ++c) v[c] = to_f(vr[c]);
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        if (r < n_rows) {
          const float pj = __shfl_sync(0xffffffffu, pb[r], j);
#pragma unroll
          for (int c = 0; c < kCols; ++c) acc[r][c] = fmaf(pj, v[c], acc[r][c]);
        }
      }
    }
    __syncthreads();  // the stage is free for the tile after next
  }

  // merge the 4 warps' states (in the freed ring) into this split's partial
  float* wm = reinterpret_cast<float*>(kv);
  float* wl = wm + kWarps * kRows;
  float* wacc = wl + kWarps * kRows;
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    if (r < n_rows) {
      if (lane == 0) {
        wm[warp * kRows + r] = m[r];
        wl[warp * kRows + r] = l[r];
      }
#pragma unroll
      for (int c = 0; c < kCols; ++c) wacc[(warp * kRows + r) * D + lane * kCols + c] = acc[r][c];
    }
  }
  __syncthreads();
  for (int i = tid; i < n_rows * D; i += kThreads) {
    const int r = i / D, d = i % D;
    float mm = kNegInf;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) mm = fmaxf(mm, wm[w * kRows + r]);
    float ll = 0.f, aa = 0.f;
    if (mm > 0.5f * kNegInf) {
#pragma unroll
      for (int w = 0; w < kWarps; ++w) {
        const float f = exp2f(wm[w * kRows + r] - mm);
        ll += wl[w * kRows + r] * f;
        aa += wacc[(w * kRows + r) * D + d] * f;
      }
    }
    const int64_t pr = (prow + r) * p.n_split + split;
    p.part_acc[pr * D + d] = aa;
    if (d == 0) {
      p.part_m[pr] = mm;
      p.part_l[pr] = ll;
    }
  }
}

// Merge the splits' partials in split order. grid (T * group, H_kv, B), D threads.
template <typename T, int D>
__global__ void __launch_bounds__(D) rpa_combine_kernel(const Params p) {
  const int r = blockIdx.x, kh = blockIdx.y, b = blockIdx.z, d = threadIdx.x;
  const int group = p.H / p.H_kv;
  const int64_t base = (((int64_t)b * p.H_kv + kh) * p.T * group + r) * p.n_split;
  float mm = kNegInf;
  for (int s = 0; s < p.n_split; ++s) mm = fmaxf(mm, p.part_m[base + s]);
  float ll = 0.f, aa = 0.f;
  if (mm > 0.5f * kNegInf) {
    for (int s = 0; s < p.n_split; ++s) {
      const float f = exp2f(p.part_m[base + s] - mm);
      ll += p.part_l[base + s] * f;
      aa += p.part_acc[(base + s) * D + d] * f;
    }
  }
  // a row that saw no key writes 0
  const float o = ll == 0.f ? 0.f : aa / ll;
  T* dst = static_cast<T*>(p.out);
  dst[(((int64_t)b * p.T + r / group) * p.H + kh * group + r % group) * D + d] = from_f<T>(o);
}

// ---------------------------------------------------------------------------
// chunk on tensor cores (bf16). grid (ceil(T * group / 64) * H_kv * B).
// An m16n8k16 accumulator gives thread (g = lane / 4, t = lane % 4), for
// each 8-column chunk, rows g (entries 0, 1) and g + 8 (2, 3) at columns
// 2t, 2t + 1; chunks 2j and 2j + 1 of S are k-step j's A fragment of P V.
// ---------------------------------------------------------------------------

__device__ __forceinline__ uint32_t pack2(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

__device__ __forceinline__ void mma16816(float c[4], const uint32_t a[4], uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void ldsm_x4(uint32_t r[4], const bf16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p)));
}

__device__ __forceinline__ void ldsm_x4_t(uint32_t r[4], const bf16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p)));
}

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}

__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

template <int D>
__host__ __device__ constexpr int chunk_smem_bytes() {
  return (kChunkRows + 2 * 2 * kTileKeys) * (D + 8) * 2;
}

template <int D>
__global__ void __launch_bounds__(kThreads) rpa_chunk_kernel(const Params p) {
  constexpr int kLd = D + 8;  // 16 bytes of padding: conflict-free ldmatrix rows
  constexpr int kStage = 2 * kTileKeys * kLd;
  extern __shared__ float4 smem4[];
  bf16* q_s = reinterpret_cast<bf16*>(smem4);  // [64][kLd]
  bf16* kv = q_s + kChunkRows * kLd;           // 2 stages of K [64][kLd], V [64][kLd]
  __shared__ int qpos_s[kChunkRows];
  __shared__ float slope_s[kChunkRows];

  const int tid = threadIdx.x, lane = tid & 31, w = tid >> 5, g = lane >> 2, t = lane & 3;
  const int group = p.H / p.H_kv;
  const int n_all = p.T * group;
  const int n_rt = (n_all + kChunkRows - 1) / kChunkRows;
  const int n_hb = p.H_kv * p.B;
  // later rows hold later positions: the heaviest row tiles go first
  const int row0 = (n_rt - 1 - (int)(blockIdx.x / n_hb)) * kChunkRows;
  const int kh = (int)(blockIdx.x % n_hb) % p.H_kv, b = (int)(blockIdx.x % n_hb) / p.H_kv;
  const int n_rows = min(kChunkRows, n_all - row0);

  const bf16* q = static_cast<const bf16*>(p.q);
  if (tid < kChunkRows) {
    int qp = -1;
    float sl = 0.f;
    if (tid < n_rows) {
      const int r = row0 + tid;
      qp = p.pos[(int64_t)b * p.pos_sb + (int64_t)(r / group) * p.pos_st];
      if (p.slopes != nullptr) sl = p.slopes[kh * group + r % group] * kLog2e;
    }
    qpos_s[tid] = qp;
    slope_s[tid] = sl;
  }
  for (int i = tid; i < kChunkRows * (D / 8); i += kThreads) {
    const int r = i / (D / 8), c = (i % (D / 8)) * 8;
    const int rr = row0 + r;
    const bool valid = r < n_rows;
    const bf16* src = valid ? q + (int64_t)b * p.q_sb + (int64_t)(rr / group) * p.q_st +
                                  (int64_t)(kh * group + rr % group) * D + c
                            : q;
    cp_async16(q_s + r * kLd + c, src, valid);
  }
  __syncthreads();
  int max_pos = -1;
  for (int r = 0; r < kChunkRows; ++r) max_pos = max(max_pos, qpos_s[r]);
  const int kv_end = min(p.n_ctx * p.bs, max_pos + 1);
  const int n_tiles = (kv_end + kTileKeys - 1) / kTileKeys;

  const int64_t kv_base = (int64_t)p.layer * p.p_slayer + (int64_t)kh * p.p_shead;
  const bf16* kp = static_cast<const bf16*>(p.k) + kv_base;
  const bf16* vp = static_cast<const bf16*>(p.v) + kv_base;
  const int* rows = p.rows + (int64_t)b * p.rows_sb;
  if (n_tiles > 0) load_kv_tile<bf16, D, kLd>(kv, kv + kTileKeys * kLd, kp, vp, rows, p, 0, kv_end);
  cp_commit();  // q and the first tile

  const int qr0 = w * 16 + g;  // this thread's rows: qr0 and qr0 + 8
  const int qp0 = qpos_s[qr0], qp1 = qpos_s[qr0 + 8];
  const float sl0 = slope_s[qr0], sl1 = slope_s[qr0 + 8];
  // the last key each row sees: its position, or the walk's end
  const int last0 = min(qp0, kv_end - 1), last1 = min(qp1, kv_end - 1);
  const float c2 = p.scale * kLog2e;
  const bool alibi = p.slopes != nullptr;
  const int mi = lane >> 3, mr = lane & 7;  // ldmatrix: this lane's matrix and row
  float o[D / 8][4] = {};
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};
  uint32_t qa[D / 16][4];

  for (int i = 0; i < n_tiles; ++i) {
    if (i + 1 < n_tiles) {
      bf16* nxt = kv + ((i + 1) & 1) * kStage;
      load_kv_tile<bf16, D, kLd>(nxt, nxt + kTileKeys * kLd, kp, vp, rows, p, (i + 1) * kTileKeys,
                                 kv_end);
      cp_commit();
      cp_wait<1>();
    } else {
      cp_wait<0>();
    }
    __syncthreads();
    if (i == 0) {
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
        ldsm_x4(qa[kk], q_s + (w * 16 + (mi & 1) * 8 + mr) * kLd + kk * 16 + (mi >> 1) * 8);
    }
    const bf16* ks = kv + (i & 1) * kStage;
    const bf16* vs = ks + kTileKeys * kLd;
    const int k0 = i * kTileKeys;

    float s[8][4] = {};
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)
#pragma unroll
      for (int np = 0; np < 4; ++np) {
        uint32_t bk[4];
        ldsm_x4(bk, ks + (np * 16 + (mi >> 1) * 8 + mr) * kLd + kk * 16 + (mi & 1) * 8);
        mma16816(s[2 * np], qa[kk], bk[0], bk[1]);
        mma16816(s[2 * np + 1], qa[kk], bk[2], bk[3]);
      }
    // one compare a score against the row's last visible key (no branch)
    float mx[2] = {kNegInf, kNegInf};
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = e >> 1, kpos = k0 + n * 8 + 2 * t + (e & 1);
        float x = s[n][e] * c2;
        if (alibi) x = fmaf(r ? sl1 : sl0, (float)(kpos - (r ? qp1 : qp0)), x);
        x = kpos > (r ? last1 : last0) ? kNegInf : x;
        s[n][e] = x;
        mx[r] = fmaxf(mx[r], x);
      }
    float alpha[2], m_new[2], m_use[2], sum[2] = {0.f, 0.f};
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      m_new[r] = fmaxf(m[r], quad_max(mx[r]));
      alpha[r] = exp2f(m[r] - m_new[r]);
      // a row with no visible key yet keeps m at NEG_INF and all its scores
      // at NEG_INF: exp2 against 0 gives p = 0, as the TPU kernel forces
      m_use[r] = m_new[r] > 0.5f * kNegInf ? m_new[r] : 0.f;
    }
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        s[n][e] = exp2f(s[n][e] - m_use[e >> 1]);
        sum[e >> 1] += s[n][e];
      }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      l[r] = l[r] * alpha[r] + sum[r];
      m[r] = m_new[r];
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
      // P rounded to V's dtype (bf16) as the A fragment of k-step j
      const uint32_t pa[4] = {pack2(s[2 * j][0], s[2 * j][1]), pack2(s[2 * j][2], s[2 * j][3]),
                              pack2(s[2 * j + 1][0], s[2 * j + 1][1]),
                              pack2(s[2 * j + 1][2], s[2 * j + 1][3])};
#pragma unroll
      for (int dp = 0; dp < D / 16; ++dp) {
        uint32_t bv[4];
        ldsm_x4_t(bv, vs + (j * 16 + (mi & 1) * 8 + mr) * kLd + dp * 16 + (mi >> 1) * 8);
        mma16816(o[2 * dp], pa, bv[0], bv[1]);
        mma16816(o[2 * dp + 1], pa, bv[2], bv[3]);
      }
    }
    __syncthreads();  // the stage is free for the tile after next
  }
  cp_wait<0>();  // n_tiles == 0 leaves q's copies in flight

#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int r = qr0 + 8 * half;
    if (r >= n_rows) continue;
    const float lr = quad_sum(l[half]);
    const float inv = __frcp_rn(lr == 0.f ? 1.f : lr);  // a row that saw no key writes 0
    const int rr = row0 + r;
    bf16* dst = static_cast<bf16*>(p.out) +
                (((int64_t)b * p.T + rr / group) * p.H + kh * group + rr % group) * D + 2 * t;
#pragma unroll
    for (int n = 0; n < D / 8; ++n)
      *reinterpret_cast<uint32_t*>(dst + n * 8) =
          pack2(o[n][2 * half] * inv, o[n][2 * half + 1] * inv);
  }
}

// ---------------------------------------------------------------------------
// verify on tensor cores (bf16; T > 1, T * group <= 64). grid (n_split,
// ceil(T * group / 16) * H_kv, B), the split-K grid: one 16-row q tile a
// CTA, warp w on keys 16w .. 16w + 15 of every 64-key tile with its own
// online softmax, the warps merged into this split's partial, the partials
// merged by rpa_combine_kernel. The fragment layouts are the chunk kernel's
// at one 16-row tile: S (16 x 16) is two 8-key accumulator chunks, which
// together are the A fragment of P V's one k-step.
// ---------------------------------------------------------------------------
constexpr int kVerifyRows = 16;

// K/V ring stages: the deepest that keeps 3 CTAs an SM at Dh 64, 2 at 128
template <int D>
__host__ __device__ constexpr int verify_stages() {
  return D == 64 ? 4 : 3;
}

template <int D>
__host__ __device__ constexpr int verify_smem_bytes() {
  return (kVerifyRows + verify_stages<D>() * 2 * kTileKeys) * (D + 8) * 2;
}

template <int D>
__global__ void __launch_bounds__(kThreads) rpa_verify_kernel(const Params p) {
  constexpr int kLd = D + 8;  // 16 bytes of padding: conflict-free ldmatrix rows
  constexpr int kStages = verify_stages<D>();
  constexpr int kStage = 2 * kTileKeys * kLd;
  static_assert(kStages * kStage * 2 >= kWarps * kVerifyRows * (D + 2) * 4,
                "the warps' merge must fit in the K/V ring");
  extern __shared__ float4 smem4[];
  bf16* q_s = reinterpret_cast<bf16*>(smem4);  // [16][kLd]
  bf16* kv = q_s + kVerifyRows * kLd;          // kStages x (K [64][kLd], V [64][kLd])
  __shared__ int qpos_s[kVerifyRows];
  __shared__ float slope_s[kVerifyRows];

  const int tid = threadIdx.x, lane = tid & 31, w = tid >> 5, g = lane >> 2, t = lane & 3;
  const int split = blockIdx.x;
  const int kh = blockIdx.y % p.H_kv, row0 = (blockIdx.y / p.H_kv) * kVerifyRows;
  const int b = blockIdx.z;
  const int group = p.H / p.H_kv;
  const int n_all = p.T * group;
  const int n_rows = min(kVerifyRows, n_all - row0);

  if (tid < kVerifyRows) {
    int qp = -1;  // padding rows see no key
    float sl = 0.f;
    if (tid < n_rows) {
      const int r = row0 + tid;
      qp = p.pos[(int64_t)b * p.pos_sb + (int64_t)(r / group) * p.pos_st];
      if (p.slopes != nullptr) sl = p.slopes[kh * group + r % group] * kLog2e;
    }
    qpos_s[tid] = qp;
    slope_s[tid] = sl;
  }
  __syncthreads();
  int max_pos = -1;
#pragma unroll
  for (int r = 0; r < kVerifyRows; ++r) max_pos = max(max_pos, qpos_s[r]);
  // keys past the tile's largest position are masked for every row
  const int kv_end = min(p.n_ctx * p.bs, max_pos + 1);
  const int lo = split * p.split_keys, hi = min(lo + p.split_keys, kv_end);
  const int64_t prow = ((int64_t)b * p.H_kv + kh) * n_all + row0;  // partial row of r = 0

  if (lo >= hi) {  // nothing to see in this split: an empty partial
    for (int i = tid; i < n_rows * D; i += kThreads)
      p.part_acc[((prow + i / D) * p.n_split + split) * D + i % D] = 0.f;
    if (tid < n_rows) {
      p.part_m[(prow + tid) * p.n_split + split] = kNegInf;
      p.part_l[(prow + tid) * p.n_split + split] = 0.f;
    }
    return;
  }

  const bf16* q = static_cast<const bf16*>(p.q);
  for (int i = tid; i < kVerifyRows * (D / 8); i += kThreads) {
    const int r = i / (D / 8), c = (i % (D / 8)) * 8;
    const int rr = row0 + r;
    const bool valid = r < n_rows;
    const bf16* src = valid ? q + (int64_t)b * p.q_sb + (int64_t)(rr / group) * p.q_st +
                                  (int64_t)(kh * group + rr % group) * D + c
                            : q;
    cp_async16(q_s + r * kLd + c, src, valid);
  }
  const int64_t kv_base = (int64_t)p.layer * p.p_slayer + (int64_t)kh * p.p_shead;
  const bf16* kp = static_cast<const bf16*>(p.k) + kv_base;
  const bf16* vp = static_cast<const bf16*>(p.v) + kv_base;
  const int* rows = p.rows + (int64_t)b * p.rows_sb;
  const int n_tiles = (hi - lo + kTileKeys - 1) / kTileKeys;
  // tiles 0 .. kStages - 2 in flight, one commit group each (q rides in the first)
#pragma unroll
  for (int st = 0; st < kStages - 1; ++st) {
    bf16* dst = kv + st * kStage;
    if (st < n_tiles)
      load_kv_tile<bf16, D, kLd>(dst, dst + kTileKeys * kLd, kp, vp, rows, p, lo + st * kTileKeys,
                                 hi);
    cp_commit();
  }

  const int r0 = g, r1 = g + 8;  // this thread's rows of the tile
  const int qp0 = qpos_s[r0], qp1 = qpos_s[r1];
  const float sl0 = slope_s[r0], sl1 = slope_s[r1];
  // the last key each row sees in this split: its position, or the split's end
  const int last0 = min(qp0, hi - 1), last1 = min(qp1, hi - 1);
  const float c2 = p.scale * kLog2e;
  const bool alibi = p.slopes != nullptr;
  const int mi = lane >> 3, mr = lane & 7;  // ldmatrix: this lane's matrix and row
  float o[D / 8][4] = {};
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};
  uint32_t qa[D / 16][4];

  for (int i = 0; i < n_tiles; ++i) {
    const int nx = i + kStages - 1;  // the tile whose loads go out now
    if (nx < n_tiles) {
      bf16* dst = kv + (nx % kStages) * kStage;
      load_kv_tile<bf16, D, kLd>(dst, dst + kTileKeys * kLd, kp, vp, rows, p, lo + nx * kTileKeys,
                                 hi);
    }
    cp_commit();
    cp_wait<kStages - 1>();  // tile i (and q) have landed
    __syncthreads();
    if (i == 0) {
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
        ldsm_x4(qa[kk], q_s + ((mi & 1) * 8 + mr) * kLd + kk * 16 + (mi >> 1) * 8);
    }
    const bf16* ks = kv + (i % kStages) * kStage + w * 16 * kLd;  // this warp's 16 keys
    const bf16* vs = ks + kTileKeys * kLd;
    const int k0 = lo + i * kTileKeys + w * 16;

    float s[2][4] = {};
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      uint32_t bk[4];
      ldsm_x4(bk, ks + ((mi >> 1) * 8 + mr) * kLd + kk * 16 + (mi & 1) * 8);
      mma16816(s[0], qa[kk], bk[0], bk[1]);
      mma16816(s[1], qa[kk], bk[2], bk[3]);
    }
    // one compare a score against the row's last visible key (no branch)
    float mx[2] = {kNegInf, kNegInf};
#pragma unroll
    for (int n = 0; n < 2; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = e >> 1, kpos = k0 + n * 8 + 2 * t + (e & 1);
        float x = s[n][e] * c2;
        if (alibi) x = fmaf(r ? sl1 : sl0, (float)(kpos - (r ? qp1 : qp0)), x);
        x = kpos > (r ? last1 : last0) ? kNegInf : x;
        s[n][e] = x;
        mx[r] = fmaxf(mx[r], x);
      }
    float alpha[2], m_use[2], sum[2] = {0.f, 0.f};
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const float m_new = fmaxf(m[r], quad_max(mx[r]));
      alpha[r] = exp2f(m[r] - m_new);
      // a row with no visible key yet keeps m at NEG_INF and all its scores
      // at NEG_INF: exp2 against 0 gives p = 0, as the TPU kernel forces
      m_use[r] = m_new > 0.5f * kNegInf ? m_new : 0.f;
      m[r] = m_new;
    }
#pragma unroll
    for (int n = 0; n < 2; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        s[n][e] = exp2f(s[n][e] - m_use[e >> 1]);
        sum[e >> 1] += s[n][e];
      }
#pragma unroll
    for (int r = 0; r < 2; ++r) l[r] = l[r] * alpha[r] + sum[r];
#pragma unroll
    for (int n = 0; n < D / 8; ++n) {
      o[n][0] *= alpha[0];
      o[n][1] *= alpha[0];
      o[n][2] *= alpha[1];
      o[n][3] *= alpha[1];
    }
    // P rounded to V's dtype (bf16) as the A fragment of the one k-step
    const uint32_t pa[4] = {pack2(s[0][0], s[0][1]), pack2(s[0][2], s[0][3]),
                            pack2(s[1][0], s[1][1]), pack2(s[1][2], s[1][3])};
#pragma unroll
    for (int dp = 0; dp < D / 16; ++dp) {
      uint32_t bv[4];
      ldsm_x4_t(bv, vs + ((mi & 1) * 8 + mr) * kLd + dp * 16 + (mi >> 1) * 8);
      mma16816(o[2 * dp], pa, bv[0], bv[1]);
      mma16816(o[2 * dp + 1], pa, bv[2], bv[3]);
    }
    __syncthreads();  // the stage is free for the tile kStages on
  }
  cp_wait<0>();  // only empty groups are left; nothing writes the ring now

  // merge the 4 warps' states (in the freed ring) into this split's partial
  float* wm = reinterpret_cast<float*>(kv);
  float* wl = wm + kWarps * kVerifyRows;
  float* wacc = wl + kWarps * kVerifyRows;  // [kWarps][16][D]
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int r = g + 8 * half;
    const float lr = quad_sum(l[half]);
    if (t == 0) {
      wm[w * kVerifyRows + r] = m[half];
      wl[w * kVerifyRows + r] = lr;
    }
#pragma unroll
    for (int n = 0; n < D / 8; ++n)
      *reinterpret_cast<float2*>(wacc + (w * kVerifyRows + r) * D + n * 8 + 2 * t) =
          make_float2(o[n][2 * half], o[n][2 * half + 1]);
  }
  __syncthreads();
  for (int i = tid; i < n_rows * D; i += kThreads) {
    const int r = i / D, d = i % D;
    float mm = kNegInf;
#pragma unroll
    for (int ww = 0; ww < kWarps; ++ww) mm = fmaxf(mm, wm[ww * kVerifyRows + r]);
    float ll = 0.f, aa = 0.f;
    if (mm > 0.5f * kNegInf) {
#pragma unroll
      for (int ww = 0; ww < kWarps; ++ww) {
        const float f = exp2f(wm[ww * kVerifyRows + r] - mm);
        ll += wl[ww * kVerifyRows + r] * f;
        aa += wacc[(ww * kVerifyRows + r) * D + d] * f;
      }
    }
    const int64_t pr = (prow + r) * p.n_split + split;
    p.part_acc[pr * D + d] = aa;
    if (d == 0) {
      p.part_m[pr] = mm;
      p.part_l[pr] = ll;
    }
  }
}

template <typename T, int D, int kRows>
int launch_split(const Params& p, cudaStream_t stream) {
  const int n_all = p.T * (p.H / p.H_kv);
  const int smem = split_smem_bytes<T, D, kRows>();
  cudaError_t err = cudaFuncSetAttribute(reinterpret_cast<const void*>(rpa_split_kernel<T, D, kRows>),
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(p.n_split, ((n_all + kRows - 1) / kRows) * p.H_kv, p.B);
  rpa_split_kernel<T, D, kRows><<<grid, kThreads, smem, stream>>>(p);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  rpa_combine_kernel<T, D><<<dim3(n_all, p.H_kv, p.B), D, 0, stream>>>(p);
  return (int)cudaGetLastError();
}

template <typename T, int D>
int launch_split(const Params& p, cudaStream_t stream) {
  return p.T * (p.H / p.H_kv) <= 4 ? launch_split<T, D, 4>(p, stream)
                                   : launch_split<T, D, 16>(p, stream);
}

template <int D>
int launch_chunk(const Params& p, cudaStream_t stream) {
  const int n_all = p.T * (p.H / p.H_kv);
  const int smem = chunk_smem_bytes<D>();
  cudaError_t err = cudaFuncSetAttribute(reinterpret_cast<const void*>(rpa_chunk_kernel<D>),
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  const int n_rt = (n_all + kChunkRows - 1) / kChunkRows;
  rpa_chunk_kernel<D><<<n_rt * p.H_kv * p.B, kThreads, smem, stream>>>(p);
  return (int)cudaGetLastError();
}

template <int D>
int launch_verify(const Params& p, cudaStream_t stream) {
  const int n_all = p.T * (p.H / p.H_kv);
  const int smem = verify_smem_bytes<D>();
  cudaError_t err = cudaFuncSetAttribute(reinterpret_cast<const void*>(rpa_verify_kernel<D>),
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(p.n_split, ((n_all + kVerifyRows - 1) / kVerifyRows) * p.H_kv, p.B);
  rpa_verify_kernel<D><<<grid, kThreads, smem, stream>>>(p);
  if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  rpa_combine_kernel<bf16, D><<<dim3(n_all, p.H_kv, p.B), D, 0, stream>>>(p);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// mode: 0 = split-K (rpa_split_kernel then rpa_combine_kernel; needs the
// part_* scratch), 1 = chunk on tensor cores (bf16 only), 2 = verify on
// tensor cores (rpa_verify_kernel then rpa_combine_kernel; bf16 only, needs
// the part_* scratch). dtype: 0 = float32, 1 = bfloat16. head_dim: 64 or
// 128. Strides are in elements.
// Returns a cudaError_t (0 on success) from the launches.
int photon_rpa_launch(int mode, int dtype, int head_dim,
                      const void* q, int64_t q_sb, int64_t q_st,
                      const void* k, const void* v,
                      int64_t p_sblk, int64_t p_slayer, int64_t p_soff, int64_t p_shead,
                      int layer,
                      const int* rows, int64_t rows_sb,
                      const int* pos, int64_t pos_sb, int64_t pos_st,
                      const float* slopes, void* out,
                      float* part_m, float* part_l, float* part_acc,
                      int B, int T, int H, int H_kv, int n_ctx, int bs,
                      int n_split, int split_keys,
                      float scale, void* stream) {
  const Params p{q, q_sb, q_st, k, v, p_sblk, p_slayer, p_soff, p_shead, layer,
                 rows, rows_sb, pos, pos_sb, pos_st, slopes, out, part_m, part_l, part_acc,
                 B, T, H, H_kv, n_ctx, bs, n_split, split_keys, scale};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (mode == 1) {
    if (dtype == 1 && head_dim == 64) return launch_chunk<64>(p, s);
    if (dtype == 1 && head_dim == 128) return launch_chunk<128>(p, s);
    return (int)cudaErrorInvalidValue;
  }
  if (mode == 2) {
    if (dtype == 1 && head_dim == 64) return launch_verify<64>(p, s);
    if (dtype == 1 && head_dim == 128) return launch_verify<128>(p, s);
    return (int)cudaErrorInvalidValue;
  }
  if (mode != 0) return (int)cudaErrorInvalidValue;
  if (dtype == 0 && head_dim == 64) return launch_split<float, 64>(p, s);
  if (dtype == 0 && head_dim == 128) return launch_split<float, 128>(p, s);
  if (dtype == 1 && head_dim == 64) return launch_split<bf16, 64>(p, s);
  if (dtype == 1 && head_dim == 128) return launch_split<bf16, 128>(p, s);
  return (int)cudaErrorInvalidValue;
}

const char* photon_rpa_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
