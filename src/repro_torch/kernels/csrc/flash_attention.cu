// Causal + sliding-window GQA flash attention (prefill) for NVIDIA Hopper
// (sm_90a), CUDA C++.
//
// Replaces: src/repro/kernels/flash_attention.py (_flash_kernel /
// flash_attention_pallas, the Pallas kernel of the reference package).
// q (B,Sq,KV,G,hd_qk), k (B,Sk,KV,hd_qk), v (B,Sk,KV,hd_v), qpos (B,Sq),
// kpos (B,Sk) int32 -> out (B,Sq,KV,G,hd_v); float32 or bfloat16 in and
// out, float32 inside.  Key j is live for query i when kpos[j] <= qpos[i]
// and, with a window, qpos[i] - kpos[j] < window.
//
// What bounds it on an H100.  Operations: 4 * hd per live (query, key) pair
// per head (two products), against 989 TFLOP/s of bf16 tensor cores.  Bytes:
// q, k, v read once and out written once, a few MB per layer.  At S = 4,608
// with a 4,096 window it is ~1.1e11 operations per layer, ~0.11 ms: bound by
// operations.
//
// Three device kernels; the wrapper (kernels/flash_attention.py,
// `_variant`) picks one by dtype and shape alone and passes its code:
//  * flash_attention_wgmma_kernel ("wgmma_tma"): bfloat16 with hd_qk ==
//    hd_v in {64, 80, 128} and 16-byte aligned operands (every dense
//    config of the port but gemma-2b's 256).  The design for this card, see
//    its note below: TMA ring, warp specialisation, wgmma, the softmax
//    state in registers.
//  * flash_attention_wmma_kernel ("wmma"): every other bfloat16 shape
//    (head dims up to 256, misaligned views).  WMMA 16x16x16 fragments.
//  * flash_attention_kernel ("cuda_cores"): float32, on the CUDA cores.
//
// What all three share.
//  * The TPU kernel's sequential kv grid dimension has no GPU counterpart:
//    a block loops over kv tiles itself and carries the online-softmax
//    state (row max m, row sum l, the accumulator).
//  * A kv tile with no live (query, key) pair is skipped (no loads, no
//    products), as the Pallas kernel does; the test is made on the tile's
//    position ranges, so it holds for any position arrays: the key tile is
//    dead when its smallest position is above the largest query position,
//    or (with a window) its largest is at or below the smallest query
//    position minus the window.  Skipping is exact: a dead tile adds 0.
//  * GQA by index: q head h reads kv head h / G directly; nothing is copied.
//  * Masking keeps the reference's form p = live ? exp(s - m) : 0 and
//    out = acc / max(l, 1e-30), so a row with no live key gives 0 and never
//    the exp(0) = 1 of a fully masked row.
//  * Ragged query and key tails of the last tiles are masked.
//
// The CUDA-core and WMMA kernels stage tiles with FA_U loads in flight per
// thread (the first version loaded one element at a time and waited on
// each: latency-bound); the float32 kernel runs 16 x 16 threads, each 4
// query rows x 4 keys for q k^T and 4 rows x ceil(hd_v / 16) columns for
// p v, the score rows reduced with half-warp shuffles.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <limits.h>
#include <math.h>
#include <mma.h>

#include "hopper.cuh"

using namespace nvcuda;

#define FA_BQ 64          // queries per block
#define FA_BK 64          // keys per tile
#define FA_THREADS 256    // 16 x 16
#define FA_NEG_INF (-1e30f)

__device__ __forceinline__ float fa_load(const float* p) { return *p; }
__device__ __forceinline__ float fa_load(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}
__device__ __forceinline__ void fa_store(float* p, float x) { *p = x; }
__device__ __forceinline__ void fa_store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
}

// Copy a rows x cols tile (row r at src + r * row_stride, rows past
// rows_valid read as 0) into shared memory at dst[r * dr + c * dc], times
// mul.  Each thread keeps FA_U loads in flight before it stores any: the
// load latency is paid once per FA_U elements, not once per element.
#define FA_U 8
template <typename T>
__device__ __forceinline__ void fa_stage(const T* __restrict__ src,
                                         size_t row_stride, int rows_valid,
                                         int rows, int cols, float* dst,
                                         int dr, int dc, float mul) {
  const int total = rows * cols;
  for (int base = threadIdx.x; base < total; base += FA_THREADS * FA_U) {
    float v[FA_U];
#pragma unroll
    for (int u = 0; u < FA_U; ++u) {
      const int i = base + u * FA_THREADS, r = i / cols, c = i - r * cols;
      v[u] = (i < total && r < rows_valid) ? fa_load(src + r * row_stride + c)
                                           : 0.f;
    }
#pragma unroll
    for (int u = 0; u < FA_U; ++u) {
      const int i = base + u * FA_THREADS, r = i / cols, c = i - r * cols;
      if (i < total) dst[r * dr + c * dc] = v[u] * mul;
    }
  }
}

// NV: output columns per thread; hd_v <= 16 * NV.
template <typename T, int NV>
__global__ void __launch_bounds__(FA_THREADS)
flash_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                       const T* __restrict__ v, const int* __restrict__ qpos,
                       const int* __restrict__ kpos, T* __restrict__ out,
                       int Sq, int Sk, int KV, int G, int hdqk, int hdv,
                       int window, float scale) {
  extern __shared__ float smem[];
  const int LDQ = FA_BQ + 1, LDK = FA_BK + 1, LDP = FA_BK + 1;
  float* Qs = smem;                      // [hdqk][LDQ], pre-scaled
  float* Ks = Qs + hdqk * LDQ;           // [hdqk][LDK]
  float* Vs = Ks + hdqk * LDK;           // [FA_BK][hdv]
  float* Ps = Vs + FA_BK * hdv;          // [FA_BQ][LDP]
  __shared__ int qp_s[FA_BQ];
  __shared__ int kp_s[FA_BK];
  __shared__ int range_s[2];

  const int H = KV * G;
  const int b = blockIdx.y / H, h = blockIdx.y % H, kvh = h / G;
  const int q0 = blockIdx.x * FA_BQ;
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int nq = min(FA_BQ, Sq - q0);

  // query tile (scaled) and its positions; rows past Sq are zero
  fa_stage(q + ((size_t)(b * Sq + q0) * H + h) * hdqk, (size_t)H * hdqk, nq,
           FA_BQ, hdqk, Qs, 1, LDQ, scale);
  if (tid < FA_BQ) qp_s[tid] = tid < nq ? qpos[(size_t)b * Sq + q0 + tid] : 0;
  __syncthreads();
  if (tid < 32) {            // smallest / largest query position of the tile
    int lo = 0x7fffffff, hi = -0x7fffffff;
    for (int r = tid; r < nq; r += 32) {
      lo = min(lo, qp_s[r]);
      hi = max(hi, qp_s[r]);
    }
    for (int o = 16; o > 0; o >>= 1) {
      lo = min(lo, __shfl_xor_sync(0xffffffffu, lo, o));
      hi = max(hi, __shfl_xor_sync(0xffffffffu, hi, o));
    }
    if (tid == 0) { range_s[0] = lo; range_s[1] = hi; }
  }
  __syncthreads();
  const int qlo = range_s[0], qhi = range_s[1];

  float m[4], l[4], acc[4][NV];
  int qr[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = FA_NEG_INF;
    l[i] = 0.f;
    qr[i] = qp_s[ty + 16 * i];
#pragma unroll
    for (int j = 0; j < NV; ++j) acc[i][j] = 0.f;
  }

  for (int k0 = 0; k0 < Sk; k0 += FA_BK) {
    const int nk = min(FA_BK, Sk - k0);
    __syncthreads();                     // previous tile's readers are done
    if (tid < FA_BK) kp_s[tid] = tid < nk ? kpos[(size_t)b * Sk + k0 + tid] : 0;
    __syncthreads();
    int live = 0;
    if (tid < 32) {
      int lo = 0x7fffffff, hi = -0x7fffffff;
      for (int c = tid; c < nk; c += 32) {
        lo = min(lo, kp_s[c]);
        hi = max(hi, kp_s[c]);
      }
      for (int o = 16; o > 0; o >>= 1) {
        lo = min(lo, __shfl_xor_sync(0xffffffffu, lo, o));
        hi = max(hi, __shfl_xor_sync(0xffffffffu, hi, o));
      }
      live = lo <= qhi && (window == 0 || hi > qlo - window);
    }
    if (!__syncthreads_or(live)) continue;   // no live pair in this tile

    fa_stage(k + ((size_t)(b * Sk + k0) * KV + kvh) * hdqk,
             (size_t)KV * hdqk, nk, FA_BK, hdqk, Ks, 1, LDK, 1.f);
    fa_stage(v + ((size_t)(b * Sk + k0) * KV + kvh) * hdv, (size_t)KV * hdv,
             nk, FA_BK, hdv, Vs, hdv, 1, 1.f);
    __syncthreads();

    // scores of 4 rows x 4 keys: rows ty + 16 i, keys tx + 16 j
    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
    for (int d = 0; d < hdqk; ++d) {
      float a[4], bk[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = Qs[d * LDQ + ty + 16 * i];
#pragma unroll
      for (int j = 0; j < 4; ++j) bk[j] = Ks[d * LDK + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] += a[i] * bk[j];
    }

    // online softmax, one row at a time across its 16 threads
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = ty + 16 * i;
      bool lv[4];
      float mt = FA_NEG_INF;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = tx + 16 * j;
        const int kp = kp_s[c];
        lv[j] = r < nq && c < nk && kp <= qr[i] &&
                (window == 0 || qr[i] - kp < window);
        s[i][j] = lv[j] ? s[i][j] : FA_NEG_INF;
        mt = fmaxf(mt, s[i][j]);
      }
      for (int o = 8; o > 0; o >>= 1)
        mt = fmaxf(mt, __shfl_xor_sync(0xffffffffu, mt, o));
      const float m_new = fmaxf(m[i], mt);
      float ps = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = lv[j] ? expf(s[i][j] - m_new) : 0.f;
        Ps[r * LDP + tx + 16 * j] = p;
        ps += p;
      }
      for (int o = 8; o > 0; o >>= 1)
        ps += __shfl_xor_sync(0xffffffffu, ps, o);
      const float corr = expf(fminf(m[i] - m_new, 0.f));
      l[i] = l[i] * corr + ps;
      m[i] = m_new;
#pragma unroll
      for (int j = 0; j < NV; ++j) acc[i][j] *= corr;
    }
    __syncthreads();

    // acc += p v: rows ty + 16 i, columns tx + 16 j
    for (int c = 0; c < nk; ++c) {
      float p[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) p[i] = Ps[(ty + 16 * i) * LDP + c];
#pragma unroll
      for (int j = 0; j < NV; ++j) {
        const int d = tx + 16 * j;
        const float vv = d < hdv ? Vs[c * hdv + d] : 0.f;
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[i][j] += p[i] * vv;
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = ty + 16 * i;
    if (r >= nq) continue;
    const float inv = 1.f / fmaxf(l[i], 1e-30f);
    T* o = out + ((size_t)(b * Sq + q0 + r) * H + h) * hdv;
#pragma unroll
    for (int j = 0; j < NV; ++j) {
      const int d = tx + 16 * j;
      if (d < hdv) fa_store(o + d, acc[i][j] * inv);
    }
  }
}

// ---------------------------------------------------------------------------
// bfloat16 on the tensor cores.  Same blocking (64 queries, 64-key tiles,
// dead tiles skipped); 4 warps, warp w owns query rows 16w..16w+15, and
// everything a warp computes stays in its own rows, so only the K/V tile
// loads need block barriers.  Per live tile, warp w:
//   S (16 x 64)  = Q K^T with WMMA 16x16x16 bf16 fragments, float32 sums,
//                  head dims zero-padded to multiples of 16 in shared memory;
//   softmax      : 2 lanes per row, the kernel's masked form, p rounded to
//                  bf16 for the next product (l sums the float32 p);
//   O (16 x hd_v) = O * corr + P V, O kept in shared memory in float32 and
//                  passed through accumulator fragments (WMMA does not
//                  expose which thread holds which accumulator element, so
//                  the per-row rescale is done in shared memory).
// Tiles are staged with 16-byte loads (all of a thread's issued before it
// stores any) when the head dims are multiples of 8, element loads
// otherwise.
#define FW_THREADS 128

__device__ __forceinline__ size_t fw_align(size_t n) { return (n + 127) & ~size_t(127); }

__device__ __forceinline__ void fw_stage(const __nv_bfloat16* __restrict__ src,
                                         size_t row_stride, int rows_valid,
                                         int hd, int hdp,
                                         __nv_bfloat16* dst, int ld,
                                         bool vec) {
  const __nv_bfloat16 zero = __float2bfloat16(0.f);
  if (vec) {                          // hd % 8 == 0, 16-byte aligned rows
    const int vpr = hdp / 8, total = FA_BK * vpr;
    for (int base = threadIdx.x; base < total; base += FW_THREADS * FA_U) {
      uint4 v[FA_U];
#pragma unroll
      for (int u = 0; u < FA_U; ++u) {
        const int i = base + u * FW_THREADS, r = i / vpr, c = (i - r * vpr) * 8;
        v[u] = (i < total && r < rows_valid && c < hd)
            ? *reinterpret_cast<const uint4*>(src + r * row_stride + c)
            : make_uint4(0u, 0u, 0u, 0u);
      }
#pragma unroll
      for (int u = 0; u < FA_U; ++u) {
        const int i = base + u * FW_THREADS, r = i / vpr, c = (i - r * vpr) * 8;
        if (i < total) *reinterpret_cast<uint4*>(dst + r * ld + c) = v[u];
      }
    }
  } else {
    const int total = FA_BK * hdp;
    for (int base = threadIdx.x; base < total; base += FW_THREADS * FA_U) {
      __nv_bfloat16 v[FA_U];
#pragma unroll
      for (int u = 0; u < FA_U; ++u) {
        const int i = base + u * FW_THREADS, r = i / hdp, c = i - r * hdp;
        v[u] = (i < total && r < rows_valid && c < hd)
            ? src[r * row_stride + c] : zero;
      }
#pragma unroll
      for (int u = 0; u < FA_U; ++u) {
        const int i = base + u * FW_THREADS, r = i / hdp, c = i - r * hdp;
        if (i < total) dst[r * ld + c] = v[u];
      }
    }
  }
}

__global__ void __launch_bounds__(FW_THREADS)
flash_attention_wmma_kernel(const __nv_bfloat16* __restrict__ q,
                            const __nv_bfloat16* __restrict__ k,
                            const __nv_bfloat16* __restrict__ v,
                            const int* __restrict__ qpos,
                            const int* __restrict__ kpos,
                            __nv_bfloat16* __restrict__ out, int Sq, int Sk,
                            int KV, int G, int hdqk, int hdv, int window,
                            float scale, int vec) {
  extern __shared__ __align__(128) unsigned char fw_smem[];
  const int hdp = (hdqk + 15) & ~15, hdvp = (hdv + 15) & ~15;
  const int LQ = hdp + 8, LV = hdvp + 8, LS = FA_BK + 4, LP = FA_BK + 8,
            LO = hdvp + 4;
  size_t off = 0;
  __nv_bfloat16* Qs = reinterpret_cast<__nv_bfloat16*>(fw_smem + off);
  off = fw_align(off + sizeof(__nv_bfloat16) * FA_BQ * LQ);
  __nv_bfloat16* Ks = reinterpret_cast<__nv_bfloat16*>(fw_smem + off);
  off = fw_align(off + sizeof(__nv_bfloat16) * FA_BK * LQ);
  __nv_bfloat16* Vs = reinterpret_cast<__nv_bfloat16*>(fw_smem + off);
  off = fw_align(off + sizeof(__nv_bfloat16) * FA_BK * LV);
  float* Ss = reinterpret_cast<float*>(fw_smem + off);
  off = fw_align(off + sizeof(float) * FA_BQ * LS);
  __nv_bfloat16* Ps = reinterpret_cast<__nv_bfloat16*>(fw_smem + off);
  off = fw_align(off + sizeof(__nv_bfloat16) * FA_BQ * LP);
  float* Os = reinterpret_cast<float*>(fw_smem + off);
  off = fw_align(off + sizeof(float) * FA_BQ * LO);
  float* ml = reinterpret_cast<float*>(fw_smem + off);      // m[64], l[64]
  __shared__ int qp_s[FA_BQ];
  __shared__ int kp_s[FA_BK];
  __shared__ int range_s[2];

  const int H = KV * G;
  const int b = blockIdx.y / H, h = blockIdx.y % H, kvh = h / G;
  const int q0 = blockIdx.x * FA_BQ;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int nq = min(FA_BQ, Sq - q0);

  fw_stage(q + ((size_t)(b * Sq + q0) * H + h) * hdqk, (size_t)H * hdqk, nq,
           hdqk, hdp, Qs, LQ, vec);
  for (int i = tid; i < FA_BQ * LO; i += FW_THREADS) Os[i] = 0.f;
  if (tid < FA_BQ) {
    qp_s[tid] = tid < nq ? qpos[(size_t)b * Sq + q0 + tid] : 0;
    ml[tid] = FA_NEG_INF;
    ml[FA_BQ + tid] = 0.f;
  }
  __syncthreads();
  if (tid < 32) {
    int lo = 0x7fffffff, hi = -0x7fffffff;
    for (int r = tid; r < nq; r += 32) {
      lo = min(lo, qp_s[r]);
      hi = max(hi, qp_s[r]);
    }
    for (int o = 16; o > 0; o >>= 1) {
      lo = min(lo, __shfl_xor_sync(0xffffffffu, lo, o));
      hi = max(hi, __shfl_xor_sync(0xffffffffu, hi, o));
    }
    if (tid == 0) { range_s[0] = lo; range_s[1] = hi; }
  }
  __syncthreads();
  const int qlo = range_s[0], qhi = range_s[1];
  const int r0 = warp * 16;                  // this warp's first row
  const int rr = r0 + (lane >> 1), half = lane & 1;   // softmax: row, half
  const int qr = qp_s[rr];

  for (int k0 = 0; k0 < Sk; k0 += FA_BK) {
    const int nk = min(FA_BK, Sk - k0);
    __syncthreads();                     // previous tile's readers are done
    if (tid < FA_BK) kp_s[tid] = tid < nk ? kpos[(size_t)b * Sk + k0 + tid] : 0;
    __syncthreads();
    int live = 0;
    if (tid < 32) {
      int lo = 0x7fffffff, hi = -0x7fffffff;
      for (int c = tid; c < nk; c += 32) {
        lo = min(lo, kp_s[c]);
        hi = max(hi, kp_s[c]);
      }
      for (int o = 16; o > 0; o >>= 1) {
        lo = min(lo, __shfl_xor_sync(0xffffffffu, lo, o));
        hi = max(hi, __shfl_xor_sync(0xffffffffu, hi, o));
      }
      live = lo <= qhi && (window == 0 || hi > qlo - window);
    }
    if (!__syncthreads_or(live)) continue;   // no live pair in this tile

    fw_stage(k + ((size_t)(b * Sk + k0) * KV + kvh) * hdqk, (size_t)KV * hdqk,
             nk, hdqk, hdp, Ks, LQ, vec);
    fw_stage(v + ((size_t)(b * Sk + k0) * KV + kvh) * hdv, (size_t)KV * hdv,
             nk, hdv, hdvp, Vs, LV, vec);
    __syncthreads();

    // S = Q K^T for this warp's 16 rows x 64 keys
    {
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> sf[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) wmma::fill_fragment(sf[j], 0.f);
      for (int kd = 0; kd < hdp; kd += 16) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16,
                       wmma::row_major> a;
        wmma::load_matrix_sync(a, Qs + r0 * LQ + kd, LQ);
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16,
                         wmma::col_major> bt;
          wmma::load_matrix_sync(bt, Ks + (16 * j) * LQ + kd, LQ);
          wmma::mma_sync(sf[j], a, bt, sf[j]);
        }
      }
#pragma unroll
      for (int j = 0; j < 4; ++j)
        wmma::store_matrix_sync(Ss + r0 * LS + 16 * j, sf[j], LS,
                                wmma::mem_row_major);
    }
    __syncwarp();

    // online softmax: row rr, columns half*32 .. half*32+31
    {
      float mt = FA_NEG_INF;
      for (int c = half * 32; c < half * 32 + 32; ++c) {
        const int kp = kp_s[c];
        const bool lv = rr < nq && c < nk && kp <= qr &&
                        (window == 0 || qr - kp < window);
        const float sv = lv ? Ss[rr * LS + c] * scale : FA_NEG_INF;
        Ss[rr * LS + c] = sv;
        mt = fmaxf(mt, sv);
      }
      mt = fmaxf(mt, __shfl_xor_sync(0xffffffffu, mt, 1));
      const float m_old = ml[rr], m_new = fmaxf(m_old, mt);
      float ps = 0.f;
      for (int c = half * 32; c < half * 32 + 32; ++c) {
        const float sv = Ss[rr * LS + c];
        const float p = sv > 0.5f * FA_NEG_INF ? expf(sv - m_new) : 0.f;
        Ps[rr * LP + c] = __float2bfloat16(p);
        ps += p;
      }
      ps += __shfl_xor_sync(0xffffffffu, ps, 1);
      const float corr = expf(fminf(m_old - m_new, 0.f));
      for (int c = half; c < hdvp; c += 2) Os[rr * LO + c] *= corr;
      __syncwarp();
      if (half == 0) {
        ml[rr] = m_new;
        ml[FA_BQ + rr] = ml[FA_BQ + rr] * corr + ps;
      }
    }
    __syncwarp();

    // O += P V for this warp's 16 rows
    for (int jb = 0; jb < hdvp; jb += 16) {
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> of;
      wmma::load_matrix_sync(of, Os + r0 * LO + jb, LO, wmma::mem_row_major);
#pragma unroll
      for (int kc = 0; kc < FA_BK; kc += 16) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16,
                       wmma::row_major> pa;
        wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16,
                       wmma::row_major> vb;
        wmma::load_matrix_sync(pa, Ps + r0 * LP + kc, LP);
        wmma::load_matrix_sync(vb, Vs + kc * LV + jb, LV);
        wmma::mma_sync(of, pa, vb, of);
      }
      wmma::store_matrix_sync(Os + r0 * LO + jb, of, LO, wmma::mem_row_major);
    }
  }
  __syncthreads();

  for (int i = tid; i < nq * hdv; i += FW_THREADS) {
    const int r = i / hdv, c = i - r * hdv;
    const float inv = 1.f / fmaxf(ml[FA_BQ + r], 1e-30f);
    out[((size_t)(b * Sq + q0 + r) * H + h) * hdv + c] =
        __float2bfloat16(Os[r * LO + c] * inv);
  }
}

static size_t fw_smem_bytes(int hdqk, int hdv) {
  const size_t hdp = (hdqk + 15) & ~15, hdvp = (hdv + 15) & ~15;
  auto al = [](size_t n) { return (n + 127) & ~size_t(127); };
  return al(2 * FA_BQ * (hdp + 8)) + al(2 * FA_BK * (hdp + 8)) +
         al(2 * FA_BK * (hdvp + 8)) + al(4 * FA_BQ * (FA_BK + 4)) +
         al(2 * FA_BQ * (FA_BK + 8)) + al(4 * FA_BQ * (hdvp + 4)) +
         al(4 * 2 * FA_BQ);
}

static int launch_wmma(const void* q, const void* k, const void* v,
                       const int* qpos, const int* kpos, void* out, int B,
                       int Sq, int Sk, int KV, int G, int hdqk, int hdv,
                       int window, float scale, cudaStream_t stream) {
  const size_t smem = fw_smem_bytes(hdqk, hdv);
  cudaError_t e = cudaFuncSetAttribute(
      flash_attention_wmma_kernel,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  // 16-byte row loads need head dims that are multiples of 8 and aligned
  // operands (every row then starts on a 16-byte boundary)
  const int vec = hdqk % 8 == 0 && hdv % 8 == 0 && (size_t)q % 16 == 0 &&
      (size_t)k % 16 == 0 && (size_t)v % 16 == 0;
  dim3 grid((Sq + FA_BQ - 1) / FA_BQ, B * KV * G);
  flash_attention_wmma_kernel<<<grid, FW_THREADS, smem, stream>>>(
      (const __nv_bfloat16*)q, (const __nv_bfloat16*)k,
      (const __nv_bfloat16*)v, qpos, kpos, (__nv_bfloat16*)out, Sq, Sk, KV, G,
      hdqk, hdv, window, scale, vec);
  return (int)cudaGetLastError();
}

template <typename T, int NV>
static int launch_nv(const void* q, const void* k, const void* v,
                     const int* qpos, const int* kpos, void* out, int B,
                     int Sq, int Sk, int KV, int G, int hdqk, int hdv,
                     int window, float scale, cudaStream_t stream) {
  const size_t smem = sizeof(float) *
      ((size_t)hdqk * (FA_BQ + 1) + (size_t)hdqk * (FA_BK + 1) +
       (size_t)FA_BK * hdv + (size_t)FA_BQ * (FA_BK + 1));
  cudaError_t e = cudaFuncSetAttribute(
      flash_attention_kernel<T, NV>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  dim3 grid((Sq + FA_BQ - 1) / FA_BQ, B * KV * G);
  flash_attention_kernel<T, NV><<<grid, FA_THREADS, smem, stream>>>(
      (const T*)q, (const T*)k, (const T*)v, qpos, kpos, (T*)out, Sq, Sk, KV,
      G, hdqk, hdv, window, scale);
  return (int)cudaGetLastError();
}

template <typename T>
static int launch_t(const void* q, const void* k, const void* v,
                    const int* qpos, const int* kpos, void* out, int B,
                    int Sq, int Sk, int KV, int G, int hdqk, int hdv,
                    int window, float scale, cudaStream_t stream) {
  if (hdv <= 64)
    return launch_nv<T, 4>(q, k, v, qpos, kpos, out, B, Sq, Sk, KV, G, hdqk,
                           hdv, window, scale, stream);
  if (hdv <= 128)
    return launch_nv<T, 8>(q, k, v, qpos, kpos, out, B, Sq, Sk, KV, G, hdqk,
                           hdv, window, scale, stream);
  return launch_nv<T, 16>(q, k, v, qpos, kpos, out, B, Sq, Sk, KV, G, hdqk,
                          hdv, window, scale, stream);
}

// ---------------------------------------------------------------------------
// bfloat16 with hd_qk == hd_v in {64, 80, 112, 128}: TMA + mbarrier ring +
// wgmma, warp specialised ("wgmma_tma").
//
// Block: 128 queries of one (batch, q head) x every live 128-key tile.
// 384 threads = three warpgroups.  Warpgroup 0 is the producer: after the
// setup below it gives registers away (setmaxnreg 40) and one thread
// issues the TMA loads: the Q tile once, then per live kv tile the K tile
// and the V tile into a ring of FH_STAGES stages, each with its own full
// (TMA bytes arrived) and empty (both consumers done) mbarrier, so K of the
// next tile streams in while V of this one is still being read.
// Warpgroups 1 and 2 are the consumers (setmaxnreg 232), 64 query rows
// each; per kv tile each one
//   S = Q K^T      wgmma m64n128k16, A (Q) and B (K) K-major from shared
//                  memory, hd / 16 k steps, f32 accumulators in registers;
//   softmax        in registers: scores scaled to log2 units, a partial
//                  tile masked per element (kpos read from global memory),
//                  row max / sum over the accumulator layout with quad
//                  shuffles, m and l per row in registers (l summed per
//                  thread, reduced across the quad once at the end);
//   O = O*c + P V  P rounded to bf16 straight from the S accumulators (the
//                  m64 accumulator layout is the register A-fragment
//                  layout) and used as the register A operand of wgmma
//                  m64n{hd}k16 with V as an MN-major B (trans-b), 8 k steps
//                  over the 128 keys; O stays in registers for the whole kv
//                  loop and is rescaled there.
// Nothing of S, P or O touches shared memory.
//
// Tile classes.  Before the roles split, the 12 warps classify every kv
// tile from its position range against the query tile's (any position
// arrays): dead (skipped: no loads, no products), full (every key live for
// every query: kmax <= qmin and, with a window, kmin > qmax - window, and
// the tile is not ragged: no per-element mask), partial (masked per
// element).  The classes sit in shared memory (one byte per tile), and
// producer and consumers walk the same list; they share the 227 KB with
// the tiles, so Sk is at most ~8.6 M keys at hd 80 / 112 / 128 (a longer
// one is refused at launch).
//
// Head dim 80: a row of 80 bf16 is 160 B, not a 128-B swizzle row.  Each
// operand is loaded as 64-column TMA boxes; the second box of an 80-wide
// row reads columns 64..127 of which 80..127 lie past the tensor map's
// extent and are zero-filled by TMA.  Q K^T uses 5 k steps (the 4 of the
// first box and the first of the second), so the padding costs no MMA
// work, only shared memory (a 32 KB Q, K or V tile instead of 20 KB) and
// TMA bandwidth into shared memory; P V is one m64n80k16 per k step, its B
// spanning both boxes (LBO = the box stride).  Head dim 112 (224-B rows)
// the same way: the second box's columns 112..127 are zero fill, Q K^T
// takes 7 k steps, P V one m64n112k16 per k step, O is 56 registers.
// GQA: q head h reads kv head h / G; the G heads of a group are not packed
// into M (one block per q head), and heads are the fastest grid dimension,
// so the G blocks that share a K/V tile run side by side and meet it in
// L2.  (Packing them into M, one K/V tile in shared memory for all G
// heads, was tried and gave no gain: the K/V traffic from L2 is not what
// holds this kernel back.)  Causal imbalance: the longest q tiles are
// launched first (q tiles in reverse order).
#define FH_BQ 128            // queries per block
#define FH_BK 128            // keys per kv tile
#define FH_STAGES 2
#define FH_THREADS 384
#define FH_BOX (FH_BK * HP_ROW_BYTES)      // one 64-column box: 16 KB
#define FH_MAX_SMEM 232448

template <int HD>
struct FhCfg {
  static constexpr int NB = (HD + HP_BOX_COLS - 1) / HP_BOX_COLS;
  static constexpr int NKS = HD / 16;          // k steps of Q K^T
  static constexpr int TILE = NB * FH_BOX;     // bytes of a Q, K or V tile
};

template <int HD>
__device__ __forceinline__ void fh_pv(float* o, const uint32_t* a,
                                      uint64_t db) {
  if constexpr (HD == 64) wgmma_rs_m64n64k16_tb(o, a, db, 1);
  else if constexpr (HD == 80) wgmma_rs_m64n80k16_tb(o, a, db, 1);
  else if constexpr (HD == 112) wgmma_rs_m64n112k16_tb(o, a, db, 1);
  else wgmma_rs_m64n128k16_tb(o, a, db, 1);
}

__device__ __forceinline__ bool fh_live(int kp, int qp, int window) {
  return kp <= qp &&
         (window == 0 || (long long)qp - (long long)kp < (long long)window);
}

template <int HD>
__global__ void __launch_bounds__(FH_THREADS, 1)
flash_attention_wgmma_kernel(const __grid_constant__ CUtensorMap tmq,
                             const __grid_constant__ CUtensorMap tmk,
                             const __grid_constant__ CUtensorMap tmv,
                             const int* __restrict__ qpos,
                             const int* __restrict__ kpos,
                             __nv_bfloat16* __restrict__ out, int Sq, int Sk,
                             int KV, int G, int window, float scale_log2) {
  using C = FhCfg<HD>;
  extern __shared__ uint8_t fh_raw[];
  const uint32_t raw = hp_smem(fh_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  const uint32_t sQ = base;
  const uint32_t sK = base + C::TILE;
  const uint32_t sV = base + (1 + FH_STAGES) * C::TILE;
  uint8_t* tail = fh_raw + (base - raw) + (1 + 2 * FH_STAGES) * C::TILE;
  const uint32_t bars = hp_smem(tail);  // fullQ, fullK[S], emptyK[S], fullV[S], emptyV[S]
  int* qrange = reinterpret_cast<int*>(tail + 96);
  uint8_t* cls = tail + 128;
  const uint32_t fullQ = bars;
  auto fullK = [&](int s) { return bars + 8u * (1 + s); };
  auto emptyK = [&](int s) { return bars + 8u * (1 + FH_STAGES + s); };
  auto fullV = [&](int s) { return bars + 8u * (1 + 2 * FH_STAGES + s); };
  auto emptyV = [&](int s) { return bars + 8u * (1 + 3 * FH_STAGES + s); };

  const int H = KV * G;
  const int b = blockIdx.x / H, h = blockIdx.x % H, kvh = h / G;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * FH_BQ;
  const int nq = min(FH_BQ, Sq - q0);
  const int nkt = (Sk + FH_BK - 1) / FH_BK;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;

  if (tid == 0) {
    hp_mbar_init(fullQ, 1);
    for (int s = 0; s < FH_STAGES; ++s) {
      hp_mbar_init(fullK(s), 1);
      hp_mbar_init(fullV(s), 1);
      hp_mbar_init(emptyK(s), 2 * 128);
      hp_mbar_init(emptyV(s), 2 * 128);
    }
    hp_mbar_fence_init();
  }
  if (warp == 0) {          // smallest / largest query position of the tile
    int lo = INT_MAX, hi = INT_MIN;
    for (int r = lane; r < nq; r += 32) {
      const int p = qpos[(size_t)b * Sq + q0 + r];
      lo = min(lo, p);
      hi = max(hi, p);
    }
    for (int o = 16; o > 0; o >>= 1) {
      lo = min(lo, __shfl_xor_sync(0xffffffffu, lo, o));
      hi = max(hi, __shfl_xor_sync(0xffffffffu, hi, o));
    }
    if (lane == 0) { qrange[0] = lo; qrange[1] = hi; }
  }
  __syncthreads();
  {                         // kv tile classes: 0 dead, 1 partial, 2 full
    const long long qlo = qrange[0], qhi = qrange[1], win = window;
    for (int t = warp; t < nkt; t += FH_THREADS / 32) {
      const int k0 = t * FH_BK, nk = min(FH_BK, Sk - k0);
      int lo = INT_MAX, hi = INT_MIN;
      for (int c = lane; c < nk; c += 32) {
        const int p = kpos[(size_t)b * Sk + k0 + c];
        lo = min(lo, p);
        hi = max(hi, p);
      }
      for (int o = 16; o > 0; o >>= 1) {
        lo = min(lo, __shfl_xor_sync(0xffffffffu, lo, o));
        hi = max(hi, __shfl_xor_sync(0xffffffffu, hi, o));
      }
      if (lane == 0) {
        const bool live = lo <= qhi && (window == 0 || hi > qlo - win);
        const bool full = nk == FH_BK && hi <= qlo &&
                          (window == 0 || lo > qhi - win);
        cls[t] = live ? (full ? 2 : 1) : 0;
      }
    }
  }
  __syncthreads();

  if (warp < 4) {
    // ---------------------------------------------------------- producer
    hp_setmaxnreg_dec<40>();
    if (tid == 0) {
      hp_mbar_expect_tx(fullQ, C::TILE);
      for (int x = 0; x < C::NB; ++x)
        hp_tma_load_4d(sQ + x * FH_BOX, &tmq, fullQ, x * HP_BOX_COLS, h, q0,
                       b);
      int s = 0;
      uint32_t ph = 0;
      for (int t = 0; t < nkt; ++t) {
        if (cls[t] == 0) continue;
        hp_mbar_wait(emptyK(s), ph ^ 1);
        hp_mbar_expect_tx(fullK(s), C::TILE);
        for (int x = 0; x < C::NB; ++x)
          hp_tma_load_4d(sK + s * C::TILE + x * FH_BOX, &tmk, fullK(s),
                         x * HP_BOX_COLS, kvh, t * FH_BK, b);
        hp_mbar_wait(emptyV(s), ph ^ 1);
        hp_mbar_expect_tx(fullV(s), C::TILE);
        for (int x = 0; x < C::NB; ++x)
          hp_tma_load_4d(sV + s * C::TILE + x * FH_BOX, &tmv, fullV(s),
                         x * HP_BOX_COLS, kvh, t * FH_BK, b);
        if (++s == FH_STAGES) { s = 0; ph ^= 1; }
      }
    }
  } else {
    // --------------------------------------------------------- consumers
    hp_setmaxnreg_inc<232>();
    const int wg = (warp >> 2) - 1;              // 0 or 1: rows 64 wg ..
    const int r0 = wg * 64 + (warp & 3) * 16 + (lane >> 2), r1 = r0 + 8;
    const int c4 = 2 * (lane & 3);
    const int qp0 = r0 < nq ? qpos[(size_t)b * Sq + q0 + r0] : qrange[0];
    const int qp1 = r1 < nq ? qpos[(size_t)b * Sq + q0 + r1] : qrange[0];
    const int* kp_b = kpos + (size_t)b * Sk;
    float o[HD / 2];
#pragma unroll
    for (int i = 0; i < HD / 2; ++i) o[i] = 0.f;
    float m0 = FA_NEG_INF, m1 = FA_NEG_INF, l0 = 0.f, l1 = 0.f;
    const uint32_t sQw = sQ + wg * 64 * HP_ROW_BYTES;

    hp_mbar_wait(fullQ, 0);
    int s = 0;
    uint32_t ph = 0;
    for (int t = 0; t < nkt; ++t) {
      const int cl = cls[t];
      if (cl == 0) continue;
      float sc[64];
#pragma unroll
      for (int i = 0; i < 64; ++i) sc[i] = 0.f;
      hp_mbar_wait(fullK(s), ph);
      hp_fence_regs<64>(sc);
      hp_wgmma_fence();
#pragma unroll
      for (int ks = 0; ks < C::NKS; ++ks) {
        const uint32_t off = (ks >> 2) * FH_BOX + (ks & 3) * 32;
        wgmma_ss_m64n128k16(sc, hp_desc_k(sQw + off),
                            hp_desc_k(sK + s * C::TILE + off), 1);
      }
      hp_wgmma_commit();
      hp_wgmma_wait<0>();
      hp_fence_regs<64>(sc);
      hp_mbar_arrive(emptyK(s));

      // scores in log2 units; a partial tile is masked per element (-inf:
      // exp2 gives 0)
      if (cl == 1) {
        const int k0 = t * FH_BK;
#pragma unroll
        for (int j = 0; j < 16; ++j)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int kj = k0 + 8 * j + c4 + e;
            const bool in = kj < Sk;
            const int kp = in ? kp_b[kj] : 0;
            sc[4 * j + e] = in && fh_live(kp, qp0, window)
                                ? sc[4 * j + e] * scale_log2 : -INFINITY;
            sc[4 * j + 2 + e] = in && fh_live(kp, qp1, window)
                                    ? sc[4 * j + 2 + e] * scale_log2
                                    : -INFINITY;
          }
      } else {
#pragma unroll
        for (int i = 0; i < 64; ++i) sc[i] *= scale_log2;
      }
      float t0 = -INFINITY, t1 = -INFINITY;
#pragma unroll
      for (int j = 0; j < 16; ++j) {
        t0 = fmaxf(t0, fmaxf(sc[4 * j], sc[4 * j + 1]));
        t1 = fmaxf(t1, fmaxf(sc[4 * j + 2], sc[4 * j + 3]));
      }
#pragma unroll
      for (int o2 = 1; o2 <= 2; o2 <<= 1) {
        t0 = fmaxf(t0, __shfl_xor_sync(0xffffffffu, t0, o2));
        t1 = fmaxf(t1, __shfl_xor_sync(0xffffffffu, t1, o2));
      }
      const float mn0 = fmaxf(m0, t0), mn1 = fmaxf(m1, t1);
      const float cr0 = exp2f(m0 - mn0), cr1 = exp2f(m1 - mn1);
      m0 = mn0;
      m1 = mn1;
      float ps0 = 0.f, ps1 = 0.f;
#pragma unroll
      for (int j = 0; j < 16; ++j) {
        sc[4 * j] = exp2f(sc[4 * j] - mn0);
        sc[4 * j + 1] = exp2f(sc[4 * j + 1] - mn0);
        sc[4 * j + 2] = exp2f(sc[4 * j + 2] - mn1);
        sc[4 * j + 3] = exp2f(sc[4 * j + 3] - mn1);
        ps0 += sc[4 * j] + sc[4 * j + 1];
        ps1 += sc[4 * j + 2] + sc[4 * j + 3];
      }
      l0 = l0 * cr0 + ps0;
      l1 = l1 * cr1 + ps1;
#pragma unroll
      for (int j = 0; j < HD / 8; ++j) {
        o[4 * j] *= cr0;
        o[4 * j + 1] *= cr0;
        o[4 * j + 2] *= cr1;
        o[4 * j + 3] *= cr1;
      }
      uint32_t pa[32];
#pragma unroll
      for (int ks = 0; ks < 8; ++ks) {
        pa[4 * ks] = hp_pack_bf16(sc[8 * ks], sc[8 * ks + 1]);
        pa[4 * ks + 1] = hp_pack_bf16(sc[8 * ks + 2], sc[8 * ks + 3]);
        pa[4 * ks + 2] = hp_pack_bf16(sc[8 * ks + 4], sc[8 * ks + 5]);
        pa[4 * ks + 3] = hp_pack_bf16(sc[8 * ks + 6], sc[8 * ks + 7]);
      }

      hp_mbar_wait(fullV(s), ph);
      hp_fence_regs<HD / 2>(o);
      hp_wgmma_fence();
#pragma unroll
      for (int ks = 0; ks < 8; ++ks)
        fh_pv<HD>(o, &pa[4 * ks],
                  hp_desc_mn(sV + s * C::TILE + ks * 16 * HP_ROW_BYTES,
                             FH_BOX));
      hp_wgmma_commit();
      hp_wgmma_wait<0>();
      hp_fence_regs<HD / 2>(o);
      hp_mbar_arrive(emptyV(s));
      if (++s == FH_STAGES) { s = 0; ph ^= 1; }
    }

#pragma unroll
    for (int o2 = 1; o2 <= 2; o2 <<= 1) {
      l0 += __shfl_xor_sync(0xffffffffu, l0, o2);
      l1 += __shfl_xor_sync(0xffffffffu, l1, o2);
    }
    const float i0 = 1.f / fmaxf(l0, 1e-30f), i1 = 1.f / fmaxf(l1, 1e-30f);
    __nv_bfloat16* o0 = out + ((size_t)(b * Sq + q0 + r0) * H + h) * HD;
    __nv_bfloat16* o1 = out + ((size_t)(b * Sq + q0 + r1) * H + h) * HD;
#pragma unroll
    for (int j = 0; j < HD / 8; ++j) {
      const int c = 8 * j + c4;
      if (r0 < nq)
        *reinterpret_cast<uint32_t*>(o0 + c) =
            hp_pack_bf16(o[4 * j] * i0, o[4 * j + 1] * i0);
      if (r1 < nq)
        *reinterpret_cast<uint32_t*>(o1 + c) =
            hp_pack_bf16(o[4 * j + 2] * i1, o[4 * j + 3] * i1);
    }
  }
}

template <int HD>
static int launch_wgmma_hd(const void* q, const void* k, const void* v,
                           const int* qpos, const int* kpos, void* out, int B,
                           int Sq, int Sk, int KV, int G, int window,
                           float scale, cudaStream_t stream) {
  using C = FhCfg<HD>;
  const uint64_t H = (uint64_t)KV * G, row = HD * 2;
  const uint32_t box[4] = {HP_BOX_COLS, 1, FH_BK, 1};
  CUtensorMap mq, mk, mv;
  const uint64_t dq[4] = {HD, H, (uint64_t)Sq, (uint64_t)B};
  const uint64_t sq[3] = {row, H * row, (uint64_t)Sq * H * row};
  const uint64_t dk[4] = {HD, (uint64_t)KV, (uint64_t)Sk, (uint64_t)B};
  const uint64_t sk[3] = {row, KV * row, (uint64_t)Sk * KV * row};
  int e = hp_tensor_map(&mq, q, 4, dq, sq, box);
  if (!e) e = hp_tensor_map(&mk, k, 4, dk, sk, box);
  if (!e) e = hp_tensor_map(&mv, v, 4, dk, sk, box);
  if (e) return e;
  const int nkt = (Sk + FH_BK - 1) / FH_BK;
  const size_t smem = 1024 + (size_t)(1 + 2 * FH_STAGES) * C::TILE + 128 +
                      (((size_t)nkt + 15) & ~(size_t)15);
  if (smem > FH_MAX_SMEM) return (int)cudaErrorInvalidValue;
  cudaError_t ce = cudaFuncSetAttribute(
      flash_attention_wgmma_kernel<HD>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (ce != cudaSuccess) return (int)ce;
  dim3 grid((unsigned)(B * H), (unsigned)((Sq + FH_BQ - 1) / FH_BQ));
  flash_attention_wgmma_kernel<HD><<<grid, FH_THREADS, smem, stream>>>(
      mq, mk, mv, qpos, kpos, (__nv_bfloat16*)out, Sq, Sk, KV, G, window,
      scale * 1.4426950408889634f);
  return (int)cudaGetLastError();
}

static int launch_wgmma(const void* q, const void* k, const void* v,
                        const int* qpos, const int* kpos, void* out, int B,
                        int Sq, int Sk, int KV, int G, int hd, int window,
                        float scale, cudaStream_t stream) {
  switch (hd) {
    case 64:
      return launch_wgmma_hd<64>(q, k, v, qpos, kpos, out, B, Sq, Sk, KV, G,
                                 window, scale, stream);
    case 80:
      return launch_wgmma_hd<80>(q, k, v, qpos, kpos, out, B, Sq, Sk, KV, G,
                                 window, scale, stream);
    case 112:
      return launch_wgmma_hd<112>(q, k, v, qpos, kpos, out, B, Sq, Sk, KV, G,
                                  window, scale, stream);
    case 128:
      return launch_wgmma_hd<128>(q, k, v, qpos, kpos, out, B, Sq, Sk, KV, G,
                                  window, scale, stream);
  }
  return (int)cudaErrorInvalidValue;
}

// dtype: 0 float32, 1 bfloat16.  variant (chosen by the wrapper's
// `_variant`): 0 the CUDA-core kernel (float32), 1 the WMMA kernel
// (bfloat16), 2 the wgmma/TMA kernel (bfloat16, hd_qk == hd_v in
// {64, 80, 112, 128}, 16-byte aligned operands).  A variant whose
// conditions do not hold is refused.  Returns a cudaError_t (0 = launched).
extern "C" int flash_attention_launch(const void* q, const void* k,
                                      const void* v, const int* qpos,
                                      const int* kpos, void* out, int B,
                                      int Sq, int Sk, int KV, int G, int hdqk,
                                      int hdv, int window, float scale,
                                      int dtype, int variant,
                                      cudaStream_t stream) {
  const bool known = (dtype == 0 && variant == 0) ||
                     (dtype == 1 && (variant == 1 || variant == 2));
  if (hdqk < 1 || hdqk > 256 || hdv < 1 || hdv > 256 || !known)
    return (int)cudaErrorInvalidValue;
  if (variant == 0)
    return launch_t<float>(q, k, v, qpos, kpos, out, B, Sq, Sk, KV, G, hdqk,
                           hdv, window, scale, stream);
  if (variant == 1)
    return launch_wmma(q, k, v, qpos, kpos, out, B, Sq, Sk, KV, G, hdqk, hdv,
                       window, scale, stream);
  const bool aligned = (size_t)q % 16 == 0 && (size_t)k % 16 == 0 &&
                       (size_t)v % 16 == 0;
  if (hdqk != hdv || !aligned) return (int)cudaErrorInvalidValue;
  return launch_wgmma(q, k, v, qpos, kpos, out, B, Sq, Sk, KV, G, hdqk,
                      window, scale, stream);
}
