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
// What the design does about it.
//  * One block per (batch * q-head, 64-query tile).  The TPU kernel's
//    sequential kv grid dimension has no GPU counterpart: the block loops
//    over 64-key tiles itself and carries the online-softmax state (row max
//    m, row sum l, the 64 x hd_v accumulator) in registers.
//  * A kv tile with no live (query, key) pair is skipped (no loads, no
//    products), as the Pallas kernel does; the test is made on the tile's
//    position ranges, so it holds for any position arrays: the key tile is
//    dead when its smallest position is above the largest query position,
//    or (with a window) its largest is at or below the smallest query
//    position minus the window.  Skipping is exact: a dead tile adds 0.
//  * GQA by index: q head h reads kv head h / G directly; nothing is copied.
//  * Any head dim up to 256 (80 for h2o-danube): the products loop over the
//    real hd and the output columns past hd_v are masked, as are the ragged
//    query and key tails of the last tiles.
//  * Masking keeps the reference's form p = live ? exp(s - m) : 0 and
//    out = acc / max(l, 1e-30), so a row with no live key gives 0 and never
//    the exp(0) = 1 of a fully masked row.
//  * Tiles are staged into shared memory with FA_U loads in flight per
//    thread (the first version loaded one element at a time and waited on
//    each: latency-bound).
//  * bfloat16 runs on the tensor cores (flash_attention_wmma_kernel, WMMA
//    16x16x16 fragments with float32 sums; see its note).  float32 runs on
//    the CUDA cores (16 x 16 threads, each 4 query rows x 4 keys for q k^T
//    and 4 rows x ceil(hd_v / 16) columns for p v, operands staged in shared
//    memory, the score rows reduced with half-warp shuffles).  wgmma / TMA
//    pipelines are later work.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <mma.h>

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

// dtype: 0 float32, 1 bfloat16.  Returns a cudaError_t (0 = launched).
extern "C" int flash_attention_launch(const void* q, const void* k,
                                      const void* v, const int* qpos,
                                      const int* kpos, void* out, int B,
                                      int Sq, int Sk, int KV, int G, int hdqk,
                                      int hdv, int window, float scale,
                                      int dtype, cudaStream_t stream) {
  if (hdqk < 1 || hdqk > 256 || hdv < 1 || hdv > 256 || dtype < 0 ||
      dtype > 1)
    return (int)cudaErrorInvalidValue;
  if (dtype == 0)
    return launch_t<float>(q, k, v, qpos, kpos, out, B, Sq, Sk, KV, G, hdqk,
                           hdv, window, scale, stream);
  return launch_wmma(q, k, v, qpos, kpos, out, B, Sq, Sk, KV, G, hdqk, hdv,
                     window, scale, stream);
}
