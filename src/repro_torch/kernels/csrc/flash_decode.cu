// Split-KV single-token attention over a ring KV cache (decode) for NVIDIA
// Hopper (sm_90a), CUDA C++.
//
// Replaces: src/repro/kernels/flash_decode.py (_decode_kernel /
// flash_decode_pallas, the Pallas kernel of the reference package).
// q (B,KV,G,hd), cache_k (B,W,KV,hd), cache_v (B,W,KV,hd_v), qpos (B,),
// kpos (B,W) int32 -> out (B,KV,G,hd_v).  Slot j is live for row b when
// kpos[b,j] <= qpos[b] and, with a window, qpos[b] - kpos[b,j] < window;
// slots not written yet carry a future position (1e9) and drop out.  q and
// the cache are float32 or bfloat16 (independently), sums in float32.
//
// What bounds it on an H100.  Bytes: the live cache slots are read once,
// 2 * W * KV * hd * 2 B per row in bf16 (~42 MB per layer for 4 rows of a
// full 4,096 window, ~12.5 us at 3.35 TB/s); the operations (4 * G * hd per
// slot) are ~1 flop per byte, far below the tensor-core rate.
//
// What the design does about it.
//  * The TPU kernel walks the cache as a sequential grid dimension and
//    carries (m, l, acc) in scratch from one step to the next.  A GPU grid
//    has no order, so the sweep is split for real: grid (B * KV, n_splits),
//    each block sweeps kv_block slots and writes its partial (m, l, acc) for
//    the G heads of its kv group; a second small kernel merges the splits
//    (acc and l rescaled by exp(m_split - m_max)).  The splits fill the card
//    where B * KV blocks alone would not (4 * 8 = 32 blocks for 132 SMs).
//  * The G query heads of a kv group share the block, so every cache tile
//    is read from device memory once for all G heads (GQA's memory saving).
//  * Cache tiles of 64 slots are staged in shared memory with neighbouring
//    threads on neighbouring addresses and FD_U loads in flight per thread
//    (the first version waited on every load: latency-bound); a tile whose
//    slots are all dead (unwritten or out of the window) is not loaded.
//  * Masking keeps the form p = live ? exp(s - m) : 0 and out = acc /
//    max(l, 1e-30): a split, or a row, with no live slot adds nothing.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>

#define FD_TILE 64
#define FD_THREADS 128
#define FD_ACC 16          // G * hd_v <= FD_THREADS * FD_ACC = 2048
#define FD_NEG_INF (-1e30f)

__device__ __forceinline__ float fd_load(const float* p) { return *p; }
__device__ __forceinline__ float fd_load(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}
__device__ __forceinline__ void fd_store(float* p, float x) { *p = x; }
__device__ __forceinline__ void fd_store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
}

// Copy a rows x cols tile (row r at src + r * row_stride, rows past
// rows_valid read as 0) into shared memory at dst[r * ld + c].  Each thread
// keeps FD_U loads in flight before it stores any.
#define FD_U 16
template <typename T>
__device__ __forceinline__ void fd_stage(const T* __restrict__ src,
                                         size_t row_stride, int rows_valid,
                                         int rows, int cols, float* dst,
                                         int ld) {
  const int total = rows * cols;
  for (int base = threadIdx.x; base < total; base += FD_THREADS * FD_U) {
    float v[FD_U];
#pragma unroll
    for (int u = 0; u < FD_U; ++u) {
      const int i = base + u * FD_THREADS, r = i / cols, c = i - r * cols;
      v[u] = (i < total && r < rows_valid) ? fd_load(src + r * row_stride + c)
                                           : 0.f;
    }
#pragma unroll
    for (int u = 0; u < FD_U; ++u) {
      const int i = base + u * FD_THREADS, r = i / cols, c = i - r * cols;
      if (i < total) dst[r * ld + c] = v[u];
    }
  }
}

// partials, per (b * KV + kvh, split): m[G], l[G], acc[G][hdv]
template <typename TQ, typename TC>
__global__ void __launch_bounds__(FD_THREADS)
flash_decode_split_kernel(const TQ* __restrict__ q, const TC* __restrict__ ck,
                          const TC* __restrict__ cv,
                          const int* __restrict__ qpos,
                          const int* __restrict__ kpos,
                          float* __restrict__ part, int W, int KV, int G,
                          int hd, int hdv, int window, int split,
                          float scale) {
  extern __shared__ float smem[];
  const int LDK = hd + 1;
  float* qs = smem;                      // [G][hd], pre-scaled
  float* ks = qs + G * hd;               // [FD_TILE][LDK]
  float* vs = ks + FD_TILE * LDK;        // [FD_TILE][hdv]
  float* ps = vs + FD_TILE * hdv;        // [G][FD_TILE]
  float* ms = ps + G * FD_TILE;          // [G] running max
  float* ls = ms + G;                    // [G] running sum
  float* cs = ls + G;                    // [G] this tile's correction
  __shared__ int kp_s[FD_TILE];

  const int bk = blockIdx.x, b = bk / KV, kvh = bk % KV;
  const int sp = blockIdx.y, ns = gridDim.y;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int c_begin = sp * split, c_end = min(W, c_begin + split);
  const int qp = qpos[b];
  const int nout = G * hdv;

  for (int i = tid; i < G * hd; i += FD_THREADS)
    qs[i] = fd_load(q + (size_t)bk * G * hd + i) * scale;
  for (int g = tid; g < G; g += FD_THREADS) {
    ms[g] = FD_NEG_INF;
    ls[g] = 0.f;
  }
  float acc[FD_ACC];
#pragma unroll
  for (int t = 0; t < FD_ACC; ++t) acc[t] = 0.f;

  for (int c0 = c_begin; c0 < c_end; c0 += FD_TILE) {
    const int nk = min(FD_TILE, c_end - c0);
    __syncthreads();                     // previous tile's readers are done
    int live = 0;
    if (tid < FD_TILE) {
      const int kp = tid < nk ? kpos[(size_t)b * W + c0 + tid] : 0;
      live = tid < nk && kp <= qp && (window == 0 || qp - kp < window);
      kp_s[tid] = live;
    }
    if (!__syncthreads_or(live)) continue;   // nothing live in this tile

    fd_stage(ck + ((size_t)(b * W + c0) * KV + kvh) * hd, (size_t)KV * hd,
             nk, FD_TILE, hd, ks, LDK);
    fd_stage(cv + ((size_t)(b * W + c0) * KV + kvh) * hdv, (size_t)KV * hdv,
             nk, FD_TILE, hdv, vs, hdv);
    __syncthreads();

    // scores, masked with the sentinel
    for (int i = tid; i < G * FD_TILE; i += FD_THREADS) {
      const int g = i / FD_TILE, c = i - g * FD_TILE;
      float s = 0.f;
      const float* qg = qs + g * hd;
      const float* kc = ks + c * LDK;
      for (int d = 0; d < hd; ++d) s += qg[d] * kc[d];
      ps[i] = kp_s[c] ? s : FD_NEG_INF;
    }
    __syncthreads();

    // online softmax per head: one warp per head, two slots per lane
    for (int g = warp; g < G; g += FD_THREADS / 32) {
      float* pg = ps + g * FD_TILE;
      const float s0 = pg[lane], s1 = pg[lane + 32];
      float mt = fmaxf(s0, s1);
      for (int o = 16; o > 0; o >>= 1)
        mt = fmaxf(mt, __shfl_xor_sync(0xffffffffu, mt, o));
      const float m_old = ms[g], m_new = fmaxf(m_old, mt);
      const float p0 = kp_s[lane] ? expf(s0 - m_new) : 0.f;
      const float p1 = kp_s[lane + 32] ? expf(s1 - m_new) : 0.f;
      pg[lane] = p0;
      pg[lane + 32] = p1;
      float sum = p0 + p1;
      for (int o = 16; o > 0; o >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, o);
      if (lane == 0) {
        const float corr = expf(fminf(m_old - m_new, 0.f));
        cs[g] = corr;
        ls[g] = ls[g] * corr + sum;
        ms[g] = m_new;
      }
    }
    __syncthreads();

    // acc[g][d] = acc * corr + sum_c p[g][c] v[c][d]
#pragma unroll
    for (int t = 0; t < FD_ACC; ++t) {
      const int i = tid + t * FD_THREADS;
      if (i < nout) {
        const int g = i / hdv, d = i - g * hdv;
        const float* pg = ps + g * FD_TILE;
        float a = acc[t] * cs[g];
        for (int c = 0; c < nk; ++c) a += pg[c] * vs[c * hdv + d];
        acc[t] = a;
      }
    }
  }
  __syncthreads();

  float* pm = part + ((size_t)bk * ns + sp) * G * (hdv + 2);
  for (int g = tid; g < G; g += FD_THREADS) {
    pm[g] = ms[g];
    pm[G + g] = ls[g];
  }
#pragma unroll
  for (int t = 0; t < FD_ACC; ++t) {
    const int i = tid + t * FD_THREADS;
    if (i < nout) pm[2 * G + i] = acc[t];
  }
}

template <typename TQ>
__global__ void __launch_bounds__(FD_THREADS)
flash_decode_combine_kernel(const float* __restrict__ part,
                            TQ* __restrict__ out, int ns, int G, int hdv) {
  const int bk = blockIdx.x;
  const int nout = G * hdv;
  const size_t stride = (size_t)G * (hdv + 2);
  const float* p0 = part + (size_t)bk * ns * stride;
  for (int i = threadIdx.x; i < nout; i += FD_THREADS) {
    const int g = i / hdv;
    float M = FD_NEG_INF;
    for (int s = 0; s < ns; ++s) M = fmaxf(M, p0[s * stride + g]);
    float L = 0.f, A = 0.f;
    for (int s = 0; s < ns; ++s) {
      const float* ps = p0 + s * stride;
      const float w = expf(fminf(ps[g] - M, 0.f));
      L += ps[G + g] * w;
      A += ps[2 * G + i] * w;
    }
    fd_store(out + (size_t)bk * nout + i, A / fmaxf(L, 1e-30f));
  }
}

template <typename TQ, typename TC>
static int launch_t(const void* q, const void* ck, const void* cv,
                    const int* qpos, const int* kpos, float* part, void* out,
                    int B, int W, int KV, int G, int hd, int hdv, int window,
                    int split, float scale, cudaStream_t stream) {
  const int ns = (W + split - 1) / split;
  const size_t smem = sizeof(float) *
      ((size_t)G * hd + (size_t)FD_TILE * (hd + 1) + (size_t)FD_TILE * hdv +
       (size_t)G * FD_TILE + 3 * (size_t)G);
  cudaError_t e = cudaFuncSetAttribute(
      flash_decode_split_kernel<TQ, TC>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  dim3 grid(B * KV, ns);
  flash_decode_split_kernel<TQ, TC><<<grid, FD_THREADS, smem, stream>>>(
      (const TQ*)q, (const TC*)ck, (const TC*)cv, qpos, kpos, part, W, KV, G,
      hd, hdv, window, split, scale);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  flash_decode_combine_kernel<TQ><<<B * KV, FD_THREADS, 0, stream>>>(
      part, (TQ*)out, ns, G, hdv);
  return (int)cudaGetLastError();
}

// qdtype / cdtype: 0 float32, 1 bfloat16 (q and out / the cache).  part:
// float32 scratch of B * KV * ceil(W / split) * G * (hd_v + 2).  Returns a
// cudaError_t (0 = both kernels launched).
extern "C" int flash_decode_launch(const void* q, const void* ck,
                                   const void* cv, const int* qpos,
                                   const int* kpos, float* part, void* out,
                                   int B, int W, int KV, int G, int hd,
                                   int hdv, int window, int split,
                                   float scale, int qdtype, int cdtype,
                                   cudaStream_t stream) {
  if (hd < 1 || hd > 256 || hdv < 1 || hdv > 256 ||
      G * hdv > FD_THREADS * FD_ACC || split < 1 || qdtype < 0 ||
      qdtype > 1 || cdtype < 0 || cdtype > 1)
    return (int)cudaErrorInvalidValue;
  if (qdtype == 0 && cdtype == 0)
    return launch_t<float, float>(q, ck, cv, qpos, kpos, part, out, B, W, KV,
                                  G, hd, hdv, window, split, scale, stream);
  if (qdtype == 0)
    return launch_t<float, __nv_bfloat16>(q, ck, cv, qpos, kpos, part, out,
                                          B, W, KV, G, hd, hdv, window, split,
                                          scale, stream);
  if (cdtype == 0)
    return launch_t<__nv_bfloat16, float>(q, ck, cv, qpos, kpos, part, out,
                                          B, W, KV, G, hd, hdv, window, split,
                                          scale, stream);
  return launch_t<__nv_bfloat16, __nv_bfloat16>(q, ck, cv, qpos, kpos, part,
                                                out, B, W, KV, G, hd, hdv,
                                                window, split, scale, stream);
}
