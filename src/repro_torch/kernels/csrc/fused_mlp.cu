// Fused RMSNorm -> gated-MLP first half for NVIDIA Hopper (sm_90a), CUDA
// C++:  out = act(rmsnorm(x) @ Wg) * (rmsnorm(x) @ Wu),
// rmsnorm(x) = x * rsqrt(mean(x^2) + eps) * (1 + scale), act silu or gelu
// (tanh form).  x (N,d), scale (d,), Wg/Wu (d,F) -> out (N,F); all float32
// or all bfloat16, sums in float32.
//
// Replaces: src/repro/kernels/fused_mlp.py (_fused_kernel /
// fused_rmsnorm_mlp_pallas, the Pallas kernel of the reference package).
//
// What bounds it on an H100.  At decode (N = the batch slots, 4) it reads
// both weight matrices once for a few rows: 2 * d * F * 2 B = 71 MB per
// layer of h2o-danube in bf16, ~21 us at 3.35 TB/s, bound by bytes.  At
// prefill (N up to 4,608) it is 4 * N * d * F = 3.3e11 operations per layer,
// bound by operations (0.33 ms on bf16 tensor cores).
//
// Five device kernels; the wrapper (kernels/fused_mlp.py, `_variant`)
// picks one by dtype and shape alone and passes its code:
//  * "gemv_tma" (bfloat16, N <= 8, d and F multiples of 8, 16-byte aligned
//    operands, the normalised rows within shared memory beside a ring of at
//    least two stages): fused_mlp_gemv_kernel, the decode design for this
//    card: one persistent block per SM, each an equal share of the weight
//    bytes by TMA, the products on tensor cores (see its note).
//  * "rows" (N <= 8, float32 or operands gemv_tma does not take):
//    fused_mlp_rows_kernel, a weight-streaming kernel with no barrier in
//    its d loop (see its note): 216 blocks of 32 columns for F = 6,912,
//    16-byte weight loads, several in flight per thread.  The first version
//    ran decode through the tiled kernel and waited on every load of every
//    K tile: latency-bound, ~20x its bound.
//  * "wgmma_tma" (bfloat16, N > 8, d and F multiples of 8, 16-byte aligned
//    operands): rms_inv_kernel + fused_mlp_wgmma_kernel, the design for
//    this card (TMA ring, warp specialisation, wgmma with the norm applied
//    to the register A operand; see its note).
//  * "wmma" (other bfloat16 shapes): fused_mlp_wmma_kernel, WMMA 16x16x16
//    fragments on 64 x 64 output tiles.
//  * "cuda_cores" (float32, more rows than "rows" takes): output tiles of
//    64 rows x 64 columns, 256 threads (16 x 16), each thread 4 rows x 4
//    columns of gate and of up on the CUDA cores.
// What they share: the TPU kernel loads a whole (TB, d) row tile and a
// (d, FB) weight slice into VMEM.  A block has at most 227 KB of shared
// memory, so here d is walked in K tiles: the rms of each row comes first
// (one warp per row), then every K tile of normalised x is formed (rounded
// to the input type, as the reference's rms_norm rounds) and feeds BOTH
// accumulations, gate and up, which share it.  The normalised activations
// never reach device memory; gate and up meet only in registers, where the
// epilogue applies the activation and the product.  Ragged N, d and F are
// masked.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <mma.h>

#include "hopper.cuh"

using namespace nvcuda;

#define FM_BN 64
#define FM_BK 32
#define FM_THREADS 256

__device__ __forceinline__ float fm_load(const float* p) { return *p; }
__device__ __forceinline__ float fm_load(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}
__device__ __forceinline__ float fm_round(float x, const float*) { return x; }
__device__ __forceinline__ float fm_round(float x, const __nv_bfloat16*) {
  return __bfloat162float(__float2bfloat16(x));
}
__device__ __forceinline__ void fm_store(float* p, float x) { *p = x; }
__device__ __forceinline__ void fm_store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
}

__device__ __forceinline__ float fm_act(float g, int act) {
  if (act == 1) {            // gelu, tanh form (jax.nn.gelu(approximate=True))
    const float c = 0.7978845608028654f;      // sqrt(2 / pi)
    return 0.5f * g * (1.f + tanhf(c * (g + 0.044715f * g * g * g)));
  }
  return g / (1.f + expf(-g));                // silu
}

// BM rows per block, TM rows per thread
template <typename T>
__global__ void __launch_bounds__(FM_THREADS)
fused_mlp_kernel(const T* __restrict__ x, const T* __restrict__ scale,
                 const T* __restrict__ wg, const T* __restrict__ wu,
                 T* __restrict__ out, int N, int d, int F, int act,
                 float eps) {
  constexpr int TM = 4, BM = 16 * TM;
  constexpr int LDX = BM + 1;
  __shared__ float xs[FM_BK][LDX];         // normalised x, k-major
  __shared__ float gs[FM_BK][FM_BN];
  __shared__ float us[FM_BK][FM_BN];
  __shared__ float inv_s[BM];

  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int lane = tid & 31, warp = tid >> 5;
  const int n0 = blockIdx.x * FM_BN, m0 = blockIdx.y * BM;

  // pass 1: 1 / rms of each row of the tile
  for (int r = warp; r < BM; r += FM_THREADS / 32) {
    const int row = m0 + r;
    float ss = 0.f;
    if (row < N)
      for (int k = lane; k < d; k += 32) {
        const float v = fm_load(x + (size_t)row * d + k);
        ss += v * v;
      }
    for (int o = 16; o > 0; o >>= 1) ss += __shfl_xor_sync(0xffffffffu, ss, o);
    if (lane == 0) inv_s[r] = row < N ? rsqrtf(ss / (float)d + eps) : 0.f;
  }
  __syncthreads();

  float g[TM][4], u[TM][4];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) g[i][j] = u[i][j] = 0.f;

  for (int k0 = 0; k0 < d; k0 += FM_BK) {
    // normalised x tile (rounded to T as rms_norm's output is) and the two
    // weight tiles; each thread issues all its loads before it stores any
    constexpr int NX = BM * FM_BK / FM_THREADS;
    constexpr int NW = FM_BK * FM_BN / FM_THREADS;
    float xv[NX], sv[NX], gv[NW], uv[NW];
#pragma unroll
    for (int t = 0; t < NX; ++t) {
      const int i = tid + t * FM_THREADS, r = i / FM_BK, kk = i - r * FM_BK;
      const int row = m0 + r, k = k0 + kk;
      const bool in = row < N && k < d;
      xv[t] = in ? fm_load(x + (size_t)row * d + k) : 0.f;
      sv[t] = in ? fm_load(scale + k) : 0.f;
    }
#pragma unroll
    for (int t = 0; t < NW; ++t) {
      const int i = tid + t * FM_THREADS, kk = i / FM_BN, c = i - kk * FM_BN;
      const int k = k0 + kk, col = n0 + c;
      const bool in = k < d && col < F;
      gv[t] = in ? fm_load(wg + (size_t)k * F + col) : 0.f;
      uv[t] = in ? fm_load(wu + (size_t)k * F + col) : 0.f;
    }
#pragma unroll
    for (int t = 0; t < NX; ++t) {
      const int i = tid + t * FM_THREADS, r = i / FM_BK, kk = i - r * FM_BK;
      // (x * inv) * (1 + scale), in the order of the reference's rms_norm
      xs[kk][r] = fm_round((xv[t] * inv_s[r]) * (1.f + sv[t]), x);
    }
#pragma unroll
    for (int t = 0; t < NW; ++t) {
      const int i = tid + t * FM_THREADS, kk = i / FM_BN, c = i - kk * FM_BN;
      gs[kk][c] = gv[t];
      us[kk][c] = uv[t];
    }
    __syncthreads();
#pragma unroll 8
    for (int kk = 0; kk < FM_BK; ++kk) {
      float a[TM], bg[4], bu[4];
#pragma unroll
      for (int i = 0; i < TM; ++i) a[i] = xs[kk][ty + 16 * i];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        bg[j] = gs[kk][tx + 16 * j];
        bu[j] = us[kk][tx + 16 * j];
      }
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          g[i][j] += a[i] * bg[j];
          u[i][j] += a[i] * bu[j];
        }
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int row = m0 + ty + 16 * i;
    if (row >= N) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int col = n0 + tx + 16 * j;
      if (col < F)
        fm_store(out + (size_t)row * F + col, fm_act(g[i][j], act) * u[i][j]);
    }
  }
}


// Decode shapes (N <= FR_ROWS): a weight-streaming kernel.  The block
// normalises its N rows once into shared memory, then 256 threads = 8
// column vectors x 32 k-lanes walk d: each thread loads 8 consecutive
// weights of one matrix per k row (one 16-byte load for bf16 when F and
// the pointers allow), keeps FR_U rows in flight, and accumulates
// N x 8 sums; the 32 k-lanes are summed by shuffles and through shared
// memory, and the epilogue applies act(g) * u.  No barrier inside the
// d loop, so the loads of a thread queue up back to back.
#define FR_ROWS 8
#define FR_COLS 32          // columns of F per block (4 vectors of 8)
#define FR_U 4
#define FR_MAX_SMEM (160 * 1024)

__device__ __forceinline__ void fr_load8(const float* p, bool vec, int valid,
                                         float* w) {
  if (vec) {
    const float4 a = *reinterpret_cast<const float4*>(p);
    const float4 b = *reinterpret_cast<const float4*>(p + 4);
    w[0] = a.x; w[1] = a.y; w[2] = a.z; w[3] = a.w;
    w[4] = b.x; w[5] = b.y; w[6] = b.z; w[7] = b.w;
  } else {
#pragma unroll
    for (int j = 0; j < 8; ++j) w[j] = j < valid ? p[j] : 0.f;
  }
}
__device__ __forceinline__ void fr_load8(const __nv_bfloat16* p, bool vec,
                                         int valid, float* w) {
  if (vec) {
    const uint4 a = *reinterpret_cast<const uint4*>(p);
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&a);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const float2 f = __bfloat1622float2(h[j]);
      w[2 * j] = f.x;
      w[2 * j + 1] = f.y;
    }
  } else {
#pragma unroll
    for (int j = 0; j < 8; ++j) w[j] = j < valid ? __bfloat162float(p[j]) : 0.f;
  }
}

template <typename T>
__global__ void __launch_bounds__(FM_THREADS)
fused_mlp_rows_kernel(const T* __restrict__ x, const T* __restrict__ scale,
                      const T* __restrict__ wg, const T* __restrict__ wu,
                      T* __restrict__ out, int N, int d, int F, int act,
                      float eps, int vec_ok) {
  extern __shared__ float xn[];                  // [N][d]
  __shared__ float red[FM_THREADS / 32][8][FR_ROWS * 8];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int n0 = blockIdx.x * FR_COLS;

  // normalised rows: warp r computes row r's rms, then writes the row
  for (int r = warp; r < N; r += FM_THREADS / 32) {
    float ss = 0.f;
    for (int k = lane; k < d; k += 32) {
      const float v = fm_load(x + (size_t)r * d + k);
      ss += v * v;
    }
    for (int o = 16; o > 0; o >>= 1) ss += __shfl_xor_sync(0xffffffffu, ss, o);
    const float inv = rsqrtf(ss / (float)d + eps);
    for (int k = lane; k < d; k += 32)
      xn[r * d + k] = fm_round(
          (fm_load(x + (size_t)r * d + k) * inv) * (1.f + fm_load(scale + k)),
          x);
  }
  __syncthreads();

  const int vsel = tid & 7, kl = tid >> 3;       // vector, k-lane (0..31)
  const T* w = (vsel < 4 ? wg : wu);
  const int col = n0 + (vsel & 3) * 8;
  const int valid = min(8, F - col);
  const bool vec = vec_ok && valid == 8;
  float acc[FR_ROWS][8];
#pragma unroll
  for (int n = 0; n < FR_ROWS; ++n)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[n][j] = 0.f;

  if (valid > 0) {
    for (int k0 = kl; k0 < d; k0 += 32 * FR_U) {
      float wv[FR_U][8];
#pragma unroll
      for (int u = 0; u < FR_U; ++u) {
        const int k = k0 + u * 32;
        if (k < d) fr_load8(w + (size_t)k * F + col, vec, valid, wv[u]);
      }
#pragma unroll
      for (int u = 0; u < FR_U; ++u) {
        const int k = k0 + u * 32;
        if (k >= d) break;
#pragma unroll
        for (int n = 0; n < FR_ROWS; ++n) {
          if (n < N) {
            const float a = xn[n * d + k];
#pragma unroll
            for (int j = 0; j < 8; ++j) acc[n][j] += a * wv[u][j];
          }
        }
      }
    }
  }

  // sum the 32 k-lanes: 4 per warp by shuffles, 8 warps through shared memory
#pragma unroll
  for (int n = 0; n < FR_ROWS; ++n)
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      float a = acc[n][j];
      a += __shfl_xor_sync(0xffffffffu, a, 8);
      a += __shfl_xor_sync(0xffffffffu, a, 16);
      if (lane < 8) red[warp][vsel][n * 8 + j] = a;
    }
  __syncthreads();
  for (int i = tid; i < N * FR_COLS; i += FM_THREADS) {
    const int n = i / FR_COLS, c = i - n * FR_COLS, v = c >> 3, j = c & 7;
    if (n0 + c >= F) continue;
    float g = 0.f, u = 0.f;
#pragma unroll
    for (int wp = 0; wp < FM_THREADS / 32; ++wp) {
      g += red[wp][v][n * 8 + j];
      u += red[wp][4 + v][n * 8 + j];
    }
    fm_store(out + (size_t)n * F + n0 + c, fm_act(g, act) * u);
  }
}

// bfloat16 shapes the wgmma kernel does not take (N > 8): the same tiling
// on the tensor cores.  A block of 4 warps owns 64 rows x 64 columns; each
// warp 32 x 32 of gate and of up as 2 x 2 WMMA 16x16x16 bf16 fragments
// with float32 accumulators.  Each 32-deep K tile of normalised x (rounded to bf16) and
// of both weight matrices is staged in shared memory with 16-byte loads
// (all issued before any store) and feeds 8 products per warp per 16-deep
// step.  The epilogue passes each fragment pair through a warp-private
// 16 x 16 buffer to apply act(g) * u.
#define FW_BM 64
#define FW_BN 64
#define FW_BK 32
#define FW_THREADS 128
#define FW_LDA (FW_BK + 8)      // bf16 elements; multiples of 8 for WMMA
#define FW_LDB (FW_BN + 8)

__global__ void __launch_bounds__(FW_THREADS)
fused_mlp_wmma_kernel(const __nv_bfloat16* __restrict__ x,
                      const __nv_bfloat16* __restrict__ scale,
                      const __nv_bfloat16* __restrict__ wg,
                      const __nv_bfloat16* __restrict__ wu,
                      __nv_bfloat16* __restrict__ out, int N, int d, int F,
                      int act, float eps, int vec_ok) {
  __shared__ __align__(32) __nv_bfloat16 as[FW_BM][FW_LDA];
  __shared__ __align__(32) __nv_bfloat16 bgs[FW_BK][FW_LDB];
  __shared__ __align__(32) __nv_bfloat16 bus[FW_BK][FW_LDB];
  __shared__ __align__(32) float epi[FW_THREADS / 32][2][16][16];
  __shared__ float inv_s[FW_BM];

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wm = warp >> 1, wn = warp & 1;
  const int n0 = blockIdx.x * FW_BN, m0 = blockIdx.y * FW_BM;

  for (int r = warp; r < FW_BM; r += FW_THREADS / 32) {
    const int row = m0 + r;
    float ss = 0.f;
    if (row < N)
      for (int k = lane; k < d; k += 32) {
        const float v = fm_load(x + (size_t)row * d + k);
        ss += v * v;
      }
    for (int o = 16; o > 0; o >>= 1) ss += __shfl_xor_sync(0xffffffffu, ss, o);
    if (lane == 0) inv_s[r] = row < N ? rsqrtf(ss / (float)d + eps) : 0.f;
  }
  __syncthreads();

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> cg[2][2], cu[2][2];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      wmma::fill_fragment(cg[i][j], 0.f);
      wmma::fill_fragment(cu[i][j], 0.f);
    }

  for (int k0 = 0; k0 < d; k0 += FW_BK) {
    // loads: 2 vectors of 8 of x (+ scale), 2 of each weight matrix
    float xv[2][8], sv[2][8], gv[2][8], uv[2][8];
#pragma unroll
    for (int t = 0; t < 2; ++t) {
      const int v = tid + t * FW_THREADS;
      const int r = v >> 2, kv = (v & 3) * 8, row = m0 + r, k = k0 + kv;
      const int kval = row < N ? min(8, d - k) : 0;
      fr_load8(x + (size_t)row * d + k, vec_ok && kval == 8, kval, xv[t]);
      fr_load8(scale + k, vec_ok && kval == 8, kval, sv[t]);
      const int kk = v >> 3, cv = (v & 7) * 8, kw = k0 + kk, col = n0 + cv;
      const int cval = kw < d ? min(8, F - col) : 0;
      fr_load8(wg + (size_t)kw * F + col, vec_ok && cval == 8, cval, gv[t]);
      fr_load8(wu + (size_t)kw * F + col, vec_ok && cval == 8, cval, uv[t]);
    }
#pragma unroll
    for (int t = 0; t < 2; ++t) {
      const int v = tid + t * FW_THREADS;
      const int r = v >> 2, kv = (v & 3) * 8;
      const int kk = v >> 3, cv = (v & 7) * 8;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        // (x * inv) * (1 + scale), rounded to bf16 as rms_norm's output is
        as[r][kv + j] = __float2bfloat16((xv[t][j] * inv_s[r]) *
                                         (1.f + sv[t][j]));
        bgs[kk][cv + j] = __float2bfloat16(gv[t][j]);
        bus[kk][cv + j] = __float2bfloat16(uv[t][j]);
      }
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < FW_BK; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16,
                     wmma::row_major> a[2];
      wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16,
                     wmma::row_major> bg[2], bu[2];
#pragma unroll
      for (int i = 0; i < 2; ++i)
        wmma::load_matrix_sync(a[i], &as[wm * 32 + i * 16][kk], FW_LDA);
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        wmma::load_matrix_sync(bg[j], &bgs[kk][wn * 32 + j * 16], FW_LDB);
        wmma::load_matrix_sync(bu[j], &bus[kk][wn * 32 + j * 16], FW_LDB);
      }
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          wmma::mma_sync(cg[i][j], a[i], bg[j], cg[i][j]);
          wmma::mma_sync(cu[i][j], a[i], bu[j], cu[i][j]);
        }
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      wmma::store_matrix_sync(&epi[warp][0][0][0], cg[i][j], 16,
                              wmma::mem_row_major);
      wmma::store_matrix_sync(&epi[warp][1][0][0], cu[i][j], 16,
                              wmma::mem_row_major);
      __syncwarp();
      for (int e = lane; e < 256; e += 32) {
        const int r = e >> 4, c = e & 15;
        const int row = m0 + wm * 32 + i * 16 + r;
        const int col = n0 + wn * 32 + j * 16 + c;
        if (row < N && col < F)
          out[(size_t)row * F + col] = __float2bfloat16(
              fm_act(epi[warp][0][r][c], act) * epi[warp][1][r][c]);
      }
      __syncwarp();
    }
}

// Prefill in bfloat16 on Hopper ("wgmma_tma": N > 8 rows, d and F
// multiples of 8, 16-byte aligned operands).  A call is two kernels:
//  * rms_inv_kernel: 1 / rms of every row into a float32 scratch inv_rms
//    (N,), one warp per row with 16-byte loads (the first pass of the
//    other kernels, written out: 18 KB at N = 4,608);
//  * fused_mlp_wgmma_kernel: output tile 128 rows x 128 columns of F per
//    block, 384 threads = three warpgroups.  Warpgroup 0 is the producer
//    (setmaxnreg 40; one thread issues TMA): d is walked in 64-deep steps
//    through a ring of FM_STAGES stages, each holding the raw x tile
//    (128 x 64, K-major) and the Wg and Wu tiles (64 x 128 each, two
//    64-column boxes: (d,F) row-major is an MN-major B operand, used as it
//    lies, no re-layout), with full / empty mbarriers.  Warpgroups 1 and 2
//    (setmaxnreg 232) own 64 rows each and accumulate BOTH gate and up
//    (64 x 128 f32 each: 128 registers a thread): per stage each thread
//    reads its A fragments of raw x from the swizzled tile, applies the norm
//    on the way into the tensor core (x * inv_rms[row] * (1 + scale[k]),
//    rounded to bf16 as the reference's rms_norm rounds its output), and
//    issues wgmma with A from registers against [Wg | Wu] as one 256-wide
//    B (m64n256k16, 4 k steps; the two tiles lie side by side in the
//    stage).  A from registers rather than a normalised copy in shared
//    memory: each element of x is used by one warpgroup only, so the
//    multiplies are the same, and the register path saves the store, the
//    proxy fence and a barrier per stage.  Two register sets of A: the
//    fragments of stage k + 1 are formed while the products of stage k
//    run, and a stage is released when the wgmma group that read it has
//    completed.  The epilogue applies act(g) * u in registers and stores
//    bf16 pairs.
//  Row tiles are the fastest grid dimension, so one wave of blocks shares
//  a few column slices of the weights (read from memory about once) and
//  the whole of x (23.6 MB at N = 4,608: it stays in L2).
#define FM_BM 128
#define FM_BNW 128
#define FM_BKD 64
#define FM_STAGES 4
#define FM_WTHREADS 384
#define FM_XBYTES (FM_BM * HP_ROW_BYTES)              // 16 KB
#define FM_WBOX (FM_BKD * HP_ROW_BYTES)               // 8 KB
#define FM_STAGE (FM_XBYTES + 4 * FM_WBOX)            // 48 KB
#define FM_WSMEM (1024 + FM_STAGES * FM_STAGE + 128)

__global__ void __launch_bounds__(256)
rms_inv_kernel(const __nv_bfloat16* __restrict__ x, float* __restrict__ inv,
               int N, int d, float eps) {
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * 8 + (threadIdx.x >> 5);
  if (row >= N) return;
  const uint4* p = reinterpret_cast<const uint4*>(x + (size_t)row * d);
  float ss = 0.f;
  for (int i = lane; i < d / 8; i += 32) {
    const uint4 v = p[i];
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&v);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const float2 f = __bfloat1622float2(h[j]);
      ss += f.x * f.x + f.y * f.y;
    }
  }
  for (int o = 16; o > 0; o >>= 1) ss += __shfl_xor_sync(0xffffffffu, ss, o);
  if (lane == 0) inv[row] = rsqrtf(ss / (float)d + eps);
}

// A fragments of one 64-deep stage for rows r0, r1 (= r0 + 8) of the
// warpgroup: raw x from the swizzled tile xs, times inv_rms[row] * (1 +
// scale[k]), rounded to bf16 (as rms_norm rounds); 4 k steps of 4
// registers (the layout in hopper.cuh).
__device__ __forceinline__ void fm_prep_a(uint32_t (&a)[16],
                                          const uint8_t* xs,
                                          const __nv_bfloat16* scale, int k0,
                                          int d, int r0, int r1, int c4,
                                          float inv0, float inv1) {
#pragma unroll
  for (int ks = 0; ks < 4; ++ks) {
    const int kk = ks * 16 + c4;
    float f[4];                     // 1 + scale at kk, kk + 1, kk + 8, kk + 9
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int k = k0 + kk + 8 * hh;
      float2 sv = make_float2(-1.f, -1.f);              // past d: x is 0
      if (k < d)
        sv = __bfloat1622float2(
            *reinterpret_cast<const __nv_bfloat162*>(scale + k));
      f[2 * hh] = 1.f + sv.x;
      f[2 * hh + 1] = 1.f + sv.y;
    }
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const float2 x0 = __bfloat1622float2(
          *reinterpret_cast<const __nv_bfloat162*>(
              xs + hp_swz(r0, kk + 8 * hh)));
      const float2 x1 = __bfloat1622float2(
          *reinterpret_cast<const __nv_bfloat162*>(
              xs + hp_swz(r1, kk + 8 * hh)));
      a[4 * ks + 2 * hh] = hp_pack_bf16((x0.x * inv0) * f[2 * hh],
                                        (x0.y * inv0) * f[2 * hh + 1]);
      a[4 * ks + 2 * hh + 1] = hp_pack_bf16((x1.x * inv1) * f[2 * hh],
                                            (x1.y * inv1) * f[2 * hh + 1]);
    }
  }
}

// One stage's products, one wgmma group: the Wg and Wu tiles lie side by
// side in the stage (four 64-column atoms, FM_WBOX apart), so they are one
// 256-wide B operand: 4 k steps of m64n256k16 fill acc[0..63] with gate
// (columns 0..127) and acc[64..127] with up.
__device__ __forceinline__ void fm_issue(float (&acc)[128],
                                         const uint32_t (&a)[16],
                                         uint32_t sgu) {
  hp_fence_regs<128>(acc);
  hp_wgmma_fence();
#pragma unroll
  for (int ks = 0; ks < 4; ++ks)
    wgmma_rs_m64n256k16_tb(
        acc, &a[4 * ks], hp_desc_mn(sgu + ks * 16 * HP_ROW_BYTES, FM_WBOX),
        1);
  hp_wgmma_commit();
}

__global__ void __launch_bounds__(FM_WTHREADS, 1)
fused_mlp_wgmma_kernel(const __grid_constant__ CUtensorMap tmx,
                       const __grid_constant__ CUtensorMap tmg,
                       const __grid_constant__ CUtensorMap tmu,
                       const __nv_bfloat16* __restrict__ scale,
                       const float* __restrict__ inv_rms,
                       __nv_bfloat16* __restrict__ out, int N, int d, int F,
                       int act) {
  extern __shared__ uint8_t fm_raw[];
  const uint32_t raw = hp_smem(fm_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  const uint8_t* gbase = fm_raw + (base - raw);
  const uint32_t bars = base + FM_STAGES * FM_STAGE;   // full[S], empty[S]
  auto full = [&](int s) { return bars + 8u * s; };
  auto empty = [&](int s) { return bars + 8u * (FM_STAGES + s); };
  auto sX = [&](int s) { return base + s * FM_STAGE; };
  auto sG = [&](int s) { return base + s * FM_STAGE + FM_XBYTES; };
  auto sU = [&](int s) {
    return base + s * FM_STAGE + FM_XBYTES + 2 * FM_WBOX;
  };

  const int m0 = blockIdx.x * FM_BM, n0 = blockIdx.y * FM_BNW;
  const int nkt = (d + FM_BKD - 1) / FM_BKD;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;

  if (tid == 0) {
    for (int s = 0; s < FM_STAGES; ++s) {
      hp_mbar_init(full(s), 1);
      hp_mbar_init(empty(s), 2 * 128);
    }
    hp_mbar_fence_init();
  }
  __syncthreads();

  if (warp < 4) {
    // ---------------------------------------------------------- producer
    hp_setmaxnreg_dec<40>();
    if (tid == 0) {
      int s = 0;
      uint32_t ph = 0;
      for (int kt = 0; kt < nkt; ++kt) {
        const int k0 = kt * FM_BKD;
        hp_mbar_wait(empty(s), ph ^ 1);
        hp_mbar_expect_tx(full(s), FM_STAGE);
        hp_tma_load_2d(sX(s), &tmx, full(s), k0, m0);
        for (int x = 0; x < 2; ++x) {
          hp_tma_load_2d(sG(s) + x * FM_WBOX, &tmg, full(s),
                         n0 + x * HP_BOX_COLS, k0);
          hp_tma_load_2d(sU(s) + x * FM_WBOX, &tmu, full(s),
                         n0 + x * HP_BOX_COLS, k0);
        }
        if (++s == FM_STAGES) { s = 0; ph ^= 1; }
      }
    }
  } else {
    // --------------------------------------------------------- consumers
    hp_setmaxnreg_inc<232>();
    const int wg = (warp >> 2) - 1;
    const int r0 = wg * 64 + (warp & 3) * 16 + (lane >> 2), r1 = r0 + 8;
    const int c4 = 2 * (lane & 3);
    const float inv0 = m0 + r0 < N ? inv_rms[m0 + r0] : 0.f;
    const float inv1 = m0 + r1 < N ? inv_rms[m0 + r1] : 0.f;
    float acc[128];                     // gate: acc[0..63], up: acc[64..]
#pragma unroll
    for (int i = 0; i < 128; ++i) acc[i] = 0.f;

    // The products of stage kt run while the A fragments of stage kt + 1
    // are formed (two register sets, a0 / a1); a stage is released once
    // the wgmma group that read it has completed.
    uint32_t a0[16], a1[16];
    int s = 0, sp = 0;
    uint32_t ph = 0;
    hp_mbar_wait(full(0), 0);
    fm_prep_a(a0, gbase + (sX(0) - base), scale, 0, d, r0, r1, c4, inv0,
              inv1);
    auto step = [&](uint32_t (&cur)[16], uint32_t (&nxt)[16], int k) {
      fm_issue(acc, cur, sG(s));
      hp_wgmma_wait<1>();                      // group k - 1 has completed
      if (k > 0) hp_mbar_arrive(empty(sp));
      sp = s;
      if (++s == FM_STAGES) { s = 0; ph ^= 1; }
      if (k + 1 < nkt) {
        hp_mbar_wait(full(s), ph);
        fm_prep_a(nxt, gbase + (sX(s) - base), scale, (k + 1) * FM_BKD, d,
                  r0, r1, c4, inv0, inv1);
      }
    };
    for (int kt = 0; kt < nkt; kt += 2) {
      step(a0, a1, kt);
      if (kt + 1 < nkt) step(a1, a0, kt + 1);
    }
    hp_wgmma_wait<0>();
    hp_fence_regs<128>(acc);
    hp_mbar_arrive(empty(sp));

    __nv_bfloat16* o0 = out + (size_t)(m0 + r0) * F;
    __nv_bfloat16* o1 = out + (size_t)(m0 + r1) * F;
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      const int c = n0 + 8 * j + c4;
      if (c >= F) continue;
      if (m0 + r0 < N)
        *reinterpret_cast<uint32_t*>(o0 + c) = hp_pack_bf16(
            fm_act(acc[4 * j], act) * acc[64 + 4 * j],
            fm_act(acc[4 * j + 1], act) * acc[64 + 4 * j + 1]);
      if (m0 + r1 < N)
        *reinterpret_cast<uint32_t*>(o1 + c) = hp_pack_bf16(
            fm_act(acc[4 * j + 2], act) * acc[64 + 4 * j + 2],
            fm_act(acc[4 * j + 3], act) * acc[64 + 4 * j + 3]);
    }
  }
}

static int launch_wgmma(const void* x, const void* scale, const void* wg,
                        const void* wu, void* out, float* inv_rms, int N,
                        int d, int F, int act, float eps,
                        cudaStream_t stream) {
  CUtensorMap mx, mg, mu;
  const uint64_t dx[2] = {(uint64_t)d, (uint64_t)N};
  const uint64_t sx[1] = {(uint64_t)d * 2};
  const uint32_t bx[2] = {HP_BOX_COLS, FM_BM};
  const uint64_t dw[2] = {(uint64_t)F, (uint64_t)d};
  const uint64_t sw[1] = {(uint64_t)F * 2};
  const uint32_t bw[2] = {HP_BOX_COLS, FM_BKD};
  int e = hp_tensor_map(&mx, x, 2, dx, sx, bx);
  if (!e) e = hp_tensor_map(&mg, wg, 2, dw, sw, bw);
  if (!e) e = hp_tensor_map(&mu, wu, 2, dw, sw, bw);
  if (e) return e;
  rms_inv_kernel<<<(N + 7) / 8, 256, 0, stream>>>(
      (const __nv_bfloat16*)x, inv_rms, N, d, eps);
  cudaError_t ce = cudaGetLastError();
  if (ce != cudaSuccess) return (int)ce;
  ce = cudaFuncSetAttribute(fused_mlp_wgmma_kernel,
                            cudaFuncAttributeMaxDynamicSharedMemorySize,
                            FM_WSMEM);
  if (ce != cudaSuccess) return (int)ce;
  dim3 grid((N + FM_BM - 1) / FM_BM, (F + FM_BNW - 1) / FM_BNW);
  fused_mlp_wgmma_kernel<<<grid, FM_WTHREADS, FM_WSMEM, stream>>>(
      mx, mg, mu, (const __nv_bfloat16*)scale, inv_rms,
      (__nv_bfloat16*)out, N, d, F, act);
  return (int)cudaGetLastError();
}

// N <= FR_ROWS rows whose normalised copy fits in shared memory.
template <typename T>
static int launch_rows(const void* x, const void* scale, const void* wg,
                       const void* wu, void* out, int N, int d, int F,
                       int act, float eps, cudaStream_t stream) {
  const size_t rows_smem = sizeof(float) * (size_t)N * d;
  if (N > FR_ROWS || rows_smem > FR_MAX_SMEM)
    return (int)cudaErrorInvalidValue;
  cudaError_t e = cudaFuncSetAttribute(
      fused_mlp_rows_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)rows_smem);
  if (e != cudaSuccess) return (int)e;
  // 16-byte vector loads need F % 8 == 0 and 16-byte aligned weights
  const int vec_ok = F % 8 == 0 &&
      ((size_t)wg % 16 == 0) && ((size_t)wu % 16 == 0);
  fused_mlp_rows_kernel<T><<<(F + FR_COLS - 1) / FR_COLS, FM_THREADS,
                             rows_smem, stream>>>(
      (const T*)x, (const T*)scale, (const T*)wg, (const T*)wu, (T*)out, N,
      d, F, act, eps, vec_ok);
  return (int)cudaGetLastError();
}

// Decode in bfloat16 on Hopper ("gemv_tma": N <= 8 rows, d and F multiples
// of 8, 16-byte aligned operands).  At N = 4, d = 2,560, F = 6,912 the call
// is 71 MB of weights for 0.14 MB of x: a matrix-vector product whose only
// cost that counts is the weight bytes (21 us at 3.35 TB/s).  What held the
// rows kernel at 4x that: a serial prologue before any weight byte was
// requested (every block normalised every row, N warps of 8 working), 216
// blocks on 132 SMs (the SMs with two finished last), four 16-byte loads in
// flight a thread, and a CUDA-core FMA chain per weight.  The design:
//  * Work: the weights are cut into chunks of one 64-column strip of F by
//    KROWS = 128 rows of d (16 KB of Wg + 16 KB of Wu), numbered
//    strip-major; the grid is one block per SM (`blocks`), and block b
//    takes the contiguous run [b * total / blocks, (b + 1) * total /
//    blocks) of chunks: every SM streams the same number of bytes, within
//    one chunk (F = 6,912: 108 strips x 20 chunks = 2,160 chunks, 16 or 17
//    a block).  A run crosses at most a few strips, so a strip's k range is
//    split over a few blocks (its segments, in block order).
//  * Bytes: a producer warp issues each chunk as two TMA boxes (64 columns
//    x 128 rows, 128-B swizzle; TMA zero-fills columns past F and rows past
//    d) into a ring of up to 16 stages of 32 KB with full / empty mbarriers,
//    from the kernel's start.  Each box row is its own 128-B run, so the
//    maps ask L2 for no promotion (a 256-B fetch brought in 128 B that
//    another block reads much later: far slower at the widest configs).
//  * The norm, once per block, by the four consumer warps (their own named
//    barrier, so the producer never waits): x and scale to shared memory by
//    cp.async, per-row sums of squares in a fixed order (warp shuffles, then
//    the four warps in order), then x * inv * (1 + scale) rounded to bf16
//    as the reference's rms_norm rounds, kept in shared memory, rows padded
//    by 8 elements (no bank conflicts) and zero past d.
//  * Products on tensor cores with the weights as the M operand: out^T =
//    W^T . xn^T, mma.sync m16n8k16 bf16 -> f32.  Four consumer warps own 16
//    columns each of the 64-column strip; per 16-deep step a warp reads
//    its Wg and Wu A fragments with ldmatrix.trans from the swizzled tile
//    (k-major rows of the stage) and the B fragment (the N rows, padded to 8
//    with zeros) from the normalised rows; gate and up share that B.  Eight
//    accumulators a thread.  The products never limit: with them removed
//    the kernel took the same time.
//  * A strip held by one block is finished in registers: act(g) * u, bf16.
//    A strip split over several blocks: each segment's partial sums go to
//    a float32 scratch `part`, a counter per (strip, warp) counts them in,
//    and the last to arrive adds the segments in segment order (a fixed
//    order, so results are the same run after run; no float atomics) and
//    writes the output; it then resets the counter to 0 for the next call.
//  What was tried and measured slower: 16- and 32-row boxes and 2 or 4
//  boxes side by side (more TMA operations per byte), more blocks than SMs
//  (each block's prologue and partials cost more than the balance gains),
//  units of chunks handed out by a counter (strip-major: the blocks in
//  flight crowd a narrow band of columns onto a few memory channels;
//  k-band-major: a flush per unit).  What is left (PERF.md): the SMs'
//  equal runs end far apart, and x lands well after the start.
#define FG_MAX_STAGES 16
#define FG_SEG 4                                  // partials loaded at once
#define FG_PROMO CU_TENSOR_MAP_L2_PROMOTION_NONE
#define FG_BOXES 1                                // 64-column boxes a strip
#define FG_KROWS 128                              // rows of d a chunk
#define FG_CONSUMERS 4
#define FG_THREADS (32 * (FG_CONSUMERS + 1))
// dynamic shared memory: 1 KB alignment slack, the ring of `stages` stages
// of `stage` bytes, the barriers, the normalised rows (N x (kc * krows + 8)
// bf16), the scale (kc * krows bf16)
#define FG_SMEM(stages, stage, N, dpad) \
  (1024 + (stages) * (stage) + 16 * FG_MAX_STAGES + (N) * ((dpad) + 8) * 2 + \
   (dpad) * 2)
#define FG_SMEM_MAX 232448                        // what a block may use
#define FG_STATIC_SMEM 512                        // room left for the static

__device__ __forceinline__ void fg_cp16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n"
               ::"r"(hp_smem(dst)), "l"(src) : "memory");
}
__device__ __forceinline__ void fg_ldm4t(uint32_t* r, const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(hp_smem(p)));
}
// d (16 x 8, f32) += a (16 x 16 bf16, row) * b (16 x 8 bf16, col)
__device__ __forceinline__ void fg_mma(float* d, const uint32_t* a,
                                       uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}
// The block whose run of chunks holds chunk c.
__host__ __device__ __forceinline__ int fg_block_of(long long c, int total,
                                                    int blocks) {
  return (int)(((c + 1) * blocks - 1) / total);
}

// The consumer warps' own barrier (0 is __syncthreads): the producer warp
// streams weights while they normalise x.
#define FG_BAR_NORM 1
__device__ __forceinline__ void fg_bar_sync(int id, int n) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(n) : "memory");
}

// BOXES: 64-column TMA boxes side by side in a strip (64 * BOXES columns,
// each row of a box a run of 128 B); a chunk is KROWS rows of d, a stage
// 2 * BOXES * KROWS * 128 B.
template <int BOXES, int KROWS>
__global__ void __launch_bounds__(FG_THREADS, 1)
fused_mlp_gemv_kernel(const __grid_constant__ CUtensorMap tmg,
                      const __grid_constant__ CUtensorMap tmu,
                      const __nv_bfloat16* __restrict__ x,
                      const __nv_bfloat16* __restrict__ scale,
                      __nv_bfloat16* __restrict__ out,
                      float* __restrict__ part, int* __restrict__ count,
                      int N, int d, int F, int act, float eps, int kc,
                      int strips, int maxseg, int stages) {
  constexpr int COLS = 64 * BOXES;
  constexpr int BOX = KROWS * HP_ROW_BYTES;             // bytes of a box
  constexpr int STAGE = 2 * BOXES * BOX;
  constexpr int PART = 16 * BOXES * 8 * 2;              // a warp's partial
  extern __shared__ uint8_t fg_raw[];
  __shared__ float red[FG_CONSUMERS][FR_ROWS];
  __shared__ float inv_s[FR_ROWS];
  const uint32_t raw = hp_smem(fg_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  uint8_t* gbase = fg_raw + (base - raw);
  const uint32_t bars = base + stages * STAGE;        // full[16], empty[16]
  const int xld = kc * KROWS + 8;                      // row stride of xn
  __nv_bfloat16* xn = reinterpret_cast<__nv_bfloat16*>(
      gbase + stages * STAGE + 16 * FG_MAX_STAGES);
  __nv_bfloat16* sc = xn + (size_t)N * xld;            // the scale row
  auto full = [&](int s) { return bars + 8u * s; };
  auto empty = [&](int s) { return bars + 8u * (FG_MAX_STAGES + s); };

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const bool producer = warp == FG_CONSUMERS;

  if (tid == 0) {
    for (int s = 0; s < stages; ++s) {
      hp_mbar_init(full(s), 1);
      hp_mbar_init(empty(s), FG_CONSUMERS);
    }
    hp_mbar_fence_init();
  }
  __syncthreads();

  const int blocks = gridDim.x, b = blockIdx.x;
  const int total = strips * kc;
  const long long c0 = (long long)b * total / blocks;
  const int n_mine = (int)((long long)(b + 1) * total / blocks - c0);

  if (producer) {
    // ------------------------------------------------------------ producer
    if (lane == 0) {
      hp_prefetch_map(&tmg);
      hp_prefetch_map(&tmu);
      for (int i = 0; i < n_mine; ++i) {
        const int s = i % stages;
        // the (i / stages)-th reuse of a stage waits for its release
        if (i >= stages) hp_mbar_wait(empty(s), ((i / stages) - 1) & 1);
        const long long c = c0 + i;
        const int strip = (int)(c / kc), k0 = (int)(c - (long long)strip * kc)
            * KROWS;
        hp_mbar_expect_tx(full(s), STAGE);
#pragma unroll
        for (int xb = 0; xb < BOXES; ++xb) {
          hp_tma_load_2d(base + s * STAGE + xb * BOX, &tmg, full(s),
                         strip * COLS + xb * 64, k0);
          hp_tma_load_2d(base + s * STAGE + (BOXES + xb) * BOX, &tmu, full(s),
                         strip * COLS + xb * 64, k0);
        }
      }
    }
    return;
  }

  // -------------------------------------------------------- consumers: norm
  // x and scale to shared memory by cp.async while the producer streams
  // the first stages, then the row sums (fixed order: warp shuffles, then
  // the four warps in order) and the normalised rows, x * inv * (1 +
  // scale) rounded to bf16 as the reference's rms_norm rounds
  const int ct = tid;                                  // 0..127
  constexpr int CT = 32 * FG_CONSUMERS;
  const int nv = d / 8;                          // 16-byte vectors a row
  const int nvp = xld / 8 - 1;                   // vectors of kc * krows
  for (int i = ct; i < (N + 1) * nvp; i += CT) {
    const int n = i / nvp, v = i - n * nvp;
    uint4* dst = n < N ? reinterpret_cast<uint4*>(xn + (size_t)n * xld) + v
                       : reinterpret_cast<uint4*>(sc) + v;
    if (v < nv)
      fg_cp16(dst, n < N ? reinterpret_cast<const uint4*>(x + (size_t)n * d) + v
                         : reinterpret_cast<const uint4*>(scale) + v);
    else
      *dst = make_uint4(0u, 0u, 0u, 0u);        // past d: zeros
  }
  asm volatile("cp.async.commit_group;\n" ::: "memory");
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
  fg_bar_sync(FG_BAR_NORM, CT);                  // all rows are in
  float ss[FR_ROWS];
#pragma unroll
  for (int n = 0; n < FR_ROWS; ++n) ss[n] = 0.f;
  for (int v = ct; v < nv; v += CT) {
#pragma unroll
    for (int n = 0; n < FR_ROWS; ++n) {
      if (n >= N) continue;
      const uint4 q = reinterpret_cast<const uint4*>(xn + (size_t)n * xld)[v];
      const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&q);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float2 f = __bfloat1622float2(h[j]);
        ss[n] += f.x * f.x + f.y * f.y;
      }
    }
  }
#pragma unroll
  for (int n = 0; n < FR_ROWS; ++n) {
    float v = ss[n];
    for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
    if (lane == 0) red[warp][n] = v;
  }
  fg_bar_sync(FG_BAR_NORM, CT);
  if (ct < N) {
    float v = 0.f;
#pragma unroll
    for (int w = 0; w < FG_CONSUMERS; ++w) v += red[w][ct];
    inv_s[ct] = rsqrtf(v / (float)d + eps);
  }
  fg_bar_sync(FG_BAR_NORM, CT);
  for (int v = ct; v < nv; v += CT) {
    const uint4 scv = reinterpret_cast<const uint4*>(sc)[v];
    const __nv_bfloat162* hs = reinterpret_cast<const __nv_bfloat162*>(&scv);
#pragma unroll
    for (int n = 0; n < FR_ROWS; ++n) {
      if (n >= N) continue;
      uint4* px = reinterpret_cast<uint4*>(xn + (size_t)n * xld) + v;
      uint4 o = *px;
      uint32_t* po = reinterpret_cast<uint32_t*>(&o);
      const float inv = inv_s[n];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float2 fx = __bfloat1622float2(
            *reinterpret_cast<const __nv_bfloat162*>(&po[j]));
        const float2 fs = __bfloat1622float2(hs[j]);
        po[j] = hp_pack_bf16((fx.x * inv) * (1.f + fs.x),
                             (fx.y * inv) * (1.f + fs.y));
      }
      *px = o;
    }
  }
  fg_bar_sync(FG_BAR_NORM, CT);

  // ---------------------------------------------------- consumers: products
  // warp w owns columns [16 BOXES w, 16 BOXES (w + 1)) of the strip: BOXES
  // m16 tiles; this lane's ldmatrix row: k row lk of a 16-deep step,
  // columns lf..lf+7 of tile mt
  const int g = lane >> 2, c2 = 2 * (lane & 3);
  const int lk = (lane & 7) + ((lane >> 4) << 3);
  const int lf = warp * 16 * BOXES + (((lane >> 3) & 1) << 3);
  const bool live = g < N;                       // rows past N: B is zero
  const __nv_bfloat16* xrow = xn + (size_t)(live ? g : 0) * xld + c2;
  float cg[BOXES][4], cu[BOXES][4];

  // out[n][f] = act(g) * u for the warp's columns of `strip`; the
  // accumulator layout of tile mt: [0] (f = g, n = c2), [1] (g, c2 + 1),
  // [2] (g + 8, c2), [3] (g + 8, c2 + 1)
  auto store = [&](int strip, float (*vg)[4], float (*vu)[4]) {
#pragma unroll
    for (int mt = 0; mt < BOXES; ++mt) {
      const int f = strip * COLS + warp * 16 * BOXES + mt * 16 + g;
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int ff = f + 8 * (e >> 1), n = c2 + (e & 1);
        if (ff < F && n < N)
          out[(size_t)n * F + ff] =
              __float2bfloat16(fm_act(vg[mt][e], act) * vu[mt][e]);
      }
    }
  };
  // the end of this block's segment of `strip`: a strip held by one block
  // is finished in registers; else the segment's partial goes to its slot,
  // and the last of the strip's segments to arrive adds them in segment
  // (block) order and writes the output
  auto flush = [&](int strip) {
    const long long sc0 = (long long)strip * kc;
    const int fb = fg_block_of(sc0, total, blocks);
    const int nseg = fg_block_of(sc0 + kc - 1, total, blocks) - fb + 1;
    const int seg = b - fb;
    if (nseg == 1) {
      store(strip, cg, cu);
      return;
    }
    float* slot = part + ((size_t)(strip * FG_CONSUMERS + warp) * maxseg) *
        PART + lane * 8 * BOXES;
    if (c2 < N) {                               // lanes of live rows only
      float4* mine = reinterpret_cast<float4*>(slot + (size_t)seg * PART);
#pragma unroll
      for (int mt = 0; mt < BOXES; ++mt) {
        mine[2 * mt] = make_float4(cg[mt][0], cg[mt][1], cg[mt][2],
                                   cg[mt][3]);
        mine[2 * mt + 1] =
            make_float4(cu[mt][0], cu[mt][1], cu[mt][2], cu[mt][3]);
      }
    }
    __threadfence();
    __syncwarp();
    int last = 0;
    if (lane == 0) {
      int* cnt = count + strip * FG_CONSUMERS + warp;
      last = atomicAdd(cnt, 1) == nseg - 1;
      if (last) *cnt = 0;                       // ready for the next call
    }
    last = __shfl_sync(0xffffffffu, last, 0);
    if (!last || c2 >= N) return;
    __threadfence();
    float vg[BOXES][4], vu[BOXES][4];
#pragma unroll
    for (int mt = 0; mt < BOXES; ++mt)
#pragma unroll
      for (int e = 0; e < 4; ++e) vg[mt][e] = vu[mt][e] = 0.f;
    // the loads of FG_SEG segments go out together, the adds follow in
    // segment order
    for (int sg0 = 0; sg0 < nseg; sg0 += FG_SEG) {
      float4 pg[FG_SEG][BOXES], pu[FG_SEG][BOXES];
#pragma unroll
      for (int q = 0; q < FG_SEG; ++q) {
        const float4* p = reinterpret_cast<const float4*>(
            slot + (size_t)(sg0 + q) * PART);
#pragma unroll
        for (int mt = 0; mt < BOXES; ++mt) {
          const bool in = sg0 + q < nseg;
          pg[q][mt] = in ? __ldcg(p + 2 * mt) : make_float4(0, 0, 0, 0);
          pu[q][mt] = in ? __ldcg(p + 2 * mt + 1) : make_float4(0, 0, 0, 0);
        }
      }
#pragma unroll
      for (int q = 0; q < FG_SEG; ++q) {
        if (sg0 + q >= nseg) break;
#pragma unroll
        for (int mt = 0; mt < BOXES; ++mt) {
          vg[mt][0] += pg[q][mt].x; vg[mt][1] += pg[q][mt].y;
          vg[mt][2] += pg[q][mt].z; vg[mt][3] += pg[q][mt].w;
          vu[mt][0] += pu[q][mt].x; vu[mt][1] += pu[q][mt].y;
          vu[mt][2] += pu[q][mt].z; vu[mt][3] += pu[q][mt].w;
        }
      }
    }
    store(strip, vg, vu);
  };

  int cur = (int)(c0 / kc);
#pragma unroll
  for (int mt = 0; mt < BOXES; ++mt)
#pragma unroll
    for (int e = 0; e < 4; ++e) cg[mt][e] = cu[mt][e] = 0.f;
  for (int i = 0; i < n_mine; ++i) {
    const long long c = c0 + i;
    const int strip = (int)(c / kc);
    const int k0 = (int)(c - (long long)strip * kc) * KROWS;
    if (strip != cur) {
      flush(cur);
#pragma unroll
      for (int mt = 0; mt < BOXES; ++mt)
#pragma unroll
        for (int e = 0; e < 4; ++e) cg[mt][e] = cu[mt][e] = 0.f;
      cur = strip;
    }
    const int s = i % stages;
    hp_mbar_wait(full(s), (i / stages) & 1);
    const uint8_t* tg = gbase + s * STAGE;
    const uint8_t* tu = tg + BOXES * BOX;
#pragma unroll
    for (int ks = 0; ks < KROWS / 16; ++ks) {
      uint32_t b0 = 0u, b1 = 0u;
      if (live) {
        b0 = *reinterpret_cast<const uint32_t*>(xrow + k0 + ks * 16);
        b1 = *reinterpret_cast<const uint32_t*>(xrow + k0 + ks * 16 + 8);
      }
#pragma unroll
      for (int mt = 0; mt < BOXES; ++mt) {
        const int col = lf + mt * 16;           // column of the strip
        const uint32_t off = (col >> 6) * BOX + hp_swz(ks * 16 + lk, col & 63);
        uint32_t ag[4], au[4];
        fg_ldm4t(ag, tg + off);
        fg_ldm4t(au, tu + off);
        fg_mma(cg[mt], ag, b0, b1);
        fg_mma(cu[mt], au, b0, b1);
      }
    }
    __syncwarp();
    if (lane == 0) hp_mbar_arrive(empty(s));    // the stage is read
  }
  if (n_mine > 0) flush(cur);
}

template <int BOXES, int KROWS>
static int launch_gemv_t(const CUtensorMap& mg, const CUtensorMap& mu,
                         const void* x, const void* scale, void* out,
                         float* part, int* count, int N, int d, int F,
                         int act, float eps, int kc, int strips, int maxseg,
                         int blocks, int stages, int smem,
                         cudaStream_t stream) {
  cudaError_t ce = cudaFuncSetAttribute(
      fused_mlp_gemv_kernel<BOXES, KROWS>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (ce != cudaSuccess) return (int)ce;
  fused_mlp_gemv_kernel<BOXES, KROWS><<<blocks, FG_THREADS, smem, stream>>>(
      mg, mu, (const __nv_bfloat16*)x, (const __nv_bfloat16*)scale,
      (__nv_bfloat16*)out, part, count, N, d, F, act, eps, kc, strips, maxseg,
      stages);
  return (int)cudaGetLastError();
}

// The most blocks (segments) that share one strip of a gemv_tma call.
static int fg_maxseg(int strips, int kc, int blocks) {
  const int total = strips * kc;
  int most = 1;
  for (int s = 0; s < strips; ++s) {
    const long long c = (long long)s * kc;
    const int n = fg_block_of(c + kc - 1, total, blocks) -
        fg_block_of(c, total, blocks) + 1;
    most = n > most ? n : most;
  }
  return most;
}

// part: float32 scratch of strips * 4 * maxseg * (256 * boxes); count:
// strips * 4 ints, zero (the kernel leaves them zero).  Refused when the
// wrapper's boxes / krows / blocks / stages / maxseg do not fit.
static int launch_gemv(const void* x, const void* scale, const void* wg,
                       const void* wu, void* out, float* part, int* count,
                       int N, int d, int F, int act, float eps, int boxes,
                       int krows, int blocks, int stages, int maxseg,
                       cudaStream_t stream) {
  if (boxes != FG_BOXES || krows != FG_KROWS)
    return (int)cudaErrorInvalidValue;
  const int strips = (F + 64 * boxes - 1) / (64 * boxes);
  const int kc = (d + krows - 1) / krows;
  const int stage = 2 * boxes * krows * HP_ROW_BYTES;
  const int smem = FG_SMEM(stages, stage, N, kc * krows);
  if (blocks < 1 || blocks > strips * kc || stages < 2 ||
      stages > FG_MAX_STAGES || smem + FG_STATIC_SMEM > FG_SMEM_MAX ||
      fg_maxseg(strips, kc, blocks) > maxseg || part == nullptr ||
      count == nullptr)
    return (int)cudaErrorInvalidValue;
  CUtensorMap mg, mu;
  const uint64_t dw[2] = {(uint64_t)F, (uint64_t)d};
  const uint64_t sw[1] = {(uint64_t)F * 2};
  const uint32_t bw[2] = {HP_BOX_COLS, (uint32_t)krows};
  int e = hp_tensor_map(&mg, wg, 2, dw, sw, bw, FG_PROMO);
  if (!e) e = hp_tensor_map(&mu, wu, 2, dw, sw, bw, FG_PROMO);
  if (e) return e;
  return launch_gemv_t<FG_BOXES, FG_KROWS>(mg, mu, x, scale, out, part, count,
                                          N, d, F, act, eps, kc, strips,
                                          maxseg, blocks, stages, smem,
                                          stream);
}

static int launch_wmma(const void* x, const void* scale, const void* wg,
                       const void* wu, void* out, int N, int d, int F,
                       int act, float eps, cudaStream_t stream) {
  // 16-byte vector loads need d, F % 8 == 0 and 16-byte aligned operands
  const int vec_ok = d % 8 == 0 && F % 8 == 0 && (size_t)x % 16 == 0 &&
      (size_t)scale % 16 == 0 && (size_t)wg % 16 == 0 &&
      (size_t)wu % 16 == 0;
  fused_mlp_wmma_kernel<<<dim3((F + FW_BN - 1) / FW_BN,
                               (N + FW_BM - 1) / FW_BM), FW_THREADS, 0,
                          stream>>>(
      (const __nv_bfloat16*)x, (const __nv_bfloat16*)scale,
      (const __nv_bfloat16*)wg, (const __nv_bfloat16*)wu,
      (__nv_bfloat16*)out, N, d, F, act, eps, vec_ok);
  return (int)cudaGetLastError();
}

static int launch_f32(const void* x, const void* scale, const void* wg,
                      const void* wu, void* out, int N, int d, int F, int act,
                      float eps, cudaStream_t stream) {
  fused_mlp_kernel<float><<<dim3((F + FM_BN - 1) / FM_BN, (N + 63) / 64),
                            FM_THREADS, 0, stream>>>(
      (const float*)x, (const float*)scale, (const float*)wg,
      (const float*)wu, (float*)out, N, d, F, act, eps);
  return (int)cudaGetLastError();
}

// act: 0 silu, 1 gelu (tanh).  dtype: 0 float32, 1 bfloat16.  variant
// (chosen by the wrapper's `_variant`): 0 the CUDA-core kernel (float32),
// 1 the WMMA kernel (bfloat16), 2 the rows kernel (N <= 8, either dtype),
// 3 the wgmma/TMA kernel pair (bfloat16, d and F multiples of 8, 16-byte
// aligned operands; scratch: a float32 inv_rms of N), 4 the gemv/TMA
// kernel (bfloat16, N <= 8, d and F multiples of 8, 16-byte aligned
// operands; scratch: the float32 partials, count: the zeroed counters,
// boxes / krows / blocks / stages / maxseg: its split, see launch_gemv).  A variant whose
// conditions do not hold is refused.  Returns a cudaError_t (0 =
// launched).
extern "C" int fused_mlp_launch(const void* x, const void* scale,
                                const void* wg, const void* wu, void* out,
                                float* scratch, int* count, int N, int d,
                                int F, int act, float eps, int dtype,
                                int variant, int boxes, int krows,
                                int blocks, int stages, int maxseg,
                                cudaStream_t stream) {
  if (N < 1 || d < 1 || F < 1 || act < 0 || act > 1 || dtype < 0 ||
      dtype > 1)
    return (int)cudaErrorInvalidValue;
  const bool tma_ok = dtype == 1 && d % 8 == 0 && F % 8 == 0 &&
      (size_t)x % 16 == 0 && (size_t)scale % 16 == 0 &&
      (size_t)wg % 16 == 0 && (size_t)wu % 16 == 0;
  switch (variant) {
    case 0:
      if (dtype != 0) break;
      return launch_f32(x, scale, wg, wu, out, N, d, F, act, eps, stream);
    case 1:
      if (dtype != 1) break;
      return launch_wmma(x, scale, wg, wu, out, N, d, F, act, eps, stream);
    case 2:
      if (dtype == 0)
        return launch_rows<float>(x, scale, wg, wu, out, N, d, F, act, eps,
                                  stream);
      return launch_rows<__nv_bfloat16>(x, scale, wg, wu, out, N, d, F, act,
                                        eps, stream);
    case 3:
      if (!tma_ok || scratch == nullptr) break;
      return launch_wgmma(x, scale, wg, wu, out, scratch, N, d, F, act, eps,
                          stream);
    case 4:
      if (!tma_ok || N > FR_ROWS) break;
      return launch_gemv(x, scale, wg, wu, out, scratch, count, N, d, F, act,
                         eps, boxes, krows, blocks, stages, maxseg, stream);
  }
  return (int)cudaErrorInvalidValue;
}
