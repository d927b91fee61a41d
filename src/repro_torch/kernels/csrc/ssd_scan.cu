// Mamba-2 SSD chunked scan for NVIDIA Hopper (sm_90a), CUDA C++, float32.
//
// Replaces: src/repro/kernels/ssd_scan.py (_ssd_kernel / ssd_scan_pallas,
// the Pallas kernel of the reference package).
// xs (B,L,nh,hd), dt (B,L,nh) post-softplus, A (nh,), Bm/Cm (B,L,st) (one
// group shared by all heads), D (nh,) -> y (B,L,nh,hd), h (B,nh,st,hd).
// Chunks of Q tokens (L = nc * Q); per (batch, head, chunk), with
// la = within-chunk cumsum(dt * A):
//   y_i  = sum_{j<=i} (C_i . B_j) exp(la_i - la_j) dt_j x_j
//        + exp(la_i) (C_i @ h_in) + D x_i
//   h_out = h_in exp(la_last) + sum_j (exp(la_last - la_j) dt_j B_j) x_j^T
//
// What bounds it on an H100.  Operations: at L = 16,384, nh = 32, hd = 64,
// st = 128, Q = 256 the live (i >= j) pairs, C B^T once per chunk, C @ h and
// the state update come to ~2.6e10 float32 operations (~0.39 ms at
// 67 TFLOP/s) against ~290 MB of inputs and outputs (~0.09 ms at
// 3.35 TB/s): bound by operations.
//
// What the design does about it.
//  * The TPU kernel walks the chunks as a sequential grid dimension and
//    carries h in VMEM scratch.  A GPU grid has no order, and one block per
//    (batch, head) would be 32 blocks for 132 SMs at B = 1, so the scan is
//    split into passes that are parallel over chunks, with one short serial
//    pass between them:
//      1. ssd_chunk_state_kernel, grid (nh * nc, 1, B): la for the chunk
//         (a scan in order, see ssd_cumsum), written out, and the chunk's
//         own state S_c = (B * w)^T x with w = exp(la_last - la) dt, a
//         (st, hd) tile in registers, 32 sums per thread.
//      2. ssd_cb_kernel, grid (pairs * nc, 1, B): G = C B^T for the lower
//         64 x 64 tiles of each chunk, once for all heads (the TPU kernel
//         recomputes it per head), stored transposed.
//      3. ssd_state_pass_kernel, grid (nh * ceil(st*hd/256), 1, B): one
//         thread per state element walks the chunks, h = h exp(la_last) + S,
//         and overwrites S_c with the state entering chunk c; the last h is
//         the output state.
//      4. ssd_chunk_out_kernel, grid (nh * nc * ceil(Q/64), 1, B): 64 rows
//         of one chunk and head: exp(la_i) (C @ h_in), then the live 64 x 64
//         tiles of the intra-chunk term, att = G exp(la_i - la_j) dt_j made
//         in shared memory, then att @ x; plus D x.
//  * Products read shared memory as float4s into register tiles (4 x 4 or
//    8 x 4 per thread), with the left operand stored transposed, so the
//    float32 FMAs and not the shared-memory port set the pace.
//  * Shared memory holds tiles of 64 rows (the TPU blocks, a (256, 128)
//    tile of C or B, do not fit beside the rest); any Q <= 256 works: rows
//    and columns past Q read as 0 and are not written.
//  * The causal mask is a select: exp(la_i - la_j) for j > i overflows to
//    inf for large dt, and inf * 0 would be NaN.
//  * Float32 on CUDA cores throughout: TF32 would not hold the reference's
//    1e-4.  Tensor cores, wgmma and TMA are later work.

#include <cuda_runtime.h>
#include <math.h>

#define SSD_THREADS 256
#define SSD_MAX_CHUNK 256
#define SSD_MAX_STATE 128
#define SSD_MAX_HEAD 64
#define SSD_TILE 64        // rows (and columns) of a chunk tile
#define SSD_KT 32          // depth of a shared-memory K tile

// Inclusive prefix sum of v[0..n) in place (n <= SSD_MAX_CHUNK), by one
// thread, in order: la_i = la_{i-1} + a_i from 0, the order in which
// torch.cumsum sums a dim that is not the innermost (the plain version's).
// A tree scan would round differently, and la_i - la_j at |la| ~ 100-400
// (a fast-decaying head over a 256-token chunk) carries those roundings
// into exp(la_i - la_j) at ~1e-4 relative, the size of the tolerance.
__device__ __forceinline__ void ssd_cumsum(float* v, int n) {
  if (threadIdx.x != 0) return;
  float run = 0.f;
#pragma unroll 8
  for (int j = 0; j < n; ++j) {
    run += v[j];
    v[j] = run;
  }
}

// 1. la (written to la_out (B,nh,L)) and the chunk states S_c (written to
//    states (B,nh,nc,st,hd)).  Thread (ty, tx) of 16 x 16 holds the sums of
//    rows s = 8 ty + k (k < 8) and columns d = 4 tx + m (m < 4), read from
//    shared memory as float4s (3 reads for 32 products).
__global__ void __launch_bounds__(SSD_THREADS)
ssd_chunk_state_kernel(const float* __restrict__ x,
                       const float* __restrict__ dt,
                       const float* __restrict__ A,
                       const float* __restrict__ Bm,
                       float* __restrict__ la_out,
                       float* __restrict__ states, int L, int nh, int hd,
                       int st, int Q) {
  __shared__ float la_s[SSD_MAX_CHUNK];
  __shared__ float w_s[SSD_MAX_CHUNK];
  __shared__ __align__(16) float Bt[SSD_KT][SSD_MAX_STATE];
  __shared__ __align__(16) float Xt[SSD_KT][SSD_MAX_HEAD];
  const int nc = L / Q;
  const int h = blockIdx.x % nh, c = blockIdx.x / nh, b = blockIdx.z;
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const size_t t0 = (size_t)b * L + (size_t)c * Q;   // first token
  const float a = A[h];

  for (int j = tid; j < Q; j += SSD_THREADS)
    la_s[j] = dt[(t0 + j) * nh + h] * a;
  __syncthreads();
  ssd_cumsum(la_s, Q);
  __syncthreads();
  const float la_last = la_s[Q - 1];
  float* la_g = la_out + ((size_t)b * nh + h) * L + (size_t)c * Q;
  for (int j = tid; j < Q; j += SSD_THREADS) {
    la_g[j] = la_s[j];
    w_s[j] = expf(la_last - la_s[j]) * dt[(t0 + j) * nh + h];
  }
  __syncthreads();

  float acc[8][4];
#pragma unroll
  for (int k = 0; k < 8; ++k)
#pragma unroll
    for (int m = 0; m < 4; ++m) acc[k][m] = 0.f;

  for (int j0 = 0; j0 < Q; j0 += SSD_KT) {
    for (int e = tid; e < SSD_KT * st; e += SSD_THREADS) {
      const int jj = e / st, s = e - jj * st, j = j0 + jj;
      Bt[jj][s] = j < Q ? Bm[(t0 + j) * st + s] * w_s[j] : 0.f;
    }
    for (int e = tid; e < SSD_KT * hd; e += SSD_THREADS) {
      const int jj = e / hd, d = e - jj * hd, j = j0 + jj;
      Xt[jj][d] = j < Q ? x[((t0 + j) * nh + h) * hd + d] : 0.f;
    }
    __syncthreads();
#pragma unroll 4
    for (int jj = 0; jj < SSD_KT; ++jj) {
      const float4 b0 = *reinterpret_cast<const float4*>(&Bt[jj][8 * ty]);
      const float4 b1 = *reinterpret_cast<const float4*>(&Bt[jj][8 * ty + 4]);
      const float4 x4 = *reinterpret_cast<const float4*>(&Xt[jj][4 * tx]);
      const float bv[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
      const float xv[4] = {x4.x, x4.y, x4.z, x4.w};
#pragma unroll
      for (int k = 0; k < 8; ++k)
#pragma unroll
        for (int m = 0; m < 4; ++m) acc[k][m] += bv[k] * xv[m];
    }
    __syncthreads();
  }

  float* S = states + (((size_t)b * nh + h) * nc + c) * st * hd;
#pragma unroll
  for (int k = 0; k < 8; ++k) {
    const int s = 8 * ty + k;
#pragma unroll
    for (int m = 0; m < 4; ++m) {
      const int d = 4 * tx + m;
      if (s < st && d < hd) S[s * hd + d] = acc[k][m];
    }
  }
}

// 2. G = C B^T for the tiles (ti, tj), tj <= ti, of each chunk, stored
//    transposed: cbT (B,nc,Q,Q) holds G[i][j] at [j][i].  Thread (ty, tx)
//    holds rows i = tx + 16r and columns j = ty + 16q (r, q < 4).
__global__ void __launch_bounds__(SSD_THREADS)
ssd_cb_kernel(const float* __restrict__ Bm, const float* __restrict__ Cm,
              float* __restrict__ cb, int L, int st, int Q) {
  __shared__ float Cs[SSD_TILE][SSD_KT + 1];
  __shared__ float Bs[SSD_TILE][SSD_KT + 1];
  const int nc = L / Q, T = (Q + SSD_TILE - 1) / SSD_TILE;
  const int pairs = T * (T + 1) / 2;
  const int p = blockIdx.x % pairs, c = blockIdx.x / pairs, b = blockIdx.z;
  int ti = 0;
  while ((ti + 1) * (ti + 2) / 2 <= p) ++ti;
  const int tj = p - ti * (ti + 1) / 2;
  const int i0 = ti * SSD_TILE, j0 = tj * SSD_TILE;
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const size_t t0 = (size_t)b * L + (size_t)c * Q;

  float acc[4][4];
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int q = 0; q < 4; ++q) acc[r][q] = 0.f;

  for (int s0 = 0; s0 < st; s0 += SSD_KT) {
    for (int e = tid; e < SSD_TILE * SSD_KT; e += SSD_THREADS) {
      const int r = e / SSD_KT, k = e - r * SSD_KT, s = s0 + k;
      Cs[r][k] = (i0 + r < Q && s < st) ? Cm[(t0 + i0 + r) * st + s] : 0.f;
      Bs[r][k] = (j0 + r < Q && s < st) ? Bm[(t0 + j0 + r) * st + s] : 0.f;
    }
    __syncthreads();
#pragma unroll 8
    for (int k = 0; k < SSD_KT; ++k) {
      float cv[4], bv[4];
#pragma unroll
      for (int r = 0; r < 4; ++r) cv[r] = Cs[tx + 16 * r][k];
#pragma unroll
      for (int q = 0; q < 4; ++q) bv[q] = Bs[ty + 16 * q][k];
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int q = 0; q < 4; ++q) acc[r][q] += cv[r] * bv[q];
    }
    __syncthreads();
  }

  float* GT = cb + ((size_t)b * nc + c) * Q * Q;
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int i = i0 + tx + 16 * r;
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int j = j0 + ty + 16 * q;
      if (i < Q && j < Q) GT[(size_t)j * Q + i] = acc[r][q];
    }
  }
}

// 3. The serial pass over chunks, one thread per state element: states[c]
//    becomes the state entering chunk c; hout gets the final state.
__global__ void __launch_bounds__(SSD_THREADS)
ssd_state_pass_kernel(const float* __restrict__ la, float* __restrict__ states,
                      float* __restrict__ hout, int L, int nh, int hd, int st,
                      int Q) {
  const int nc = L / Q, n = st * hd;
  const int h = blockIdx.x % nh, part = blockIdx.x / nh;
  const int e = part * SSD_THREADS + threadIdx.x;
  if (e >= n) return;
  const size_t bh = (size_t)blockIdx.z * nh + h;
  float* S = states + bh * nc * n + e;
  const float* la_last = la + bh * L + (Q - 1);
  float hv = 0.f, s_next = S[0];
  for (int c = 0; c < nc; ++c) {
    const float s = s_next;
    const float decay = expf(la_last[(size_t)c * Q]);
    if (c + 1 < nc) s_next = S[(size_t)(c + 1) * n];
    S[(size_t)c * n] = hv;
    hv = hv * decay + s;
  }
  hout[bh * n + e] = hv;
}

// 4. y for rows i0 .. i0+63 of chunk c, head h.  Thread (ty, tx) holds rows
//    i = i0 + 4 ty + r (r < 4) and columns d = 4 tx + m (m < 4); C and the
//    att tile sit transposed in shared memory, so each product step reads
//    two float4s for 16 products.
__global__ void __launch_bounds__(SSD_THREADS)
ssd_chunk_out_kernel(const float* __restrict__ x, const float* __restrict__ dt,
                     const float* __restrict__ Cm, const float* __restrict__ D,
                     const float* __restrict__ la,
                     const float* __restrict__ states,
                     const float* __restrict__ cb, float* __restrict__ y,
                     int L, int nh, int hd, int st, int Q) {
  __shared__ float la_s[SSD_MAX_CHUNK];
  __shared__ float dt_s[SSD_MAX_CHUNK];
  // inter-chunk step: CsT (32 x 68, C transposed) then Hs (32 x 64);
  // intra-chunk step: GsT (64 x 68, att transposed) then Xs (64 x 64).
  // Rows of 68 floats keep float4 reads aligned.
  constexpr int LDT = SSD_TILE + 4;
  __shared__ __align__(16) float buf[SSD_TILE * LDT + SSD_TILE * SSD_MAX_HEAD];
  float(*CsT)[LDT] = reinterpret_cast<float(*)[LDT]>(buf);
  float(*Hs)[SSD_MAX_HEAD] = reinterpret_cast<float(*)[SSD_MAX_HEAD]>(
      buf + SSD_KT * LDT);
  float(*GsT)[LDT] = reinterpret_cast<float(*)[LDT]>(buf);
  float(*Xs)[SSD_MAX_HEAD] = reinterpret_cast<float(*)[SSD_MAX_HEAD]>(
      buf + SSD_TILE * LDT);

  const int nc = L / Q, T = (Q + SSD_TILE - 1) / SSD_TILE;
  const int h = blockIdx.x % nh, rest = blockIdx.x / nh;
  const int ti = rest % T, c = rest / T, b = blockIdx.z;
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int i0 = ti * SSD_TILE, jmax = min(Q, i0 + SSD_TILE);
  const size_t t0 = (size_t)b * L + (size_t)c * Q;
  const size_t bh = (size_t)b * nh + h;

  for (int j = tid; j < jmax; j += SSD_THREADS) {
    la_s[j] = la[bh * L + (size_t)c * Q + j];
    dt_s[j] = dt[(t0 + j) * nh + h];
  }

  float acc[4][4];
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int m = 0; m < 4; ++m) acc[r][m] = 0.f;

  // inter-chunk: C_i @ h_in (h_in = 0 in the first chunk)
  if (c > 0) {
    const float* Hg = states + (bh * nc + c) * st * hd;
    for (int s0 = 0; s0 < st; s0 += SSD_KT) {
      for (int e = tid; e < SSD_TILE * SSD_KT; e += SSD_THREADS) {
        const int r = e / SSD_KT, k = e - r * SSD_KT, s = s0 + k;
        CsT[k][r] = (i0 + r < Q && s < st) ? Cm[(t0 + i0 + r) * st + s] : 0.f;
      }
      for (int e = tid; e < SSD_KT * SSD_MAX_HEAD; e += SSD_THREADS) {
        const int k = e / SSD_MAX_HEAD, d = e - k * SSD_MAX_HEAD;
        const int s = s0 + k;
        Hs[k][d] = (s < st && d < hd) ? Hg[(size_t)s * hd + d] : 0.f;
      }
      __syncthreads();
#pragma unroll 8
      for (int k = 0; k < SSD_KT; ++k) {
        const float4 c4 = *reinterpret_cast<const float4*>(&CsT[k][4 * ty]);
        const float4 h4 = *reinterpret_cast<const float4*>(&Hs[k][4 * tx]);
        const float cv[4] = {c4.x, c4.y, c4.z, c4.w};
        const float hv[4] = {h4.x, h4.y, h4.z, h4.w};
#pragma unroll
        for (int r = 0; r < 4; ++r)
#pragma unroll
          for (int m = 0; m < 4; ++m) acc[r][m] += cv[r] * hv[m];
      }
      __syncthreads();
    }
  }
  __syncthreads();                       // la_s / dt_s are written
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int i = i0 + 4 * ty + r;
    const float g = i < Q ? expf(la_s[i]) : 0.f;
#pragma unroll
    for (int m = 0; m < 4; ++m) acc[r][m] *= g;
  }

  // intra-chunk: the live tiles tj <= ti
  const float* GgT = cb + ((size_t)b * nc + c) * Q * Q;   // G[i][j] at [j][i]
  for (int tj = 0; tj <= ti; ++tj) {
    const int j0 = tj * SSD_TILE;
    for (int e = tid; e < SSD_TILE * SSD_TILE; e += SSD_THREADS) {
      const int hi = e / SSD_TILE, lo = e - hi * SSD_TILE;
      // att (row i = i0 + lo, column j = j0 + hi) -> GsT[hi][lo]
      const int i = i0 + lo, j = j0 + hi;
      float v = 0.f;
      if (i < Q && j <= i)               // a select, never a multiply
        v = GgT[(size_t)j * Q + i] * expf(la_s[i] - la_s[j]) * dt_s[j];
      GsT[hi][lo] = v;
      // x (row j0 + hi, column lo) -> Xs[hi][lo]
      Xs[hi][lo] = (j0 + hi < Q && lo < hd)
                       ? x[((t0 + j0 + hi) * nh + h) * hd + lo] : 0.f;
    }
    __syncthreads();
#pragma unroll 8
    for (int jj = 0; jj < SSD_TILE; ++jj) {
      const float4 g4 = *reinterpret_cast<const float4*>(&GsT[jj][4 * ty]);
      const float4 x4 = *reinterpret_cast<const float4*>(&Xs[jj][4 * tx]);
      const float gv[4] = {g4.x, g4.y, g4.z, g4.w};
      const float xv[4] = {x4.x, x4.y, x4.z, x4.w};
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int m = 0; m < 4; ++m) acc[r][m] += gv[r] * xv[m];
    }
    __syncthreads();
  }

  const float Dh = D[h];
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int i = i0 + 4 * ty + r;
#pragma unroll
    for (int m = 0; m < 4; ++m) {
      const int d = 4 * tx + m;
      if (i < Q && d < hd) {
        const size_t idx = ((t0 + i) * nh + h) * hd + d;
        y[idx] = acc[r][m] + x[idx] * Dh;
      }
    }
  }
}

// Scratch (float32, from the caller): la (B,nh,L), states (B,nh,nc,st,hd),
// cb (B,nc,Q,Q) (C B^T, transposed).  Launches the four kernels on `stream`
// in order and returns a cudaError_t (0 = all four launched).
extern "C" int ssd_scan_launch(const float* x, const float* dt,
                               const float* A, const float* Bm,
                               const float* Cm, const float* D, float* y,
                               float* hout, float* la, float* states,
                               float* cb, int B, int L, int nh, int hd,
                               int st, int Q, cudaStream_t stream) {
  if (B < 1 || B > 65535 || L < 1 || nh < 1 || hd < 1 ||
      hd > SSD_MAX_HEAD || st < 1 || st > SSD_MAX_STATE || Q < 1 ||
      Q > SSD_MAX_CHUNK || L % Q != 0)
    return (int)cudaErrorInvalidValue;
  const int nc = L / Q, T = (Q + SSD_TILE - 1) / SSD_TILE;
  const long long blocks_out = (long long)nh * nc * T;
  if (blocks_out > 2147483647LL) return (int)cudaErrorInvalidValue;

  ssd_chunk_state_kernel<<<dim3(nh * nc, 1, B), SSD_THREADS, 0, stream>>>(
      x, dt, A, Bm, la, states, L, nh, hd, st, Q);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  ssd_cb_kernel<<<dim3(T * (T + 1) / 2 * nc, 1, B), SSD_THREADS, 0,
                  stream>>>(Bm, Cm, cb, L, st, Q);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  const int parts = (st * hd + SSD_THREADS - 1) / SSD_THREADS;
  ssd_state_pass_kernel<<<dim3(nh * parts, 1, B), SSD_THREADS, 0, stream>>>(
      la, states, hout, L, nh, hd, st, Q);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  ssd_chunk_out_kernel<<<dim3((unsigned)blocks_out, 1, B), SSD_THREADS, 0,
                         stream>>>(x, dt, Cm, D, la, states, cb, y, L, nh,
                                   hd, st, Q);
  return (int)cudaGetLastError();
}
