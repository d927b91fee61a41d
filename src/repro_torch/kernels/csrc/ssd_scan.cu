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
//  * These four kernels ("cuda_cores") compute in float32 on CUDA cores:
//    the row's bound, 0.396 ms at the serving shape, is the CUDA-core rate
//    itself.  The "tf32x3" kernels further down run the same passes with
//    three of the products on tensor cores at float32-level error (see
//    there); the wrapper (kernels/ssd_scan.py:_variant) takes them whenever
//    the operands are 16-byte aligned with hd and st multiples of 4, and
//    these for the rest.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <initializer_list>

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

// ------------------------------------------------------------- "tf32x3"
//
// The same four passes with three of the four products on tensor cores:
// the chunk states (B w)^T x, C @ h_in and att @ x.  C B^T stays on CUDA
// cores (ssd_cb_kernel above, 3% of a call): with large dt, att = (C B^T)
// dt is ~150 times C B^T, and where C_i . B_j cancels to near zero a
// 3xTF32 C B^T (its running sum kept by the tensor core) erred by up to
// 1e-3 absolute in y against a 1e-4 limit; float32 FMAs hold it.  mma.sync
// m16n8k8 in TF32 keeps 10 mantissa bits, ~5e-4 relative: one pass would
// not hold the 1e-4 limit.  Each operand is split as a = hi + lo, hi =
// rna_tf32(a) and lo = rna_tf32(a - hi) (a - hi is exact; tc_rna), and a
// product is hi*hi' + hi*lo' + lo*hi' accumulated in float32 (the lo*lo'
// term, ~2^-22 relative, is left out): float32-level error for three MMAs.
// Fragments (PTX ISA, m16n8k8 .tf32; g = lane / 4, t = lane % 4):
//   A (16 x 8, row): a0 (g, t), a1 (g + 8, t), a2 (g, t + 4), a3 (g + 8, t + 4)
//   B (8 x 8, col):  b0 (t, g), b1 (t + 4, g)
//   C (16 x 8):      c0 (g, 2t), c1 (g, 2t + 1), c2 (g + 8, 2t), c3 (g + 8, 2t + 1)
// Each block has 4 warps over a 64 x 64 output tile: warp w takes the 32 x
// 32 quarter at rows 32 (w % 2), columns 32 (w / 2) (2 x 4 MMA tiles, so
// each split fragment feeds 4 or 8 MMAs and the per-MMA splitting and
// shared-memory reads stay below the tensor cores' time).  Tiles
// sit in shared memory with rows padded (+4 or +8 floats) so that the
// fragment reads of a warp hit 32 distinct banks.  Plain copies (x, C, B,
// h) come in as 16-byte cp.async, zero-filled past the tensor's edge; the
// decayed att tile is computed by the threads (one exp per pair and head,
// the mask a select).  la is summed in order, one thread, the chain in
// registers.  C B^T runs as extra blocks of the chunk-state launch, so the
// two overlap.  A call with one chunk writes its chunk state as the final
// state and skips the state pass: three launches become two.

#define TC_LDA 68          // 64 + 4: rows of a K-major A tile / an att^T tile
#define TC_LDK 36          // 32 + 4: rows of a 32-deep tile stored [row][k]
#define TC_LDB 72          // 64 + 8: rows of a [k][n] B tile

__device__ __forceinline__ uint32_t tc_smem(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
// 16 bytes global -> shared, asynchronously; !valid writes 16 zero bytes.
__device__ __forceinline__ void tc_cp16(void* dst, const float* src,
                                        bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   tc_smem(dst)),
               "l"(src), "r"(valid ? 16 : 0) : "memory");
}
__device__ __forceinline__ void tc_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void tc_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ float tc_exp2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// cvt.rna.tf32.f32 (round to nearest, ties away from zero) as two integer
// operations on the bits: the magnitude plus half a TF32 ulp, the 13 low
// bits cleared (exact for every finite input below the largest float).
// The conversion instruction runs on a narrow pipe; these run at full rate.
__device__ __forceinline__ uint32_t tc_rna(float a) {
  return (__float_as_uint(a) + 0x1000u) & 0xffffe000u;
}
__device__ __forceinline__ void tc_split(float a, uint32_t& hi,
                                         uint32_t& lo) {
  hi = tc_rna(a);
  lo = tc_rna(a - __uint_as_float(hi));     // a - hi is exact
}
__device__ __forceinline__ void tc_mma(float* d, const uint32_t* a,
                                       const uint32_t* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}
#define TC_THREADS 128     // 4 warps, each a 32 x 32 quarter of a 64 x 64 tile

// One 8-deep step of a warp's 32 x 32 tile (rows m0.., columns n0..): two
// A fragments and four B fragments, each split once, 24 MMAs.  a(r, k) and
// b(k, n) read shared memory (r, n relative to the warp's tile).
template <typename FA, typename FB>
__device__ __forceinline__ void tc_step(float (*acc)[4][4], FA a, FB b) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  uint32_t ah[2][4], al[2][4];
#pragma unroll
  for (int mt = 0; mt < 2; ++mt) {
    const int r = 16 * mt + g;
    tc_split(a(r, t), ah[mt][0], al[mt][0]);
    tc_split(a(r + 8, t), ah[mt][1], al[mt][1]);
    tc_split(a(r, t + 4), ah[mt][2], al[mt][2]);
    tc_split(a(r + 8, t + 4), ah[mt][3], al[mt][3]);
  }
#pragma unroll
  for (int nt = 0; nt < 4; ++nt) {
    uint32_t bh[2], bl[2];
    tc_split(b(t, 8 * nt + g), bh[0], bl[0]);
    tc_split(b(t + 4, 8 * nt + g), bh[1], bl[1]);
#pragma unroll
    for (int mt = 0; mt < 2; ++mt) {
      tc_mma(acc[mt][nt], al[mt], bh);
      tc_mma(acc[mt][nt], ah[mt], bl);
      tc_mma(acc[mt][nt], ah[mt], bh);
    }
  }
}

__device__ __forceinline__ void tc_zero(float (*acc)[4][4]) {
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mt][nt][e] = 0.f;
}
// Row / column (in the warp's tile) of accumulator element (mt, nt, e).
__device__ __forceinline__ int tc_row(int mt, int e) {
  return 16 * mt + ((threadIdx.x & 31) >> 2) + 8 * (e >> 1);
}
__device__ __forceinline__ int tc_col(int nt, int e) {
  return 8 * nt + 2 * (threadIdx.x & 3) + (e & 1);
}

// la_s[j] = sum_{i<=j} la_s[i] for j < Q, in order, by one thread with the
// chain in registers (the order of torch.cumsum; see ssd_cumsum); ends
// with a barrier.
__device__ __forceinline__ void tc_cumsum(float* la_s, int Q) {
  if (threadIdx.x == 0) {
    float run = 0.f;
    for (int j0 = 0; j0 < Q; j0 += 8) {
      float v[8];
#pragma unroll
      for (int u = 0; u < 8; ++u) v[u] = j0 + u < Q ? la_s[j0 + u] : 0.f;
#pragma unroll
      for (int u = 0; u < 8; ++u) {
        run += v[u];
        v[u] = run;
      }
#pragma unroll
      for (int u = 0; u < 8; ++u)
        if (j0 + u < Q) la_s[j0 + u] = v[u];
    }
  }
  __syncthreads();
}

// Shared memory of the first launch, in floats: the chunk-state role's
// la (256), w (256), B (2 x 32 x 68) and x (2 x 32 x 72) tiles; the C B^T
// role's two 64 x 33 tiles fit inside.
#define TC_STATE_SMEM (2 * SSD_MAX_CHUNK + 2 * SSD_KT * TC_LDA + \
                       2 * SSD_KT * TC_LDB)

// Chunk-state role: la (block y == 0 writes it) and rows s0 .. s0+63 of
// S_c = (B w)^T x for (head h, chunk c).  One chunk: S_0 is the final
// state, written to hout.
__device__ __forceinline__ void tc_state_role(
    const float* __restrict__ x, const float* __restrict__ dt,
    const float* __restrict__ A, const float* __restrict__ Bm,
    float* __restrict__ la_out, float* __restrict__ states,
    float* __restrict__ hout, int L, int nh, int hd, int st, int Q, int h,
    int c, int s0, int b, bool write_la, float* smem) {
  float* la_s = smem;
  float* w_s = la_s + SSD_MAX_CHUNK;
  float(*Bs)[SSD_KT][TC_LDA] = reinterpret_cast<float(*)[SSD_KT][TC_LDA]>(
      w_s + SSD_MAX_CHUNK);                                   // [j][s]
  float(*Xs)[SSD_KT][TC_LDB] = reinterpret_cast<float(*)[SSD_KT][TC_LDB]>(
      w_s + SSD_MAX_CHUNK + 2 * SSD_KT * TC_LDA);             // [j][d]
  const int nc = L / Q;
  const int tid = threadIdx.x, warp = tid >> 5;
  const int m0 = 32 * (warp & 1), n0 = 32 * (warp >> 1);
  const size_t t0 = (size_t)b * L + (size_t)c * Q;

  const int nk = (Q + SSD_KT - 1) / SSD_KT;
  for (int j = tid; j < nk * SSD_KT; j += TC_THREADS) {   // dt, 0 past Q
    const float d = j < Q ? dt[(t0 + j) * nh + h] : 0.f;
    w_s[j] = d;
    la_s[j] = d * A[h];
  }
  __syncthreads();
  tc_cumsum(la_s, Q);
  const float la_last = la_s[Q - 1];
  if (write_la) {
    float* la_g = la_out + ((size_t)b * nh + h) * L + (size_t)c * Q;
    for (int j = tid; j < Q; j += TC_THREADS) la_g[j] = la_s[j];
  }
  for (int j = tid; j < Q; j += TC_THREADS)     // the same j as above
    w_s[j] *= expf(la_last - la_s[j]);

  // 32 rows of B (64 columns from s0) and of x per stage, 16-byte chunks
  auto load = [&](int stage, int j0) {
    for (int e = tid; e < SSD_KT * 16; e += TC_THREADS) {
      const int jj = e >> 4, q4 = (e & 15) * 4, j = j0 + jj;
      const bool okb = j < Q && s0 + q4 < st;
      tc_cp16(&Bs[stage][jj][q4], Bm + (okb ? (t0 + j) * st + s0 + q4 : 0),
              okb);
      const bool okx = j < Q && q4 < hd;
      tc_cp16(&Xs[stage][jj][q4],
              x + (okx ? ((t0 + j) * nh + h) * hd + q4 : 0), okx);
    }
    tc_commit();
  };

  float acc[2][4][4];
  tc_zero(acc);
  load(0, 0);
  __syncthreads();                       // w_s is written
  for (int kt = 0; kt < nk; ++kt) {
    if (kt + 1 < nk) load((kt + 1) & 1, (kt + 1) * SSD_KT); else tc_commit();
    tc_wait<1>();
    __syncthreads();
    const int sg = kt & 1, j0 = kt * SSD_KT;
#pragma unroll
    for (int k = 0; k < SSD_KT; k += 8)
      tc_step(acc,
              [&](int r, int kk) {
                return Bs[sg][k + kk][m0 + r] * w_s[j0 + k + kk];
              },
              [&](int kk, int n) { return Xs[sg][k + kk][n0 + n]; });
    __syncthreads();                     // the stage may be refilled
  }

  float* S = nc == 1 ? hout + ((size_t)b * nh + h) * st * hd
                     : states + (((size_t)b * nh + h) * nc + c) * st * hd;
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int s = s0 + m0 + tc_row(mt, e), d = n0 + tc_col(nt, e);
        if (s < st && d < hd) S[(size_t)s * hd + d] = acc[mt][nt][e];
      }
}

// C B^T role, float32 on CUDA cores (see the note above): the tile
// (ti, tj) of chunk c, stored transposed (G[i][j] at cbT[j][i], rows of QP
// floats).  32-deep stages of C and B rows come in by cp.async, two in
// flight; thread (ty, tx) of 8 x 16 holds rows i = tx + 16 q (q < 4) and
// columns j = ty + 8 r (r < 8).
__device__ __forceinline__ void tc_cb_role(const float* __restrict__ Bm,
                                           const float* __restrict__ Cm,
                                           float* __restrict__ cb, int L,
                                           int st, int Q, int QP, int p,
                                           int c, int b, float* smem) {
  float(*Cs)[SSD_TILE][TC_LDK] =
      reinterpret_cast<float(*)[SSD_TILE][TC_LDK]>(smem);
  float(*Bs)[SSD_TILE][TC_LDK] = reinterpret_cast<float(*)[SSD_TILE][TC_LDK]>(
      smem + 2 * SSD_TILE * TC_LDK);
  const int nc = L / Q;
  int ti = 0;
  while ((ti + 1) * (ti + 2) / 2 <= p) ++ti;
  const int tj = p - ti * (ti + 1) / 2;
  const int i0 = ti * SSD_TILE, j0 = tj * SSD_TILE;
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const size_t t0 = (size_t)b * L + (size_t)c * Q;
  auto load = [&](int stage, int s0) {
    for (int e = tid; e < SSD_TILE * 8; e += TC_THREADS) {
      const int r = e >> 3, q4 = (e & 7) * 4, s = s0 + q4;
      const bool okc = i0 + r < Q && s < st;
      tc_cp16(&Cs[stage][r][q4], Cm + (okc ? (t0 + i0 + r) * st + s : 0),
              okc);
      const bool okb = j0 + r < Q && s < st;
      tc_cp16(&Bs[stage][r][q4], Bm + (okb ? (t0 + j0 + r) * st + s : 0),
              okb);
    }
    tc_commit();
  };
  float acc[4][8];
#pragma unroll
  for (int q = 0; q < 4; ++q)
#pragma unroll
    for (int r = 0; r < 8; ++r) acc[q][r] = 0.f;
  const int nk = (st + SSD_KT - 1) / SSD_KT;
  load(0, 0);
  for (int kt = 0; kt < nk; ++kt) {
    if (kt + 1 < nk) load((kt + 1) & 1, (kt + 1) * SSD_KT); else tc_commit();
    tc_wait<1>();
    __syncthreads();
    const int sg = kt & 1;
#pragma unroll 8
    for (int k = 0; k < SSD_KT; ++k) {
      float cv[4], bv[8];
#pragma unroll
      for (int q = 0; q < 4; ++q) cv[q] = Cs[sg][tx + 16 * q][k];
#pragma unroll
      for (int r = 0; r < 8; ++r) bv[r] = Bs[sg][ty + 8 * r][k];
#pragma unroll
      for (int q = 0; q < 4; ++q)
#pragma unroll
        for (int r = 0; r < 8; ++r) acc[q][r] += cv[q] * bv[r];
    }
    __syncthreads();
  }
  float* GT = cb + ((size_t)b * nc + c) * Q * QP;
#pragma unroll
  for (int q = 0; q < 4; ++q)
#pragma unroll
    for (int r = 0; r < 8; ++r) {
      const int i = i0 + tx + 16 * q, j = j0 + ty + 8 * r;
      if (i < Q && j < Q) GT[(size_t)j * QP + i] = acc[q][r];
    }
}

// 1 + 2. One launch, two roles, so that C B^T overlaps the chunk states
// (at one chunk the three C B^T blocks would otherwise run alone): blocks
// x < n_state take (head, chunk, 64 rows of st), the rest a C B^T tile;
// grid (nh * nc * ceil(st/64) + nc * T (T + 1) / 2, 1, B).
__global__ void __launch_bounds__(TC_THREADS)
ssd_state_cb_tc_kernel(const float* __restrict__ x,
                       const float* __restrict__ dt,
                       const float* __restrict__ A,
                       const float* __restrict__ Bm,
                       const float* __restrict__ Cm,
                       float* __restrict__ la_out,
                       float* __restrict__ states, float* __restrict__ hout,
                       float* __restrict__ cb, int L, int nh, int hd, int st,
                       int Q) {
  __shared__ __align__(16) float smem[TC_STATE_SMEM];
  const int ny = (st + SSD_TILE - 1) / SSD_TILE;
  const int n_state = nh * (L / Q) * ny;
  const int bx = blockIdx.x, b = blockIdx.z;
  if (bx < n_state) {
    const int y = bx % ny, hc = bx / ny;
    tc_state_role(x, dt, A, Bm, la_out, states, hout, L, nh, hd, st, Q,
                  hc % nh, hc / nh, y * SSD_TILE, b, y == 0, smem);
  } else {
    const int T = (Q + SSD_TILE - 1) / SSD_TILE, pairs = T * (T + 1) / 2;
    const int r = bx - n_state;
    tc_cb_role(Bm, Cm, cb, L, st, Q, (Q + 3) & ~3, r % pairs, r / pairs, b,
               smem);
  }
}

// Shared memory of ssd_chunk_out_tc_kernel, in floats: la and dt (256
// each); stage 0 of the intra-chunk ring (a 64 x 64 tile of C B^T, made
// into att in place, [j][i], and 64 rows of x); then stage 1, which the
// inter-chunk step's C and h stages use before it (74,752 bytes).
#define TC_STAGE (SSD_TILE * TC_LDA + SSD_TILE * TC_LDB)
#define TC_CH (2 * SSD_TILE * TC_LDK + 2 * SSD_KT * TC_LDB)
#define TC_OUT_SMEM \
  (2 * SSD_MAX_CHUNK + TC_STAGE + (TC_CH > TC_STAGE ? TC_CH : TC_STAGE))

// 4. y for rows i0 .. i0+63 of chunk c, head h: exp(la_i) (C @ h_in), then
//    the live 64 x 64 tiles att @ x, plus D x; grid (nh * nc * T, 1, B).
//    The tiles of C B^T and x come in by cp.async, the next tile's while
//    this one's products run (and the first during C @ h_in).
__global__ void __launch_bounds__(TC_THREADS)
ssd_chunk_out_tc_kernel(const float* __restrict__ x,
                        const float* __restrict__ dt,
                        const float* __restrict__ Cm,
                        const float* __restrict__ D,
                        const float* __restrict__ la,
                        const float* __restrict__ states,
                        const float* __restrict__ cb, float* __restrict__ y,
                        int L, int nh, int hd, int st, int Q) {
  extern __shared__ __align__(16) float tc_dyn[];
  float* la_s = tc_dyn;
  float* dt_s = la_s + SSD_MAX_CHUNK;
  float* stage0 = dt_s + SSD_MAX_CHUNK;
  float* stage1 = stage0 + TC_STAGE;
  float(*Cs)[SSD_TILE][TC_LDK] =
      reinterpret_cast<float(*)[SSD_TILE][TC_LDK]>(stage1);
  float(*Hs)[SSD_KT][TC_LDB] = reinterpret_cast<float(*)[SSD_KT][TC_LDB]>(
      stage1 + 2 * SSD_TILE * TC_LDK);

  const int nc = L / Q, T = (Q + SSD_TILE - 1) / SSD_TILE;
  const int QP = (Q + 3) & ~3;
  const int h = blockIdx.x % nh, rest = blockIdx.x / nh;
  const int ti = rest % T, c = rest / T, b = blockIdx.z;
  const int tid = threadIdx.x, warp = tid >> 5;
  const int m0 = 32 * (warp & 1), n0 = 32 * (warp >> 1);
  const int i0 = ti * SSD_TILE, jmax = min(Q, i0 + SSD_TILE);
  const size_t t0 = (size_t)b * L + (size_t)c * Q;
  const size_t bh = (size_t)b * nh + h;
  const float* GgT = cb + ((size_t)b * nc + c) * Q * QP;   // G[i][j] at [j][i]

  // tile tj of C B^T (rows j0.., columns i0..) and of x (rows j0..)
  auto issue_tile = [&](int tj, float* stg) {
    float(*Gs)[TC_LDA] = reinterpret_cast<float(*)[TC_LDA]>(stg);
    float(*Xs)[TC_LDB] =
        reinterpret_cast<float(*)[TC_LDB]>(stg + SSD_TILE * TC_LDA);
    const int j0 = tj * SSD_TILE;
    for (int e = tid; e < SSD_TILE * 16; e += TC_THREADS) {
      const int r = e >> 4, q4 = (e & 15) * 4, j = j0 + r;
      const bool okg = j < Q && i0 + q4 < Q;    // a row of QP floats
      tc_cp16(&Gs[r][q4], GgT + (okg ? (size_t)j * QP + i0 + q4 : 0), okg);
      const bool okx = j < Q && q4 < hd;
      tc_cp16(&Xs[r][q4], x + (okx ? ((t0 + j) * nh + h) * hd + q4 : 0),
              okx);
    }
    tc_commit();
  };
  issue_tile(0, stage0);

  for (int j = tid; j < jmax; j += TC_THREADS) {
    la_s[j] = la[bh * L + (size_t)c * Q + j];
    dt_s[j] = dt[(t0 + j) * nh + h];
  }

  float acc[2][4][4];
  tc_zero(acc);

  // inter-chunk: C_i @ h_in (h_in = 0 in the first chunk)
  if (c > 0) {
    const float* Hg = states + (bh * nc + c) * st * hd;
    auto load = [&](int stage, int k0) {
      for (int e = tid; e < SSD_TILE * 8; e += TC_THREADS) {
        const int r = e >> 3, q4 = (e & 7) * 4, s = k0 + q4;
        const bool ok = i0 + r < Q && s < st;
        tc_cp16(&Cs[stage][r][q4], Cm + (ok ? (t0 + i0 + r) * st + s : 0),
                ok);
      }
      for (int e = tid; e < SSD_KT * 16; e += TC_THREADS) {
        const int k = e >> 4, q4 = (e & 15) * 4, s = k0 + k;
        const bool ok = s < st && q4 < hd;
        tc_cp16(&Hs[stage][k][q4], Hg + (ok ? (size_t)s * hd + q4 : 0), ok);
      }
      tc_commit();
    };
    const int nk = (st + SSD_KT - 1) / SSD_KT;
    load(0, 0);
    for (int kt = 0; kt < nk; ++kt) {
      if (kt + 1 < nk) load((kt + 1) & 1, (kt + 1) * SSD_KT); else tc_commit();
      tc_wait<1>();
      __syncthreads();
      const int sg = kt & 1;
#pragma unroll
      for (int k = 0; k < SSD_KT; k += 8)
        tc_step(acc, [&](int r, int kk) { return Cs[sg][m0 + r][k + kk]; },
                [&](int kk, int n) { return Hs[sg][k + kk][n0 + n]; });
      __syncthreads();
    }
  }
  __syncthreads();                       // la_s / dt_s; stage 1 is free
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int i = i0 + m0 + tc_row(mt, e);
      const float sc = i < Q ? expf(la_s[i]) : 0.f;
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) acc[mt][nt][e] *= sc;
    }

  // intra-chunk: the live tiles tj <= ti
  for (int tj = 0; tj <= ti; ++tj) {
    float* stg = (tj & 1) ? stage1 : stage0;
    if (tj < ti) issue_tile(tj + 1, (tj & 1) ? stage0 : stage1);
    else tc_commit();
    tc_wait<1>();                        // tile tj is here
    __syncthreads();
    float(*At)[TC_LDA] = reinterpret_cast<float(*)[TC_LDA]>(stg);
    float(*Xs)[TC_LDB] =
        reinterpret_cast<float(*)[TC_LDB]>(stg + SSD_TILE * TC_LDA);
    const int j0 = tj * SSD_TILE;
    // att[i][j] in place at [j][i]; a warp's 32 lanes share j (broadcast
    // reads of la_s[j], dt_s[j]), four rows j in flight per thread.  The
    // decay is 2^((la_i - la_j) log2 e): the difference first, exact where
    // it is small, then ex2.approx (~2e-7 relative; the limit is 1e-4).
    const int il = tid & 63, i = i0 + il;
    const float la_i = i < Q ? la_s[i] : 0.f;
#pragma unroll 4
    for (int jl = tid >> 6; jl < SSD_TILE; jl += TC_THREADS / SSD_TILE) {
      const int j = j0 + jl;
      float v = 0.f;
      if (i < Q && j <= i)               // a select, never a multiply
        v = At[jl][il] *
            tc_exp2((la_i - la_s[j]) * 1.4426950408889634f) * dt_s[j];
      At[jl][il] = v;
    }
    __syncthreads();
#pragma unroll
    for (int k = 0; k < SSD_TILE; k += 8)
      tc_step(acc, [&](int r, int kk) { return At[k + kk][m0 + r]; },
              [&](int kk, int n) { return Xs[k + kk][n0 + n]; });
    __syncthreads();                     // the stage may be refilled
  }

  const float Dh = D[h];
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int i = i0 + m0 + tc_row(mt, e), d = n0 + tc_col(nt, e);
        if (i < Q && d < hd) {
          const size_t idx = ((t0 + i) * nh + h) * hd + d;
          y[idx] = acc[mt][nt][e] + x[idx] * Dh;
        }
      }
}

// Scratch (float32, from the caller): la (B,nh,L), states (B,nh,nc,st,hd),
// cb (B,nc,Q,QP) (C B^T, transposed; rows of QP = Q rounded up to 4 floats
// for variant 1, of Q for variant 0).  variant: 0 "cuda_cores" (the four
// float32 CUDA-core kernels), 1 "tf32x3" (tensor cores; hd and st multiples
// of 4 and 16-byte aligned x, Bm, Cm and scratch).  Launches the kernels on
// `stream` in order and returns a cudaError_t (0 = all launched); a
// variant whose conditions fail is refused.
extern "C" int ssd_scan_launch(const float* x, const float* dt,
                               const float* A, const float* Bm,
                               const float* Cm, const float* D, float* y,
                               float* hout, float* la, float* states,
                               float* cb, int B, int L, int nh, int hd,
                               int st, int Q, int variant,
                               cudaStream_t stream) {
  if (B < 1 || B > 65535 || L < 1 || nh < 1 || hd < 1 ||
      hd > SSD_MAX_HEAD || st < 1 || st > SSD_MAX_STATE || Q < 1 ||
      Q > SSD_MAX_CHUNK || L % Q != 0 || variant < 0 || variant > 1)
    return (int)cudaErrorInvalidValue;
  const int nc = L / Q, T = (Q + SSD_TILE - 1) / SSD_TILE;
  const long long blocks_out = (long long)nh * nc * T;
  if (blocks_out > 2147483647LL) return (int)cudaErrorInvalidValue;
  const int parts = (st * hd + SSD_THREADS - 1) / SSD_THREADS;
  cudaError_t e;

  if (variant == 1) {
    const uintptr_t ptrs = reinterpret_cast<uintptr_t>(x) |
                           reinterpret_cast<uintptr_t>(Bm) |
                           reinterpret_cast<uintptr_t>(Cm) |
                           reinterpret_cast<uintptr_t>(states) |
                           reinterpret_cast<uintptr_t>(hout) |
                           reinterpret_cast<uintptr_t>(cb);
    if (hd % 4 || st % 4 || ptrs % 16) return (int)cudaErrorInvalidValue;
    // all of L1 as shared memory, so that several blocks fit on an SM
    for (const void* k : {(const void*)ssd_state_cb_tc_kernel,
                          (const void*)ssd_chunk_out_tc_kernel}) {
      e = cudaFuncSetAttribute(k,
                               cudaFuncAttributePreferredSharedMemoryCarveout,
                               (int)cudaSharedmemCarveoutMaxShared);
      if (e != cudaSuccess) return (int)e;
    }
    const int n_state = nh * nc * ((st + SSD_TILE - 1) / SSD_TILE);
    ssd_state_cb_tc_kernel<<<dim3(n_state + nc * T * (T + 1) / 2, 1, B),
                             TC_THREADS, 0, stream>>>(
        x, dt, A, Bm, Cm, la, states, hout, cb, L, nh, hd, st, Q);
    e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
    if (nc > 1) {           // one chunk: its state is the final state
      ssd_state_pass_kernel<<<dim3(nh * parts, 1, B), SSD_THREADS, 0,
                              stream>>>(la, states, hout, L, nh, hd, st, Q);
      e = cudaGetLastError();
      if (e != cudaSuccess) return (int)e;
    }
    e = cudaFuncSetAttribute(ssd_chunk_out_tc_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)(TC_OUT_SMEM * sizeof(float)));
    if (e != cudaSuccess) return (int)e;
    ssd_chunk_out_tc_kernel<<<dim3((unsigned)blocks_out, 1, B), TC_THREADS,
                              TC_OUT_SMEM * sizeof(float), stream>>>(
        x, dt, Cm, D, la, states, cb, y, L, nh, hd, st, Q);
    return (int)cudaGetLastError();
  }

  ssd_chunk_state_kernel<<<dim3(nh * nc, 1, B), SSD_THREADS, 0, stream>>>(
      x, dt, A, Bm, la, states, L, nh, hd, st, Q);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  ssd_cb_kernel<<<dim3(T * (T + 1) / 2 * nc, 1, B), SSD_THREADS, 0,
                  stream>>>(Bm, Cm, cb, L, st, Q);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  ssd_state_pass_kernel<<<dim3(nh * parts, 1, B), SSD_THREADS, 0, stream>>>(
      la, states, hout, L, nh, hd, st, Q);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  ssd_chunk_out_kernel<<<dim3((unsigned)blocks_out, 1, B), SSD_THREADS, 0,
                         stream>>>(x, dt, Cm, D, la, states, cb, y, L, nh,
                                   hd, st, Q);
  return (int)cudaGetLastError();
}
