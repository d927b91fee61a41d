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
//  * On request (a non-null lse) the combine also writes each row's
//    log-sum-exp, M + log L in natural units, or -inf for a row with no
//    live slot (whose output is 0).  A caller that splits the ring over
//    ranks (flash-decoding across devices) merges the ranks' outputs by it;
//    the sweep is unchanged, and a null lse costs one branch.
//
// Two sweeps, each with its combine; the wrapper picks one by dtype and
// shape (kernels/flash_decode.py:_variant):
//  * "cuda_cores" (flash_decode_split_kernel, the first design above): any
//    dtype and head dims; tiles staged as float32 by 2-byte loads, three
//    block-wide barriers per tile, split = kv_block.
//  * "cp_async" (flash_decode_warp_kernel + fd2_combine_kernel): a bf16
//    cache with hd and hd_v multiples of 8 up to 128, G <= 16 and 16-byte
//    aligned q and cache.  The first design sat at 25x its byte bound (8x
//    slower than SDPA) at the serving shape: scalar loads staged as
//    float32, three block barriers per tile and no load in flight while a
//    tile was computed.  Timestamps (%globaltimer) of a first rewrite
//    showed where the time of a warp goes: not waiting for bytes but its
//    own serial chain of instructions, step after step.  So here
//      - the wrapper picks the split (decode_split) for about 2 blocks per
//        SM, one wave (32 x 8 blocks of 512 slots at 4 slots x 8 kv heads
//        over a 4,096 ring; 256-slot splits, twice the blocks, timed no
//        faster: chip_smoke.py's split_sweep_ms);
//      - each of the 4 warps owns 16-slot steps of the split (warp w takes
//        slots 64 k + 16 w ..) and its own 2-stage ring of bf16 K and V
//        rows in shared memory, filled by 16-byte cp.async (two lanes a
//        row, whole sectors; zero-filled for dead slots, none issued for an
//        all-dead step), the next step's bytes in flight while one is
//        computed; the first step is issued before the live flags exist;
//      - the products run on tensor cores (mma.sync m16n8k16 bf16, the G
//        heads as the 16 rows of A; see the kernel), the softmax in
//        registers in log2 units (ex2.approx), the rescale of the sums
//        skipped when no row's max moved;
//      - no block barrier after the flags: every warp writes its own
//        partial (m, l, acc), and the combine merges a row's partials with
//        its loads independent of one another.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

#define FD_TILE 64
#define FD_THREADS 128
#define FD_ACC 16          // G * hd_v <= FD_THREADS * FD_ACC = 2048
#define FD_NEG_INF (-1e30f)
// the log-sum-exp of a row with no live slot: -inf
#define FD_LSE_NONE (__int_as_float(0xff800000))

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
                            TQ* __restrict__ out, float* __restrict__ lse,
                            int ns, int G, int hdv) {
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
    if (lse != nullptr && i - g * hdv == 0)
      lse[(size_t)bk * G + g] = L > 0.f ? M + logf(L) : FD_LSE_NONE;
  }
}

// ----------------------------------------------------------- "cp_async"

#define FD2_WARPS 4
#define FD2_THREADS (FD2_WARPS * 32)
#define FD2_SLOTS 16          // slots of one warp step
#define FD2_STAGES 2          // ring depth per warp: one step in flight
#define FD2_MAX_G 16          // heads per kv group: the 16 rows of an MMA
#define FD2_MAX_HD 128        // head dims (q fragments, accumulators)
#define FD2_MAX_SPLIT 1024    // live flags of the split in shared memory

__device__ __forceinline__ uint32_t fd2_smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
// 16 bytes global -> shared, asynchronously; !valid writes 16 zero bytes.
__device__ __forceinline__ void fd2_cp16(uint32_t dst, const void* src,
                                         bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(valid ? 16 : 0) : "memory");
}
__device__ __forceinline__ void fd2_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void fd2_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ uint32_t fd2_pack(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}
// x = hi + lo, both bf16 pairs (lo the bf16 of the remainder)
__device__ __forceinline__ void fd2_split2(float x0, float x1, uint32_t& hi,
                                           uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x0, x1);
  const float2 hf = __bfloat1622float2(h);
  hi = *reinterpret_cast<const uint32_t*>(&h);
  lo = fd2_pack(x0 - hf.x, x1 - hf.y);
}
// d (16 x 8, f32) += a (16 x 16, bf16, row) * b (16 x 8, bf16, col)
__device__ __forceinline__ void fd2_mma(float* d, const uint32_t* a,
                                        uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}
__device__ __forceinline__ void fd2_ldm4(uint32_t* r, const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(fd2_smem_addr(p)));
}
__device__ __forceinline__ void fd2_ldm4t(uint32_t* r, const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(fd2_smem_addr(p)));
}
__device__ __forceinline__ void fd2_ldm2t(uint32_t* r, const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0, %1}, [%2];\n"
      : "=r"(r[0]), "=r"(r[1])
      : "r"(fd2_smem_addr(p)));
}

// ex2.approx: 2^x in one MUFU instruction (scores carry log2 e)
__device__ __forceinline__ float fd2_exp2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// Shared memory of flash_decode_warp_kernel, in bytes: the live flags of
// the split (split bytes), then the K/V rings of the warps (rows padded by
// 16 bytes so that ldmatrix hits distinct banks).
static size_t fd2_smem_bytes(int hd, int hdv, int split) {
  return (((size_t)split + 15) / 16) * 16 +
         (size_t)FD2_WARPS * FD2_STAGES * FD2_SLOTS *
             ((hd + 8) + (hdv + 8)) * 2;
}

// The products of a 16-slot step on tensor cores (mma.sync m16n8k16, bf16
// in, f32 sums): the G <= 16 heads of the kv group are the 16 rows of A
// (rows past G are zero), so scores S = Q K^T are two 16 x 8 tiles and
// P V is hd_v / 8 tiles of 16 x 8.  K rows are the "col" B operand as they
// lie (ldmatrix), V rows are read transposed (ldmatrix.trans).  q stays in
// registers as A fragments (float32 q as bf16 hi + lo: two products), and
// P goes from the score accumulators into A fragments without shared
// memory, as bf16 hi + lo (two products), so the sums keep float32-level
// weights.  Masking: p = live ? 2^(s - m) : 0 with s in log2 units; dead
// slots' V rows are zero.  Each warp writes its own partial (m, l, acc):
// the splits of a row are its blocks' warps, merged by fd2_combine_kernel.
// D: the head dims' bound (64, 80 or 128), so loops and registers fit it.
template <typename TQ, int D>
__global__ void __launch_bounds__(FD2_THREADS)
flash_decode_warp_kernel(const TQ* __restrict__ q,
                         const __nv_bfloat16* __restrict__ ck,
                         const __nv_bfloat16* __restrict__ cv,
                         const int* __restrict__ qpos,
                         const int* __restrict__ kpos,
                         float* __restrict__ part, int W, int KV, int G,
                         int hd, int hdv, int window, int split,
                         float scale) {
  constexpr bool kSplitQ = sizeof(TQ) == 4;    // float32 q: hi + lo
  constexpr int KS = (D + 15) / 16;            // 16-deep k steps of q K^T
  constexpr int NT = D / 8;                    // 8-wide tiles of P V
  extern __shared__ __align__(16) unsigned char fd2_smem[];
  const int bk = blockIdx.x, b = bk / KV, kvh = bk % KV;
  const int sp = blockIdx.y;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int c_begin = sp * split, n_slots = min(W, c_begin + split) - c_begin;
  const int qp = qpos[b];
  const int KLD = hd + 8, VLD = hdv + 8;     // rows padded by 16 bytes
  const int stage_elems = FD2_SLOTS * (KLD + VLD);
  const float qscale = scale * 1.4426950408889634f;      // log2 e

  unsigned char* flags = fd2_smem;
  __nv_bfloat16* my_ring =
      reinterpret_cast<__nv_bfloat16*>(fd2_smem + ((split + 15) / 16) * 16) +
      (size_t)warp * FD2_STAGES * stage_elems;
  const int first = warp * FD2_SLOTS;        // warp step k: first + 64 k
  const int nst = n_slots > first
      ? (n_slots - first + FD2_WARPS * FD2_SLOTS - 1) /
            (FD2_WARPS * FD2_SLOTS) : 0;

  // the K rows' padding is read by the last k step when hd % 16 == 8
  for (int r = lane; r < FD2_STAGES * FD2_SLOTS; r += 32)
    *reinterpret_cast<uint4*>(my_ring + (r / FD2_SLOTS) * stage_elems +
                              (r % FD2_SLOTS) * KLD + hd) =
        make_uint4(0u, 0u, 0u, 0u);

  // Loads of a step: lanes 2r and 2r + 1 take row r (slot r of the step),
  // alternate 16-byte chunks, K then V, so each instruction reads 16 whole
  // 32-byte sectors.
  const int lr = lane >> 1, lc = (lane & 1) * 8;
  const size_t kstride = (size_t)KV * hd, vstride = (size_t)KV * hdv;
  const __nv_bfloat16* krow0 = ck + ((size_t)b * W * KV + kvh) * hd + lc;
  const __nv_bfloat16* vrow0 = cv + ((size_t)b * W * KV + kvh) * hdv + lc;
  // live slots of step k as a 16-bit mask (the same in every lane)
  auto step_mask = [&](int k) -> unsigned {
    const int rel = first + k * FD2_WARPS * FD2_SLOTS + (lane & 15);
    const bool live = rel < n_slots && flags[rel];
    return __ballot_sync(0xffffffffu, live) & 0xffffu;
  };
  // rows of step k: the live ones, or (blind: before the flags exist)
  // every one in range; the rest are zero-filled
  // (returns the live mask of step k, 0 when blind or past the end)
  auto issue = [&](int k, bool blind) -> unsigned {
    unsigned mask = 0, live = 0;
    if (k < nst) {
      const int rel0 = first + k * FD2_WARPS * FD2_SLOTS;
      if (blind) {
        mask = n_slots - rel0 >= 16 ? 0xffffu
                                    : (1u << (n_slots - rel0)) - 1u;
      } else {
        mask = step_mask(k);
        live = mask;
      }
      if (mask) {
        const bool valid = (mask >> lr) & 1u;
        const size_t c = (size_t)(c_begin + rel0 + lr);
        const __nv_bfloat16* ks = valid ? krow0 + c * kstride : ck;
        const __nv_bfloat16* vs = valid ? vrow0 + c * vstride : ck;
        __nv_bfloat16* st = my_ring + (k % FD2_STAGES) * stage_elems;
        const uint32_t kd = fd2_smem_addr(st + lr * KLD + lc);
        const uint32_t vd = fd2_smem_addr(st + FD2_SLOTS * KLD + lr * VLD + lc);
#pragma unroll
        for (int c8 = 0; c8 < D / 16; ++c8) {
          if (2 * c8 * 8 + lc < hd)
            fd2_cp16(kd + 32 * c8, ks + (valid ? 16 * c8 : 0), valid);
          if (2 * c8 * 8 + lc < hdv)
            fd2_cp16(vd + 32 * c8, vs + (valid ? 16 * c8 : 0), valid);
        }
      }
    }
    fd2_commit();                            // one group per step, always
    return live;
  };

  // start the first steps' loads before the flags are known: the latency
  // of the kpos and q reads then overlaps theirs
#pragma unroll
  for (int k = 0; k < FD2_STAGES - 1; ++k) issue(k, true);

  // q as A fragments: a0 (row g, k 2t), a1 (g + 8, 2t), a2 (g, 2t + 8),
  // a3 (g + 8, 2t + 8), per 16-deep k step; rows past G and dims past hd 0
  uint32_t qa[KS][4], ql[kSplitQ ? KS : 1][4];
  const TQ* qb = q + (size_t)bk * G * hd;
#pragma unroll
  for (int ks = 0; ks < KS; ++ks)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int row = g + 8 * (e & 1), d = 16 * ks + 2 * t + 8 * (e >> 1);
      const bool in = row < G && d < hd;
      if (kSplitQ) {
        const float2 v = in ? *reinterpret_cast<const float2*>(
                                  qb + row * hd + d) : make_float2(0.f, 0.f);
        fd2_split2(v.x, v.y, qa[ks][e], ql[kSplitQ ? ks : 0][e]);
      } else {
        qa[ks][e] = in ? *reinterpret_cast<const uint32_t*>(qb + row * hd + d)
                       : 0u;
      }
    }

  // live flags of the split, all loads in flight at once
#pragma unroll
  for (int u = 0; u < FD2_MAX_SPLIT / FD2_THREADS; ++u) {
    const int i = tid + u * FD2_THREADS;
    if (i < n_slots) {
      const int kp = kpos[(size_t)b * W + c_begin + i];
      flags[i] = kp <= qp && (window == 0 || qp - kp < window);
    }
  }
  __syncthreads();

  float m[2] = {FD_NEG_INF, FD_NEG_INF}, l[2] = {0.f, 0.f};
  float acc[NT][4];
#pragma unroll
  for (int n = 0; n < NT; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;
  // ldmatrix row of this lane: K (x4: slots 0-7 / 8-15, dims +0 / +8) and
  // V (x4.trans: slots 0-7 / 8-15, dims +0 / +8)
  const int k_slot = ((lane >> 4) << 3) + (lane & 7);
  const int k_col = ((lane >> 3) & 1) * 8;
  const int v_slot = (((lane >> 3) & 1) << 3) + (lane & 7);
  const int v_col = (lane >> 4) * 8;

  unsigned masks[FD2_STAGES];               // live masks of steps in flight
#pragma unroll
  for (int k = 0; k < FD2_STAGES; ++k)
    masks[k] = k < FD2_STAGES - 1 ? step_mask(k) : 0u;
  for (int k = 0; k < nst; ++k) {
    const unsigned next = issue(k + FD2_STAGES - 1, false);
    fd2_wait<FD2_STAGES - 1>();              // step k's copies are done
    __syncwarp();
    masks[FD2_STAGES - 1] = next;            // masks[j]: step k + j
    const unsigned mask = masks[0];
#pragma unroll
    for (int j = 0; j + 1 < FD2_STAGES; ++j) masks[j] = masks[j + 1];
    const __nv_bfloat16* Ks = my_ring + (k % FD2_STAGES) * stage_elems;
    const __nv_bfloat16* Vs = Ks + FD2_SLOTS * KLD;
    if (mask && k < FD2_STAGES - 1 && mask != 0xffffu) {
      // a blind step: zero the V rows of its dead slots
      __nv_bfloat16* Vz = const_cast<__nv_bfloat16*>(Vs);
      if (!((mask >> lr) & 1u))
        for (int c8 = lc; c8 < hdv; c8 += 16)
          *reinterpret_cast<uint4*>(Vz + lr * VLD + c8) =
              make_uint4(0u, 0u, 0u, 0u);
      __syncwarp();
    }
    if (mask) {
      // two sets of sums (even / odd k steps) halve the MMA chain
      float sc[2][4], s2[2][4];
#pragma unroll
      for (int n = 0; n < 2; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) sc[n][e] = s2[n][e] = 0.f;
#pragma unroll
      for (int ks = 0; ks < KS; ++ks) {
        if (16 * ks < hd) {
          uint32_t kb[4];
          fd2_ldm4(kb, Ks + k_slot * KLD + 16 * ks + k_col);
          float(*acc_s)[4] = (ks & 1) ? s2 : sc;
          fd2_mma(acc_s[0], qa[ks], kb[0], kb[1]);
          fd2_mma(acc_s[1], qa[ks], kb[2], kb[3]);
          if (kSplitQ) {
            fd2_mma(acc_s[0], ql[kSplitQ ? ks : 0], kb[0], kb[1]);
            fd2_mma(acc_s[1], ql[kSplitQ ? ks : 0], kb[2], kb[3]);
          }
        }
      }
#pragma unroll
      for (int n = 0; n < 2; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) sc[n][e] += s2[n][e];
      // online softmax in log2 units; this lane holds rows g (e < 2) and
      // g + 8 (e >= 2) at slots 8 n + 2 t + (e & 1); with G <= 8 the rows
      // g + 8 are padding: p = 0 there, no softmax
      float corr[2] = {1.f, 1.f};
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        if (r == 1 && G <= 8) {
#pragma unroll
          for (int n = 0; n < 2; ++n) sc[n][2] = sc[n][3] = 0.f;
          break;
        }
        float mt = FD_NEG_INF;
#pragma unroll
        for (int n = 0; n < 2; ++n)
#pragma unroll
          for (int u = 0; u < 2; ++u) {
            const bool live = (mask >> (8 * n + 2 * t + u)) & 1u;
            const float v = live ? sc[n][2 * r + u] * qscale : FD_NEG_INF;
            sc[n][2 * r + u] = v;
            mt = fmaxf(mt, v);
          }
        mt = fmaxf(mt, __shfl_xor_sync(0xffffffffu, mt, 1));
        mt = fmaxf(mt, __shfl_xor_sync(0xffffffffu, mt, 2));
        const float m_new = fmaxf(m[r], mt);
        float sum = 0.f;
#pragma unroll
        for (int n = 0; n < 2; ++n)
#pragma unroll
          for (int u = 0; u < 2; ++u) {
            const bool live = (mask >> (8 * n + 2 * t + u)) & 1u;
            const float p = live ? fd2_exp2(sc[n][2 * r + u] - m_new) : 0.f;
            sc[n][2 * r + u] = p;
            sum += p;
          }
        sum += __shfl_xor_sync(0xffffffffu, sum, 1);
        sum += __shfl_xor_sync(0xffffffffu, sum, 2);
        corr[r] = fd2_exp2(fminf(m[r] - m_new, 0.f));
        l[r] = l[r] * corr[r] + sum;
        m[r] = m_new;
      }
      // P as A fragments (k = slot): a0 (g, 2t), a1 (g + 8, 2t), a2 (g,
      // 2t + 8), a3 (g + 8, 2t + 8), each as bf16 hi + lo
      uint32_t ph[4], pl[4];
      fd2_split2(sc[0][0], sc[0][1], ph[0], pl[0]);
      fd2_split2(sc[0][2], sc[0][3], ph[1], pl[1]);
      fd2_split2(sc[1][0], sc[1][1], ph[2], pl[2]);
      fd2_split2(sc[1][2], sc[1][3], ph[3], pl[3]);
      if (__any_sync(0xffffffffu, corr[0] != 1.f || corr[1] != 1.f)) {
#pragma unroll
        for (int n = 0; n < NT; ++n) {
          acc[n][0] *= corr[0];
          acc[n][1] *= corr[0];
          acc[n][2] *= corr[1];
          acc[n][3] *= corr[1];
        }
      }
#pragma unroll
      for (int n2 = 0; n2 < NT / 2; ++n2) {
        const int d0 = 16 * n2;
        if (d0 + 8 < hdv) {                  // two 8-wide tiles
          uint32_t vb[4];
          fd2_ldm4t(vb, Vs + v_slot * VLD + d0 + v_col);
          fd2_mma(acc[2 * n2], pl, vb[0], vb[1]);
          fd2_mma(acc[2 * n2], ph, vb[0], vb[1]);
          fd2_mma(acc[2 * n2 + 1], pl, vb[2], vb[3]);
          fd2_mma(acc[2 * n2 + 1], ph, vb[2], vb[3]);
        } else if (d0 < hdv) {               // the last, odd tile
          uint32_t vb[2];
          fd2_ldm2t(vb, Vs + v_slot * VLD + d0);
          fd2_mma(acc[2 * n2], pl, vb[0], vb[1]);
          fd2_mma(acc[2 * n2], ph, vb[0], vb[1]);
        }
      }
    }
    __syncwarp();                            // the ring slot is free again
  }
  fd2_wait<0>();

  // this warp's partial: m, l (log2 units) and acc of rows g, g + 8 < G
  const int parts = gridDim.y * FD2_WARPS;
  float* pm = part + ((size_t)bk * parts + sp * FD2_WARPS + warp) * G *
                         (hdv + 2);
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = g + 8 * r;
    if (row < G) {
      if (t == 0) {
        pm[row] = m[r];
        pm[G + row] = l[r];
      }
      float* ar = pm + 2 * G + row * hdv;
#pragma unroll
      for (int n = 0; n < NT; ++n) {
        const int d = 8 * n + 2 * t;
        if (d < hdv)
          *reinterpret_cast<float2*>(ar + d) =
              make_float2(acc[n][2 * r], acc[n][2 * r + 1]);
      }
    }
  }
}

// Merge of the cp_async sweep's partials (one per warp of each block; m in
// log2 units): grid (B * KV, ceil(G * hd_v / 32)), 128 threads.  The m and
// l of all partials of the row come into shared memory at once; warp w
// turns those of heads w, w + 4, .. into weights w_s = 2^(m_s - M) /
// max(L, 1e-30) (lanes over the partials, shuffle reductions); then thread
// (grp, o) sums output o over partials grp, grp + 4, .. and the four sums
// are added in shared memory.
template <typename TQ>
__global__ void __launch_bounds__(FD2_THREADS)
fd2_combine_kernel(const float* __restrict__ part, TQ* __restrict__ out,
                   float* __restrict__ lse, int ns, int G, int hdv) {
  extern __shared__ float fd2_w[];           // [G][ns] m, then weights
  float* lw = fd2_w + G * ns;                // [G][ns] l
  __shared__ float red[4][32];
  const int bk = blockIdx.x, tid = threadIdx.x, lane = tid & 31;
  const int warp = tid >> 5;
  const size_t stride = (size_t)G * (hdv + 2);
  const float* p0 = part + (size_t)bk * ns * stride;
  for (int idx = tid; idx < G * ns; idx += FD2_THREADS) {
    const int g = idx / ns, sp = idx - g * ns;
    fd2_w[idx] = p0[sp * stride + g];
    lw[idx] = p0[sp * stride + G + g];
  }
  // this thread's output o and its group of partials grp, grp + 4, ..;
  // the first 8 of its values load while the weights form
  const int o = blockIdx.y * 32 + lane, grp = warp;
  const bool has_o = o < G * hdv;
  const float* ap = p0 + 2 * G + o;
  float pre[8];
#pragma unroll
  for (int u = 0; u < 8; ++u) {
    const int sp = grp + 4 * u;
    pre[u] = has_o && sp < ns ? ap[sp * stride] : 0.f;
  }
  __syncthreads();
  for (int g = warp; g < G; g += 4) {
    float* wg = fd2_w + g * ns;
    const float* lg = lw + g * ns;
    float M = FD_NEG_INF;
    for (int sp = lane; sp < ns; sp += 32) M = fmaxf(M, wg[sp]);
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      M = fmaxf(M, __shfl_xor_sync(0xffffffffu, M, off));
    float L = 0.f;
    for (int sp = lane; sp < ns; sp += 32) {
      const float e = fd2_exp2(fminf(wg[sp] - M, 0.f));
      wg[sp] = e;
      L += lg[sp] * e;
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      L += __shfl_xor_sync(0xffffffffu, L, off);
    const float inv = 1.f / fmaxf(L, 1e-30f);
    for (int sp = lane; sp < ns; sp += 32) wg[sp] *= inv;
    // the row's log-sum-exp in natural units (m is in log2 units)
    if (lse != nullptr && blockIdx.y == 0 && lane == 0)
      lse[(size_t)bk * G + g] =
          L > 0.f ? (M + log2f(L)) * 0.6931471805599453f : FD_LSE_NONE;
  }
  __syncthreads();
  float a = 0.f;
  if (has_o) {
    const float* wg = fd2_w + (o / hdv) * ns;
#pragma unroll
    for (int u = 0; u < 8; ++u) {
      const int sp = grp + 4 * u;
      if (sp < ns) a += wg[sp] * pre[u];
    }
#pragma unroll 8
    for (int sp = grp + 32; sp < ns; sp += 4) a += wg[sp] * ap[sp * stride];
  }
  red[grp][lane] = a;
  __syncthreads();
  if (grp == 0 && has_o)
    fd_store(out + (size_t)bk * G * hdv + o,
             red[0][lane] + red[1][lane] + red[2][lane] + red[3][lane]);
}

template <typename TQ, int D>
static int launch_warp_t(const void* q, const void* ck, const void* cv,
                         const int* qpos, const int* kpos, float* part,
                         void* out, float* lse, int B, int W, int KV, int G,
                         int hd, int hdv, int window, int split, float scale,
                         cudaStream_t stream) {
  const int ns = (W + split - 1) / split;
  const size_t smem = fd2_smem_bytes(hd, hdv, split);
  cudaError_t e = cudaFuncSetAttribute(
      flash_decode_warp_kernel<TQ, D>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  // all of L1 as shared memory, so that several blocks fit on an SM
  e = cudaFuncSetAttribute(flash_decode_warp_kernel<TQ, D>,
                           cudaFuncAttributePreferredSharedMemoryCarveout,
                           (int)cudaSharedmemCarveoutMaxShared);
  if (e != cudaSuccess) return (int)e;
  flash_decode_warp_kernel<TQ, D><<<dim3(B * KV, ns), FD2_THREADS, smem,
                                    stream>>>(
      (const TQ*)q, (const __nv_bfloat16*)ck, (const __nv_bfloat16*)cv, qpos,
      kpos, part, W, KV, G, hd, hdv, window, split, scale);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  const int parts = ns * FD2_WARPS;          // one partial per warp
  const size_t csmem = 2 * sizeof(float) * (size_t)G * parts;
  e = cudaFuncSetAttribute(fd2_combine_kernel<TQ>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           (int)csmem);
  if (e != cudaSuccess) return (int)e;
  fd2_combine_kernel<TQ><<<dim3(B * KV, (G * hdv + 31) / 32), FD2_THREADS,
                           csmem, stream>>>(part, (TQ*)out, lse, parts, G,
                                            hdv);
  return (int)cudaGetLastError();
}

template <typename TQ>
static int launch_warp_d(const void* q, const void* ck, const void* cv,
                         const int* qpos, const int* kpos, float* part,
                         void* out, float* lse, int B, int W, int KV, int G,
                         int hd, int hdv, int window, int split, float scale,
                         cudaStream_t stream) {
  const int d = hd > hdv ? hd : hdv;
  if (d <= 64)
    return launch_warp_t<TQ, 64>(q, ck, cv, qpos, kpos, part, out, lse, B, W,
                                 KV, G, hd, hdv, window, split, scale,
                                 stream);
  if (d <= 80)
    return launch_warp_t<TQ, 80>(q, ck, cv, qpos, kpos, part, out, lse, B, W,
                                 KV, G, hd, hdv, window, split, scale,
                                 stream);
  return launch_warp_t<TQ, 128>(q, ck, cv, qpos, kpos, part, out, lse, B, W,
                                KV, G, hd, hdv, window, split, scale, stream);
}

template <typename TQ, typename TC>
static int launch_t(const void* q, const void* ck, const void* cv,
                    const int* qpos, const int* kpos, float* part, void* out,
                    float* lse, int B, int W, int KV, int G, int hd, int hdv,
                    int window, int split, float scale, cudaStream_t stream) {
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
      part, (TQ*)out, lse, ns, G, hdv);
  return (int)cudaGetLastError();
}

// qdtype / cdtype: 0 float32, 1 bfloat16 (q and out / the cache); variant:
// 0 "cuda_cores" (flash_decode_split_kernel), 1 "cp_async"
// (flash_decode_warp_kernel: bf16 cache, hd and hd_v multiples of 8 up to
// 128, G <= 16, split <= 1024, 16-byte aligned q and cache).  part: float32
// scratch of B * KV * ceil(W / split) * G * (hd_v + 2), times 4 (a partial
// per warp) for variant 1.  lse: float32 (B, KV, G), each row's
// log-sum-exp of its scaled live scores in natural units (-inf for a row
// with no live slot), or null when the caller does not want it; both
// combines write it.  Returns a cudaError_t (0 = both kernels launched); a
// variant whose conditions fail is refused.
extern "C" int flash_decode_launch(const void* q, const void* ck,
                                   const void* cv, const int* qpos,
                                   const int* kpos, float* part, void* out,
                                   float* lse, int B, int W, int KV, int G,
                                   int hd, int hdv, int window, int split,
                                   float scale, int qdtype, int cdtype,
                                   int variant, cudaStream_t stream) {
  if (hd < 1 || hd > 256 || hdv < 1 || hdv > 256 ||
      G * hdv > FD_THREADS * FD_ACC || split < 1 || qdtype < 0 ||
      qdtype > 1 || cdtype < 0 || cdtype > 1 || variant < 0 || variant > 1)
    return (int)cudaErrorInvalidValue;
  if (variant == 1) {
    if (cdtype != 1 || hd % 8 || hdv % 8 || hd > FD2_MAX_HD ||
        hdv > FD2_MAX_HD || G > FD2_MAX_G ||
        split > FD2_MAX_SPLIT ||
        (reinterpret_cast<uintptr_t>(q) | reinterpret_cast<uintptr_t>(ck) |
         reinterpret_cast<uintptr_t>(cv)) % 16)
      return (int)cudaErrorInvalidValue;
    if (qdtype == 0)
      return launch_warp_d<float>(q, ck, cv, qpos, kpos, part, out, lse, B, W,
                                  KV, G, hd, hdv, window, split, scale,
                                  stream);
    return launch_warp_d<__nv_bfloat16>(q, ck, cv, qpos, kpos, part, out, lse,
                                        B, W, KV, G, hd, hdv, window, split,
                                        scale, stream);
  }
  if (qdtype == 0 && cdtype == 0)
    return launch_t<float, float>(q, ck, cv, qpos, kpos, part, out, lse, B, W,
                                  KV, G, hd, hdv, window, split, scale,
                                  stream);
  if (qdtype == 0)
    return launch_t<float, __nv_bfloat16>(q, ck, cv, qpos, kpos, part, out,
                                          lse, B, W, KV, G, hd, hdv, window,
                                          split, scale, stream);
  if (cdtype == 0)
    return launch_t<__nv_bfloat16, float>(q, ck, cv, qpos, kpos, part, out,
                                          lse, B, W, KV, G, hd, hdv, window,
                                          split, scale, stream);
  return launch_t<__nv_bfloat16, __nv_bfloat16>(q, ck, cv, qpos, kpos, part,
                                                out, lse, B, W, KV, G, hd,
                                                hdv, window, split, scale,
                                                stream);
}
