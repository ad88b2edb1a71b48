// Mamba2 SSD chunked scan for Hopper (sm_90a).
//
// Plain C entry point, loaded with ctypes by
// repro_torch/kernels/ssd_scan/kernel.py. It takes device pointers, the
// sizes, three scratch buffers and the caller's CUDA stream, launches on
// that stream without synchronising, allocates nothing, and returns
// cudaGetLastError() after each launch so a refused launch is reported
// at once.
//
// Replaces the Pallas kernel _ssd_kernel of
// repro/kernels/ssd_scan/kernel.py (ssd_scan_kernel). Per (batch, head)
// and chunk of Q steps, with cum the inclusive prefix sum of dt * a:
//   y     = (C B^T * exp(cum_t - cum_s) * dt_s, s <= t) X
//         + exp(cum) * (C state^T) + d * X
//   state = exp(cum_last) * state + (w * X)^T B,  w = dt * exp(cum_last - cum)
// and the (P, N) fp32 state after the last chunk is the final state.
// Head h reads B and C of group h / (H / G).
//
// Bound: Q (Q + 1) (N + P) FLOP per chunk and head for the causal
// (s <= t) half of the Q x Q products, the only half computed here, plus
// 4 Q N P for C state^T and the state update, against x, dt and y per
// head and B, C per group; at the zamba2 prefill shape (B 2, S 4096,
// H 64, G 1, P = N = 64, Q 128) that is 17.2 GFLOP of fp32 work,
// 0.257 ms at 67 TFLOP/s, above the 0.08 ms its bytes need.
//
// Design: the TPU's sequential chunk axis becomes four launches, the
// decomposition of ref.ssd_reference, with the chunks in parallel:
//   1. ssd_scan_kernel_chunk_state, one block per (chunk, head, batch),
//      4096 at the zamba2 shape: cum, the chunk's cum_last, and its
//      local state (w * B)^T X, written as (N, P) to scratch.
//   2. ssd_scan_kernel_bc_transpose, one block per (chunk, group,
//      batch): B and C of the chunk transposed to fp32 (N, Q) once per
//      group, not once per head, so that phase 4 stages them with
//      cp.async.
//   3. ssd_scan_kernel_state_pass, V state elements a thread per
//      (batch, head): the scan over chunks, with the loads of 8 chunks
//      in flight; each chunk's slot of the scratch becomes the state
//      that enters it, and the final state is written.
//   4. ssd_scan_kernel_chunk_out, one block per (chunk, head, batch):
//      y = exp(cum) C state_in^T + (masked C B^T) X + d x, written once.
// Blocks take the heads of one chunk together, so that neighbouring
// blocks read neighbouring heads of the same steps. Every product is a
// 4 x 4 register tile per thread from operands kept k-major in shared
// memory, read as float4: 2 shared loads per 16 FMAs (0.125 a FMA) in
// (w B)^T X, C state^T, B C^T and mm X; a warp's tiles are 4 x 8, so
// its loads fall on 4 and 8 consecutive 16-byte words, and the rows of
// C^T and B^T are padded by 4 floats. Phase 4 computes the causal
// tiles of mm^T only (528 of 1024 at Q 128), in one pass, into a
// compact triangular layout; each thread's two y tiles pair row-tile r
// with row-tile Q/4 - 1 - r, so every thread does the same causal work.
// Shared memory per block at Q 128, P = N = 64: 66.5 KB in phase 1 and
// 100 KB in phase 4 (C^T; B^T, then x in its place; the incoming state,
// then mm^T in its place), so two blocks fit on an SM. Phase 4 keeps
// y in registers, 2 tiles a thread (Q P <= 8192); a longer chunk is
// refused, as is one whose buffers exceed the card's shared memory.
// Sizes that are not multiples of 4 take the same code with 1 x 1
// tiles and scalar loads.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxYTile = 2 * 16;  // y outputs a thread keeps: 2 tiles of 4 x 4
constexpr float kLog2e = 1.4426950408889634f;

// 2^x on the special-function unit (2 ulp).
__device__ __forceinline__ float fast_exp2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}
__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src));
}
__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

template <int V>
__device__ __forceinline__ void lds(float* dst, const float* src) {
  if constexpr (V == 4) {
    const float4 x = *reinterpret_cast<const float4*>(src);
    dst[0] = x.x; dst[1] = x.y; dst[2] = x.z; dst[3] = x.w;
  } else {
    dst[0] = *src;
  }
}

// acc[i][j] += sum_k A[k][i] * Bm[k][j] for k in [0, kn): the V x V tile
// of a product whose operands lie k-major in shared memory (row strides
// lda, ldb): 2 loads per V * V FMAs.
template <int V>
__device__ __forceinline__ void tile_mma(float (*acc)[V], const float* A,
                                         int lda, const float* Bm, int ldb,
                                         int kn) {
#pragma unroll 4
  for (int kk = 0; kk < kn; ++kk) {
    float a[V], b[V];
    lds<V>(a, A + kk * lda);
    lds<V>(b, Bm + kk * ldb);
#pragma unroll
    for (int i = 0; i < V; ++i)
#pragma unroll
      for (int j = 0; j < V; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
  }
}

// The (row, column) of tile t in an mt x nt grid of tiles. Where the
// grid allows, a warp's 32 tiles are 4 rows by 8 columns, so its A reads
// touch 4 and its B reads 8 consecutive 16-byte words of a k-row.
__device__ __forceinline__ void tile_at(int t, int mt, int nt, int* r,
                                        int* c) {
  if (mt % 4 == 0 && nt % 8 == 0) {
    const int w = t / 32, l = t % 32, wn = nt / 8;
    *r = (w / wn) * 4 + l / 8;
    *c = (w % wn) * 8 + l % 8;
  } else {
    *r = t / nt;
    *c = t % nt;
  }
}

// rows x cols of a row-major matrix (row stride `stride`) into shared
// memory as fp32 with row stride ld: fp32 by cp.async (16 bytes where
// V == 4), bf16 widened through registers.
template <int V, typename T>
__device__ __forceinline__ void stage(float* dst, int ld, const T* src,
                                      size_t stride, int rows, int cols) {
  const int per = cols / V;
  for (int i = threadIdx.x; i < rows * per; i += kThreads) {
    const int r = i / per, c = (i % per) * V;
    const T* sp = src + r * stride + c;
    float* dp = dst + r * ld + c;
    if constexpr (sizeof(T) == 4) {
      if constexpr (V == 4) cp_async16(dp, sp); else cp_async4(dp, sp);
    } else {
#pragma unroll
      for (int e = 0; e < V; ++e) dp[e] = to_float(sp[e]);
    }
  }
}

// dts[t] = dt, cum[t] = inclusive prefix sum of dt * a over the chunk
// (warp 0 scans; each lane owns a contiguous run of steps). Ends with a
// barrier after which every cp.async of the calling thread has landed.
__device__ __forceinline__ void chunk_cum(float* dts, float* cum,
                                          const float* __restrict__ dt,
                                          size_t dt0, int H, int Q,
                                          float ah) {
  for (int t = threadIdx.x; t < Q; t += kThreads)
    dts[t] = dt[dt0 + (size_t)t * H];
  cp_async_wait<0>();
  __syncthreads();
  if (threadIdx.x < 32) {
    const int lane = threadIdx.x;
    const int per = (Q + 31) / 32;
    const int lo = min(Q, lane * per), hi = min(Q, lo + per);
    float run = 0.f;
    for (int t = lo; t < hi; ++t) {
      run += dts[t] * ah;
      cum[t] = run;
    }
    float incl = run;
    for (int off = 1; off < 32; off <<= 1) {
      const float o = __shfl_up_sync(0xffffffffu, incl, off);
      if (lane >= off) incl += o;
    }
    const float before = incl - run;
    for (int t = lo; t < hi; ++t) cum[t] += before;
  }
  __syncthreads();
}

// Phase 1. Grid (S / Q * H, B). x: (B, S, H, P); dt: (B, S, H); a: (H,);
// bm: (B, S, G, N). Writes states[b][h][chunk] = (w * B)^T X as (N, P)
// and totals[b][h][chunk] = cum_last.
template <typename T, int V>
__global__ void __launch_bounds__(kThreads)
ssd_scan_kernel_chunk_state(const T* __restrict__ x,
                            const float* __restrict__ dt,
                            const float* __restrict__ a,
                            const T* __restrict__ bm,
                            float* __restrict__ states,
                            float* __restrict__ totals, int S, int H, int G,
                            int P, int N, int Q) {
  // Heads vary fastest, so blocks running together read neighbouring
  // heads of the same steps.
  const int h = blockIdx.x % H, ck = blockIdx.x / H, b = blockIdx.y;
  const int K = gridDim.x / H, grp = h / (H / G);
  const int t0 = ck * Q;
  extern __shared__ __align__(16) float smem[];
  float* xs = smem;             // Q x P
  float* bs = xs + Q * P;       // Q x N, scaled by w
  float* dts = bs + Q * N;      // Q
  float* cum = dts + Q;         // Q

  stage<V>(xs, P, x + (((size_t)b * S + t0) * H + h) * P, (size_t)H * P, Q,
           P);
  stage<V>(bs, N, bm + (((size_t)b * S + t0) * G + grp) * N, (size_t)G * N,
           Q, N);
  cp_async_commit();
  chunk_cum(dts, cum, dt, (size_t)b * S * H + (size_t)t0 * H + h, H, Q,
            a[h]);
  const float total = cum[Q - 1];
  for (int i = threadIdx.x; i < Q * N; i += kThreads) {
    const int s = i / N;
    bs[i] *= dts[s] * expf(total - cum[s]);
  }
  __syncthreads();

  float* out = states + (((size_t)b * H + h) * K + ck) * N * P;
  const int tn = N / V, tp = P / V;
  for (int tile = threadIdx.x; tile < tn * tp; tile += kThreads) {
    int rn, cp;
    tile_at(tile, tn, tp, &rn, &cp);
    const int n0 = rn * V, p0 = cp * V;
    float acc[V][V] = {};
    tile_mma<V>(acc, bs + n0, N, xs + p0, P, Q);
#pragma unroll
    for (int i = 0; i < V; ++i) {
      float* dst = out + (n0 + i) * P + p0;
      if constexpr (V == 4)
        *reinterpret_cast<float4*>(dst) =
            make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]);
      else
        dst[0] = acc[i][0];
    }
  }
  if (threadIdx.x == 0) totals[((size_t)b * H + h) * K + ck] = total;
}

// Phase 3. One thread per V state elements of a (batch, head): grid
// (ceil(N P / (256 V)), H, B). Each chunk's slot of states becomes the
// state entering that chunk; fstate (B, H, P, N) gets the final state.
// The loads of 8 chunks are issued before their chain of updates.
template <int V>
__global__ void __launch_bounds__(kThreads)
ssd_scan_kernel_state_pass(float* __restrict__ states,
                           const float* __restrict__ totals,
                           float* __restrict__ fstate, int H, int P, int N,
                           int K) {
  constexpr int kBatch = 8;
  const int e0 = (blockIdx.x * kThreads + threadIdx.x) * V;
  const int h = blockIdx.y, b = blockIdx.z;
  if (e0 >= N * P) return;
  const size_t bh = (size_t)b * H + h, slot = (size_t)N * P;
  float* st = states + bh * K * slot + e0;
  const float* tot = totals + bh * K;
  float run[V] = {};
  for (int k0 = 0; k0 < K; k0 += kBatch) {
    float local[kBatch][V], decay[kBatch];
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      if (k0 + u >= K) break;
      lds<V>(local[u], st + (k0 + u) * slot);
      decay[u] = expf(tot[k0 + u]);
    }
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      if (k0 + u >= K) break;
      float* dst = st + (k0 + u) * slot;
      if constexpr (V == 4)
        *reinterpret_cast<float4*>(dst) =
            make_float4(run[0], run[1], run[2], run[3]);
      else
        dst[0] = run[0];
#pragma unroll
      for (int e = 0; e < V; ++e) run[e] = run[e] * decay[u] + local[u][e];
    }
  }
#pragma unroll
  for (int e = 0; e < V; ++e) {
    const int n = (e0 + e) / P, p = (e0 + e) % P;
    fstate[bh * slot + (size_t)p * N + n] = run[e];
  }
}

// Phase 2. Once per (chunk, group, batch): grid (S / Q, G, B). B and
// C of the chunk, (Q, N) rows of bm, cm (B, S, G, N), transposed to
// fp32 (N, Q) in bct: (2, B, G, S / Q, N, Q), B first, through a padded
// 32 x 32 tile so that reads and writes are both coalesced.
template <typename T>
__global__ void __launch_bounds__(kThreads)
ssd_scan_kernel_bc_transpose(const T* __restrict__ bm,
                             const T* __restrict__ cm,
                             float* __restrict__ bct, int B, int S, int G,
                             int N, int Q) {
  __shared__ float tile[32][33];
  const int ck = blockIdx.x, g = blockIdx.y, b = blockIdx.z;
  const int K = gridDim.x, tx = threadIdx.x % 32, ty = threadIdx.x / 32;
  for (int which = 0; which < 2; ++which) {
    const T* src = (which ? cm : bm) + (((size_t)b * S + ck * Q) * G + g) * N;
    float* dst = bct + (size_t)which * B * G * S * N +
                 (((size_t)b * G + g) * K + ck) * N * Q;
    for (int s0 = 0; s0 < Q; s0 += 32)
      for (int n0 = 0; n0 < N; n0 += 32) {
        for (int r = ty; r < 32; r += kThreads / 32) {
          const int s = s0 + r, n = n0 + tx;
          tile[r][tx] =
              s < Q && n < N ? to_float(src[(size_t)s * G * N + n]) : 0.f;
        }
        __syncthreads();
        for (int r = ty; r < 32; r += kThreads / 32) {
          const int n = n0 + r, s = s0 + tx;
          if (n < N && s < Q) dst[(size_t)n * Q + s] = tile[tx][r];
        }
        __syncthreads();
      }
  }
}

// Row stride of C^T and B^T in shared memory: 4 floats of padding keep
// rows 16-byte aligned and move each row's banks by 4.
__host__ __device__ __forceinline__ int padded(int rows, int V) {
  return V == 4 ? rows + 4 : rows;
}

// Where row s of the masked matrix mm^T starts in its compact
// triangular layout: row s holds t = V (s / V) .. Q - 1, so each row
// keeps whole V-wide tiles and stays 16-byte aligned.
__host__ __device__ __forceinline__ int tri_row(int s, int Q, int V) {
  const int a = s / V, r = s % V;
  return V * (a * Q - V * a * (a - 1) / 2) + r * (Q - V * a);
}

// y tile u of this thread (q0, p0), false if it has none. Tiles pair
// row-tile r with row-tile mq - 1 - r, so that every thread's causal
// work, (r + 1) + (mq - r) row-tiles of steps, is the same.
template <int V>
__device__ __forceinline__ bool y_tile(int u, int mq, int tp, int* q0,
                                       int* p0) {
  const int mh = (mq + 1) / 2;
  const int idx = threadIdx.x + (u / 2) * kThreads;
  if (idx >= mh * tp) return false;
  int r, c;
  tile_at(idx, mh, tp, &r, &c);
  if (u & 1) {
    if (mq - 1 - r == r) return false;
    r = mq - 1 - r;
  }
  *q0 = r * V;
  *p0 = c * V;
  return true;
}

// Slots of the causal (s-tile <= t-tile) tiles of mm^T for the threads
// of a block, and the tile of slot i (false for an idle slot). Where
// mq % 8 == 0 a warp takes 4 s-tiles x 8 t-tiles, the blocks of 4 x 8
// that hold a causal tile, in s-major order; else one tile a slot.
__device__ __forceinline__ int mm_slots(int mq) {
  if (mq % 8) return mq * (mq + 1) / 2;
  int n = 0;
  for (int A = 0; A < mq / 4; ++A) n += mq / 8 - max(0, A / 2);
  return 32 * n;
}
__device__ __forceinline__ bool mm_tile(int i, int mq, int* ra, int* ca) {
  if (mq % 8) {
    int a = 0;
    while (i >= mq - a) i -= mq - a++;
    *ra = a;
    *ca = a + i;
    return true;
  }
  int blk = i / 32, A = 0;
  for (;; ++A) {
    const int lo = max(0, A / 2), n = mq / 8 - lo;
    if (blk < n) {
      blk += lo;
      break;
    }
    blk -= n;
  }
  *ra = 4 * A + (i % 32) / 8;
  *ca = 8 * blk + i % 8;
  return *ca >= *ra;
}

// Phase 4. Grid (S / Q * H, B). x, y: (B, S, H, P); dt: (B, S, H); a, d:
// (H,) (d may be null); bct from phase 2; states from phase 3.
// Shared memory: C^T; B^T, whose space then holds x; and state_in^T,
// whose space then holds the causal half of mm^T in a compact layout.
template <typename T, int V>
__global__ void __launch_bounds__(kThreads)
ssd_scan_kernel_chunk_out(const T* __restrict__ x,
                          const float* __restrict__ dt,
                          const float* __restrict__ a,
                          const float* __restrict__ bct,
                          const float* __restrict__ dskip,
                          const float* __restrict__ states,
                          T* __restrict__ y, int B, int S, int H, int G,
                          int P, int N, int Q) {
  constexpr int kTiles = kMaxYTile / (V * V);  // y tiles a thread keeps
  const int h = blockIdx.x % H, ck = blockIdx.x / H, b = blockIdx.y;
  const int K = gridDim.x / H, grp = h / (H / G);
  const int t0 = ck * Q, LQ = padded(Q, V), mq = Q / V, tp = P / V;
  extern __shared__ __align__(16) float smem[];
  float* ct = smem;                       // N x LQ: C^T
  float* bx = ct + N * LQ;                // N x LQ: B^T; then Q x P: x
  float* rm = bx + max(N * LQ, Q * P);    // N x P: state_in^T; then mm^T
  float* dts = rm + max(N * P, Q * (Q + V) / 2);  // Q
  float* cum = dts + Q;                   // Q

  const size_t row0 = (size_t)b * S + t0;
  // B^T and C^T of this chunk, (N, Q) each
  const float* bt = bct + (((size_t)b * G + grp) * K + ck) * N * Q;
  stage<V>(ct, LQ, bt + (size_t)B * G * S * N, Q, N, Q);
  stage<V>(bx, LQ, bt, Q, N, Q);
  stage<V>(rm, P, states + (((size_t)b * H + h) * K + ck) * N * P, P, N, P);
  cp_async_commit();
  chunk_cum(dts, cum, dt, row0 * H + h, H, Q, a[h]);

  // y = exp(cum_t) C_t . state_in, in registers.
  float acc[kTiles][V][V];
#pragma unroll
  for (int u = 0; u < kTiles; ++u) {
#pragma unroll
    for (int i = 0; i < V; ++i)
#pragma unroll
      for (int j = 0; j < V; ++j) acc[u][i][j] = 0.f;
    int q0, p0;
    if (!y_tile<V>(u, mq, tp, &q0, &p0)) continue;
    tile_mma<V>(acc[u], ct + q0, LQ, rm + p0, P, N);
#pragma unroll
    for (int i = 0; i < V; ++i) {
      const float ec = expf(cum[q0 + i]);
#pragma unroll
      for (int j = 0; j < V; ++j) acc[u][i][j] *= ec;
    }
  }
  __syncthreads();  // the state is consumed

  // mm^T[s][t] = (B_s . C_t) exp(cum_t - cum_s) dt_s for s <= t, else 0,
  // on the causal tiles only.
  const int slots = mm_slots(mq);
  for (int i = threadIdx.x; i < slots; i += kThreads) {
    int ra, ca;
    if (!mm_tile(i, mq, &ra, &ca)) continue;
    const int s0 = ra * V, tq0 = ca * V;
    float m[V][V] = {};
    tile_mma<V>(m, bx + s0, LQ, ct + tq0, LQ, N);
#pragma unroll
    for (int r = 0; r < V; ++r) {
      const int s = s0 + r;
      const float cs = cum[s], ds = dts[s];
      float o[V];
#pragma unroll
      for (int j = 0; j < V; ++j) {
        const int t = tq0 + j;
        o[j] = s <= t ? m[r][j] * fast_exp2((cum[t] - cs) * kLog2e) * ds
                      : 0.f;
      }
      float* dst = rm + tri_row(s, Q, V) + tq0 - s0;
      if constexpr (V == 4)
        *reinterpret_cast<float4*>(dst) = make_float4(o[0], o[1], o[2], o[3]);
      else
        dst[0] = o[0];
    }
  }
  __syncthreads();  // B^T is consumed: x takes its place
  stage<V>(bx, P, x + (row0 * H + h) * P, (size_t)H * P, Q, P);
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();

  // y_t += sum_{s <= t} mm^T[s][t] x_s, V rows of s at a time.
#pragma unroll
  for (int u = 0; u < kTiles; ++u) {
    int q0, p0;
    if (!y_tile<V>(u, mq, tp, &q0, &p0)) continue;
    int start = 0;  // tri_row(V ga)
    for (int ga = 0; ga * V <= q0; ++ga) {
      const int lda = Q - V * ga;
      const float* arow = rm + start + q0 - V * ga;
      const float* brow = bx + (size_t)ga * V * P + p0;
#pragma unroll
      for (int r = 0; r < V; ++r) {
        float av[V], bv[V];
        lds<V>(av, arow + r * lda);
        lds<V>(bv, brow + r * P);
#pragma unroll
        for (int i = 0; i < V; ++i)
#pragma unroll
          for (int j = 0; j < V; ++j)
            acc[u][i][j] = fmaf(av[i], bv[j], acc[u][i][j]);
      }
      start += V * lda;
    }
  }

  const float dh = dskip ? dskip[h] : 0.f;
#pragma unroll
  for (int u = 0; u < kTiles; ++u) {
    int q0, p0;
    if (!y_tile<V>(u, mq, tp, &q0, &p0)) continue;
#pragma unroll
    for (int i = 0; i < V; ++i) {
      T* dst = y + ((row0 + q0 + i) * H + h) * P + p0;
      float o[V];
#pragma unroll
      for (int j = 0; j < V; ++j)
        o[j] = acc[u][i][j] + dh * bx[(q0 + i) * P + p0 + j];
      if constexpr (V == 4 && sizeof(T) == 4)
        *reinterpret_cast<float4*>(dst) = make_float4(o[0], o[1], o[2], o[3]);
      else
#pragma unroll
        for (int j = 0; j < V; ++j) store(dst + j, o[j]);
    }
  }
}

template <typename Kernel>
int set_smem(Kernel kernel, size_t smem) {
  if (smem <= 48 * 1024) return 0;
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) cudaGetLastError();  // clear it for the next launch
  return (int)err;
}

template <typename T, int V>
int launch(const void* x, const void* dt, const void* a, const void* bm,
           const void* cm, const void* d, void* y, void* fstate,
           void* states, void* totals, void* bct, int B, int S, int H, int G,
           int P, int N, int Q, cudaStream_t stream) {
  const int K = S / Q;
  // Phase 4 keeps its y tiles in registers: ceil(Q / 2V) x P / V tile
  // pairs for 256 threads.
  const int pairs = (Q / V + 1) / 2 * (P / V);
  if (pairs > kThreads * (kMaxYTile / (V * V)) / 2)
    return (int)cudaErrorInvalidValue;
  const size_t smem1 = sizeof(float) * ((size_t)Q * (P + N) + 2 * Q);
  const size_t smem3 =
      sizeof(float) *
      ((size_t)N * padded(Q, V) + max(N * padded(Q, V), Q * P) +
       max(N * P, Q * (Q + V) / 2) + 2 * (size_t)Q);
  auto k1 = ssd_scan_kernel_chunk_state<T, V>;
  auto k3 = ssd_scan_kernel_chunk_out<T, V>;
  if (int err = set_smem(k1, smem1)) return err;
  if (int err = set_smem(k3, smem3)) return err;
  const dim3 chunks(K * H, B);
  k1<<<chunks, kThreads, smem1, stream>>>(
      (const T*)x, (const float*)dt, (const float*)a, (const T*)bm,
      (float*)states, (float*)totals, S, H, G, P, N, Q);
  if (cudaError_t err = cudaGetLastError()) return (int)err;
  ssd_scan_kernel_bc_transpose<T><<<dim3(K, G, B), kThreads, 0, stream>>>(
      (const T*)bm, (const T*)cm, (float*)bct, B, S, G, N, Q);
  if (cudaError_t err = cudaGetLastError()) return (int)err;
  ssd_scan_kernel_state_pass<V>
      <<<dim3((N * P / V + kThreads - 1) / kThreads, H, B), kThreads, 0,
          stream>>>((float*)states, (const float*)totals, (float*)fstate, H,
                    P, N, K);
  if (cudaError_t err = cudaGetLastError()) return (int)err;
  k3<<<chunks, kThreads, smem3, stream>>>(
      (const T*)x, (const float*)dt, (const float*)a, (const float*)bct,
      (const float*)d, (const float*)states, (T*)y, B, S, H, G, P, N, Q);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_v(const void* x, const void* dt, const void* a, const void* bm,
             const void* cm, const void* d, void* y, void* fstate,
             void* states, void* totals, void* bct, int B, int S, int H,
             int G, int P, int N, int Q, cudaStream_t stream) {
  if (P % 4 == 0 && N % 4 == 0 && Q % 4 == 0)
    return launch<T, 4>(x, dt, a, bm, cm, d, y, fstate, states, totals, bct,
                        B, S, H, G, P, N, Q, stream);
  return launch<T, 1>(x, dt, a, bm, cm, d, y, fstate, states, totals, bct, B,
                      S, H, G, P, N, Q, stream);
}

}  // namespace

extern "C" {

// x: (B, S, H, P), bm, cm: (B, S, G, N), y: (B, S, H, P), all of one
// type, fp32 (bf16 == 0) or bf16 (bf16 == 1), 16-byte aligned; dt:
// (B, S, H), a: (H,), d: (H,) or null, fstate: (B, H, P, N), states:
// (B, H, S / Q, N, P), totals: (B, H, S / Q) and bct: (2, B, G, S / Q,
// N, Q) scratch, all fp32. Contiguous; S % Q == 0; H % G == 0;
// Q P <= 8192.
int ssd_scan_launch(const void* x, const void* dt, const void* a,
                    const void* bm, const void* cm, const void* d, void* y,
                    void* fstate, void* states, void* totals, void* bct,
                    int B, int S, int H, int G, int P, int N, int Q,
                    int bf16, void* stream) {
  const cudaStream_t st = (cudaStream_t)stream;
  if (bf16)
    return launch_v<__nv_bfloat16>(x, dt, a, bm, cm, d, y, fstate, states,
                                   totals, bct, B, S, H, G, P, N, Q, st);
  return launch_v<float>(x, dt, a, bm, cm, d, y, fstate, states, totals, bct,
                         B, S, H, G, P, N, Q, st);
}

const char* ssd_scan_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
