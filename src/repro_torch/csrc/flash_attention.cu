// Blockwise (flash) causal attention for Hopper (sm_90a).
//
// Plain C entry point, loaded with ctypes by
// repro_torch/kernels/flash_attention/kernel.py. It takes device
// pointers, the sizes and the caller's CUDA stream, launches on that
// stream without synchronising, allocates nothing, and returns
// cudaGetLastError() so a refused launch is reported at once.
//
// Replaces the Pallas kernel _flash_kernel of
// repro/kernels/flash_attention/kernel.py (flash_attention): the same
// online softmax with fp32 running max m, running sum l and accumulator
// acc, the same masks (k_pos < T, causal k_pos <= q_pos, sliding window
// q_pos - k_pos < window), GQA with kv head = h / (H / KH) by pointer
// arithmetic, and the output acc / max(l, 1e-30).
//
// Bound: the work is 4 * B * H * D FLOP per unmasked (q, k) pair
// against 2 or 4 bytes per element of q, k, v and out, so at the zamba2
// prefill shape (B 2, S 4096, 32 heads of 64) it is bound by
// operations: 2.05 ms of fp32 work at the 67 TFLOP/s CUDA-core rate,
// 0.14 ms of bf16 work at the 989 TFLOP/s tensor-core rate.
//
// Both kernels: one block per (q tile, head, batch), the heaviest
// (last) q tiles first; k/v tiles of 64 rows staged with cp.async; k
// tiles wholly above the diagonal or wholly outside the window skipped
// (they would add p = 0), and the masks evaluated only on tiles that the
// diagonal, the window edge or the end of k cut. Masked scores become
// -inf, so p = 2^-inf = 0 even in a row with nothing unmasked yet. The
// softmax runs in the log2 domain: p = ex2(s * scale * log2 e - m), one
// FMA and one special-function op a score.
//
// bf16 (flash_attention_kernel_bf16): FA2 on the tensor cores. 4 warps,
// each owning 2 m-tiles of 16 q rows (1 at D 128, for registers), so a
// block takes 128 q rows (64 at D 128) and every k or v fragment a warp
// loads feeds 2 products. Q's fragments are loaded once into registers
// with ldmatrix; k and v tiles are double-buffered in shared memory
// with rows padded by 16 bytes, so that the 8 row addresses of each
// ldmatrix (K) and ldmatrix.trans (V) fall on distinct bank groups. Both
// products are mma.sync.m16n8k16 bf16 x bf16 -> fp32. S = Q K^T stays
// in the accumulator registers; the online softmax (m, l per row) is
// reduced over the 4 lanes of a quad with __shfl_xor_sync; P is packed
// to bf16 in registers and fed as the A operand of P V, with no P tile
// in shared memory. No bf16 element is widened before a product.
//
// fp32 (flash_attention_kernel_f32): fp32 FMAs on the CUDA cores (no
// TF32: the parity tolerance is 1e-5). 64 q rows a block, 128 threads
// as 8 x 16; each thread owns an 8 x 4 score tile (8 q rows, keys
// tx + 16 j) and an 8 x D/16 output tile. Q and K are read along d as
// float4, so a step of 4 d costs 8 + 4 = 12 shared loads for
// 8 * 4 * 4 = 128 FMAs (0.094 loads per FMA); P is written to shared
// memory and P V reads 4 keys at a time, 8 float4 of P and 4 * D/64
// float4 of V (D/16 columns) for 4 * 8 * D/16 FMAs: 0.094 loads per FMA
// at D 64, 0.0625 at D 128 and 0.19 at D 32 (float2 loads of V). One k
// and one v buffer and three barriers a tile: v_j loads under Q K_j^T,
// and k_{j+1} under the softmax and P V_j.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kBQ = 64;        // q rows per block of the fp32 kernel
constexpr int kBK = 64;        // k rows per tile
constexpr float kNegInf = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;

// ---- cp.async ---------------------------------------------------------

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

// 16 bytes from global to shared; zero-filled when !valid (src must
// still be a mapped address).
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(valid ? 16 : 0));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// rows x D tile of one head from a (B, L, NH, D) tensor into shared
// memory with row stride LD elements; rows past `valid` are zero.
template <typename T, int D, int LD, int kThreads, int kRowsT = kBK>
__device__ __forceinline__ void stage_async(T* dst, const T* __restrict__ src,
                                            int row0, int valid,
                                            int head_stride) {
  constexpr int kVec = 16 / sizeof(T);  // elements per 16 bytes
  constexpr int kPerRow = D / kVec;
  for (int i = threadIdx.x; i < kRowsT * kPerRow; i += kThreads) {
    const int r = i / kPerRow, c = (i % kPerRow) * kVec;
    const bool ok = r < valid;
    const T* s = src + (size_t)(row0 + (ok ? r : 0)) * head_stride + c;
    cp_async16(dst + r * LD + c, s, ok);
  }
}

// The k range [k_begin, k_end) that can be unmasked for some row of the
// tile q0 .. q0 + q_rows - 1, with k_begin rounded down to a tile.
__device__ __forceinline__ void k_range(int q0, int q_rows, int TK,
                                        int causal, int window, int* begin,
                                        int* end) {
  int e = TK;
  if (causal) e = min(TK, q0 + q_rows);
  int b = 0;
  if (window > 0) b = max(0, q0 - window + 1);
  *begin = (b / kBK) * kBK;
  *end = e;
}

// Whether some (q, k) pair of the tile is masked: the tile reaches past
// the end of k, above the diagonal, or beyond the window.
__device__ __forceinline__ bool tile_needs_mask(int q0, int bq, int k0,
                                                int TK, int causal,
                                                int window) {
  return k0 + kBK > TK || (causal && k0 + kBK - 1 > q0) ||
         (window > 0 && (q0 + bq - 1) - k0 >= window);
}

// 2^x on the special-function unit (2 ulp; 2^-inf = 0).
__device__ __forceinline__ float fast_exp2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ bool unmasked(int q_pos, int k_pos, int TK,
                                         int causal, int window) {
  return k_pos < TK && (!causal || k_pos <= q_pos) &&
         (window <= 0 || q_pos - k_pos < window);
}

// ---- bf16: mma.sync on the tensor cores -------------------------------

__device__ __forceinline__ void ldmatrix_x4(uint32_t* r, const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t* r,
                                                  const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

// c += a (16 x 16, row) * b (16 x 8, col), bf16 in, fp32 accumulate.
__device__ __forceinline__ void mma_bf16(float* c, const uint32_t* a,
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// Grid (ceil(S / (16 W MT)), H, B), 32 W threads; each warp owns MT
// m-tiles of 16 q rows, so every k or v fragment it loads feeds MT
// products. q: (B, S, H, D); k, v: (B, T, KH, D); out: (B, S, H, D),
// all contiguous bf16 with 16-byte aligned rows. Dynamic shared memory:
// the q tile (16 W MT rows), then two k and two v buffers of 64 rows,
// all with rows of D + 8 bf16.
template <int D, int W, int MT>
__global__ void __launch_bounds__(32 * W)
flash_attention_kernel_bf16(const __nv_bfloat16* __restrict__ q,
                            const __nv_bfloat16* __restrict__ k,
                            const __nv_bfloat16* __restrict__ v,
                            __nv_bfloat16* __restrict__ out, int S, int TK,
                            int H, int KH, int causal, int window,
                            float scale_log2) {
  constexpr int kThreads = 32 * W;
  constexpr int BQ = 16 * W * MT;  // q rows per block
  constexpr int LD = D + 8;     // 16-byte pad: ldmatrix rows hit distinct banks
  constexpr int KC = D / 16;    // k-chunks of Q K^T
  constexpr int NB = kBK / 8;   // 8-key blocks of S
  constexpr int DB = D / 8;     // 8-column blocks of the output
  constexpr int TILE = kBK * LD;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* qs = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* ks = qs + BQ * LD;     // two buffers
  __nv_bfloat16* vs = ks + 2 * TILE;    // two buffers

  const int qt = gridDim.x - 1 - blockIdx.x;  // heaviest first
  const int h = blockIdx.y, b = blockIdx.z;
  const int kh = h / (H / KH);
  const int q0 = qt * BQ;
  const int q_rows = min(BQ, S - q0);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;  // mma fragment row and column pair

  int k_begin, k_end;
  k_range(q0, q_rows, TK, causal, window, &k_begin, &k_end);
  const __nv_bfloat16* kb = k + ((size_t)b * TK * KH + kh) * D;
  const __nv_bfloat16* vb = v + ((size_t)b * TK * KH + kh) * D;

  stage_async<__nv_bfloat16, D, LD, kThreads, BQ>(
      qs, q + ((size_t)b * S * H + h) * D, q0, q_rows, H * D);
  if (k_begin < k_end) {
    stage_async<__nv_bfloat16, D, LD, kThreads>(
        ks, kb, k_begin, min(kBK, TK - k_begin), KH * D);
    stage_async<__nv_bfloat16, D, LD, kThreads>(
        vs, vb, k_begin, min(kBK, TK - k_begin), KH * D);
  }
  cp_async_commit();

  // Row g (r = 0) and g + 8 (r = 1) of m-tile i; m in log2 units.
  const int wrow = warp * 16 * MT;
  float m[MT][2], l[MT][2], acc[MT][DB][4];
  uint32_t qf[MT][KC][4];
#pragma unroll
  for (int i = 0; i < MT; ++i) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      m[i][r] = kNegInf;
      l[i][r] = 0.f;
    }
#pragma unroll
    for (int j = 0; j < DB; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;
  }

  int buf = 0;
  for (int k0 = k_begin; k0 < k_end; k0 += kBK, buf ^= 1) {
    // Prefetch the next tile into the other buffer, then wait for this one.
    if (k0 + kBK < k_end) {
      const int n0 = k0 + kBK;
      stage_async<__nv_bfloat16, D, LD, kThreads>(
          ks + (buf ^ 1) * TILE, kb, n0, min(kBK, TK - n0), KH * D);
      stage_async<__nv_bfloat16, D, LD, kThreads>(
          vs + (buf ^ 1) * TILE, vb, n0, min(kBK, TK - n0), KH * D);
    }
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();

    if (k0 == k_begin) {
#pragma unroll
      for (int i = 0; i < MT; ++i)
#pragma unroll
        for (int c = 0; c < KC; ++c)
          ldmatrix_x4(qf[i][c], qs + (wrow + i * 16 + (lane & 15)) * LD +
                                    c * 16 + (lane >> 4) * 8);
    }
    const __nv_bfloat16* kt = ks + buf * TILE;
    const __nv_bfloat16* vt = vs + buf * TILE;

    // S = Q K^T: per m-tile 16 x 64, 8 key blocks of 4 accumulators.
    float s[MT][NB][4];
#pragma unroll
    for (int i = 0; i < MT; ++i)
#pragma unroll
      for (int j = 0; j < NB; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[i][j][e] = 0.f;
#pragma unroll
    for (int c = 0; c < KC; ++c) {
#pragma unroll
      for (int j = 0; j < NB; j += 2) {
        // keys 8j .. 8j + 15, d 16c .. 16c + 15
        uint32_t r[4];
        ldmatrix_x4(r, kt + (j * 8 + (lane & 7) + ((lane >> 4) << 3)) * LD +
                           c * 16 + ((lane >> 3) & 1) * 8);
#pragma unroll
        for (int i = 0; i < MT; ++i) {
          mma_bf16(s[i][j], qf[i][c], r[0], r[1]);
          mma_bf16(s[i][j + 1], qf[i][c], r[2], r[3]);
        }
      }
    }

    // Online softmax; in m-tile i, s[i][j][0..1] are row g and
    // s[i][j][2..3] row g + 8. Masked scores become -inf, so that
    // p = 2^-inf = 0 even in a row with nothing unmasked yet (m = -1e30).
    if (tile_needs_mask(q0, BQ, k0, TK, causal, window)) {
#pragma unroll
      for (int i = 0; i < MT; ++i)
#pragma unroll
        for (int j = 0; j < NB; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e)
            if (!unmasked(q0 + wrow + i * 16 + g + (e >> 1) * 8,
                          k0 + j * 8 + 2 * t + (e & 1), TK, causal, window))
              s[i][j][e] = -INFINITY;
    }
    uint32_t pf[MT][NB / 2][4];
#pragma unroll
    for (int i = 0; i < MT; ++i) {
      float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
      for (int j = 0; j < NB; ++j) {
        mx[0] = fmaxf(mx[0], fmaxf(s[i][j][0], s[i][j][1]));
        mx[1] = fmaxf(mx[1], fmaxf(s[i][j][2], s[i][j][3]));
      }
      float mn[2];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
#pragma unroll
        for (int off = 1; off < 4; off <<= 1)
          mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], off));
        mn[r] = fmaxf(m[i][r], mx[r] * scale_log2);
        const float alpha = fast_exp2(m[i][r] - mn[r]);
        m[i][r] = mn[r];
        l[i][r] *= alpha;
#pragma unroll
        for (int j = 0; j < DB; ++j) {
          acc[i][j][2 * r] *= alpha;
          acc[i][j][2 * r + 1] *= alpha;
        }
      }
      // p = 2^(s scale - m), packed to bf16 as the A fragments of P V:
      // keys 16c .. 16c + 15 are s[i][2c] and s[i][2c + 1].
#pragma unroll
      for (int j = 0; j < NB; ++j) {
        float p[4];
#pragma unroll
        for (int e = 0; e < 4; ++e)
          p[e] = fast_exp2(fmaf(s[i][j][e], scale_log2, -mn[e >> 1]));
        l[i][0] += p[0] + p[1];
        l[i][1] += p[2] + p[3];
        pf[i][j / 2][(j & 1) * 2 + 0] = pack_bf16(p[0], p[1]);
        pf[i][j / 2][(j & 1) * 2 + 1] = pack_bf16(p[2], p[3]);
      }
    }

    // O += P V: V's fragments by ldmatrix.trans, 16 keys x 16 columns.
#pragma unroll
    for (int c = 0; c < NB / 2; ++c) {
#pragma unroll
      for (int j = 0; j < DB; j += 2) {
        uint32_t r[4];
        ldmatrix_x4_trans(
            r, vt + (c * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * LD +
                   j * 8 + (lane >> 4) * 8);
#pragma unroll
        for (int i = 0; i < MT; ++i) {
          mma_bf16(acc[i][j], pf[i][c], r[0], r[1]);
          mma_bf16(acc[i][j + 1], pf[i][c], r[2], r[3]);
        }
      }
    }
    __syncthreads();  // this buffer is refilled two tiles on
  }
  cp_async_wait<0>();

#pragma unroll
  for (int i = 0; i < MT; ++i) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float sum = l[i][r];
#pragma unroll
      for (int off = 1; off < 4; off <<= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, off);
      const float inv = 1.f / fmaxf(sum, 1e-30f);
      const int row = q0 + wrow + i * 16 + g + r * 8;
      if (row >= S) continue;
      __nv_bfloat16* o = out + (((size_t)b * S + row) * H + h) * D + 2 * t;
#pragma unroll
      for (int j = 0; j < DB; ++j)
        *reinterpret_cast<__nv_bfloat162*>(o + j * 8) = __floats2bfloat162_rn(
            acc[i][j][2 * r] * inv, acc[i][j][2 * r + 1] * inv);
    }
  }
}

// ---- fp32: register-tiled FMAs on the CUDA cores -----------------------

constexpr int kThreadsF32 = 128;  // 8 (ty, 8 q rows each) x 16 (tx)
constexpr int kRows = 8;          // q rows per thread
constexpr int kKeys = 4;          // keys per thread: tx + 16 j

// Output columns of thread tx: VW-wide vectors at u * 16 * VW + tx * VW.
template <int D>
struct OutCols {
  static constexpr int VW = D >= 64 ? 4 : 2;
  static constexpr int NU = D / (16 * VW);
  static constexpr int PER = VW * NU;  // D / 16
};

template <int VW>
__device__ __forceinline__ void load_vec(float* dst, const float* src) {
  if constexpr (VW == 4) {
    const float4 x = *reinterpret_cast<const float4*>(src);
    dst[0] = x.x; dst[1] = x.y; dst[2] = x.z; dst[3] = x.w;
  } else {
    const float2 x = *reinterpret_cast<const float2*>(src);
    dst[0] = x.x; dst[1] = x.y;
  }
}

// Grid (ceil(S / 64), H, B). q: (B, S, H, D); k, v: (B, T, KH, D);
// out: (B, S, H, D), all contiguous fp32 with 16-byte aligned rows.
// Dynamic shared memory: q, k and v tiles of 64 x (D + 4) floats and a
// p tile of 64 x 68 floats.
template <int D>
__global__ void __launch_bounds__(kThreadsF32)
flash_attention_kernel_f32(const float* __restrict__ q,
                           const float* __restrict__ k,
                           const float* __restrict__ v,
                           float* __restrict__ out, int S, int TK, int H,
                           int KH, int causal, int window,
                           float scale_log2) {
  constexpr int LD = D + 4;     // rows stay 16-byte aligned, banks rotate by 4
  constexpr int LP = kBK + 4;
  using OC = OutCols<D>;
  extern __shared__ __align__(16) float smem[];
  float* qs = smem;             // kBQ x LD
  float* ks = qs + kBQ * LD;    // kBK x LD
  float* vs = ks + kBK * LD;    // kBK x LD
  float* ps = vs + kBK * LD;    // kBQ x LP; rows r0 .. r0 + 7 are one warp's

  const int qt = gridDim.x - 1 - blockIdx.x;
  const int h = blockIdx.y, b = blockIdx.z;
  const int kh = h / (H / KH);
  const int q0 = qt * kBQ;
  const int q_rows = min(kBQ, S - q0);
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const int r0 = ty * kRows;    // this thread's first q row in the tile

  int k_begin, k_end;
  k_range(q0, q_rows, TK, causal, window, &k_begin, &k_end);
  const float* kb = k + ((size_t)b * TK * KH + kh) * D;
  const float* vb = v + ((size_t)b * TK * KH + kh) * D;

  // cp.async groups in order: (q, k_0), then per tile v_j and k_{j+1}.
  stage_async<float, D, LD, kThreadsF32>(
      qs, q + ((size_t)b * S * H + h) * D, q0, q_rows, H * D);
  if (k_begin < k_end)
    stage_async<float, D, LD, kThreadsF32>(ks, kb, k_begin,
                                           min(kBK, TK - k_begin), KH * D);
  cp_async_commit();

  float m[kRows], l[kRows], acc[kRows][OC::PER];
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int j = 0; j < OC::PER; ++j) acc[i][j] = 0.f;
  }

  for (int k0 = k_begin; k0 < k_end; k0 += kBK) {
    const int n0 = k0 + kBK;
    cp_async_wait<0>();  // this tile's k
    __syncthreads();     // ... from every thread; the last P V is done
    stage_async<float, D, LD, kThreadsF32>(vs, vb, k0, min(kBK, TK - k0),
                                           KH * D);
    cp_async_commit();

    float s[kRows][kKeys];
#pragma unroll
    for (int i = 0; i < kRows; ++i)
#pragma unroll
      for (int j = 0; j < kKeys; ++j) s[i][j] = 0.f;
#pragma unroll 2
    for (int d = 0; d < D; d += 4) {
      float kv[kKeys][4];
#pragma unroll
      for (int j = 0; j < kKeys; ++j)
        load_vec<4>(kv[j], ks + (tx + 16 * j) * LD + d);
#pragma unroll
      for (int i = 0; i < kRows; ++i) {
        float qv[4];
        load_vec<4>(qv, qs + (r0 + i) * LD + d);
#pragma unroll
        for (int j = 0; j < kKeys; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) s[i][j] = fmaf(qv[e], kv[j][e], s[i][j]);
      }
    }
    __syncthreads();  // every read of this k tile is done: refill it
    if (n0 < k_end)
      stage_async<float, D, LD, kThreadsF32>(ks, kb, n0, min(kBK, TK - n0),
                                             KH * D);
    cp_async_commit();

    if (tile_needs_mask(q0, kBQ, k0, TK, causal, window)) {
#pragma unroll
      for (int i = 0; i < kRows; ++i)
#pragma unroll
        for (int j = 0; j < kKeys; ++j)
          if (!unmasked(q0 + r0 + i, k0 + tx + 16 * j, TK, causal, window))
            s[i][j] = -INFINITY;  // p = 0, even where m is still -1e30
    }
#pragma unroll
    for (int i = 0; i < kRows; ++i) {
      float row_max = fmaxf(fmaxf(s[i][0], s[i][1]), fmaxf(s[i][2], s[i][3]));
      // The 16 threads of a row are 16 consecutive lanes of one warp.
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        row_max = fmaxf(row_max, __shfl_xor_sync(0xffffffffu, row_max, off));
      const float m_new = fmaxf(m[i], row_max * scale_log2);
      const float alpha = fast_exp2(m[i] - m_new);
      float row_sum = 0.f;
#pragma unroll
      for (int j = 0; j < kKeys; ++j) {
        const float p = fast_exp2(fmaf(s[i][j], scale_log2, -m_new));
        ps[(r0 + i) * LP + tx + 16 * j] = p;
        row_sum += p;
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        row_sum += __shfl_xor_sync(0xffffffffu, row_sum, off);
      l[i] = l[i] * alpha + row_sum;
      m[i] = m_new;
#pragma unroll
      for (int j = 0; j < OC::PER; ++j) acc[i][j] *= alpha;
    }
    cp_async_wait<1>();  // this tile's v (the next k may be in flight)
    __syncthreads();     // ... from every thread; p rows are warp-private

#pragma unroll 2
    for (int c = 0; c < kBK; c += 4) {
      float vv[4][OC::PER];
#pragma unroll
      for (int cc = 0; cc < 4; ++cc)
#pragma unroll
        for (int u = 0; u < OC::NU; ++u)
          load_vec<OC::VW>(vv[cc] + u * OC::VW,
                           vs + (c + cc) * LD + u * 16 * OC::VW + tx * OC::VW);
#pragma unroll
      for (int i = 0; i < kRows; ++i) {
        float pv[4];
        load_vec<4>(pv, ps + (r0 + i) * LP + c);
#pragma unroll
        for (int cc = 0; cc < 4; ++cc)
#pragma unroll
          for (int j = 0; j < OC::PER; ++j)
            acc[i][j] = fmaf(pv[cc], vv[cc][j], acc[i][j]);
      }
    }
  }
  cp_async_wait<0>();

#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    const int r = r0 + i;
    if (r >= q_rows) continue;
    const float inv = 1.f / fmaxf(l[i], 1e-30f);
    float* o = out + (((size_t)b * S + q0 + r) * H + h) * D;
#pragma unroll
    for (int u = 0; u < OC::NU; ++u) {
      float* dst = o + u * 16 * OC::VW + tx * OC::VW;
      const float* a = acc[i] + u * OC::VW;
      if constexpr (OC::VW == 4)
        *reinterpret_cast<float4*>(dst) =
            make_float4(a[0] * inv, a[1] * inv, a[2] * inv, a[3] * inv);
      else
        *reinterpret_cast<float2*>(dst) = make_float2(a[0] * inv, a[1] * inv);
    }
  }
}

// ---- launch ------------------------------------------------------------

template <typename Kernel>
int set_smem(Kernel kernel, size_t smem) {
  if (smem <= 48 * 1024) return 0;
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) cudaGetLastError();  // clear it for the next launch
  return (int)err;
}

template <int D>
int launch_bf16(const void* q, const void* k, const void* v, void* out,
                int B, int S, int TK, int H, int KH, int causal, int window,
                cudaStream_t stream) {
  // 4 warps of 2 m-tiles; at D 128 a second m-tile would not fit in a
  // thread's 255 registers.
  constexpr int W = 4, MT = D >= 128 ? 1 : 2;
  constexpr int BQ = 16 * W * MT;
  const size_t smem = sizeof(__nv_bfloat16) * (BQ + 4 * kBK) * (D + 8);
  auto kernel = flash_attention_kernel_bf16<D, W, MT>;
  if (int err = set_smem(kernel, smem)) return err;
  const dim3 grid((S + BQ - 1) / BQ, H, B);
  kernel<<<grid, 32 * W, smem, stream>>>(
      (const __nv_bfloat16*)q, (const __nv_bfloat16*)k,
      (const __nv_bfloat16*)v, (__nv_bfloat16*)out, S, TK, H, KH, causal,
      window, kLog2e / sqrtf((float)D));
  return (int)cudaGetLastError();
}

template <int D>
int launch_f32(const void* q, const void* k, const void* v, void* out, int B,
               int S, int TK, int H, int KH, int causal, int window,
               cudaStream_t stream) {
  const size_t smem =
      sizeof(float) * ((size_t)3 * kBK * (D + 4) + kBQ * (kBK + 4));
  auto kernel = flash_attention_kernel_f32<D>;
  if (int err = set_smem(kernel, smem)) return err;
  const dim3 grid((S + kBQ - 1) / kBQ, H, B);
  kernel<<<grid, kThreadsF32, smem, stream>>>(
      (const float*)q, (const float*)k, (const float*)v, (float*)out, S, TK,
      H, KH, causal, window, kLog2e / sqrtf((float)D));
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// q: (B, S, H, D); k, v: (B, T, KH, D); out: (B, S, H, D); all
// contiguous with 16-byte aligned base pointers, fp32 (bf16 == 0) or
// bf16 (bf16 == 1). D is 32, 64 or 128; H % KH == 0. window <= 0 means
// no window.
int flash_attention_launch(const void* q, const void* k, const void* v,
                           void* out, int B, int S, int TK, int H, int KH,
                           int D, int causal, int window, int bf16,
                           void* stream) {
  const cudaStream_t st = (cudaStream_t)stream;
#define FA_CASE(DIM)                                                       \
  case DIM:                                                                \
    return bf16 ? launch_bf16<DIM>(q, k, v, out, B, S, TK, H, KH, causal,  \
                                   window, st)                             \
                : launch_f32<DIM>(q, k, v, out, B, S, TK, H, KH, causal,   \
                                  window, st);
  switch (D) {
    FA_CASE(32)
    FA_CASE(64)
    FA_CASE(128)
    default:
      return (int)cudaErrorInvalidValue;
  }
#undef FA_CASE
}

const char* flash_attention_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
