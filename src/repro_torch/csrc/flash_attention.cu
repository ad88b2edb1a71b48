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
// Bound: at the zamba2 prefill shape the work is
// 4 * B * H * S * T * D * (unmasked share) FLOP against a few bytes per
// element of q, k, v and out, so it is bound by operations. fp32 inputs
// are multiplied as fp32 FMAs on the CUDA cores (no TF32: the parity
// tolerance is 2e-6), so the bound is the 67 TFLOP/s fp32 rate. Design:
// one block per (q tile of 64 rows, head, batch); k/v tiles of 64 rows
// staged in shared memory and reused by all 64 q rows; each thread keeps
// a 4 x 4 register tile of scores and a 4 x D/16 tile of the output;
// k tiles wholly above the diagonal or wholly outside the window are
// skipped (they would add p = 0). bf16 inputs are widened to fp32 as
// they are staged, and take the same fp32 path.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kBQ = 64;        // q rows per block
constexpr int kBK = 64;        // k rows per tile
constexpr int kThreads = 256;  // 16 x 16: ty picks rows, tx picks columns
constexpr float kNegInf = -1e30f;
static_assert(kBQ == kBK, "stage() loads q and k/v tiles of kBK rows");

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);
}

// rows x D tile of one head from a (B, L, NH, D) tensor into shared
// memory as fp32 with row stride D + 1; rows past `valid` are zero.
template <typename T, int D>
__device__ void stage(float* dst, const T* __restrict__ src, int row0,
                      int valid, int head_stride) {
  for (int i = threadIdx.x; i < kBK * D; i += kThreads) {
    const int r = i / D, d = i % D;
    dst[r * (D + 1) + d] =
        r < valid ? to_float(src[(size_t)(row0 + r) * head_stride + d]) : 0.f;
  }
}

// Grid (ceil(S / 64), H, B). q: (B, S, H, D); k, v: (B, T, KH, D);
// out: (B, S, H, D), all contiguous and of type T.
template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
flash_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                       const T* __restrict__ v, T* __restrict__ out, int S,
                       int TK, int H, int KH, int causal, int window,
                       float scale) {
  constexpr int LD = D + 1;       // padded row stride: no bank conflicts
  constexpr int LP = kBK + 16;    // rows r and r + 1 on opposite bank halves
  constexpr int DJ = D / 16;      // output columns per thread
  extern __shared__ float smem[];
  float* qs = smem;               // kBQ x LD
  float* ks = qs + kBQ * LD;      // kBK x LD
  float* vs = ks + kBK * LD;      // kBK x LD
  float* ps = vs + kBK * LD;      // kBQ x LP: this tile's p

  // Heaviest (last) q tiles first.
  const int qt = gridDim.x - 1 - blockIdx.x;
  const int h = blockIdx.y, b = blockIdx.z;
  const int kh = h / (H / KH);
  const int q0 = qt * kBQ;
  const int q_rows = min(kBQ, S - q0);
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;

  stage<T, D>(qs, q + ((size_t)b * S * H + h) * D, q0, q_rows, H * D);

  // k range that can be unmasked for some row of this tile.
  int k_end = TK;
  if (causal) k_end = min(TK, q0 + q_rows);
  int k_begin = 0;
  if (window > 0) k_begin = max(0, q0 - window + 1);
  k_begin = (k_begin / kBK) * kBK;

  float m[4], l[4], acc[4][DJ];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int j = 0; j < DJ; ++j) acc[i][j] = 0.f;
  }

  const T* kb = k + ((size_t)b * TK * KH + kh) * D;
  const T* vb = v + ((size_t)b * TK * KH + kh) * D;
  for (int k0 = k_begin; k0 < k_end; k0 += kBK) {
    const int k_rows = min(kBK, TK - k0);
    __syncthreads();  // previous tile fully consumed
    stage<T, D>(ks, kb, k0, k_rows, KH * D);
    stage<T, D>(vs, vb, k0, k_rows, KH * D);
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 8
    for (int d = 0; d < D; ++d) {
      float qv[4], kv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) qv[i] = qs[(ty + 16 * i) * LD + d];
#pragma unroll
      for (int j = 0; j < 4; ++j) kv[j] = ks[(tx + 16 * j) * LD + d];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int q_pos = q0 + ty + 16 * i;
      bool ok[4];
      float row_max = kNegInf;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int k_pos = k0 + tx + 16 * j;
        ok[j] = k_pos < TK;
        if (causal) ok[j] = ok[j] && k_pos <= q_pos;
        if (window > 0) ok[j] = ok[j] && (q_pos - k_pos) < window;
        s[i][j] = ok[j] ? s[i][j] * scale : kNegInf;
        row_max = fmaxf(row_max, s[i][j]);
      }
      // The 16 threads of a row are 16 consecutive lanes of one warp.
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        row_max = fmaxf(row_max, __shfl_xor_sync(0xffffffffu, row_max, off));
      const float m_new = fmaxf(m[i], row_max);
      const float alpha = expf(m[i] - m_new);
      float row_sum = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = ok[j] ? expf(s[i][j] - m_new) : 0.f;
        ps[(ty + 16 * i) * LP + tx + 16 * j] = p;
        row_sum += p;
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        row_sum += __shfl_xor_sync(0xffffffffu, row_sum, off);
      l[i] = l[i] * alpha + row_sum;
      m[i] = m_new;
#pragma unroll
      for (int j = 0; j < DJ; ++j) acc[i][j] *= alpha;
    }
    __syncthreads();  // p tile complete

#pragma unroll 4
    for (int c = 0; c < kBK; ++c) {
      float vv[DJ];
#pragma unroll
      for (int j = 0; j < DJ; ++j) vv[j] = vs[c * LD + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float p = ps[(ty + 16 * i) * LP + c];
#pragma unroll
        for (int j = 0; j < DJ; ++j) acc[i][j] = fmaf(p, vv[j], acc[i][j]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = ty + 16 * i;
    if (r >= q_rows) continue;
    const float denom = fmaxf(l[i], 1e-30f);
    T* o = out + (((size_t)b * S + q0 + r) * H + h) * D;
#pragma unroll
    for (int j = 0; j < DJ; ++j) store(o + tx + 16 * j, acc[i][j] / denom);
  }
}

template <typename T, int D>
int launch(const void* q, const void* k, const void* v, void* out, int B,
           int S, int TK, int H, int KH, int causal, int window,
           cudaStream_t stream) {
  const size_t smem =
      sizeof(float) * ((size_t)(kBQ + 2 * kBK) * (D + 1) + kBQ * (kBK + 16));
  auto kernel = flash_attention_kernel<T, D>;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  const dim3 grid((S + kBQ - 1) / kBQ, H, B);
  kernel<<<grid, kThreads, smem, stream>>>(
      (const T*)q, (const T*)k, (const T*)v, (T*)out, S, TK, H, KH, causal,
      window, 1.0f / sqrtf((float)D));
  return (int)cudaGetLastError();
}

template <typename T>
int launch_d(const void* q, const void* k, const void* v, void* out, int B,
             int S, int TK, int H, int KH, int D, int causal, int window,
             cudaStream_t stream) {
  switch (D) {
    case 32:
      return launch<T, 32>(q, k, v, out, B, S, TK, H, KH, causal, window,
                           stream);
    case 64:
      return launch<T, 64>(q, k, v, out, B, S, TK, H, KH, causal, window,
                           stream);
    case 128:
      return launch<T, 128>(q, k, v, out, B, S, TK, H, KH, causal, window,
                            stream);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// q: (B, S, H, D); k, v: (B, T, KH, D); out: (B, S, H, D); all
// contiguous, fp32 (bf16 == 0) or bf16 (bf16 == 1). D is 32, 64 or 128;
// H % KH == 0. window <= 0 means no window.
int flash_attention_launch(const void* q, const void* k, const void* v,
                           void* out, int B, int S, int TK, int H, int KH,
                           int D, int causal, int window, int bf16,
                           void* stream) {
  const cudaStream_t st = (cudaStream_t)stream;
  if (bf16)
    return launch_d<__nv_bfloat16>(q, k, v, out, B, S, TK, H, KH, D, causal,
                                   window, st);
  return launch_d<float>(q, k, v, out, B, S, TK, H, KH, D, causal, window,
                         st);
}

const char* flash_attention_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
