// Mamba2 SSD chunked scan for Hopper (sm_90a).
//
// Plain C entry point, loaded with ctypes by
// repro_torch/kernels/ssd_scan/kernel.py. It takes device pointers, the
// sizes and the caller's CUDA stream, launches on that stream without
// synchronising, allocates nothing, and returns cudaGetLastError() so a
// refused launch is reported at once.
//
// Replaces the Pallas kernel _ssd_kernel of
// repro/kernels/ssd_scan/kernel.py (ssd_scan_kernel). Per (batch, head)
// and chunk of Q steps, with cum the inclusive prefix sum of dt * a:
//   y     = (C B^T * exp(cum_t - cum_s) * dt_s, s <= t) X
//         + exp(cum) * (C state^T) + d * X
//   state = exp(cum_last) * state + (w * X)^T B,  w = dt * exp(cum_last - cum)
// and the (P, N) fp32 state after the last chunk is the final state.
//
// Bound: Q (Q + 1) (N + P) FLOP per chunk for the causal (s <= t) half
// of the Q x Q products, the only half computed here, plus 4 Q N P for
// the state, against 4 (P + 2 N) bytes per step read and 4 P written,
// so at Q = 128, P = N = 64 it is bound by fp32 operations (67 TFLOP/s).
// Design: the TPU's sequential chunk axis becomes a loop inside one
// block per (head, batch), carrying the state in shared memory; each
// chunk's x, B, C (widened to fp32), its Q x Q matrix and the state all
// sit in dynamic shared memory (about 180 KB at the zamba2 shapes), with
// odd row strides so that column walks do not collide on banks. The
// blocks number B * H, which is below the H100's 132 SMs at B = 1;
// a two-pass form (chunks in parallel, then a scan over chunks) is
// later work.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 512;

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);
}

// Grid (H, B). x: (B, S, H, P); dt: (B, S, H) fp32; a, d: (H,) fp32 (d
// may be null); bm, cm: (B, S, H, N); y: (B, S, H, P); fstate:
// (B, H, P, N) fp32. S % Q == 0.
template <typename T>
__global__ void __launch_bounds__(kThreads)
ssd_scan_kernel(const T* __restrict__ x, const float* __restrict__ dt,
                const float* __restrict__ a, const T* __restrict__ bm,
                const T* __restrict__ cm, const float* __restrict__ dskip,
                T* __restrict__ y, float* __restrict__ fstate, int S, int H,
                int P, int N, int Q) {
  const int h = blockIdx.x, b = blockIdx.y;
  const int tid = threadIdx.x;
  const int LN = N | 1, LQ = Q | 1;  // odd row strides
  extern __shared__ float smem[];
  float* xs = smem;              // Q x P
  float* bs = xs + Q * P;        // Q x LN
  float* cs = bs + Q * LN;       // Q x LN
  float* st = cs + Q * LN;       // P x LN: the carried state
  float* mm = st + P * LN;       // Q x LQ: the masked quadratic form
  float* dts = mm + Q * LQ;      // Q
  float* cum = dts + Q;          // Q
  float* ecum = cum + Q;         // Q: exp(cum)
  float* ws = ecum + Q;          // Q: dt * exp(cum_last - cum)

  const float ah = a[h];
  const float dh = dskip ? dskip[h] : 0.f;
  for (int i = tid; i < P * N; i += kThreads) st[(i / N) * LN + i % N] = 0.f;

  for (int t0 = 0; t0 < S; t0 += Q) {
    __syncthreads();  // previous chunk fully consumed
    for (int i = tid; i < Q * P; i += kThreads) {
      const int t = i / P, p = i % P;
      xs[i] = to_float(x[(((size_t)b * S + t0 + t) * H + h) * P + p]);
    }
    for (int i = tid; i < Q * N; i += kThreads) {
      const int t = i / N, n = i % N;
      const size_t g = (((size_t)b * S + t0 + t) * H + h) * N + n;
      bs[t * LN + n] = to_float(bm[g]);
      cs[t * LN + n] = to_float(cm[g]);
    }
    for (int t = tid; t < Q; t += kThreads)
      dts[t] = dt[((size_t)b * S + t0 + t) * H + h];
    __syncthreads();

    // cum: warp 0 scans; each lane owns a contiguous run of steps.
    if (tid < 32) {
      const int per = (Q + 31) / 32;
      const int lo = min(Q, tid * per), hi = min(Q, lo + per);
      float run = 0.f;
      for (int t = lo; t < hi; ++t) {
        run += dts[t] * ah;
        cum[t] = run;
      }
      float incl = run;
      for (int off = 1; off < 32; off <<= 1) {
        const float o = __shfl_up_sync(0xffffffffu, incl, off);
        if (tid >= off) incl += o;
      }
      const float before = incl - run;
      for (int t = lo; t < hi; ++t) cum[t] += before;
      __syncwarp();
      const float total = cum[Q - 1];
      for (int t = lo; t < hi; ++t) {
        ecum[t] = expf(cum[t]);
        ws[t] = dts[t] * expf(total - cum[t]);
      }
    }
    __syncthreads();
    const float total = cum[Q - 1];

    // Masked quadratic form: mm[t][s] = (C_t . B_s) exp(cum_t - cum_s) dt_s.
    for (int i = tid; i < Q * Q; i += kThreads) {
      const int t = i / Q, s = i % Q;
      float v = 0.f;
      if (s <= t) {
        const float* ct = cs + t * LN;
        const float* bsr = bs + s * LN;
        float dot = 0.f;
        for (int n = 0; n < N; ++n) dot = fmaf(ct[n], bsr[n], dot);
        v = dot * expf(cum[t] - cum[s]) * dts[s];
      }
      mm[t * LQ + s] = v;
    }
    __syncthreads();

    // y = mm X + exp(cum) (C state^T) + d x.
    for (int i = tid; i < Q * P; i += kThreads) {
      const int t = i / P, p = i % P;
      const float* mt = mm + t * LQ;
      float intra = 0.f;
      for (int s = 0; s <= t; ++s) intra = fmaf(mt[s], xs[s * P + p], intra);
      const float* ct = cs + t * LN;
      const float* sp = st + p * LN;
      float inter = 0.f;
      for (int n = 0; n < N; ++n) inter = fmaf(ct[n], sp[n], inter);
      const float v = intra + ecum[t] * inter + xs[i] * dh;
      store(y + (((size_t)b * S + t0 + t) * H + h) * P + p, v);
    }
    __syncthreads();  // every read of the old state is done

    // state = exp(total) state + sum_s (w_s x_s)^T B_s.
    const float decay = expf(total);
    for (int i = tid; i < P * N; i += kThreads) {
      const int p = i / N, n = i % N;
      float acc = 0.f;
      for (int s = 0; s < Q; ++s)
        acc = fmaf(ws[s] * xs[s * P + p], bs[s * LN + n], acc);
      st[p * LN + n] = decay * st[p * LN + n] + acc;
    }
  }
  __syncthreads();
  float* fs = fstate + ((size_t)b * H + h) * P * N;
  for (int i = tid; i < P * N; i += kThreads) fs[i] = st[(i / N) * LN + i % N];
}

template <typename T>
int launch(const void* x, const void* dt, const void* a, const void* bm,
           const void* cm, const void* d, void* y, void* fstate, int B, int S,
           int H, int P, int N, int Q, size_t smem, cudaStream_t stream) {
  auto kernel = ssd_scan_kernel<T>;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) {
      cudaGetLastError();  // clear it, or the next launch would report it
      return (int)err;
    }
  }
  kernel<<<dim3(H, B), kThreads, smem, stream>>>(
      (const T*)x, (const float*)dt, (const float*)a, (const T*)bm,
      (const T*)cm, (const float*)d, (T*)y, (float*)fstate, S, H, P, N, Q);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// x: (B, S, H, P), bm, cm: (B, S, H, N), y: (B, S, H, P), all of one
// type, fp32 (bf16 == 0) or bf16 (bf16 == 1); dt: (B, S, H), a: (H,),
// d: (H,) or null, fstate: (B, H, P, N), all fp32. Contiguous; S % Q == 0.
int ssd_scan_launch(const void* x, const void* dt, const void* a,
                    const void* bm, const void* cm, const void* d, void* y,
                    void* fstate, int B, int S, int H, int P, int N, int Q,
                    int bf16, void* stream) {
  // The layout of ssd_scan_kernel. A chunk too long for the card's
  // shared memory makes cudaFuncSetAttribute fail, and that is returned.
  const size_t LN = N | 1, LQ = Q | 1;
  const size_t smem = sizeof(float) * ((size_t)Q * P + 2 * Q * LN + P * LN +
                                       Q * LQ + 4 * (size_t)Q);
  const cudaStream_t st = (cudaStream_t)stream;
  if (bf16)
    return launch<__nv_bfloat16>(x, dt, a, bm, cm, d, y, fstate, B, S, H, P,
                                 N, Q, smem, st);
  return launch<float>(x, dt, a, bm, cm, d, y, fstate, B, S, H, P, N, Q,
                       smem, st);
}

const char* ssd_scan_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
