// Free-box search ("fitmask") kernels for Hopper (sm_90a).
//
// Plain C entry points, loaded with ctypes by
// repro_torch/kernels/fitmask/kernel.py. Each takes device pointers,
// the sizes it needs and the caller's CUDA stream, launches on that
// stream without synchronising, allocates nothing, and returns
// cudaGetLastError() so a refused launch is reported at once.
//
// Replaces the Pallas kernels of repro/kernels/fitmask/kernel.py:
//   fitmask_multibox_kernel  <- _fitmask_multibox_kernel (fitmask_multibox)
//                               and _fitmask_kernel (fitmask_batched, K = 1)
//   occupancy_counts_kernel  <- _occupancy_counts_kernel (occupancy_counts)
//
// Bound: the fit masks are written as int32, four bytes per (grid, box,
// cell), against a few integer operations per cell, so the multi-box
// kernel is bound by device-memory bytes (1.38 us at the placement
// loop's 8^3 shape, B 8 and K 282). At the small shapes of the loop
// (one 16^3 grid and one box: 16 KB of output) the card's time for one
// launch is the real floor, so what counts is a short chain of
// dependent steps per launch.
//
// Design: bit-packed occupancy rows. Each (grid, x, y) row of Z <= 64
// cells becomes one 64-bit word in shared memory, bit z set where the
// cell is nonzero, read with the widest load the row's alignment
// allows (16 bytes a thread at Z = 16). For a box (a, b, c) with its
// corner at row (x, y), the OR of the a x b rows it covers has bit z set
// where the column (x.., y.., z) holds an occupied cell; c - 1 shifted
// ORs, formed by doubling, give the occupied runs of length c, and the
// complement masked to the low Z - c + 1 bits is the row of fit flags.
// The work is flattened into items (grid, box, x, y), one a thread, in
// the output's order: a block loads the row words of the grids its
// items touch once (one barrier), answers every item from them, and
// each warp writes its own items' planes as consecutive 16-byte chunks
// (8 at even Z, 4 at odd Z), so every store is coalesced. A 16^3 grid
// is 2 KB of words, and any grid with Z <= 64 whose words fit a block's
// shared memory runs (the reference's 64^3 is 32 KB).
//
// The OR over the a x b rows (OrMode): where a warp holds whole rows of
// items (32 % Y == 0, every grid of the placement loop), a loads along
// x and then ceil(log2 b) shuffles along y; elsewhere a loads along x
// into a staging word, a barrier and b loads along y, or, for boxes of
// at most 16 rows, the a * b loads direct. kernel.py picks the mode.
// Item coordinates come from float-reciprocal division (quot): each
// thread's work is short, and a signed integer division costs some
// forty instructions of it.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
typedef unsigned long long u64;

// Bits 0..3 set where the four bytes of w are nonzero.
__device__ __forceinline__ uint32_t nonzero4(uint32_t w) {
  return ((__vcmpne4(w, 0u) & 0x01010101u) * 0x10204080u) >> 28;
}

// Bit z set where row[z] != 0, for z < Z, reading V bytes at a time (V
// divides Z and the row's address).
template <int V>
__device__ __forceinline__ u64 row_word(const uint8_t* __restrict__ row,
                                        int Z) {
  u64 w = 0;
#pragma unroll 4
  for (int z = 0; z < Z; z += V) {
    uint32_t bits;
    if (V == 16) {
      const uint4 q = *reinterpret_cast<const uint4*>(row + z);
      bits = nonzero4(q.x) | nonzero4(q.y) << 4 | nonzero4(q.z) << 8
             | nonzero4(q.w) << 12;
    } else if (V == 8) {
      const uint2 q = *reinterpret_cast<const uint2*>(row + z);
      bits = nonzero4(q.x) | nonzero4(q.y) << 4;
    } else if (V == 4) {
      bits = nonzero4(*reinterpret_cast<const uint32_t*>(row + z));
    } else if (V == 2) {
      bits = nonzero4(*reinterpret_cast<const uint16_t*>(row + z));
    } else {
      bits = row[z] != 0;
    }
    w |= (u64)bits << z;
  }
  return w;
}

template <int V>
__device__ void load_rows(const uint8_t* __restrict__ occ, u64* rows,
                          int nrows, int Z) {
  for (int r = threadIdx.x; r < nrows; r += blockDim.x)
    rows[r] = row_word<V>(occ + (size_t)r * Z, Z);
}

// Bit z (z < Z - c + 1) set where bits z .. z + c - 1 of o are all
// clear; 0 when c > Z. No shift reaches 64: the doubling shifts by at
// most 32, and the mask of 64 low bits is written out.
__device__ __forceinline__ u64 free_runs(u64 o, int c, int Z) {
  if (c > Z) return 0;
  for (int s = 1; s < c;) {
    const int t = min(s, c - s);
    o |= o >> t;
    s += t;
  }
  const int n = Z - c + 1;
  return ~o & (n == 64 ? ~0ull : (1ull << n) - 1);
}

// n / d for 0 <= n < 2^23 and d >= 1, from r = 1 / d rounded to float:
// the float quotient is within one of the true one, and one step
// corrects it. A few instructions against some forty for a signed
// integer division.
__device__ __forceinline__ int quot(int n, int d, float r) {
  const int q = __float2int_rz(__int2float_rn(n) * r);
  return q * d > n ? q - 1 : (q + 1) * d <= n ? q + 1 : q;
}

// Writes the fit flags of n consecutive items (a row of Z cells each)
// to dst, one warp, lane by lane on consecutive chunks of V cells
// (16, 8 or 4 bytes). Each lane finds its first (item, chunk) with one
// quot and steps 32 chunks at a time.
template <int V>
__device__ __forceinline__ void store_items(const u64* f,
                                            int* __restrict__ dst, int n,
                                            int Z, int lane) {
  const int per = Z / V;
  const float r = __frcp_rn((float)per);
  const int di = quot(32, per, r), dp = 32 - di * per;
  int item = quot(lane, per, r), part = lane - item * per;
  for (int j = lane; j < n * per; j += 32) {
    const uint32_t bits = (uint32_t)(f[item] >> (part * V));
    if (V == 4)
      reinterpret_cast<int4*>(dst)[j] =
          make_int4(bits & 1, bits >> 1 & 1, bits >> 2 & 1, bits >> 3 & 1);
    else if (V == 2)
      reinterpret_cast<int2*>(dst)[j] = make_int2(bits & 1, bits >> 1 & 1);
    else
      dst[j] = bits & 1;
    item += di;
    part += dp;
    if (part >= per) {
      part -= per;
      ++item;
    }
  }
}

// How an item ORs the a x b row words its box covers.
enum OrMode {
  kDirect = 0,   // a * b shared loads
  kStaged = 1,   // a loads along x into a staging word, a barrier, b along y
  kShuffle = 2,  // a loads along x, then b along y by doubling across the
                 // lanes of the warp; needs 32 % Y == 0, so that a warp
                 // holds whole (grid, box, x) units
};

// One item: its grid (counted from the block's first), its origin row
// (x, y) and its box. An index past the block's items is a dead item,
// a 1 x 1 x 1 box at (X, Y) that fits nowhere.
struct Item {
  int g, x, y, a, b, c;
};

// Units are the (grid, box, x) rows of the output, Y items each. Block
// (part, group) takes grids [g0, g0 + gpb), g0 = group * gpb, and, of
// their K * X units each, units [u0, u0 + upb), u0 = part * upb, counted
// from grid g0's first. Shared memory: the grids' row words, then one
// fits word an item (and, staged, one staging word an item).
template <int kMode>
__global__ void __launch_bounds__(kThreads)
fitmask_multibox_kernel(const uint8_t* __restrict__ occ,
                        const int* __restrict__ boxes,
                        int* __restrict__ out, int B, int X, int Y, int Z,
                        int K, int gpb, int upb) {
  extern __shared__ u64 smem[];
  const int XY = X * Y, KX = K * X;
  const int g0 = blockIdx.y * gpb;
  const int ng = min(gpb, B - g0);
  const int u0 = blockIdx.x * upb;
  const int u1 = min(u0 + upb, ng * KX);
  if (u0 >= u1) return;
  const int n_items = (u1 - u0) * Y;
  u64* rows = smem;
  u64* fits = smem + (size_t)gpb * XY;
  u64* stage = fits + n_items;

  const float rY = __frcp_rn((float)Y), rKX = __frcp_rn((float)KX),
              rX = __frcp_rn((float)X);
  auto item_at = [&](int i) {
    Item it = {0, X, Y, 1, 1, 1};
    if (i < n_items) {
      const int du = quot(i, Y, rY);
      const int u = u0 + du, g = quot(u, KX, rKX), r = u - g * KX;
      const int k = quot(r, X, rX);
      it = {g, r - k * X, i - du * Y, __ldg(boxes + 3 * k),
            __ldg(boxes + 3 * k + 1), __ldg(boxes + 3 * k + 2)};
    }
    return it;
  };
  // The first item's box is read before the row words are waited on, so
  // the two reads from device memory overlap.
  const Item first = item_at(threadIdx.x);

  const uint8_t* src = occ + (size_t)g0 * XY * Z;
  const int m = Z | 16 | (int)((uintptr_t)occ & 15);
  switch (m & -m) {
    case 16: load_rows<16>(src, rows, ng * XY, Z); break;
    case 8: load_rows<8>(src, rows, ng * XY, Z); break;
    case 4: load_rows<4>(src, rows, ng * XY, Z); break;
    case 2: load_rows<2>(src, rows, ng * XY, Z); break;
    default: load_rows<1>(src, rows, ng * XY, Z); break;
  }
  __syncthreads();

  if (kMode == kStaged) {   // staging word: OR of the a rows along x
    for (int i = threadIdx.x; i < n_items; i += blockDim.x) {
      const Item it = i < (int)blockDim.x ? first : item_at(i);
      u64 h = 0;
      if (it.x + it.a <= X) {
        const u64* w = rows + (size_t)it.g * XY + it.x * Y + it.y;
        for (int p = 0; p < it.a; ++p) h |= w[p * Y];
      }
      stage[i] = h;
    }
    __syncthreads();
  }

  int* dst = out + ((size_t)g0 * KX + u0) * Y * Z;
  const int lane = threadIdx.x & 31;
  for (int base = 0; base < n_items; base += blockDim.x) {
    const int i = base + threadIdx.x;
    const Item it = base ? item_at(i) : first;
    const bool fit = it.x + it.a <= X && it.y + it.b <= Y;
    u64 o = 0;
    if (kMode == kStaged) {
      if (fit)
        for (int q = 0; q < it.b; ++q) o |= stage[i + q];
    } else if (it.x + it.a <= X) {
      const u64* w = rows + (size_t)it.g * XY + it.x * Y + it.y;
      const int nq = kMode == kDirect && fit ? it.b : 1;
      for (int p = 0; p < it.a; ++p, w += Y)
        for (int q = 0; q < nq; ++q) o |= w[q];
    }
    if (kMode == kShuffle) {   // OR of lanes y .. y + b - 1 of the unit
      // ceil(log2 b) doubling steps cover b lanes; the warp takes as many
      // as its longest box needs, and a lane already covered reads itself
      const int b = it.b;
      const int bmax = __reduce_max_sync(0xffffffffu, (unsigned)b);
      for (int s = 1, n = 32 - __clz(bmax - 1); n > 0; --n) {
        const int t = s < b ? min(s, b - s) : 0;
        o |= __shfl_sync(0xffffffffu, o, (lane + t) & 31);
        s += t;
      }
    }
    if (i < n_items) fits[i] = fit ? free_runs(o, it.c, Z) : 0;
    __syncwarp();
    const int w0 = base + (threadIdx.x & ~31);
    if (w0 < n_items) {
      const int n = min(32, n_items - w0);
      int* d = dst + (size_t)w0 * Z;
      if ((Z & 3) == 0) store_items<4>(fits + w0, d, n, Z, lane);
      else if ((Z & 1) == 0) store_items<2>(fits + w0, d, n, Z, lane);
      else store_items<1>(fits + w0, d, n, Z, lane);
    }
  }
}

// One block per grid: occupied cells, reduced across the block.
__global__ void __launch_bounds__(kThreads)
occupancy_counts_kernel(const uint8_t* __restrict__ occ,
                        int* __restrict__ out, int n) {
  __shared__ int warp_sums[kThreads / 32];
  const uint8_t* g = occ + (size_t)blockIdx.x * n;
  int acc = 0;
  for (int i = threadIdx.x; i < n; i += blockDim.x) acc += (g[i] != 0);
  for (int off = 16; off > 0; off >>= 1)
    acc += __shfl_down_sync(0xffffffffu, acc, off);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (lane == 0) warp_sums[warp] = acc;
  __syncthreads();
  if (warp == 0) {
    acc = lane < (int)(blockDim.x >> 5) ? warp_sums[lane] : 0;
    for (int off = 16; off > 0; off >>= 1)
      acc += __shfl_down_sync(0xffffffffu, acc, off);
    if (lane == 0) out[blockIdx.x] = acc;
  }
}

}  // namespace

extern "C" {

// occ: (B, X, Y, Z) bool/uint8, any byte alignment, Z <= 64; boxes:
// (K, 3) int32, every extent >= 1; out: (B, K, X, Y, Z) int32, 16-byte
// aligned. A grid of bpg x ceil(B / gpb) blocks of `threads` (a
// multiple of 32, at most 256) threads and `smem` bytes of shared
// memory, as kernel.py's launch_plan computes them; mode is an OrMode
// (kShuffle only where 32 % Y == 0).
int fitmask_multibox_launch(const void* occ, const void* boxes, void* out,
                            int B, int X, int Y, int Z, int K, int gpb,
                            int bpg, int upb, int threads, int smem,
                            int mode, void* stream) {
  const void* fn =
      mode == kShuffle  ? (const void*)fitmask_multibox_kernel<kShuffle>
      : mode == kStaged ? (const void*)fitmask_multibox_kernel<kStaged>
                        : (const void*)fitmask_multibox_kernel<kDirect>;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        fn, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return (int)err;
  }
  void* args[] = {&occ, &boxes, &out, &B, &X, &Y, &Z, &K, &gpb, &upb};
  cudaLaunchKernel(fn, dim3(bpg, (B + gpb - 1) / gpb), dim3(threads), args,
                   (size_t)smem, (cudaStream_t)stream);
  return (int)cudaGetLastError();
}

// occ: (B, n) bool/uint8; out: (B,) int32.
int occupancy_counts_launch(const void* occ, void* out, int B, int n,
                            void* stream) {
  occupancy_counts_kernel<<<B, kThreads, 0, (cudaStream_t)stream>>>(
      (const uint8_t*)occ, (int*)out, n);
  return (int)cudaGetLastError();
}

const char* fitmask_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
