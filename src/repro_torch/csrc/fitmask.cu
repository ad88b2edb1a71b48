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
//                               and _fitmask_kernel (fitmask_batched, K = 1);
//                               with bool planes and the occupied counts
//                               in the same launch, the counterpart of
//                               repro's JaxEngine._bucket_fn (the fleet
//                               broker's multibox_bucketed)
//   occupancy_counts_*       <- _occupancy_counts_kernel (occupancy_counts)
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
//
// The bucketed form (kCounts) writes the planes as bool, a quarter of
// the int32 bytes, and the first block of each group of grids also
// writes each grid's occupied count, from the row words it already
// holds: where the block holds one grid, every thread adds the
// popcounts of the words it loads and the warps' sums meet in one int a
// warp ahead of the row words; where it holds several (then X * Y is at
// most half a block), a few lanes a grid read the words back. No second
// launch and no second read of the grids.
//
// Occupancy counts alone: B grids of n bytes, bound by reading n bytes
// a grid (at the loop's shapes, by the launch and one trip to memory).
// kernel.py's counts_plan reads a grid with the widest vector dividing
// n and the address, a lane a load up to a warp a grid (a thread's
// loads, at most eight, issued together; occupancy_counts_lanes_kernel:
// 2^3 grids are one lane each, so B 512 is two blocks, with shuffles
// only and no barrier), or, past 256 loads, a thread-block cluster of
// up to eight blocks of 256 threads a grid
// (occupancy_counts_cluster_kernel), whose warps add their sums in the
// first block's shared memory through the cluster's distributed shared
// memory. One launch, no atomics into the output, no second pass; a
// grid beyond a cluster's eight loads a thread loops inside it. A byte
// counts where it is nonzero (__vcmpne4, the test of nonzero4), so a
// bool tensor viewed from uint8 with bytes of 2 or 255 counts right.
#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

namespace cg = cooperative_groups;

constexpr int kThreads = 256;
constexpr int kMaxCluster = 8;   // blocks a cluster, portable on sm_90
// Shared memory the bucketed form keeps ahead of the row words: one
// int a warp. kernel.py adds it to the plan's bytes.
constexpr int kCountBytes = 4 * kThreads / 32;
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

// Loads rows r = threadIdx.x, + blockDim.x, ... and, with kOnes,
// returns the occupied cells among them (the popcounts of their words).
template <int V, bool kOnes>
__device__ int load_rows(const uint8_t* __restrict__ occ, u64* rows,
                         int nrows, int Z) {
  int ones = 0;
  for (int r = threadIdx.x; r < nrows; r += blockDim.x) {
    const u64 w = row_word<V>(occ + (size_t)r * Z, Z);
    rows[r] = w;
    if (kOnes) ones += __popcll(w);
  }
  return ones;
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

// Bytes 0..3 of the result are bits 0..3 of b, each 0 or 1: the four
// products b_i * 2^(7 i + i) land on the byte boundaries, and no two
// overlap.
__device__ __forceinline__ uint32_t bytes4(uint32_t b) {
  return ((b & 15u) * 0x00204081u) & 0x01010101u;
}

// Writes the fit flags of n consecutive items (a row of Z cells each)
// to dst, one warp, lane by lane on consecutive chunks of V cells: 16,
// 8 or 4 bytes of int32 flags, or 8 down to 1 byte of bool flags (not
// 16: that variant needs enough more registers in the shuffle form to
// push the 8^3 path case's blocks into a second wave).
// Each lane finds its first (item, chunk) with one quot and steps 32
// chunks at a time.
template <int V, typename Out>
__device__ __forceinline__ void store_items(const u64* f,
                                            Out* __restrict__ dst, int n,
                                            int Z, int lane) {
  const int per = Z / V;
  const float r = __frcp_rn((float)per);
  const int di = quot(32, per, r), dp = 32 - di * per;
  int item = quot(lane, per, r), part = lane - item * per;
  for (int j = lane; j < n * per; j += 32) {
    const uint32_t bits = (uint32_t)(f[item] >> (part * V));
    if constexpr (sizeof(Out) == 4) {
      if (V == 4)
        reinterpret_cast<int4*>(dst)[j] =
            make_int4(bits & 1, bits >> 1 & 1, bits >> 2 & 1, bits >> 3 & 1);
      else if (V == 2)
        reinterpret_cast<int2*>(dst)[j] = make_int2(bits & 1, bits >> 1 & 1);
      else
        dst[j] = bits & 1;
    } else {
      if (V == 8)
        reinterpret_cast<uint2*>(dst)[j] =
            make_uint2(bytes4(bits), bytes4(bits >> 4));
      else if (V == 4)
        reinterpret_cast<uint32_t*>(dst)[j] = bytes4(bits);
      else if (V == 2)
        reinterpret_cast<uint16_t*>(dst)[j] = (uint16_t)bytes4(bits & 3);
      else
        dst[j] = bits & 1;
    }
    item += di;
    part += dp;
    if (part >= per) {
      part -= per;
      ++item;
    }
  }
}

// Sum of acc over each aligned group of `lanes` lanes (a power of two
// up to 32), in every lane of the group; every lane of the warp calls it.
__device__ __forceinline__ int segment_sum(int acc, int lanes) {
  for (int off = lanes >> 1; off > 0; off >>= 1)
    acc += __shfl_xor_sync(0xffffffffu, acc, off);
  return acc;
}

// counts[j] = occupied cells of grid j < ng, from its XY row words at
// rows + j * XY: `lanes` threads a grid (the power of two >= XY, at most
// a warp) sum popcounts, then shuffles. Every thread of the block calls
// it. Used where a block holds several grids, so XY <= blockDim.x / 2
// and a lane reads at most 4 words.
__device__ __forceinline__ void grid_counts(const u64* rows,
                                            int* __restrict__ counts, int ng,
                                            int XY) {
  const int lanes = XY >= 32 ? 32 : 1 << (32 - __clz(XY - 1));
  const int shift = 31 - __clz(lanes), sub = threadIdx.x & (lanes - 1);
  for (int j0 = 0; j0 < ng; j0 += blockDim.x >> shift) {
    const int j = j0 + (threadIdx.x >> shift);
    int acc = 0;
    if (j < ng)
      for (int r = sub; r < XY; r += lanes)
        acc += __popcll(rows[(size_t)j * XY + r]);
    acc = segment_sum(acc, lanes);
    if (j < ng && sub == 0) counts[j] = acc;
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
// fits word an item (and, staged, one staging word an item). Out is int
// (int32 planes) or uint8_t (bool planes); with kCounts, block part 0
// also writes counts[g] for its grids, and shared memory starts with
// one int a warp (kCountBytes).
template <int kMode, typename Out, bool kCounts>
__global__ void __launch_bounds__(kThreads)
fitmask_multibox_kernel(const uint8_t* __restrict__ occ,
                        const int* __restrict__ boxes,
                        Out* __restrict__ out, int* __restrict__ counts,
                        int B, int X, int Y, int Z, int K, int gpb,
                        int upb) {
  extern __shared__ u64 smem[];
  const int XY = X * Y, KX = K * X;
  const int g0 = blockIdx.y * gpb;
  const int ng = min(gpb, B - g0);
  const int u0 = blockIdx.x * upb;
  const int u1 = min(u0 + upb, ng * KX);
  if (u0 >= u1) return;
  const int n_items = (u1 - u0) * Y;
  int* warp_ones = reinterpret_cast<int*>(smem);
  u64* rows = smem + (kCounts ? kCountBytes / 8 : 0);
  u64* fits = rows + (size_t)gpb * XY;
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
  int ones;
  switch (m & -m) {
    case 16: ones = load_rows<16, kCounts>(src, rows, ng * XY, Z); break;
    case 8: ones = load_rows<8, kCounts>(src, rows, ng * XY, Z); break;
    case 4: ones = load_rows<4, kCounts>(src, rows, ng * XY, Z); break;
    case 2: ones = load_rows<2, kCounts>(src, rows, ng * XY, Z); break;
    default: ones = load_rows<1, kCounts>(src, rows, ng * XY, Z); break;
  }
  // One grid in the block: its count is the sum of what every thread
  // loaded, summed a warp at a time here and across the warps at the end.
  if constexpr (kCounts)
    if (blockIdx.x == 0 && ng == 1) {
      ones = segment_sum(ones, 32);
      if ((threadIdx.x & 31) == 0) warp_ones[threadIdx.x >> 5] = ones;
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

  Out* dst = out + ((size_t)g0 * KX + u0) * Y * Z;
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
      Out* d = dst + (size_t)w0 * Z;
      if constexpr (sizeof(Out) == 4) {
        if ((Z & 3) == 0) store_items<4>(fits + w0, d, n, Z, lane);
        else if ((Z & 1) == 0) store_items<2>(fits + w0, d, n, Z, lane);
        else store_items<1>(fits + w0, d, n, Z, lane);
      } else {
        if ((Z & 7) == 0) store_items<8>(fits + w0, d, n, Z, lane);
        else if ((Z & 3) == 0) store_items<4>(fits + w0, d, n, Z, lane);
        else if ((Z & 1) == 0) store_items<2>(fits + w0, d, n, Z, lane);
        else store_items<1>(fits + w0, d, n, Z, lane);
      }
    }
  }

  if constexpr (kCounts)   // after the stores, which drain meanwhile
    if (blockIdx.x == 0) {
      if (ng > 1) {
        grid_counts(rows, counts + g0, ng, XY);
      } else if (threadIdx.x < 32) {
        ones = threadIdx.x < (blockDim.x >> 5) ? warp_ones[threadIdx.x] : 0;
        ones = segment_sum(ones, 32);
        if (threadIdx.x == 0) counts[g0] = ones;
      }
    }
}

// V bytes (V divides the address), zero-extended into 32-bit words.
template <int V>
struct Chunk {
  uint32_t w[V >= 4 ? V / 4 : 1];
};

template <int V>
__device__ __forceinline__ Chunk<V> load_chunk(const uint8_t* __restrict__ p) {
  Chunk<V> c;
  if constexpr (V == 16) {
    const uint4 q = *reinterpret_cast<const uint4*>(p);
    c.w[0] = q.x, c.w[1] = q.y, c.w[2] = q.z, c.w[3] = q.w;
  } else if constexpr (V == 8) {
    const uint2 q = *reinterpret_cast<const uint2*>(p);
    c.w[0] = q.x, c.w[1] = q.y;
  } else if constexpr (V == 4) {
    c.w[0] = *reinterpret_cast<const uint32_t*>(p);
  } else if constexpr (V == 2) {
    c.w[0] = *reinterpret_cast<const uint16_t*>(p);
  } else {
    c.w[0] = *p;
  }
  return c;
}

// Nonzero bytes of g at begin, begin + step, ... below n, V bytes a
// load. The loads go out kBatch at a time (kBatch at least the loads a
// thread has, up to 8), predicated and not branched over, so that a
// batch costs one trip to memory. Each nonzero byte adds 8 (the set bits
// of __vcmpne4's 0xff), so the sum is shifted down by 3 at the end.
template <int V, int kBatch>
__device__ __forceinline__ int count_strided(const uint8_t* __restrict__ g,
                                             int begin, int n, int step) {
  constexpr int kWords = V >= 4 ? V / 4 : 1;
  int bits = 0;
  for (int i = begin; i < n; i += kBatch * step) {
    Chunk<V> c[kBatch];
#pragma unroll
    for (int k = 0; k < kBatch; ++k)
      c[k] = i + k * step < n ? load_chunk<V>(g + i + k * step) : Chunk<V>{};
#pragma unroll
    for (int k = 0; k < kBatch; ++k)
#pragma unroll
      for (int w = 0; w < kWords; ++w) bits += __popc(__vcmpne4(c[k].w[w], 0u));
  }
  return bits >> 3;
}

// `lanes` threads a grid (a power of two up to 32), a warp holding
// 32 / lanes whole grids: shuffles only, no barrier.
template <int V, int kBatch>
__global__ void __launch_bounds__(kThreads)
occupancy_counts_lanes_kernel(const uint8_t* __restrict__ occ,
                              int* __restrict__ out, int B, int n,
                              int lanes) {
  const int shift = 31 - __clz(lanes);
  const int t = blockIdx.x * blockDim.x + threadIdx.x;
  const int g = t >> shift, sub = t & (lanes - 1);
  int acc = 0;
  if (g < B)
    acc = count_strided<V, kBatch>(occ + (size_t)g * n, sub * V, n,
                                   lanes * V);
  acc = segment_sum(acc, lanes);
  if (g < B && sub == 0) out[g] = acc;
}

// A cluster of C blocks a grid (blocks g * C .. g * C + C - 1); thread
// i of the cluster reads chunks i, i + C * blockDim.x, ... Each warp
// writes its sum into the first block's shared memory (distributed
// shared memory), and the first block's first warp adds them up. Two
// cluster barriers: the first, arrived at on entry and waited on after
// the loads, makes sure every block runs before its shared memory is
// written; the second publishes the sums.
template <int V, int kBatch>
__global__ void __launch_bounds__(kThreads)
occupancy_counts_cluster_kernel(const uint8_t* __restrict__ occ,
                                int* __restrict__ out, int n) {
  __shared__ int sums[kMaxCluster * kThreads / 32];
  asm volatile("barrier.cluster.arrive.relaxed.aligned;" ::: "memory");
  cg::cluster_group cluster = cg::this_cluster();
  const int C = (int)cluster.num_blocks(), rank = (int)cluster.block_rank();
  const int g = blockIdx.x / C, warps = blockDim.x >> 5;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  int acc = count_strided<V, kBatch>(occ + (size_t)g * n,
                                     (rank * blockDim.x + threadIdx.x) * V,
                                     n, C * blockDim.x * V);
  acc = segment_sum(acc, 32);
  asm volatile("barrier.cluster.wait.aligned;" ::: "memory");
  if (lane == 0) *cluster.map_shared_rank(sums + rank * warps + warp, 0) = acc;
  asm volatile("barrier.cluster.arrive.release.aligned;" ::: "memory");
  asm volatile("barrier.cluster.wait.acquire.aligned;" ::: "memory");
  if (rank == 0 && warp == 0) {
    const int m = C * warps;
    acc = (lane < m ? sums[lane] : 0) + (lane + 32 < m ? sums[lane + 32] : 0);
    acc = segment_sum(acc, 32);
    if (lane == 0) out[g] = acc;
  }
}

// The lanes and the cluster kernel for each load width (1 .. 16 bytes)
// and batch (1 .. 8 loads), indexed [log2 V][log2 kBatch].
template <int V>
struct CountKernels {
  const void* lanes[4] = {(const void*)occupancy_counts_lanes_kernel<V, 1>,
                          (const void*)occupancy_counts_lanes_kernel<V, 2>,
                          (const void*)occupancy_counts_lanes_kernel<V, 4>,
                          (const void*)occupancy_counts_lanes_kernel<V, 8>};
  const void* cluster[4] = {
      (const void*)occupancy_counts_cluster_kernel<V, 1>,
      (const void*)occupancy_counts_cluster_kernel<V, 2>,
      (const void*)occupancy_counts_cluster_kernel<V, 4>,
      (const void*)occupancy_counts_cluster_kernel<V, 8>};
};

const void* count_kernel(int vec, int batch, bool cluster) {
  static const CountKernels<1> k1;
  static const CountKernels<2> k2;
  static const CountKernels<4> k4;
  static const CountKernels<8> k8;
  static const CountKernels<16> k16;
  const int b = __builtin_ctz((unsigned)batch);
  switch (vec) {
    case 16: return cluster ? k16.cluster[b] : k16.lanes[b];
    case 8: return cluster ? k8.cluster[b] : k8.lanes[b];
    case 4: return cluster ? k4.cluster[b] : k4.lanes[b];
    case 2: return cluster ? k2.cluster[b] : k2.lanes[b];
    default: return cluster ? k1.cluster[b] : k1.lanes[b];
  }
}

// Launches fitmask_multibox_kernel<mode, Out, kCounts>; see below.
template <typename Out, bool kCounts>
int launch_multibox(const void* occ, const void* boxes, void* out,
                    void* counts, int B, int X, int Y, int Z, int K,
                    int gpb, int bpg, int upb, int threads, int smem,
                    int mode, void* stream) {
  const void* fn =
      mode == kShuffle
          ? (const void*)fitmask_multibox_kernel<kShuffle, Out, kCounts>
      : mode == kStaged
          ? (const void*)fitmask_multibox_kernel<kStaged, Out, kCounts>
          : (const void*)fitmask_multibox_kernel<kDirect, Out, kCounts>;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        fn, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return (int)err;
  }
  void* args[] = {&occ, &boxes, &out, &counts, &B, &X,   &Y,
                  &Z,   &K,     &gpb, &upb};
  cudaLaunchKernel(fn, dim3(bpg, (B + gpb - 1) / gpb), dim3(threads), args,
                   (size_t)smem, (cudaStream_t)stream);
  return (int)cudaGetLastError();
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
  return launch_multibox<int, false>(occ, boxes, out, nullptr, B, X, Y, Z,
                                     K, gpb, bpg, upb, threads, smem, mode,
                                     stream);
}

// As fitmask_multibox_launch, with planes: (B, K, X, Y, Z) bool, 16-byte
// aligned, and counts: (B,) int32, the occupied cells of each grid.
int fitmask_multibox_bucketed_launch(const void* occ, const void* boxes,
                                     void* planes, void* counts, int B,
                                     int X, int Y, int Z, int K, int gpb,
                                     int bpg, int upb, int threads,
                                     int smem, int mode, void* stream) {
  return launch_multibox<uint8_t, true>(occ, boxes, planes, counts, B, X, Y,
                                        Z, K, gpb, bpg, upb, threads, smem,
                                        mode, stream);
}

// occ: (B, n) bool/uint8 whose address and n are multiples of vec (1,
// 2, 4, 8 or 16); out: (B,) int32; a thread's loads go out `batch` (1,
// 2, 4 or 8) at a time. With cluster == 0, `blocks` blocks of `threads`
// threads, `lanes` threads a grid; else B clusters of `cluster` blocks
// (at most 8) of 256 threads, `blocks` = B * cluster. As kernel.py's
// counts_plan computes them.
int occupancy_counts_launch(const void* occ, void* out, int B, int n,
                            int vec, int batch, int lanes, int cluster,
                            int threads, int blocks, void* stream) {
  const void* fn = count_kernel(vec, batch, cluster > 0);
  if (cluster == 0) {
    void* args[] = {&occ, &out, &B, &n, &lanes};
    cudaLaunchKernel(fn, dim3(blocks), dim3(threads), args, 0,
                     (cudaStream_t)stream);
    return (int)cudaGetLastError();
  }
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeClusterDimension;
  attr.val.clusterDim.x = cluster;
  attr.val.clusterDim.y = 1;
  attr.val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(blocks);
  cfg.blockDim = dim3(threads);
  cfg.stream = (cudaStream_t)stream;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  void* args[] = {&occ, &out, &n};
  const cudaError_t err = cudaLaunchKernelExC(&cfg, fn, args);
  const cudaError_t last = cudaGetLastError();
  return (int)(err != cudaSuccess ? err : last);
}

const char* fitmask_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
