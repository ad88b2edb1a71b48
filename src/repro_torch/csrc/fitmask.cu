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
// Both are bound by device-memory bytes: the fit masks are written as
// int32, four bytes per (grid, box, cell), against about eight integer
// operations per cell. The integral image lives in shared memory and
// every global store is coalesced along z.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

// (X+1)(Y+1)(Z+1) int32 integral image of one grid, in shared memory:
// ii[x][y][z] = number of occupied cells in occ[:x, :y, :z]. The zero
// planes at x = 0, y = 0 and z = 0 come from the load; then one prefix
// pass per axis, each thread owning whole lines of that axis.
__device__ void build_integral_image(const uint8_t* __restrict__ occ,
                                     int* ii, int X, int Y, int Z) {
  const int Y1 = Y + 1, Z1 = Z + 1;
  const int sx = Y1 * Z1;
  const int n1 = (X + 1) * sx;
  for (int i = threadIdx.x; i < n1; i += blockDim.x) {
    const int z = i % Z1;
    const int t = i / Z1;
    const int y = t % Y1;
    const int x = t / Y1;
    ii[i] = (x > 0 && y > 0 && z > 0)
                ? (occ[((x - 1) * Y + (y - 1)) * Z + (z - 1)] != 0)
                : 0;
  }
  __syncthreads();
  for (int l = threadIdx.x; l < (X + 1) * Y1; l += blockDim.x) {
    int* p = ii + l * Z1;
    int acc = 0;
    for (int z = 0; z < Z1; ++z) { acc += p[z]; p[z] = acc; }
  }
  __syncthreads();
  for (int l = threadIdx.x; l < (X + 1) * Z1; l += blockDim.x) {
    int* p = ii + (l / Z1) * sx + (l % Z1);
    int acc = 0;
    for (int y = 0; y < Y1; ++y) { acc += p[y * Z1]; p[y * Z1] = acc; }
  }
  __syncthreads();
  for (int l = threadIdx.x; l < sx; l += blockDim.x) {
    int* p = ii + l;
    int acc = 0;
    for (int x = 0; x <= X; ++x) { acc += p[x * sx]; p[x * sx] = acc; }
  }
  __syncthreads();
}

// Block (b, g) builds grid b's integral image once and answers boxes
// [g * per_block, min(K, (g + 1) * per_block)) from it. Every output
// cell of those planes is written: 1 where the a x b x c window with
// its corner at the cell is entirely free, 0 where it is not or where
// the box overhangs the grid.
__global__ void __launch_bounds__(kThreads)
fitmask_multibox_kernel(const uint8_t* __restrict__ occ,
                        const int* __restrict__ boxes,
                        int* __restrict__ out,
                        int X, int Y, int Z, int K, int per_block) {
  extern __shared__ int ii[];
  const int n = X * Y * Z;
  const int grid = blockIdx.x;
  build_integral_image(occ + (size_t)grid * n, ii, X, Y, Z);
  const int Z1 = Z + 1;
  const int sx = (Y + 1) * Z1;
  const int k_end = min(K, (int)(blockIdx.y + 1) * per_block);
  for (int k = blockIdx.y * per_block; k < k_end; ++k) {
    const int a = boxes[3 * k], b = boxes[3 * k + 1], c = boxes[3 * k + 2];
    const int da = a * sx, db = b * Z1;
    int* o = out + ((size_t)grid * K + k) * n;
    for (int i = threadIdx.x; i < n; i += blockDim.x) {
      const int z = i % Z;
      const int t = i / Z;
      const int y = t % Y;
      const int x = t / Y;
      int fits = 0;
      if (x + a <= X && y + b <= Y && z + c <= Z) {
        const int* p = ii + x * sx + y * Z1 + z;
        const int s = p[da + db + c] - p[db + c] - p[da + c] - p[da + db]
                      + p[c] + p[db] + p[da] - p[0];
        fits = (s == 0);
      }
      o[i] = fits;
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

// occ: (B, X, Y, Z) bool/uint8; boxes: (K, 3) int32, every extent >= 1;
// out: (B, K, X, Y, Z) int32. Grid (B, ceil(K / per_block)).
int fitmask_multibox_launch(const void* occ, const void* boxes, void* out,
                            int B, int X, int Y, int Z, int K,
                            int per_block, void* stream) {
  const size_t smem = (size_t)(X + 1) * (Y + 1) * (Z + 1) * sizeof(int);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        fitmask_multibox_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  const dim3 grid(B, (K + per_block - 1) / per_block);
  fitmask_multibox_kernel<<<grid, kThreads, smem, (cudaStream_t)stream>>>(
      (const uint8_t*)occ, (const int*)boxes, (int*)out, X, Y, Z, K,
      per_block);
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
