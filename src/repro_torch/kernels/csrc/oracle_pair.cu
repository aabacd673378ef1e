// oracle_pair: (xo, yo) = (Z @ x, Z^T @ y) in one pass over Z.
//
// Replaces the TPU kernel src/repro/kernels/oracle_fused.py::oracle_pair
// (pallas_call at :83, body _kernel at :36), which streamed 128-row blocks
// of Z through VMEM and kept the Z^T y sum in a grid-constant accumulator.
// Blocks on a GPU run in no order, so that accumulator becomes per-block
// partials and a second pass.
//
// What bounds it on an H100: bytes, and at the main path's shapes the launch.
// Z is read once (R*K*4 B: 11.5 MB for nell-2's 28,818 x 100 mode) for
// 4*R*K*s flops; at 3.35 TB/s that is a few microseconds, the same order as
// launching the two kernels.
//
// Design:
//  * Pass 1, one block per `rb` consecutive rows: the block stages its rows
//    of Z (contiguous in memory, read with coalesced loads) and of y in
//    shared memory, so Z leaves device memory once for both products. Each
//    warp computes whole rows of Z @ x (lanes over columns, then a
//    fixed-order shuffle reduction); each thread computes columns of the
//    block's partial Z_blk^T @ y over the block's rows in order.
//  * Pass 2 adds the per-block partials in block order (a fixed split of the
//    blocks over 8 thread rows, then a fixed-order sum), so there are no
//    atomics and reruns are bitwise equal.
//  * Panels: x is (K, s) and y (R, s), row-major; s = 1 is the vector oracle.
//  * Either operand may be null, and then its half is not computed: a null x
//    skips the Z @ x rows, a null y skips the partials and pass 2. Golub-Kahan
//    needs one product at a time (u = f(Z v) comes before Z^T u), so this is
//    how the Lanczos loop calls it.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kReduceRows = 8;

__global__ void rows_kernel(const float* __restrict__ Z,
                            const float* __restrict__ x,
                            const float* __restrict__ y,
                            float* __restrict__ xo,
                            float* __restrict__ part,
                            int R, int K, int s, int rb) {
  extern __shared__ float smem[];
  float* zs = smem;           // rb * K
  float* ys = smem + rb * K;  // rb * s
  const int blk = blockIdx.x;
  const long long r0 = (long long)blk * rb;
  const int nr = (int)min((long long)rb, (long long)R - r0);

  const float* zsrc = Z + r0 * K;
  for (int i = threadIdx.x; i < nr * K; i += blockDim.x) zs[i] = zsrc[i];
  if (y != nullptr) {
    const float* ysrc = y + r0 * s;
    for (int i = threadIdx.x; i < nr * s; i += blockDim.x) ys[i] = ysrc[i];
  }
  __syncthreads();

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int nwarps = blockDim.x >> 5;
  for (int r = warp; x != nullptr && r < nr; r += nwarps) {
    for (int c = 0; c < s; ++c) {
      float acc = 0.f;
      for (int k = lane; k < K; k += 32) acc += zs[r * K + k] * x[(long long)k * s + c];
      for (int off = 16; off > 0; off >>= 1) acc += __shfl_down_sync(0xffffffffu, acc, off);
      if (lane == 0) xo[(r0 + r) * s + c] = acc;
    }
  }

  if (y == nullptr) return;
  float* pblk = part + (long long)blk * K * s;
  for (int k = threadIdx.x; k < K; k += blockDim.x) {
    for (int c = 0; c < s; ++c) {
      float acc = 0.f;
      for (int r = 0; r < nr; ++r) acc += zs[r * K + k] * ys[r * s + c];
      pblk[(long long)k * s + c] = acc;
    }
  }
}

__global__ void reduce_kernel(const float* __restrict__ part,
                              float* __restrict__ yo, int nb, int Ks) {
  __shared__ float red[kReduceRows][33];
  const int col = blockIdx.x * 32 + threadIdx.x;
  float acc = 0.f;
  if (col < Ks) {
    for (int blk = threadIdx.y; blk < nb; blk += kReduceRows)
      acc += part[(long long)blk * Ks + col];
  }
  red[threadIdx.y][threadIdx.x] = acc;
  __syncthreads();
  if (threadIdx.y == 0 && col < Ks) {
    float t = 0.f;
    for (int i = 0; i < kReduceRows; ++i) t += red[i][threadIdx.x];
    yo[col] = t;
  }
}

}  // namespace

// Launch the passes on `stream`. `rb` rows per block, chosen by the wrapper
// so that (rb*K + rb*s) floats fit the default 48 KB of shared memory; `part`
// holds ceil(R / rb) * K * s floats of scratch. x and xo, or y, yo and part,
// may be null (not both halves). Returns the CUDA error code of the launches
// (0 = ok).
extern "C" int oracle_pair_launch(const float* Z, const float* x,
                                  const float* y, float* xo, float* yo,
                                  float* part, int R, int K, int s, int rb,
                                  void* stream) {
  if (R <= 0 || K <= 0 || s <= 0 || rb <= 0 || (x == nullptr && y == nullptr))
    return (int)cudaErrorInvalidValue;
  const size_t smem = (size_t)rb * (K + s) * sizeof(float);
  if (smem > 48 * 1024) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int nb = (R + rb - 1) / rb;
  rows_kernel<<<nb, kThreads, smem, st>>>(Z, x, y, xo, part, R, K, s, rb);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || y == nullptr) return (int)err;
  const int Ks = K * s;
  reduce_kernel<<<(Ks + 31) / 32, dim3(32, kReduceRows), 0, st>>>(part, yo, nb, Ks);
  return (int)cudaGetLastError();
}
