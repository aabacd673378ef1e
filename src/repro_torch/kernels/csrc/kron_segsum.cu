// kron_segsum: Z[r] = sum_{e : rows[e] == r} kron(a[e], b[e])   (C order, b fastest)
//
// Replaces the TPU kernel src/repro/kernels/kron_segsum.py::kron_segsum
// (pallas_call at :218, body _kernel at :109), which ran the segment sum as a
// one-hot matmul into a VMEM-resident 128-row Z tile. That formulation existed
// for the TPU's systolic unit; here the elements arrive sorted by row, so each
// row's run is a contiguous stretch of elements and a sorted segmented reduce
// needs no scatter at all.
//
// What bounds it on an H100: bytes. Every element is read once (row id 4 B,
// a row 4*Ka B, b row 4*Kb B: 84 B at Ka = Kb = 10) for 2*Ka*Kb flops, far
// below the card's ratio of flops to bytes, so the least time is the input
// bytes over 3.35 TB/s. Reaching it takes few instructions and few cache
// transactions per element, since each element feeds Ka*Kb outputs.
//
// Design:
//  * Balance under hub slices. One warp walks one chunk of exactly `chunk`
//    consecutive elements, whatever rows they hold. A row with millions of
//    elements (the paper's hub slices) is split over many warps instead of
//    serialising one block, which a block-per-row design would do.
//  * Few loads per output: each lane owns one a column and up to four
//    adjacent b columns (32 lanes cover K̂ = 100 in one pass; wider K̂ adds
//    tiles of 32 lanes), and all lanes of a warp read the same element at
//    once, so the row id and the a and b rows are broadcast loads. On an
//    H100 at nell-2 size this halved the time of a first version that gave
//    each thread a single output column.
//  * Determinism: no atomics. Each lane keeps the current row's run in
//    registers and walks its chunk in element order. A row wholly inside a
//    chunk can occur in no other chunk, so the warp writes it directly. The
//    chunk's first and last rows may continue in neighbouring chunks: their
//    sums go to two partial slots per chunk. The second kernel adds the
//    partial slots of each boundary row in chunk order. Every sum is taken
//    in one fixed order, so reruns are bitwise equal.
//  * bf16: operands and each product are rounded to bf16 exactly as the
//    reference's contract does (the product of two bf16 values is exact in
//    f32, so one round-to-nearest-even of it matches a bf16 multiply bit for
//    bit); accumulation stays f32.
//  * The wrapper allocates Z with zeros, so rows without elements stay 0.
//  * A row id outside [0, num_rows) adds nothing, as the reference's
//    segment_sum drops it; no write leaves Z. The ids are not read on the
//    host, so the launch costs no device-to-host sync.
//
// Preconditions (arranged by the callers, which sort by row on the device):
// rows sorted ascending; a and b row-major float32; E >= 1.
//
// kron_segsum_oracle: (Z, Z @ X) for a (Ka*Kb, s) float32 panel X.
//
// Replaces the TPU kernel src/repro/kernels/kron_segsum.py::kron_segsum_oracle
// (pallas_call at :356, body _kernel_fused at :228), which multiplied the
// VMEM-resident Z tile into the first block-Lanczos panel before Z left the
// core, so the first Lanczos product cost no second read of Z from HBM.
//
// What bounds it here is kron_segsum's: the element bytes. Z itself is small
// (at most 28,818 x 100 floats, 11.5 MB, at nell-2 widths), so the product
// is a few microseconds of work; what matters is that it does not slow the
// element walk.
//
// Design: the launcher runs kron_segsum's two kernels unchanged, so Z is
// bitwise equal to kron_segsum's, and then zx_kernel, one warp per row of Z.
// Z was written a moment before and fits in the H100's 50 MB L2 at these
// widths, so the product should find it there rather than in device memory:
// the saving the TPU kernel made with VMEM. (Computing a row's ZX in the
// chunk walk's registers, where the row finishes, was measured to slow the
// walk itself by about 5% at nell-2 size: the epilogue in the loop changes
// how the loop is compiled.) Each lane sums its columns in column order and
// a fixed-order __shfl_xor butterfly sums the warp, so reruns are bitwise
// equal; no atomics. ZX is f32 from the f32 Z under both precisions.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

__device__ __forceinline__ float bf16_round(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

template <bool kBf16>
__device__ __forceinline__ float product(float a, float b) {
  if (kBf16) return bf16_round(bf16_round(a) * bf16_round(b));
  return a * b;
}

constexpr int kWarpsPerBlock = 4;
constexpr int kCols = 4;  // adjacent b columns one lane accumulates

__device__ __forceinline__ void store_cols(float* dst, const float (&acc)[kCols],
                                           int ncol) {
#pragma unroll
  for (int w = 0; w < kCols; ++w)
    if (w < ncol) dst[w] = acc[w];
}

// One warp per element chunk. Lane p of pair tile blockIdx.y owns the output
// columns ka*Kb + kb0 .. + ncol-1 (one a column, up to kCols adjacent b
// columns), so every lane of the warp reads the same element at the same
// time: the row id, the a row and the b row are broadcast loads.
template <bool kBf16>
__global__ void chunk_kernel(const int* __restrict__ rows,
                             const float* __restrict__ a,
                             const float* __restrict__ b,
                             float* __restrict__ z,
                             float* __restrict__ part,
                             long long E, long long nchunks, int num_rows,
                             int Ka, int Kb, int chunk) {
  const int groups = (Kb + kCols - 1) / kCols;
  const int p = blockIdx.y * 32 + (threadIdx.x & 31);
  const long long c = (long long)blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  if (p >= Ka * groups || c >= nchunks) return;
  const int K = Ka * Kb;
  const int ka = p / groups;
  const int kb0 = (p - ka * groups) * kCols;
  const int ncol = min(kCols, Kb - kb0);
  const long long col = (long long)ka * Kb + kb0;
  const long long e0 = c * chunk;
  const long long e1 = min(e0 + chunk, E);
  const int head = rows[e0];
  const float* ap = a + e0 * Ka + ka;
  const float* bp = b + e0 * Kb + kb0;
  float* head_slot = part + (2 * c) * K + col;
  float* tail_slot = part + (2 * c + 1) * K + col;

  float acc[kCols];
#pragma unroll
  for (int w = 0; w < kCols; ++w) acc[w] = 0.f;
  int cur = head;
  for (long long e = e0; e < e1; ++e, ap += Ka, bp += Kb) {
    const int r = __ldg(rows + e);
    if (r != cur) {
      // cur is not the chunk's last row here (r > cur follows it)
      if (cur == head)
        store_cols(head_slot, acc, ncol);
      else if ((unsigned)cur < (unsigned)num_rows)
        store_cols(z + (long long)cur * K + col, acc, ncol);
#pragma unroll
      for (int w = 0; w < kCols; ++w) acc[w] = 0.f;
      cur = r;
    }
    const float av = __ldg(ap);
#pragma unroll
    for (int w = 0; w < kCols; ++w)
      if (w < ncol) acc[w] += product<kBf16>(av, __ldg(bp + w));
  }
  // cur is the chunk's last row
  if (cur == head) {
    store_cols(head_slot, acc, ncol);
#pragma unroll
    for (int w = 0; w < kCols; ++w) acc[w] = 0.f;
    store_cols(tail_slot, acc, ncol);
  } else {
    store_cols(tail_slot, acc, ncol);
  }
}

// Row of partial slot s: slot 2c is chunk c's first row, slot 2c+1 its last.
// Over all slots these rows never decrease.
__device__ __forceinline__ int slot_row(const int* __restrict__ rows,
                                        long long s, long long E, int chunk) {
  const long long c = s >> 1;
  const long long e = (s & 1) ? min((c + 1) * chunk, E) - 1 : c * chunk;
  return rows[e];
}

// One block per (slot, column tile). The block of the first slot of each run
// of equal slot rows sums that run's partials in slot order into Z.
__global__ void fixup_kernel(const int* __restrict__ rows,
                             const float* __restrict__ part,
                             float* __restrict__ z,
                             long long E, int num_rows, int K, int chunk,
                             long long nslots) {
  const long long s = blockIdx.x;
  const int r = slot_row(rows, s, E, chunk);
  if (s > 0 && slot_row(rows, s - 1, E, chunk) == r) return;  // block-uniform
  if ((unsigned)r >= (unsigned)num_rows) return;  // block-uniform

  // run end: slot rows are sorted, so the matches in each window form a prefix
  long long end = s + 1;
  while (true) {
    const long long q = end + threadIdx.x;
    const int match = (q < nslots) && (slot_row(rows, q, E, chunk) == r);
    const int cnt = __syncthreads_count(match);
    end += cnt;
    if (cnt < (int)blockDim.x) break;
  }

  const int j = blockIdx.y * blockDim.x + threadIdx.x;
  if (j >= K) return;
  const float* p = part + s * K + j;
  float acc = 0.f;
#pragma unroll 8
  for (long long q = s; q < end; ++q, p += K) acc += *p;
  z[(long long)r * K + j] = acc;
}

// ZX[r, j] = sum_k Z[r, k] * X[k, j]: one warp per row, up to kPanel panel
// columns at a time. Lane l sums the columns l, l + 32, ... of the row in
// order (coalesced reads of Z, X from the read-only cache) into one
// register per panel column, then the warp adds its lanes by a fixed
// butterfly.
constexpr int kPanel = 8;

__global__ void zx_kernel(const float* __restrict__ z,
                          const float* __restrict__ x,
                          float* __restrict__ zx, int num_rows, int K, int s) {
  const long long r = (long long)blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  if (r >= num_rows) return;  // warp-uniform
  const int lane = threadIdx.x & 31;
  const float* zr = z + r * K;
  for (int j0 = 0; j0 < s; j0 += kPanel) {
    const int nj = min(kPanel, s - j0);
    float acc[kPanel];
#pragma unroll
    for (int jj = 0; jj < kPanel; ++jj) acc[jj] = 0.f;
    for (int k = lane; k < K; k += 32) {
      const float zv = zr[k];
      const float* xk = x + (long long)k * s + j0;
#pragma unroll
      for (int jj = 0; jj < kPanel; ++jj)
        if (jj < nj) acc[jj] += zv * __ldg(xk + jj);
    }
#pragma unroll
    for (int jj = 0; jj < kPanel; ++jj) {
      float v = acc[jj];
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
      if (lane == jj && jj < nj) zx[r * s + j0 + jj] = v;
    }
  }
}

}  // namespace

// Launch both kernels on `stream`. `part` holds 2 * ceil(E / chunk) * Ka * Kb
// floats of scratch. Returns the CUDA error code of the launches (0 = ok).
extern "C" int kron_segsum_launch(const int* rows, const float* a,
                                  const float* b, float* z, float* part,
                                  long long E, int num_rows, int Ka, int Kb,
                                  int chunk, int bf16, void* stream) {
  if (E <= 0 || num_rows < 0 || Ka <= 0 || Kb <= 0 || chunk <= 0)
    return (int)cudaErrorInvalidValue;
  const int K = Ka * Kb;
  const long long pairs = (long long)Ka * ((Kb + kCols - 1) / kCols);
  const long long nchunks = (E + chunk - 1) / chunk;
  const long long pair_tiles = (pairs + 31) / 32;
  const long long col_tiles = (K + 127) / 128;
  if (2 * nchunks > 0x7fffffffLL || pair_tiles > 65535 || col_tiles > 65535)
    return (int)cudaErrorInvalidConfiguration;
  cudaStream_t st = static_cast<cudaStream_t>(stream);

  dim3 grid((unsigned)((nchunks + kWarpsPerBlock - 1) / kWarpsPerBlock),
            (unsigned)pair_tiles);
  const int threads = 32 * kWarpsPerBlock;
  if (bf16) {
    chunk_kernel<true><<<grid, threads, 0, st>>>(rows, a, b, z, part, E, nchunks, num_rows, Ka, Kb, chunk);
  } else {
    chunk_kernel<false><<<grid, threads, 0, st>>>(rows, a, b, z, part, E, nchunks, num_rows, Ka, Kb, chunk);
  }
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;

  dim3 grid2((unsigned)(2 * nchunks), (unsigned)col_tiles);
  fixup_kernel<<<grid2, 128, 0, st>>>(rows, part, z, E, num_rows, K, chunk, 2 * nchunks);
  return (int)cudaGetLastError();
}

// (Z, Z @ X) on `stream`: kron_segsum_launch, then the row products. `x` is
// (Ka*Kb, s) row-major and `zx` (num_rows, s); `z` zeroed and `part` as for
// kron_segsum_launch. Returns the CUDA error code of the launches (0 = ok).
extern "C" int kron_segsum_oracle_launch(const int* rows, const float* a,
                                         const float* b, float* z, float* part,
                                         const float* x, float* zx,
                                         long long E, int num_rows, int Ka,
                                         int Kb, int chunk, int s, int bf16,
                                         void* stream) {
  if (s <= 0 || num_rows < 0) return (int)cudaErrorInvalidValue;
  const int err = kron_segsum_launch(rows, a, b, z, part, E, num_rows, Ka, Kb,
                                     chunk, bf16, stream);
  if (err != 0 || num_rows == 0) return err;
  const long long blocks = ((long long)num_rows + kWarpsPerBlock - 1) / kWarpsPerBlock;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidConfiguration;
  zx_kernel<<<(unsigned)blocks, 32 * kWarpsPerBlock, 0,
              static_cast<cudaStream_t>(stream)>>>(z, x, zx, num_rows, Ka * Kb, s);
  return (int)cudaGetLastError();
}
