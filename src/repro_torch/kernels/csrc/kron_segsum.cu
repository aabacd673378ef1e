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
