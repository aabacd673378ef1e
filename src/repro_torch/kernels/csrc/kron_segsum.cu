// kron_segsum: Z[r] = sum_{e : rows[e] == r} kron(a[e], b[e])   (C order, b fastest)
//
// Replaces the TPU kernel src/repro/kernels/kron_segsum.py::kron_segsum
// (pallas_call at :218, body _kernel at :109), which ran the segment sum as a
// one-hot matmul into a VMEM-resident 128-row Z tile. That formulation existed
// for the TPU's systolic unit; here the elements arrive sorted by row, so each
// row's run is a contiguous stretch of elements and a sorted segmented reduce
// needs no scatter at all.
//
// Two input forms run through the same chunk kernel:
//  * the gather form (the main path at N = 3): per element its row id, its
//    value and its int32 coordinates, one (E, N) row-major row; a[e] =
//    value[e] * F_lead[coords[e, col_a]] (one f32 multiply per entry, as the
//    host's split forms it) and b[e] = F_last[coords[e, col_b]], read from
//    the small factor matrices, which stay in L2. For N >= 5 the leading
//    factors are folded on the host into a (E, Ka) `a` and only b is
//    gathered;
//  * the row form (the TPU function's own signature): a and b given per
//    element, the element's own row as the index and no value factor.
//  Given the same a bits, both forms give the same Z bits: the same walk and
//  the same arithmetic in the same order. At N = 4 the main path takes a
//  third form with its own walk (lead2::chunk_kernel, below): both leading
//  factors gathered, a formed in registers, the same chunks, partial slots
//  and fix-up, so Z is bitwise the folded a's through the gather form.
//
// What bounds it on an H100: bytes. The gather form reads per element 4 B of
// row id, 4 B of value and 4*N B of coordinates (20 B at N = 3), the factors
// once and Z once (and the row form 4*(1 + Ka + Kb) B: 84 B at Ka = Kb = 10),
// for 2*Ka*Kb flops, far below the card's ratio of flops to bytes, so the least
// time is those bytes over 3.35 TB/s. What the design does about it: the
// element records stream through shared memory by cp.async, two tiles
// ahead of the walk; the a and b rows of the next tile are gathered from
// L2/L1 into shared memory by cp.async while the warp walks the current
// one, several elements per instruction (a warp instruction touches few
// cache lines), so the walk itself reads only shared memory and the
// gather latency hides behind it.
//
// The four-mode form is bound by operations instead: per element K̂ = Ka*Kb
// multiply-adds (1000 at K = 10 per mode: 2*E*K̂ flops, 1.6 ms at enron's
// 54.2M elements on the f32 peak) against 24 B of records and three 40-byte
// factor rows from L2. Folding a on the host instead wrote and read an
// (E, 100) f32 array (21.7 GB at enron's size), and a walk over it re-read
// each element's a row once per 32-lane column tile (ten of them at
// K̂ = 1000), about 250 GB a build from device memory. What its design does
// about it: one pass carries every column (a lane's kA x kB block of
// accumulators in registers, grid.y = 1 at K = 10 per mode), so records and
// gathers are read once and hide behind the multiply-adds; each element's
// operands are read from shared memory one element ahead of its products;
// a new row stores a lane's block with 16-byte stores and restarts its sums
// in place (no copy of the accumulators on the common path).
//
// Design:
//  * Balance under hub slices. One warp walks one chunk of exactly `chunk`
//    consecutive elements, whatever rows they hold. A row with millions of
//    elements (the paper's hub slices) is split over many warps instead of
//    serialising one block, which a block-per-row design would do.
//  * Staging: each warp owns kRecStages record tiles and two gather tiles
//    of `tile` elements in shared memory (10 KB a warp); records run
//    kRecDepth tiles ahead of the walk (device-memory latency), gathers one
//    tile ahead (L2 latency). A tile's a and b rows are padded to 16 bytes,
//    so a lane reads its four b values with one 16-byte shared load.
//  * Few loads per output: each lane owns one a column and up to four
//    adjacent b columns (32 lanes cover K̂ = 100 in one pass; wider K̂ adds
//    tiles of 32 lanes), and all lanes of a warp read the same element at
//    once: broadcast reads of shared memory.
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
// rows sorted ascending; a, b, values and the factors row-major float32;
// coordinates within their factors' rows; E >= 1; padded(Ka) + padded(Kb)
// at most about 1,250 floats (a tile of one element must fit a warp's
// shared memory; wider rows are refused at launch). Padding elements of the
// distributed partitions carry value 0 and coordinates 0: their gathers read
// row 0 of each factor and add 0.
//
// kron_segsum_oracle: (Z, Z @ X) for a (Ka*Kb, s) float32 panel X.
//
// Replaces the TPU kernel src/repro/kernels/kron_segsum.py::kron_segsum_oracle
// (pallas_call at :356, body _kernel_fused at :228), which multiplied the
// VMEM-resident Z tile into the first block-Lanczos panel before Z left the
// core, so the first Lanczos product cost no second read of Z from HBM.
//
// What bounds it is kron_segsum's: the element bytes. Z itself is small
// (at most 28,818 x 100 floats, 11.5 MB, at nell-2 widths), so the product
// is a few microseconds of work; what matters is that it does not slow the
// element walk.
//
// Design: the launcher runs kron_segsum's two kernels unchanged (either
// input form), so Z is bitwise equal to kron_segsum's, and then zx_kernel,
// one warp per row of Z. Z was written a moment before and fits in the
// H100's 50 MB L2 at these widths, so the product should find it there
// rather than in device memory: the saving the TPU kernel made with VMEM.
// (Computing a row's ZX in the chunk walk's registers, where the row
// finishes, was measured to slow the walk itself by about 5% at nell-2 size:
// the epilogue in the loop changes how the loop is compiled.) Each lane sums
// its columns in column order and a fixed-order __shfl_xor butterfly sums
// the warp, so reruns are bitwise equal; no atomics. ZX is f32 from the f32
// Z under both precisions.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

__device__ __forceinline__ float bf16_round(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

// acc + a * b: one fused multiply-add in f32; under bf16 the rounded
// operands' product rounded to bf16, then added in f32
template <bool kBf16>
__device__ __forceinline__ float accumulate(float acc, float a, float b) {
  if (kBf16) return __fadd_rn(acc, bf16_round(__fmul_rn(bf16_round(a), bf16_round(b))));
  return __fmaf_rn(a, b, acc);
}

constexpr int kWarpsPerBlock = 4;
constexpr int kCols = 4;              // adjacent b columns one lane accumulates
constexpr int kRecDepth = 4;          // record tiles in flight ahead of the walk
constexpr int kRecStages = kRecDepth + 1;
constexpr int kMaxTile = 32;
constexpr int kWarpSmemWords = 2560;  // shared memory per warp (10 KB)

struct ChunkArgs {
  const int* rows;      // (E,)
  const float* values;  // (E,) in the gather form of a, else null
  const int* coords;    // (E, N) when either operand is gathered, else null
  const float* A;       // gathered: (L, Ka) factor; row form: (E, Ka) a
  const float* B;       // gathered: (L, Kb) factor; row form: (E, Kb) b
  float* z;
  float* part;
  long long E, nchunks;
  int num_rows, Ka, Kb, chunk, N, col_a, col_b;
  int tile;  // elements per staged tile
};

// 32-bit words of one staged element record: row id, value, coordinates
__host__ __device__ constexpr int record_words(bool gather_a, bool gather_b, int N) {
  return 1 + (gather_a ? 1 : 0) + ((gather_a || gather_b) ? N : 0);
}

// staged a and b rows are padded to 16-byte multiples
__host__ __device__ constexpr int padded(int k) { return (k + 3) & ~3; }

// Words of one record stage (a 16-byte multiple) and of a warp's record
// and gather stages.
__host__ __device__ constexpr int record_stage(int T, int W) { return padded(T * W); }
__host__ __device__ constexpr int warp_words(int T, int W, int Ka, int Kb) {
  return kRecStages * record_stage(T, W) + 2 * T * (padded(Ka) + padded(Kb));
}

// Elements per tile: a power of two up to kMaxTile whose record and gather
// stages fit one warp's share of shared memory (0: the rows are too wide).
__host__ __device__ inline int tile_elements(bool gather_a, bool gather_b, int N,
                                             int Ka, int Kb) {
  const int W = record_words(gather_a, gather_b, N);
  for (int t = kMaxTile; t >= 1; t >>= 1)
    if (warp_words(t, W, Ka, Kb) <= kWarpSmemWords) return t;
  return 0;
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d), "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async8(void* dst, const void* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(d), "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d), "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// wait until at most N of this thread's committed copy groups are pending
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// The warp copies n 32-bit words from src to dst: 16-byte copies where
// both are 16-byte aligned, else 4-byte ones.
__device__ __forceinline__ void warp_copy(uint32_t* dst, const uint32_t* src, int n,
                                          int lane) {
  int done = 0;
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  if (((reinterpret_cast<uintptr_t>(src) | d) & 15) == 0) {
    done = n & ~3;
    for (int i = 4 * lane; i < done; i += 128) cp_async16(dst + i, src + i);
  }
  for (int i = done + lane; i < n; i += 32) cp_async4(dst + i, src + i);
}

__device__ __forceinline__ void store_cols(float* dst, const float (&acc)[kCols],
                                           int ncol) {
#pragma unroll
  for (int w = 0; w < kCols; ++w)
    if (w < ncol) dst[w] = acc[w];
}

// One warp per element chunk, walked in tiles of g.tile elements through
// shared memory. Copy groups, in commit order: the records (row ids, values,
// coordinates) of tiles 0 .. kRecDepth-1, the gather of tile 0 and an empty
// group; then per tile k, the gather of tile k+1 (its a and b rows, read
// from the factors at the staged coordinates: cp.async, several elements
// per warp instruction) and the records of tile k+kRecDepth. So before
// walking tile k a lane waits for all but its newest group: tile k's gather
// and tile k+1's records are then in place, while later records stay in
// flight. The walk reads only shared memory. Lane p of pair tile blockIdx.y
// owns the output columns ka*Kb + kb0 .. + ncol-1 (one a column, up to kCols
// adjacent b columns); every lane reads the same element at the same time
// (broadcast reads). Lanes past the last pair only help stage.
template <bool kBf16, bool kGatherA, bool kGatherB>
__global__ void __launch_bounds__(32 * kWarpsPerBlock) chunk_kernel(ChunkArgs g) {
  extern __shared__ __align__(16) uint32_t smem[];
  constexpr bool kCoords = kGatherA || kGatherB;
  const int N = g.N, T = g.tile;
  const int Ka = g.Ka, Kb = g.Kb;
  const int ka_s = padded(Ka), kb_s = padded(Kb);
  const int W = record_words(kGatherA, kGatherB, N);
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const long long c = (long long)blockIdx.x * kWarpsPerBlock + warp;
  if (c >= g.nchunks) return;  // warp-uniform
  const int RS = record_stage(T, W);
  uint32_t* rec = smem + warp * kWarpSmemWords;                  // kRecStages x RS
  float* gat = reinterpret_cast<float*>(rec + kRecStages * RS);  // 2 x T x (ka_s + kb_s)

  const int groups = (Kb + kCols - 1) / kCols;
  const int p = blockIdx.y * 32 + lane;
  const bool active = p < Ka * groups;
  const int ka = active ? p / groups : 0;
  const int kb0 = active ? (p - ka * groups) * kCols : 0;
  const int ncol = min(kCols, Kb - kb0);
  const int K = Ka * Kb;
  const long long col = (long long)ka * Kb + kb0;
  const long long e0 = c * g.chunk;
  const long long e1 = min(e0 + g.chunk, g.E);
  const int ntiles = (int)((e1 - e0 + T - 1) / T);
  const int head = g.rows[e0];
  float* head_slot = g.part + (2 * c) * K + col;
  float* tail_slot = g.part + (2 * c + 1) * K + col;

  // gather lanes: `wb` floats per copy (8-byte copies when the rows allow),
  // h lanes per element, epw elements per warp instruction
  const bool pairs_ok = ((Ka | Kb) & 1) == 0 &&
                        ((reinterpret_cast<uintptr_t>(g.A) | reinterpret_cast<uintptr_t>(g.B)) & 7) == 0;
  const int wb = pairs_ok ? 2 : 1;
  const int ua = Ka / wb;
  const int h = ua + Kb / wb;
  const int epw = h <= 32 ? 32 / h : 1;
  const int slot = h <= 32 ? lane / h : 0;
  const int q0 = h <= 32 ? lane - slot * h : lane;

  auto tile_start = [&](int k) { return e0 + (long long)k * T; };
  auto tile_len = [&](int k) { return (int)min((long long)T, e1 - tile_start(k)); };
  auto rec_at = [&](int k) { return rec + (k % kRecStages) * RS; };
  auto gat_at = [&](int k) { return gat + (k & 1) * T * (ka_s + kb_s); };

  auto issue_records = [&](int k) {
    if (k >= ntiles) return;
    const long long es = tile_start(k);
    const int n = tile_len(k);
    uint32_t* buf = rec_at(k);
    warp_copy(buf, reinterpret_cast<const uint32_t*>(g.rows + es), n, lane);
    if (kGatherA)
      warp_copy(buf + T, reinterpret_cast<const uint32_t*>(g.values + es), n, lane);
    if (kCoords)
      warp_copy(buf + T * (kGatherA ? 2 : 1),
                reinterpret_cast<const uint32_t*>(g.coords + es * N), n * N, lane);
  };

  auto issue_gather = [&](int k) {
    if (k >= ntiles || slot >= epw) return;
    const long long es = tile_start(k);
    const int n = tile_len(k);
    const int* crd = reinterpret_cast<const int*>(rec_at(k) + T * (kGatherA ? 2 : 1));
    float* ga = gat_at(k);
    float* gb = ga + T * ka_s;
    for (int u = slot; u < n; u += epw) {
      for (int q = q0; q < h; q += 32) {
        const bool is_a = q < ua;
        const int cc = (is_a ? q : q - ua) * wb;
        long long idx = es + u;
        if (is_a ? kGatherA : kGatherB) idx = crd[u * N + (is_a ? g.col_a : g.col_b)];
        const float* src = is_a ? g.A + idx * Ka + cc : g.B + idx * Kb + cc;
        float* dst = is_a ? ga + u * ka_s + cc : gb + u * kb_s + cc;
        if (wb == 2) cp_async8(dst, src);
        else cp_async4(dst, src);
      }
    }
  };

#pragma unroll
  for (int k = 0; k < kRecDepth; ++k) {
    issue_records(k);
    cp_async_commit();
  }
  cp_async_wait<kRecDepth - 1>();  // tile 0's records
  __syncwarp();
  issue_gather(0);
  cp_async_commit();
  cp_async_commit();  // empty: every tile then waits for all but one group

  float acc[kCols];
#pragma unroll
  for (int w = 0; w < kCols; ++w) acc[w] = 0.f;
  int cur = head;
  for (int k = 0; k < ntiles; ++k) {
    cp_async_wait<1>();  // tile k's gather and tile k+1's records
    __syncwarp();
    issue_gather(k + 1);
    cp_async_commit();
    issue_records(k + kRecDepth);
    cp_async_commit();
    if (active) {
      const int n = tile_len(k);
      const uint32_t* r = rec_at(k);
      const int* srow = reinterpret_cast<const int*>(r);
      const float* sval = reinterpret_cast<const float*>(r + T);
      const float* ga = gat_at(k) + ka;
      const float* gb = gat_at(k) + T * ka_s + kb0;
#pragma unroll 4
      for (int u = 0; u < n; ++u) {
        const int row = srow[u];
        float av = ga[u * ka_s];
        if (kGatherA) av = __fmul_rn(sval[u], av);
        const float4 bq = *reinterpret_cast<const float4*>(gb + u * kb_s);
        const float bv[kCols] = {bq.x, bq.y, bq.z, bq.w};
        if (row != cur) {
          // cur is not the chunk's last row here (row > cur follows it)
          if (cur == head)
            store_cols(head_slot, acc, ncol);
          else if ((unsigned)cur < (unsigned)g.num_rows)
            store_cols(g.z + (long long)cur * K + col, acc, ncol);
#pragma unroll
          for (int w = 0; w < kCols; ++w) acc[w] = 0.f;
          cur = row;
        }
#pragma unroll
        for (int w = 0; w < kCols; ++w)
          if (w < ncol) acc[w] = accumulate<kBf16>(acc[w], av, bv[w]);
      }
    }
    __syncwarp();
  }
  cp_async_wait<0>();  // no copy outlives the warp
  if (!active) return;
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

// The four-mode gather form: two leading factors, gathered per element like
// the last one, so the (E, Ka) fold of a is never formed. One pass over the
// elements carries every output column: lane p owns kA consecutive a
// columns and kB consecutive b columns (kA * kB accumulators in registers;
// at K = 10 per mode 25 lanes of 4 x 10 cover K̂ = 1000, so grid.y is 1).
// Per element it forms a[ka] = (value * F1[i]) * F2[j] for its a columns,
// rounded as the fold rounds it (two f32 multiplies in that order), and
// multiply-adds them with the last factor's row, read by broadcast. The
// chunks, the partial slots and the fix-up are the other form's, so Z is
// bitwise the fold form's, in f32 and under the bf16 contract.
namespace lead2 {

struct Args {
  const int* rows;      // (E,)
  const float* values;  // (E,)
  const int* coords;    // (E, N)
  const float* F1;      // (L1, K1): the first leading factor
  const float* F2;      // (L2, K2): the second (fastest within a)
  const float* F3;      // (L3, Kb): the last factor
  float* z;
  float* part;
  long long E, nchunks;
  int num_rows, K1, K2, Kb, chunk, N, c1, c2, c3;
  int s3;    // staged floats of a last-factor row (covers every b group)
  int tile;  // elements per staged tile
};

// record: row id, value, N coordinates; gathered: the three factor rows of
// an element side by side, each padded to 16 bytes
__host__ __device__ constexpr int record_words(int N) { return 2 + N; }
__host__ __device__ constexpr int gather_words(int K1, int K2, int s3) {
  return padded(K1) + padded(K2) + s3;
}
__host__ __device__ constexpr int warp_words(int T, int N, int S) {
  return kRecStages * record_stage(T, record_words(N)) + 2 * T * S;
}

// Shared memory of one warp, in 32-bit words (13 KB): 32 elements a tile at
// K = 10 per mode, where the other form's 10 KB would hold 16, so each
// tile's wait and copy instructions are spread over twice the elements
// (about 10% of the walk's time on an H100). Blocks take 52 KB, past the
// default 48 KB, so the launch raises the kernel's limit.
constexpr int kWords = 3328;

__host__ __device__ inline int tile_elements(int N, int S) {
  for (int t = kMaxTile; t >= 1; t >>= 1)
    if (warp_words(t, N, S) <= kWords) return t;
  return 0;
}

// One staged element as a lane reads it: row id, value, its a columns'
// entries of F1 and F2, and the b row from its first b column (read in
// 16-byte pieces: kb0 is a multiple of 4 and the staged row long enough).
template <int kA, int kB>
struct Element {
  int row;
  float v, f1[kA], f2[kA], b[padded(kB)];
};

// `ge` is the staged element; o1, o2 are byte offsets in it (o2[kA]: the
// lane's b row), so each read is one add and one shared load
template <int kA, int kB>
__device__ __forceinline__ void load_element(Element<kA, kB>& e, const int* srow,
                                             const float* sval, const char* ge,
                                             const int (&o1)[kA], const int (&o2)[kA + 1],
                                             int u) {
  e.row = srow[u];
  e.v = sval[u];
#pragma unroll
  for (int t = 0; t < kA; ++t) {
    e.f1[t] = *reinterpret_cast<const float*>(ge + o1[t]);
    e.f2[t] = *reinterpret_cast<const float*>(ge + o2[t]);
  }
  const float4* gb = reinterpret_cast<const float4*>(ge + o2[kA]);
#pragma unroll
  for (int w = 0; w < padded(kB) / 4; ++w) {
    const float4 q = gb[w];
    e.b[4 * w] = q.x;
    e.b[4 * w + 1] = q.y;
    e.b[4 * w + 2] = q.z;
    e.b[4 * w + 3] = q.w;
  }
}

// the lane's accumulators into the row that starts at dst (its real
// columns only). A whole block of an exact width (every lane at K = 10 per
// mode) is kA * kB consecutive floats, stored 16 or 8 bytes at a time;
// otherwise one pointer steps over the a columns, so no per-column offset
// or predicate stays live in the walk.
template <int kA, int kB>
__device__ __forceinline__ void store_block(float* dst, const float (&acc)[kA][kB],
                                            int ka0, int kb0, int nA, int nB, int Kb) {
  static_assert((kA * kB) % 4 == 0, "a whole block is stored in float4s");
  float* p = dst + (long long)ka0 * Kb + kb0;
  if (Kb == kB && nA == kA) {
    if ((reinterpret_cast<uintptr_t>(p) & 15) == 0) {
#pragma unroll
      for (int i = 0; i < kA * kB; i += 4)
        *reinterpret_cast<float4*>(p + i) =
            make_float4(acc[i / kB][i % kB], acc[(i + 1) / kB][(i + 1) % kB],
                        acc[(i + 2) / kB][(i + 2) % kB], acc[(i + 3) / kB][(i + 3) % kB]);
    } else {  // rows of an odd Ka: 8-byte aligned (kB is even)
#pragma unroll
      for (int i = 0; i < kA * kB; i += 2)
        *reinterpret_cast<float2*>(p + i) =
            make_float2(acc[i / kB][i % kB], acc[(i + 1) / kB][(i + 1) % kB]);
    }
    return;
  }
#pragma unroll
  for (int t = 0; t < kA; ++t, p += Kb) {
    if (t >= nA) break;
#pragma unroll
    for (int w = 0; w < kB; ++w)
      if (w < nB) p[w] = acc[t][w];
  }
}

template <int kA, int kB>
__device__ __forceinline__ void zero_block(float (&acc)[kA][kB]) {
#pragma unroll
  for (int t = 0; t < kA; ++t)
#pragma unroll
    for (int w = 0; w < kB; ++w) acc[t][w] = 0.f;
}

// Blocks an SM must hold: caps the registers (the accumulators and two
// elements' operands fit without spilling) so that enough warps hide the
// latency of the gathers and of the shared-memory reads.
constexpr int kMinBlocks = 3;

// The walk of the other form (records kRecDepth tiles ahead, gathers one
// tile ahead, the same copy groups in the same order); the differences are
// the gather of three rows per element, the lane's block of columns, and
// that each element's operands are read from shared memory one element
// ahead of its products, so those reads wait behind the previous element's
// multiply-adds and not in front of them. Columns past the real ones
// (t >= nA, w >= nB) read clamped entries or staged padding and are never
// stored.
template <bool kBf16, int kA, int kB>
__global__ void __launch_bounds__(32 * kWarpsPerBlock, kMinBlocks) chunk_kernel(Args g) {
  extern __shared__ __align__(16) uint32_t smem[];
  const int N = g.N, T = g.tile;
  const int K1 = g.K1, K2 = g.K2, Kb = g.Kb;
  const int s1 = padded(K1), s12 = s1 + padded(K2);
  const int S = s12 + g.s3;
  const int Ka = K1 * K2, K = Ka * Kb;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const long long c = (long long)blockIdx.x * kWarpsPerBlock + warp;
  if (c >= g.nchunks) return;  // warp-uniform
  const int RS = record_stage(T, record_words(N));
  uint32_t* rec = smem + warp * kWords;                          // kRecStages x RS
  float* gat = reinterpret_cast<float*>(rec + kRecStages * RS);  // 2 x T x S

  const int nbg = (Kb + kB - 1) / kB;
  const int p = blockIdx.y * 32 + lane;
  const bool active = p < ((Ka + kA - 1) / kA) * nbg;
  const int ag = active ? p / nbg : 0;
  const int ka0 = ag * kA;
  const int kb0 = (active ? p - ag * nbg : 0) * kB;
  const int nA = min(kA, Ka - ka0), nB = min(kB, Kb - kb0);
  // byte offsets in a staged element: each a column's F1 and F2 entries,
  // and (o2[kA]) the lane's first b column
  int o1[kA], o2[kA + 1];
#pragma unroll
  for (int t = 0; t < kA; ++t) {
    const int ka = min(ka0 + t, Ka - 1);
    const int i = ka / K2;
    o1[t] = 4 * i;
    o2[t] = 4 * (s1 + ka - i * K2);
  }
  o2[kA] = 4 * (s12 + kb0);
  const long long e0 = c * g.chunk;
  const long long e1 = min(e0 + g.chunk, g.E);
  const int ntiles = (int)((e1 - e0 + T - 1) / T);
  const int head = g.rows[e0];
  float* head_slot = g.part + (2 * c) * K;
  float* tail_slot = g.part + (2 * c + 1) * K;

  // gather lanes as in the other form: `wb` floats per copy, h lanes per
  // element over its three rows, epw elements per warp instruction
  const bool pairs_ok = ((K1 | K2 | Kb) & 1) == 0 &&
                        ((reinterpret_cast<uintptr_t>(g.F1) | reinterpret_cast<uintptr_t>(g.F2) |
                          reinterpret_cast<uintptr_t>(g.F3)) & 7) == 0;
  const int wb = pairs_ok ? 2 : 1;
  const int u1 = K1 / wb, u2 = u1 + K2 / wb;
  const int h = u2 + Kb / wb;
  const int epw = h <= 32 ? 32 / h : 1;
  const int slot = h <= 32 ? lane / h : 0;
  const int q0 = h <= 32 ? lane - slot * h : lane;

  auto tile_start = [&](int k) { return e0 + (long long)k * T; };
  auto tile_len = [&](int k) { return (int)min((long long)T, e1 - tile_start(k)); };
  auto rec_at = [&](int k) { return rec + (k % kRecStages) * RS; };
  auto gat_at = [&](int k) { return gat + (k & 1) * T * S; };

  auto issue_records = [&](int k) {
    if (k >= ntiles) return;
    const long long es = tile_start(k);
    const int n = tile_len(k);
    uint32_t* buf = rec_at(k);
    warp_copy(buf, reinterpret_cast<const uint32_t*>(g.rows + es), n, lane);
    warp_copy(buf + T, reinterpret_cast<const uint32_t*>(g.values + es), n, lane);
    warp_copy(buf + 2 * T, reinterpret_cast<const uint32_t*>(g.coords + es * N), n * N, lane);
  };

  // piece q of an element: wb floats of F1, F2 or F3 (chosen by selects,
  // so the lanes of a warp do not diverge)
  auto issue_gather = [&](int k) {
    if (k >= ntiles || slot >= epw) return;
    const int n = tile_len(k);
    const int* crd = reinterpret_cast<const int*>(rec_at(k) + 2 * T);
    float* gs = gat_at(k);
    for (int q = q0; q < h; q += 32) {
      const bool in1 = q < u1, in2 = q < u2;
      const int cc = (in1 ? q : in2 ? q - u1 : q - u2) * wb;
      const int col = in1 ? g.c1 : in2 ? g.c2 : g.c3;
      const long long kw = in1 ? K1 : in2 ? K2 : Kb;
      const float* F = (in1 ? g.F1 : in2 ? g.F2 : g.F3) + cc;
      float* d = gs + (in1 ? 0 : in2 ? s1 : s12) + cc;
      for (int u = slot; u < n; u += epw) {
        const float* src = F + crd[u * N + col] * kw;
        if (wb == 2) cp_async8(d + u * S, src);
        else cp_async4(d + u * S, src);
      }
    }
  };

#pragma unroll
  for (int k = 0; k < kRecDepth; ++k) {
    issue_records(k);
    cp_async_commit();
  }
  cp_async_wait<kRecDepth - 1>();  // tile 0's records
  __syncwarp();
  issue_gather(0);
  cp_async_commit();
  cp_async_commit();  // empty: every tile then waits for all but one group

  float acc[kA][kB];
  zero_block(acc);
  int cur = head;
  // One element's products. A new row stores the sums so far and starts
  // each from 0 (the same sums as zeroing first; the branch writes the
  // accumulators in place, so none is copied on the common path).
  auto step = [&](const Element<kA, kB>& e) {
    float a[kA];
#pragma unroll
    for (int t = 0; t < kA; ++t) a[t] = __fmul_rn(__fmul_rn(e.v, e.f1[t]), e.f2[t]);
    if (e.row != cur) {
      // cur is not the chunk's last row here (row > cur follows it)
      if (cur == head)
        store_block(head_slot, acc, ka0, kb0, nA, nB, Kb);
      else if ((unsigned)cur < (unsigned)g.num_rows)
        store_block(g.z + (long long)cur * K, acc, ka0, kb0, nA, nB, Kb);
      cur = e.row;
#pragma unroll
      for (int t = 0; t < kA; ++t)
#pragma unroll
        for (int w = 0; w < kB; ++w) acc[t][w] = accumulate<kBf16>(0.f, a[t], e.b[w]);
    } else {
#pragma unroll
      for (int t = 0; t < kA; ++t)
#pragma unroll
        for (int w = 0; w < kB; ++w) acc[t][w] = accumulate<kBf16>(acc[t][w], a[t], e.b[w]);
    }
  };

  for (int k = 0; k < ntiles; ++k) {
    cp_async_wait<1>();  // tile k's gather and tile k+1's records
    __syncwarp();
    issue_gather(k + 1);
    cp_async_commit();
    issue_records(k + kRecDepth);
    cp_async_commit();
    if (active) {
      const int n = tile_len(k);
      const uint32_t* r = rec_at(k);
      const int* srow = reinterpret_cast<const int*>(r);
      const float* sval = reinterpret_cast<const float*>(r + T);
      const char* gs = reinterpret_cast<const char*>(gat_at(k));
      const int SB = 4 * S;
      // two elements in flight: the next one's reads before this one's
      // products (a read past the tile's end rereads its last element)
      Element<kA, kB> x, y;
      load_element(x, srow, sval, gs, o1, o2, 0);
      for (int u = 0; u < n; u += 2) {
        const int u1n = min(u + 1, n - 1);
        load_element(y, srow, sval, gs + u1n * SB, o1, o2, u1n);
        step(x);
        if (u + 1 == n) break;
        const int u2n = min(u + 2, n - 1);
        load_element(x, srow, sval, gs + u2n * SB, o1, o2, u2n);
        step(y);
      }
    }
    __syncwarp();
  }
  cp_async_wait<0>();  // no copy outlives the warp
  if (!active) return;
  // cur is the chunk's last row
  if (cur == head) {
    store_block(head_slot, acc, ka0, kb0, nA, nB, Kb);
    zero_block(acc);
  }
  store_block(tail_slot, acc, ka0, kb0, nA, nB, Kb);
}

template <bool kBf16, int kA, int kB>
cudaError_t launch(Args a, cudaStream_t st) {
  const int nbg = (a.Kb + kB - 1) / kB;
  a.s3 = padded(nbg * kB);
  a.tile = tile_elements(a.N, gather_words(a.K1, a.K2, a.s3));
  if (a.tile == 0) return cudaErrorInvalidValue;  // rows too wide to stage
  const long long pairs = (long long)((a.K1 * a.K2 + kA - 1) / kA) * nbg;
  const long long pair_tiles = (pairs + 31) / 32;
  if (pair_tiles > 65535) return cudaErrorInvalidConfiguration;
  const dim3 grid((unsigned)((a.nchunks + kWarpsPerBlock - 1) / kWarpsPerBlock),
                  (unsigned)pair_tiles);
  const size_t smem = sizeof(uint32_t) * kWarpsPerBlock * kWords;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        chunk_kernel<kBf16, kA, kB>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
  }
  chunk_kernel<kBf16, kA, kB><<<grid, 32 * kWarpsPerBlock, smem, st>>>(a);
  return cudaGetLastError();
}

// The lane block: 4 x 10 covers a last factor of up to 10 columns in one b
// group (K = 10 per mode exactly; narrower ones leave columns unused); a
// wider one takes b groups of 16. Either way kb0 is a multiple of 4.
template <bool kBf16>
cudaError_t launch_widths(const Args& a, cudaStream_t st) {
  if (a.Kb <= 10) return launch<kBf16, 4, 10>(a, st);
  return launch<kBf16, 2, 16>(a, st);
}

}  // namespace lead2

template <bool kBf16, bool kGatherA, bool kGatherB>
cudaError_t launch_chunks(ChunkArgs a, dim3 grid, cudaStream_t st) {
  a.tile = tile_elements(kGatherA, kGatherB, a.N, a.Ka, a.Kb);
  if (a.tile == 0) return cudaErrorInvalidValue;  // rows too wide to stage
  const size_t smem = sizeof(uint32_t) * kWarpsPerBlock * kWarpSmemWords;
  chunk_kernel<kBf16, kGatherA, kGatherB><<<grid, 32 * kWarpsPerBlock, smem, st>>>(a);
  return cudaGetLastError();
}

template <bool kBf16>
cudaError_t launch_form(const ChunkArgs& a, dim3 grid, cudaStream_t st) {
  if (a.col_a >= 0) return launch_chunks<kBf16, true, true>(a, grid, st);
  if (a.col_b >= 0) return launch_chunks<kBf16, false, true>(a, grid, st);
  return launch_chunks<kBf16, false, false>(a, grid, st);
}

}  // namespace

// The fix-up of the rows that span chunks, after either chunk walk.
static int launch_fixup(const int* rows, const float* part, float* z,
                        long long E, int num_rows, int K, int chunk,
                        long long nchunks, cudaStream_t st) {
  const dim3 grid((unsigned)(2 * nchunks), (unsigned)((K + 127) / 128));
  fixup_kernel<<<grid, 128, 0, st>>>(rows, part, z, E, num_rows, K, chunk, 2 * nchunks);
  return (int)cudaGetLastError();
}

// The row products ZX = Z @ x of the fused form, once Z is whole.
static int launch_zx(const float* z, const float* x, float* zx, int num_rows,
                     int K, int s, cudaStream_t st) {
  if (num_rows == 0) return 0;
  const long long blocks = ((long long)num_rows + kWarpsPerBlock - 1) / kWarpsPerBlock;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidConfiguration;
  zx_kernel<<<(unsigned)blocks, 32 * kWarpsPerBlock, 0, st>>>(z, x, zx, num_rows, K, s);
  return (int)cudaGetLastError();
}

// Launch both kernels on `stream`. Form: col_a >= 0 gathers a = values *
// A[coords[:, col_a]] (then col_b >= 0 too); col_a < 0 reads a as (E, Ka) rows
// of A; likewise b from B with col_b. `coords` is (E, N) row-major and may be
// null when neither is gathered. `part` holds 2 * ceil(E / chunk) * Ka * Kb
// floats of scratch. Returns the CUDA error code of the launches (0 = ok).
extern "C" int kron_segsum_launch(const int* rows, const float* values,
                                  const int* coords, const float* A,
                                  const float* B, float* z, float* part,
                                  long long E, int num_rows, int Ka, int Kb,
                                  int N, int col_a, int col_b, int chunk,
                                  int bf16, void* stream) {
  if (E <= 0 || num_rows < 0 || Ka <= 0 || Kb <= 0 || chunk <= 0)
    return (int)cudaErrorInvalidValue;
  if ((col_a >= 0 && (col_b < 0 || values == nullptr)) ||
      ((col_a >= 0 || col_b >= 0) && (coords == nullptr || N <= 0)) ||
      col_a >= N || col_b >= N)
    return (int)cudaErrorInvalidValue;
  const int K = Ka * Kb;
  const long long pairs = (long long)Ka * ((Kb + kCols - 1) / kCols);
  const long long nchunks = (E + chunk - 1) / chunk;
  const long long pair_tiles = (pairs + 31) / 32;
  const long long col_tiles = (K + 127) / 128;
  if (2 * nchunks > 0x7fffffffLL || pair_tiles > 65535 || col_tiles > 65535)
    return (int)cudaErrorInvalidConfiguration;
  cudaStream_t st = static_cast<cudaStream_t>(stream);

  const ChunkArgs args{rows, values, coords, A, B, z, part, E, nchunks,
                       num_rows, Ka, Kb, chunk, N, col_a, col_b, 0};
  const dim3 grid((unsigned)((nchunks + kWarpsPerBlock - 1) / kWarpsPerBlock),
                  (unsigned)pair_tiles);
  const cudaError_t err = bf16 ? launch_form<true>(args, grid, st)
                               : launch_form<false>(args, grid, st);
  if (err != cudaSuccess) return (int)err;
  return launch_fixup(rows, part, z, E, num_rows, K, chunk, nchunks, st);
}

// (Z, Z @ X) on `stream`: kron_segsum_launch, then the row products. `x` is
// (Ka*Kb, s) row-major and `zx` (num_rows, s); the other arguments as for
// kron_segsum_launch, `z` zeroed. Returns the CUDA error code (0 = ok).
extern "C" int kron_segsum_oracle_launch(const int* rows, const float* values,
                                         const int* coords, const float* A,
                                         const float* B, float* z, float* part,
                                         const float* x, float* zx, long long E,
                                         int num_rows, int Ka, int Kb, int N,
                                         int col_a, int col_b, int chunk, int s,
                                         int bf16, void* stream) {
  if (s <= 0 || num_rows < 0) return (int)cudaErrorInvalidValue;
  const int err = kron_segsum_launch(rows, values, coords, A, B, z, part, E,
                                     num_rows, Ka, Kb, N, col_a, col_b, chunk,
                                     bf16, stream);
  if (err != 0) return err;
  return launch_zx(z, x, zx, num_rows, Ka * Kb, s, static_cast<cudaStream_t>(stream));
}

// The four-mode gather form on `stream`: per element a = (values[e] *
// F1[coords[e, c1]]) kron F2[coords[e, c2]], formed in the walk and never
// stored, and b = F3[coords[e, c3]]; Z (num_rows, K1*K2*Kb) zeroed, `part`
// as for kron_segsum_launch. With s > 0 also ZX = Z @ x, as
// kron_segsum_oracle_launch (x and zx unused at s = 0). Returns the CUDA
// error code of the launches (0 = ok).
extern "C" int kron_segsum_lead2_launch(const int* rows, const float* values,
                                        const int* coords, const float* F1,
                                        const float* F2, const float* F3,
                                        float* z, float* part, const float* x,
                                        float* zx, long long E, int num_rows,
                                        int K1, int K2, int Kb, int N, int c1,
                                        int c2, int c3, int chunk, int s,
                                        int bf16, void* stream) {
  if (E <= 0 || num_rows < 0 || K1 <= 0 || K2 <= 0 || Kb <= 0 || chunk <= 0 ||
      s < 0 || values == nullptr || coords == nullptr || N <= 0 || c1 < 0 ||
      c2 < 0 || c3 < 0 || c1 >= N || c2 >= N || c3 >= N ||
      (s > 0 && (x == nullptr || zx == nullptr)))
    return (int)cudaErrorInvalidValue;
  const long long K = (long long)K1 * K2 * Kb;
  const long long nchunks = (E + chunk - 1) / chunk;
  if (K > 0x7fffffffLL || 2 * nchunks > 0x7fffffffLL || (K + 127) / 128 > 65535)
    return (int)cudaErrorInvalidConfiguration;
  cudaStream_t st = static_cast<cudaStream_t>(stream);

  const lead2::Args args{rows, values, coords, F1, F2, F3, z, part, E, nchunks,
                         num_rows, K1, K2, Kb, chunk, N, c1, c2, c3, 0, 0};
  const cudaError_t err = bf16 ? lead2::launch_widths<true>(args, st)
                               : lead2::launch_widths<false>(args, st);
  if (err != cudaSuccess) return (int)err;
  const int rc = launch_fixup(rows, part, z, E, num_rows, (int)K, chunk, nchunks, st);
  if (rc != 0 || s == 0) return rc;
  return launch_zx(z, x, zx, num_rows, (int)K, s, st);
}
