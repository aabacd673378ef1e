// oracle_pair: (xo, yo) = (Z @ x, Z^T @ y) in one launch, for P stacked ranks.
//
// Replaces the TPU kernel src/repro/kernels/oracle_fused.py::oracle_pair
// (pallas_call at :83, body _kernel at :36), which streamed 128-row blocks
// of Z through VMEM and kept the Z^T y sum in a grid-constant accumulator.
// Blocks on a GPU run in no order, so that accumulator becomes per-block
// partials, added in the same launch by the blocks that finish last.
//
// Shapes: Z is (P*R, K) row-major, the ranks' local matrices stacked; x is
// (K, s) and xo (P*R, s); y is (P, R, s) and yo (P, K, s): each rank's
// Z_p^T y_p. s = 1 is the vector oracle. Either half may be left out (null
// x, or null y): Golub-Kahan asks for one product at a time (u = f(Z v)
// comes before Z^T u), so this is how the Lanczos loop calls it; a call
// asking for both reads each block's rows twice, once per half.
//
// What bounds it on an H100: bytes. Z is read once (R*K*4 B: 11.5 MB for
// nell-2's 28,818 x 100 mode) for 2*R*K*s flops per half; at 3.35 TB/s that
// is a few microseconds, the same order as a launch and a grid-wide
// reduction, so the design keeps to one launch and a short reduction tail.
//
// Design:
//  * One launch for either half. Each rank's rows are cut into `bpr` blocks
//    of `rb` consecutive rows (from R, K, s, the SM count and which half is
//    asked); no block straddles two ranks.
//  * Z @ x: each warp takes kRU rows at a time straight from device memory,
//    each lane loading 16 bytes of each row (V = 4 floats when K % 4 == 0
//    and Z is 16-byte aligned, else 1), kRU rows of loads in flight per
//    warp; a lane sums its columns in column order and a fixed pattern of
//    __shfl_xor steps adds the warp (for 8-column panels a transposing
//    butterfly: 9 shuffles a row instead of 40). A row's sum does not
//    depend on the blocks, so a stacked call gives every row the bits of a
//    single call.
//  * Z^T y: a block first copies its whole slab of Z and of y into shared
//    memory with cp.async (16-byte copies where aligned), so all of its
//    bytes are in flight at once: one round trip to device memory. Then a
//    thread per (column, panel-column group) and, when there are fewer of
//    those than threads, a fixed split of the rows sums its rows in row
//    order; the splits are added in split order into the block's partial.
//    Blocks are grouped by kGroup; the last block of a group to finish (an
//    integer ticket, reset by that block) adds the group's partials in
//    block order, and the last group to finish adds the groups' sums in
//    group order into yo. The integer tickets decide who adds, never the
//    order of a float sum, and there are no float atomics, so reruns are
//    bitwise equal, and a stacked call gives each rank exactly the bits of a
//    single call on that rank's rows (same rb, same order).
//  * The kernel is compiled for vectors (one panel column per pass) and
//    for panels (kSC columns per pass).
//  * On the H100 (PERF.md) the Z @ x half runs at about one cuBLAS gemv;
//    the Z^T y half stays slower: after the slab copy, the sums from shared
//    memory and the two-level reduction tail take most of its time.
//
// Preconditions: Z, x, y contiguous float32; `part`, `gpart` and `ticket`
// scratch from the wrapper, tickets zero before the first launch (each
// launch leaves them zero). Calls sharing one scratch must be stream-ordered.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kSC = 8;       // panel columns per pass (panels; 1 for vectors)
constexpr int kRU = 4;       // rows a warp has in flight in the Z @ x half
constexpr int kGroup = 8;    // blocks per first-level reduction group
constexpr int kMinRows = 128;  // rows per block at least (fewer, larger partials)
constexpr int kSmemBytes = 96 * 1024;  // a block's staged slab and scratch

struct Args {
  const float* Z;
  const float* x;
  const float* y;
  float* xo;
  float* yo;
  float* part;   // (P * bpr, K * s)
  float* gpart;  // (P * ngroups, K * s)
  int* ticket;   // (P * ngroups + P)
  int R, K, s, P, rb, bpr;
};

// floats of shared memory a block uses for rb rows in the Z^T y half
__host__ __device__ inline long long smem_floats(long long rb, int K, int s) {
  return rb * (K + s) + (long long)kThreads * kSC;
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d), "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d), "l"(src) : "memory");
}

// The block copies n floats from src to dst: 16-byte copies where both are
// 16-byte aligned, else 4-byte ones.
__device__ __forceinline__ void block_copy(float* dst, const float* src, long long n) {
  long long done = 0;
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  if (((reinterpret_cast<uintptr_t>(src) | d) & 15) == 0) {
    done = n & ~3LL;
    for (long long i = 4LL * threadIdx.x; i < done; i += 4LL * kThreads)
      cp_async16(dst + i, src + i);
  }
  for (long long i = done + threadIdx.x; i < n; i += kThreads) cp_async4(dst + i, src + i);
}

// Sums the `count` rows of `src` (stride n) in row order into dst, columns
// over the block's threads; reads through L2, where the other blocks wrote.
__device__ void sum_rows(const float* src, int count, int n, float* dst) {
  for (int o = threadIdx.x; o < n; o += kThreads) {
    float acc = 0.f;
#pragma unroll 8
    for (int q = 0; q < count; ++q) acc += __ldcg(src + (long long)q * n + o);
    dst[o] = acc;
  }
}

// True in every thread of the block when it is the last of `total` to take
// a ticket from *t; that block resets the ticket for the next launch.
// The block's stores are ordered before the ticket by the barrier and one
// device-scope fence in the thread that takes it (as a CUTLASS semaphore
// releases); the last block fences again before it reads the others' sums.
__device__ bool last_to_arrive(int* t, int total) {
  __shared__ int last;
  __syncthreads();
  if (threadIdx.x == 0) {
    __threadfence();
    last = atomicAdd(t, 1) == total - 1;
    if (last) *t = 0;
  }
  __syncthreads();
  if (last) __threadfence();
  return last;
}

// The warp's sums of SC values per lane, by a fixed pattern of xor
// shuffles. SC = 1: a butterfly, every lane holds the sum. SC = 8: a
// transposing butterfly (9 shuffles instead of 40): after the first three
// steps a lane keeps one column, column_of<8>(lane), summed over its
// 8-lane group, and two more steps add the groups.
template <int SC>
__device__ __forceinline__ float warp_sum(const float (&v)[SC], int lane);

template <>
__device__ __forceinline__ float warp_sum<1>(const float (&v)[1], int) {
  float t = v[0];
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) t += __shfl_xor_sync(0xffffffffu, t, off);
  return t;
}

template <>
__device__ __forceinline__ float warp_sum<8>(const float (&v)[8], int lane) {
  const bool b4 = lane & 16, b3 = lane & 8, b2 = lane & 4;
  float w4[4], w2[2];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float keep = b4 ? v[i + 4] : v[i];
    w4[i] = keep + __shfl_xor_sync(0xffffffffu, b4 ? v[i] : v[i + 4], 16);
  }
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const float keep = b3 ? w4[i + 2] : w4[i];
    w2[i] = keep + __shfl_xor_sync(0xffffffffu, b3 ? w4[i] : w4[i + 2], 8);
  }
  float t = (b2 ? w2[1] : w2[0]) + __shfl_xor_sync(0xffffffffu, b2 ? w2[0] : w2[1], 4);
  t += __shfl_xor_sync(0xffffffffu, t, 2);
  t += __shfl_xor_sync(0xffffffffu, t, 1);
  return t;
}

// The panel column whose sum warp_sum<SC> leaves in `lane`.
template <int SC>
__device__ __forceinline__ int column_of(int lane) {
  return SC == 1 ? 0 : ((lane >> 4) & 1) * 4 + ((lane >> 3) & 1) * 2 + ((lane >> 2) & 1);
}

template <int V>
struct Vec;
template <>
struct Vec<4> {
  __device__ static void load(const float* p, float (&v)[4]) {
    const float4 q = __ldg(reinterpret_cast<const float4*>(p));
    v[0] = q.x; v[1] = q.y; v[2] = q.z; v[3] = q.w;
  }
};
template <>
struct Vec<1> {
  __device__ static void load(const float* p, float (&v)[1]) { v[0] = __ldg(p); }
};

// V: floats per load of Z in the Z @ x half (4 when K % 4 == 0 and Z is
// 16-byte aligned); SC: panel columns per pass (1 for the vector oracle).
template <int V, int SC>
__global__ void __launch_bounds__(kThreads) oracle_kernel(Args p) {
  extern __shared__ __align__(16) float smem[];
  const int rank = blockIdx.x / p.bpr;
  const int blk = blockIdx.x - rank * p.bpr;
  const int r0 = blk * p.rb;
  const int nr = min(p.R, r0 + p.rb) - r0;
  const int K = p.K, s = p.s;
  const long long row0 = (long long)rank * p.R + r0;  // first stacked row

  if (p.x != nullptr) {
    // a warp per kRU rows at a time, straight from device memory: each lane
    // loads V columns of each row (16 bytes), sums them in column order,
    // and warp_sum adds the warp
    const int lane = threadIdx.x & 31;
    const int warp = threadIdx.x >> 5;
    const int G = K / V;
    const float* Zr = p.Z + row0 * K;
    for (int c0 = 0; c0 < s; c0 += SC) {
      const int sc = min(SC, s - c0);
      for (int r = warp * kRU; r < nr; r += kWarps * kRU) {
        float acc[kRU][SC];
#pragma unroll
        for (int u = 0; u < kRU; ++u)
#pragma unroll
          for (int c = 0; c < SC; ++c) acc[u][c] = 0.f;
        for (int g = lane; g < G; g += 32) {
          float z[kRU][V];
#pragma unroll
          for (int u = 0; u < kRU; ++u) {
            if (r + u < nr) Vec<V>::load(Zr + (long long)(r + u) * K + g * V, z[u]);
            else
#pragma unroll
              for (int v = 0; v < V; ++v) z[u][v] = 0.f;
          }
#pragma unroll
          for (int v = 0; v < V; ++v) {
            const float* xk = p.x + (long long)(g * V + v) * s + c0;
#pragma unroll
            for (int c = 0; c < SC; ++c) {
              if (c < sc) {
                const float xv = __ldg(xk + c);
#pragma unroll
                for (int u = 0; u < kRU; ++u) acc[u][c] = fmaf(z[u][v], xv, acc[u][c]);
              }
            }
          }
        }
#pragma unroll
        for (int u = 0; u < kRU; ++u) {
          const float t = warp_sum<SC>(acc[u], lane);
          const int c = column_of<SC>(lane);
          const bool writer = SC == 1 ? lane == 0 : (lane & 3) == 0;
          if (writer && c < sc && r + u < nr) p.xo[(row0 + r + u) * s + c0 + c] = t;
        }
      }
    }
  }

  if (p.y == nullptr) return;
  // Z^T y: the block's slab of Z and of y, staged in shared memory
  float* zs = smem;                        // nr x K
  float* ys = zs + (long long)p.rb * K;    // nr x s
  float* red = ys + (long long)p.rb * s;   // kThreads x SC
  block_copy(zs, p.Z + row0 * K, (long long)nr * K);
  block_copy(ys, p.y + row0 * s, (long long)nr * s);
  asm volatile("cp.async.commit_group;\n" ::: "memory");
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
  __syncthreads();

  const int n = K * s;
  float* mine = p.part + (long long)blockIdx.x * n;
  const int nch = (s + SC - 1) / SC;
  const int J = K * nch;                                   // (column, chunk) jobs
  const int Q = J < kThreads ? min(kThreads / J, nr) : 1;  // row splits
  for (int jq = threadIdx.x; jq < J * Q; jq += kThreads) {
    const int q = jq / J, j = jq - q * J;
    const int ch = j / K, k = j - ch * K;
    const int c0 = ch * SC, sc = min(SC, s - c0);
    float acc[SC];
#pragma unroll
    for (int c = 0; c < SC; ++c) acc[c] = 0.f;
    const int ra = (int)((long long)nr * q / Q), rz = (int)((long long)nr * (q + 1) / Q);
    for (int r = ra; r < rz; ++r) {
      const float zv = zs[(long long)r * K + k];
      const float* yr = ys + (long long)r * s + c0;
#pragma unroll
      for (int c = 0; c < SC; ++c)
        if (c < sc) acc[c] = fmaf(zv, yr[c], acc[c]);
    }
    if (Q == 1) {
#pragma unroll
      for (int c = 0; c < SC; ++c)
        if (c < sc) mine[(long long)k * s + c0 + c] = acc[c];
    } else {
#pragma unroll
      for (int c = 0; c < SC; ++c) red[jq * SC + c] = acc[c];
    }
  }
  if (Q > 1) {
    __syncthreads();
    for (int j = threadIdx.x; j < J; j += kThreads) {
      const int ch = j / K, k = j - ch * K;
      const int c0 = ch * SC, sc = min(SC, s - c0);
      for (int c = 0; c < sc; ++c) {
        float t = 0.f;
        for (int q = 0; q < Q; ++q) t += red[(q * J + j) * SC + c];
        mine[(long long)k * s + c0 + c] = t;
      }
    }
  }

  const int ngroups = (p.bpr + kGroup - 1) / kGroup;
  const int grp = blk / kGroup;
  const int in_grp = min(kGroup, p.bpr - grp * kGroup);
  if (!last_to_arrive(p.ticket + rank * ngroups + grp, in_grp)) return;
  float* gsum = p.gpart + ((long long)rank * ngroups + grp) * n;
  sum_rows(p.part + ((long long)rank * p.bpr + grp * kGroup) * n, in_grp, n, gsum);
  int* rank_ticket = p.ticket + p.P * ngroups + rank;
  if (!last_to_arrive(rank_ticket, ngroups)) return;
  sum_rows(p.gpart + (long long)rank * ngroups * n, ngroups, n, p.yo + (long long)rank * n);
}

}  // namespace

// Rows per block, blocks per rank and reduction groups per rank for R rows
// per rank of width K with s panel columns on `sms` SMs. With y (a Z^T y
// half): about one block per SM for a single rank, at least kMinRows rows
// (so the partials stay a small share of the bytes), within kSmemBytes of
// shared memory. Without y: about two blocks per SM, at least kWarps * kRU
// rows. Both a multiple of kWarps. They depend on R, K, s and the card only,
// so a stacked call cuts each rank exactly as a single call on it does.
// Returns 0, or -1 when even one row does not fit.
extern "C" int oracle_pair_geometry(int R, int K, int s, int sms, int with_y,
                                    int* rb, int* bpr, int* groups) {
  const long long target = (with_y ? 1LL : 2LL) * (sms > 0 ? sms : 1);
  const long long least = with_y ? kMinRows : kWarps * kRU;
  long long rows = (R + target - 1) / target;
  rows = ((rows + kWarps - 1) / kWarps) * kWarps;
  if (rows < least) rows = least;
  if (with_y) {
    const long long cap = (kSmemBytes / 4 - (long long)kThreads * kSC) / ((long long)K + s);
    if (cap < 1) return -1;
    if (rows > cap) rows = cap;
  }
  *rb = (int)rows;
  *bpr = (int)((R + rows - 1) / rows);
  *groups = (*bpr + kGroup - 1) / kGroup;
  return 0;
}

template <int V, int SC>
cudaError_t launch(const Args& a, size_t smem, cudaStream_t st) {
  static bool attr_set[64] = {};  // the shared-memory limit, once per device
  int dev = 0;
  cudaGetDevice(&dev);
  if (dev < 0 || dev >= 64) return cudaErrorInvalidDevice;
  if (!attr_set[dev]) {
    const cudaError_t err = cudaFuncSetAttribute(
        oracle_kernel<V, SC>, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemBytes);
    if (err != cudaSuccess) return err;
    attr_set[dev] = true;
  }
  oracle_kernel<V, SC><<<a.P * a.bpr, kThreads, smem, st>>>(a);
  return cudaGetLastError();
}

// One launch on `stream`. x and xo, or y and yo (with part, gpart and
// ticket), may be null, not both halves; rb and bpr from
// oracle_pair_geometry with with_y = (y != null). Returns the CUDA error
// code of the launch (0 = ok).
extern "C" int oracle_pair_launch(const float* Z, const float* x, const float* y,
                                  float* xo, float* yo, float* part,
                                  float* gpart, int* ticket, int R, int K,
                                  int s, int P, int rb, int bpr, void* stream) {
  if (R <= 0 || K <= 0 || s <= 0 || P <= 0 || rb <= 0 || bpr <= 0 ||
      (x == nullptr && y == nullptr))
    return (int)cudaErrorInvalidValue;
  if ((long long)P * bpr > 0x7fffffffLL) return (int)cudaErrorInvalidConfiguration;
  const long long smem = y != nullptr ? 4 * smem_floats(rb, K, s) : 0;
  if (smem > kSmemBytes) return (int)cudaErrorInvalidValue;
  const Args a{Z, x, y, xo, yo, part, gpart, ticket, R, K, s, P, rb, bpr};
  const bool vec4 = K % 4 == 0 && (reinterpret_cast<uintptr_t>(Z) & 15) == 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (s == 1)
    err = vec4 ? launch<4, 1>(a, (size_t)smem, st) : launch<1, 1>(a, (size_t)smem, st);
  else
    err = vec4 ? launch<4, kSC>(a, (size_t)smem, st) : launch<1, kSC>(a, (size_t)smem, st);
  return (int)err;
}
