// Keyed arrival rank for the interval join's grouped block form, for
// NVIDIA Hopper (sm_90a).
//
// Replaces no Pallas kernel: the TPU package computes the same function
// with jnp.cumsum over a one-hot (clonos_tpu/api/operators.py,
// IntervalJoinOperator.process_block), which XLA lowers for the TPU. On
// this card the same one-hot cumsum is an outer-dim scan of a [P, G*B, nk]
// int32 tensor that, at config #5's replay shape (P=1, G=64, B=256,
// nk=211: 13.8 MB), keeps 211 columns of one SM busy 16,384 rows deep,
// ~2.8 ms a group. This kernel computes the function without building the
// one-hot.
//
// For each lane p of [P, n = G*B] int32 keys (clamped to [0, nk) by the
// caller) and bool valid, in (step g, slot i) order:
//   rank[p, g*B + i]   the 0-based rank of a valid record among the valid
//                      records of its key at or before it; n for an
//                      invalid record (int64, the join's spare row)
//   through[p, g, k]   the count of valid records of key k in steps 0..g
//                      (int32, inclusive)
// bit-identical to ops/keyrank.py's keyed_rank_plain. A key outside
// [0, nk), which the caller never passes, is treated as invalid, so the
// kernel never writes outside its tables.
//
// Bound. Bytes: P*n*(4 + 1) in, P*n*8 + P*G*nk*4 out; at the replay shape
// 267,008 bytes (0.08 us at 3.35 TB/s), at the fill shape (P=32, G=4,
// B=256) 534,016 bytes (0.16 us); the counts scratch, P*G*nk*4 written
// and read back from L2, is not counted. The arithmetic is a few integer
// operations a record. Either way the kernel is launch-bound: what the
// design does is keep the work in two short launches with no host
// synchronisation.
//   1. rank_step_kernel, one block per (step g, lane p). Each warp groups
//      its 32 records by key with __match_any_sync; a record's rank among
//      its warp's peers is the popcount of its lower peer lanes. The
//      block's per-key running count lives in a table; the warps take
//      turns on it in slot order (one __syncthreads() a warp), the lowest
//      lane of each key group reading the count and adding the group's
//      size, so the in-step rank is exact and in order. The table is in
//      shared memory where nk ints fit the 48 KB a block has without an
//      opt-in, else the block's own row of the global `counts` scratch
//      (large nk; ops/keyrank.py allocates it). Each step's counts go to
//      counts[p, g, :].
//   2. rank_offset_kernel, one block per (g, p) again: through[p, g, k] is
//      the sum of counts[p, 0..g, k] (at most G <= 64 values a key, read
//      from L2, independent loads), and each valid record's rank gains
//      its key's count in the steps before g.
// Interface: plain C, loaded with ctypes; the launch returns
// cudaGetLastError() so the Python wrapper raises on a refused launch.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxThreads = 1024;
constexpr int kOffsetThreads = 256;
constexpr int kSmemTableBytes = 48 * 1024;
constexpr int kMaxGridY = 65535;

__global__ void __launch_bounds__(kMaxThreads)
rank_step_kernel(const int32_t* __restrict__ keys,
                 const uint8_t* __restrict__ valid,
                 int64_t* __restrict__ rank, int32_t* __restrict__ counts,
                 int G, int B, int nk, int in_smem) {
  extern __shared__ int32_t s_table[];
  const int64_t step = static_cast<int64_t>(blockIdx.y) * G + blockIdx.x;
  const int64_t base = step * B;
  const int64_t n = static_cast<int64_t>(G) * B;
  int32_t* table = in_smem ? s_table : counts + step * nk;
  for (int k = threadIdx.x; k < nk; k += blockDim.x) table[k] = 0;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int warps = blockDim.x >> 5;
  const unsigned lower = (1u << lane) - 1u;
  for (int t0 = 0; t0 < B; t0 += blockDim.x) {
    const int i = t0 + threadIdx.x;
    int k = -1;
    if (i < B) {
      const int32_t key = keys[base + i];
      if (valid[base + i] && static_cast<uint32_t>(key)
                                 < static_cast<uint32_t>(nk))
        k = key;
    }
    const unsigned peers = __match_any_sync(0xffffffffu, k);
    const int below = __popc(peers & lower);
    int64_t r = n;
    const int live = min(warps, (B - t0 + 31) >> 5);
    for (int w = 0; w < live; ++w) {
      // The zeroed table, or warp w - 1's counts, are visible.
      __syncthreads();
      if (warp == w && k >= 0) {
        const int32_t c = table[k];
        r = c + below;
        __syncwarp(peers);  // every peer has read c
        if (below == 0) table[k] = c + __popc(peers);
      }
    }
    if (i < B) rank[base + i] = r;
  }
  if (in_smem) {
    __syncthreads();
    int32_t* out = counts + step * nk;
    for (int k = threadIdx.x; k < nk; k += blockDim.x) out[k] = s_table[k];
  }
}

__global__ void __launch_bounds__(kOffsetThreads)
rank_offset_kernel(const int32_t* __restrict__ keys,
                   int64_t* __restrict__ rank,
                   const int32_t* __restrict__ counts,
                   int32_t* __restrict__ through, int G, int B, int nk) {
  const int g = blockIdx.x;
  const int64_t step = static_cast<int64_t>(blockIdx.y) * G + g;
  const int32_t* c = counts + static_cast<int64_t>(blockIdx.y) * G * nk;
  const int32_t* own = counts + step * nk;
  int32_t* th = through + step * nk;
  for (int k = threadIdx.x; k < nk; k += blockDim.x) {
    int32_t s = own[k];
#pragma unroll 8
    for (int j = 0; j < g; ++j) s += c[static_cast<int64_t>(j) * nk + k];
    th[k] = s;
  }
  if (g == 0) return;  // the first step's ranks are its in-step ranks
  __syncthreads();     // this step's through row is written
  const int64_t base = step * B;
  const int64_t n = static_cast<int64_t>(G) * B;
  for (int i = threadIdx.x; i < B; i += blockDim.x) {
    const int64_t r = rank[base + i];
    if (r != n) {
      const int32_t k = keys[base + i];
      rank[base + i] = r + th[k] - own[k];
    }
  }
}

}  // namespace

// One call of ops/keyrank.py's keyed_rank_cuda: args = {P, G, B, nk,
// threads, smem, device}, smem the table's bytes (0: the table is the
// global `counts` scratch); both kernels on `stream` of `device`. Returns
// a cudaError_t (0 on success).
extern "C" int keyed_rank_launch(const void* keys, const void* valid,
                                 void* rank, void* counts, void* through,
                                 const int* args, void* stream) {
  const int P = args[0], G = args[1], B = args[2], nk = args[3];
  const int threads = args[4], smem = args[5], device = args[6];
  if (P <= 0 || P > kMaxGridY || G <= 0 || B < 0 || nk <= 0
      || threads < 32 || threads > kMaxThreads || threads % 32 != 0
      || (smem != 0 && (static_cast<int64_t>(nk) * 4 != smem
                        || smem > kSmemTableBytes)))
    return static_cast<int>(cudaErrorInvalidValue);
  int prev = 0;
  cudaError_t err = cudaGetDevice(&prev);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (prev != device) {
    err = cudaSetDevice(device);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int32_t* k = static_cast<const int32_t*>(keys);
  int64_t* r = static_cast<int64_t*>(rank);
  int32_t* c = static_cast<int32_t*>(counts);
  const dim3 grid(G, P);
  rank_step_kernel<<<grid, threads, smem, s>>>(
      k, static_cast<const uint8_t*>(valid), r, c, G, B, nk,
      smem != 0 ? 1 : 0);
  err = cudaGetLastError();
  if (err == cudaSuccess) {
    rank_offset_kernel<<<grid, kOffsetThreads, 0, s>>>(
        k, r, c, static_cast<int32_t*>(through), G, B, nk);
    err = cudaGetLastError();
  }
  if (prev != device) {
    const cudaError_t back = cudaSetDevice(prev);
    if (err == cudaSuccess) err = back;
  }
  return static_cast<int>(err);
}

extern "C" const char* keyed_rank_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
