// Keyed histogram (per-row segment sum) for NVIDIA Hopper (sm_90a).
//
// Replaces the Pallas TPU kernels of clonos_tpu/ops/histogram.py:
//   _hist_kernel       (histogram.py:34, launched by _hist_pallas at :112)
//   _hist_kernel_sums  (histogram.py:56, launched by _hist_pallas at :103)
// as ONE kernel template with the count output as a flag.
//
// Computes, for each row r of the flattened [R, B] int32 keys/vals and
// bool valid:
//   sums[r, k] = sum of vals[r, i] over valid records with keys[r, i] == k
//   cnts[r, k] = number of such records              (kCounts only)
// for k in [0, nk). Invalid records and out-of-range keys drop (the
// scatter mode="drop" contract of the reference's XLA fallback). The TPU
// kernel does an O(R * B * nk) one-hot compare-accumulate on the VPU; here
// the work is O(R * (B + nk)): a row's table lives in shared memory and
// takes int32 atomicAdds. int32 addition wraps and is associative mod
// 2^32, so the atomic order cannot change the result: the output is
// bit-exact against the plain scatter_add_ version.
//
// Bound. Bytes: R * B * 9 in (keys, vals int32, valid bool), R * nk * 4 out
// for each output. At the exchange shape (R=512, B=1024, nk=8192, counts)
// ~38 MB, 11.4 us at 3.35 TB/s, 33.5 MB of it output; at the window shape
// (R=4096, B=1024, nk=997, sums only) ~54 MB, 16.1 us. The int32 adds (R * B
// per output) are far below the card's rate. What the design does:
//   1. No load waits on another. All three fields of a record are loaded
//      unconditionally; `valid` and the range check are a predicate on the
//      atomic, never a branch in front of a load. Same-key atomics are not
//      aggregated: at the window shape on an H100, Zipf(1.2) keys cost
//      within 4% of uniform keys' device time, and 90% of records on one
//      key 14-20% more (chip_smoke.py phase 2).
//   2. Persistent blocks. The grid is at most the blocks resident at once
//      (ops/histogram.py's _plan); each walks its rows with a stride of
//      gridDim.x, zeroing its table once and again in the write-out pass.
//      In the direct branch each thread loads its first four records of a
//      row before the barrier that waits for the table, so their latency
//      overlaps the fill (first row) or the previous row's write-out.
//   3. Rows prefetched where few blocks share an SM. With a 64 KB or wider
//      table (the route's counts form at nk >= 8192) at most 3 blocks fit
//      an SM, and the plan takes the bulk branch: a 2-stage ring in
//      shared memory into which one thread issues 1-D bulk async copies
//      (TMA, cp.async.bulk) of the next chunk's keys, vals and valid onto
//      the stage's mbarrier; they land while the block accumulates and
//      writes out the current row, and a stage is refilled only after the
//      __syncthreads() that ends the reads of it. Bulk copies need 16-byte
//      aligned bases and B % 16 == 0. Where 4 or more blocks fit, the
//      other blocks' warps hide the load latency and the direct branch
//      (the same kernel: 16-byte vector loads where a row is aligned,
//      scalar ones elsewhere) measured as fast or faster (chip_smoke.py
//      phase 2 times both branches at every shape).
//   4. Occupancy. Threads per block are 256, 512 or 1024 by the table's
//      bytes, and the ring is 2 x 9 KB at B >= 1024, so the nk=8192 counts
//      table keeps 2 blocks on an SM; launch bounds hold registers to 32 a
//      thread, so threads never limit residency.
//   5. Vector tables. Fills and write-outs are 16-byte where nk % 4 == 0
//      (a scalar loop otherwise), and the write-out zeroes the table for
//      the next row in the same pass. Row r's write-out is issued before
//      the block waits on row r+1's barrier.
// When a row's table does not fit the shared-memory budget, a third branch
// (no path reaches it) adds straight into a zeroed output with global
// atomics.
//
// Host path. The launch plan (branch, grid, threads, shared bytes, chunk)
// comes from Python as one pointer to ints, cached per shape there; the
// kernel's shared-memory attributes are set once per instantiation and
// device here; the launch switches device only when the caller's thread
// is on another one. Interface: plain C, loaded with ctypes; the launch
// returns cudaGetLastError() so the Python wrapper raises on a refused
// launch.

#include <cuda_runtime.h>
#include <stdint.h>

#include <atomic>

namespace {

constexpr int kMaxThreads = 1024;
constexpr int kGlobalThreads = 256;
constexpr int kStages = 2;
constexpr int kMaxDevices = 64;

// The branches, numbered as ops/histogram.py's _plan returns them: bulk
// copies into the ring, direct loads (both hist_smem_kernel), global
// atomics (hist_global_kernel).
constexpr int kBulk = 0;
constexpr int kGlobal = 2;

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n"
               :: "r"(smem_addr(bar)) : "memory");
}

// Wait until the barrier's phase of the given parity has completed.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = smem_addr(bar);
  uint32_t done = 0;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(addr), "r"(parity) : "memory");
  } while (!done);
}

__device__ __forceinline__ void bulk_load(void* dst, const void* src,
                                          uint32_t bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n"
      :: "r"(smem_addr(dst)),
         "l"(static_cast<uint64_t>(__cvta_generic_to_global(src))),
         "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}

template <bool kCounts>
__device__ __forceinline__ void add(int32_t* s, int nk, int32_t k,
                                    int32_t v, uint32_t m) {
  if (m != 0u && static_cast<uint32_t>(k) < static_cast<uint32_t>(nk)) {
    atomicAdd(&s[k], v);
    if (kCounts) atomicAdd(&s[nk + k], 1);
  }
}

// Four records: int4 keys and vals, their four valid bytes in one word.
template <bool kCounts>
__device__ __forceinline__ void add4(int32_t* s, int nk, int4 k, int4 v,
                                     uint32_t m) {
  add<kCounts>(s, nk, k.x, v.x, m & 0xffu);
  add<kCounts>(s, nk, k.y, v.y, (m >> 8) & 0xffu);
  add<kCounts>(s, nk, k.z, v.z, (m >> 16) & 0xffu);
  add<kCounts>(s, nk, k.w, v.w, m >> 24);
}

// Write row `row`'s table out and leave it zeroed for the next row.
template <bool kCounts>
__device__ __forceinline__ void store_row(int32_t* s, int32_t* sums,
                                          int32_t* cnts, int row, int nk,
                                          bool vec) {
  const int64_t o = static_cast<int64_t>(row) * nk;
  if (vec) {
    const int n4 = nk >> 2;
    const int4 zero = make_int4(0, 0, 0, 0);
    int4* s4 = reinterpret_cast<int4*>(s);
    int4* gs = reinterpret_cast<int4*>(sums + o);
    int4* gc = reinterpret_cast<int4*>(kCounts ? cnts + o : sums + o);
    for (int i = threadIdx.x; i < n4; i += blockDim.x) {
      gs[i] = s4[i];
      s4[i] = zero;
      if (kCounts) {
        gc[i] = s4[n4 + i];
        s4[n4 + i] = zero;
      }
    }
  } else {
    for (int i = threadIdx.x; i < nk; i += blockDim.x) {
      sums[o + i] = s[i];
      s[i] = 0;
      if (kCounts) {
        cnts[o + i] = s[nk + i];
        s[nk + i] = 0;
      }
    }
  }
}

__device__ __forceinline__ void zero_table(unsigned char* smem,
                                           int tbl_bytes) {
  for (int i = threadIdx.x; i < tbl_bytes / 16; i += blockDim.x)
    reinterpret_cast<int4*>(smem)[i] = make_int4(0, 0, 0, 0);
}

// Thread 0: start the copies of work item `it` (chunk `it % per_row` of
// this block's row `it / per_row`) into ring stage `it % kStages`.
__device__ __forceinline__ void issue(const int32_t* keys,
                                      const int32_t* vals,
                                      const uint8_t* valid,
                                      unsigned char* ring, uint64_t* bar,
                                      int it, int per_row, int b, int chunk,
                                      int stage_bytes) {
  const int row = blockIdx.x + (it / per_row) * gridDim.x;
  const int c0 = (it % per_row) * chunk;
  const int len = min(chunk, b - c0);
  const int64_t g = static_cast<int64_t>(row) * b + c0;
  unsigned char* st = ring + (it % kStages) * stage_bytes;
  uint64_t* mb = bar + it % kStages;
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               :: "r"(smem_addr(mb)), "r"(len * 9) : "memory");
  bulk_load(st, keys + g, len * 4, mb);
  bulk_load(st + chunk * 4, vals + g, len * 4, mb);
  bulk_load(st + chunk * 8, valid + g, len, mb);
}

// Shared memory: the table (nk ints, 2 * nk with counts, rounded up to 16
// bytes); in the bulk branch then kStages stages of `chunk` keys, `chunk`
// vals and `chunk` valid bytes, then one mbarrier per stage.
template <bool kCounts>
__global__ void __launch_bounds__(kMaxThreads, 2)
hist_smem_kernel(const int32_t* __restrict__ keys,
                 const int32_t* __restrict__ vals,
                 const uint8_t* __restrict__ valid,
                 int32_t* __restrict__ sums, int32_t* __restrict__ cnts,
                 int rows, int b, int nk, int chunk, int bulk) {
  extern __shared__ __align__(16) unsigned char smem[];
  int32_t* s = reinterpret_cast<int32_t*>(smem);
  const int tbl_bytes = ((kCounts ? 2 : 1) * nk * 4 + 15) & ~15;
  const bool vec_out =
      (nk & 3) == 0
      && ((reinterpret_cast<uintptr_t>(sums)
           | (kCounts ? reinterpret_cast<uintptr_t>(cnts) : 0)) & 15) == 0;
  const int stage_bytes = chunk * 9;
  unsigned char* ring = smem + tbl_bytes;
  uint64_t* bar = reinterpret_cast<uint64_t*>(ring + kStages * stage_bytes);
  const int per_row = bulk ? (b + chunk - 1) / chunk : 0;
  const int items =
      (rows - static_cast<int>(blockIdx.x) + gridDim.x - 1) / gridDim.x
      * per_row;
  // The first copies start before the table is zeroed, so their latency
  // overlaps the fill; no thread waits on a barrier before the
  // __syncthreads() below, which follows the barriers' initialisation.
  if (bulk) {
    if (threadIdx.x == 0) {
      for (int i = 0; i < kStages; ++i) mbar_init(bar + i);
      asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
      for (int it = 0; it < kStages && it < items; ++it)
        issue(keys, vals, valid, ring, bar, it, per_row, b, chunk,
              stage_bytes);
    }
    zero_table(smem, tbl_bytes);
    __syncthreads();
    for (int it = 0; it < items; ++it) {
      const int c = it % per_row;
      const int len = min(chunk, b - c * chunk);
      mbar_wait(bar + it % kStages, (it / kStages) & 1);
      const unsigned char* st = ring + (it % kStages) * stage_bytes;
      const int32_t* sk = reinterpret_cast<const int32_t*>(st);
      const int32_t* sv = sk + chunk;
      const unsigned char* sm = st + chunk * 8;
      // len % 16 == 0: every thread's four records are whole.
      for (int i = threadIdx.x * 4; i < len; i += blockDim.x * 4)
        add4<kCounts>(s, nk, *reinterpret_cast<const int4*>(sk + i),
                      *reinterpret_cast<const int4*>(sv + i),
                      *reinterpret_cast<const uint32_t*>(sm + i));
      __syncthreads();  // the stage is read and the chunk's adds are done
      if (threadIdx.x == 0 && it + kStages < items)
        issue(keys, vals, valid, ring, bar, it + kStages, per_row, b, chunk,
              stage_bytes);
      if (c == per_row - 1) {
        store_row<kCounts>(s, sums, cnts,
                           blockIdx.x + (it / per_row) * gridDim.x, nk,
                           vec_out);
        __syncthreads();  // the table is zero again
      }
    }
    return;
  }

  // Direct: each thread loads its first four records of a row before the
  // barrier that waits for the table to be zero (the fill before the
  // block's first row, the previous row's write-out after), so the loads'
  // latency overlaps that work.
  for (int row = blockIdx.x; row < rows; row += gridDim.x) {
    const int64_t g = static_cast<int64_t>(row) * b;
    const int32_t* gk = keys + g;
    const int32_t* gv = vals + g;
    const uint8_t* gm = valid + g;
    const bool vec =
        ((reinterpret_cast<uintptr_t>(gk) | reinterpret_cast<uintptr_t>(gv))
         & 15) == 0 && (reinterpret_cast<uintptr_t>(gm) & 3) == 0;
    const int head = vec ? b & ~3 : 0;
    const int i0 = threadIdx.x * 4;
    int4 k0 = make_int4(0, 0, 0, 0), v0 = k0;
    uint32_t m0 = 0;
    if (i0 < head) {
      k0 = __ldg(reinterpret_cast<const int4*>(gk + i0));
      v0 = __ldg(reinterpret_cast<const int4*>(gv + i0));
      m0 = __ldg(reinterpret_cast<const unsigned int*>(gm + i0));
    }
    if (row == static_cast<int>(blockIdx.x)) zero_table(smem, tbl_bytes);
    __syncthreads();  // the table is zero
    if (i0 < head) add4<kCounts>(s, nk, k0, v0, m0);
    for (int i = i0 + blockDim.x * 4; i < head; i += blockDim.x * 4)
      add4<kCounts>(s, nk, __ldg(reinterpret_cast<const int4*>(gk + i)),
                    __ldg(reinterpret_cast<const int4*>(gv + i)),
                    __ldg(reinterpret_cast<const unsigned int*>(gm + i)));
    for (int i = head + threadIdx.x; i < b; i += blockDim.x)
      add<kCounts>(s, nk, __ldg(gk + i), __ldg(gv + i), __ldg(gm + i));
    __syncthreads();  // the row's adds are done
    store_row<kCounts>(s, sums, cnts, row, nk, vec_out);
  }
}

// Large-nk branch: the outputs were zeroed by the launcher; every valid
// in-range record adds into its row's global slot.
template <bool kCounts>
__global__ void __launch_bounds__(kGlobalThreads)
hist_global_kernel(const int32_t* __restrict__ keys,
                   const int32_t* __restrict__ vals,
                   const uint8_t* __restrict__ valid,
                   int32_t* __restrict__ sums, int32_t* __restrict__ cnts,
                   int64_t total, int b, int nk) {
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t j = static_cast<int64_t>(blockIdx.x) * blockDim.x
                   + threadIdx.x;
       j < total; j += stride) {
    if (!valid[j]) continue;
    const int32_t k = keys[j];
    if (static_cast<uint32_t>(k) >= static_cast<uint32_t>(nk)) continue;
    const int64_t slot = (j / b) * nk + k;
    atomicAdd(&sums[slot], vals[j]);
    if (kCounts) atomicAdd(&cnts[slot], 1);
  }
}

// Opt the shared-memory kernel into the device's whole shared-memory
// budget, once per instantiation and device. Threads that race here set
// the same attributes twice, which is harmless.
template <bool kCounts>
cudaError_t prepare(int device) {
  static std::atomic<bool> ready[kMaxDevices];
  const bool cached = device >= 0 && device < kMaxDevices;
  if (cached && ready[device].load(std::memory_order_acquire))
    return cudaSuccess;
  int optin = 0;
  cudaError_t err = cudaDeviceGetAttribute(
      &optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(hist_smem_kernel<kCounts>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             optin);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(hist_smem_kernel<kCounts>,
                             cudaFuncAttributePreferredSharedMemoryCarveout,
                             cudaSharedmemCarveoutMaxShared);
  if (err != cudaSuccess) return err;
  if (cached) ready[device].store(true, std::memory_order_release);
  return cudaSuccess;
}

template <bool kCounts>
cudaError_t launch(const int32_t* keys, const int32_t* vals,
                   const uint8_t* valid, int32_t* sums, int32_t* cnts,
                   int rows, int b, int nk, int branch, int grid, int threads,
                   int smem, int chunk, int device, cudaStream_t stream) {
  if (branch == kGlobal) {
    const size_t out_bytes = static_cast<size_t>(rows) * nk * sizeof(int32_t);
    cudaError_t err = cudaMemsetAsync(sums, 0, out_bytes, stream);
    if (err != cudaSuccess) return err;
    if (kCounts) {
      err = cudaMemsetAsync(cnts, 0, out_bytes, stream);
      if (err != cudaSuccess) return err;
    }
    const int64_t total = static_cast<int64_t>(rows) * b;
    if (total == 0) return cudaGetLastError();
    hist_global_kernel<kCounts><<<grid, kGlobalThreads, 0, stream>>>(
        keys, vals, valid, sums, cnts, total, b, nk);
    return cudaGetLastError();
  }
  cudaError_t err = prepare<kCounts>(device);
  if (err != cudaSuccess) return err;
  hist_smem_kernel<kCounts><<<grid, threads, smem, stream>>>(
      keys, vals, valid, sums, cnts, rows, b, nk, chunk,
      branch == kBulk ? 1 : 0);
  return cudaGetLastError();
}

}  // namespace

// One launch of the plan ops/histogram.py's _launch_args packed for this
// shape: args = {rows, b, nk, want_counts, branch, grid, threads, smem,
// chunk, device}; on `stream` of `device`. Returns a cudaError_t (0 on
// success).
extern "C" int keyed_hist_launch(const void* keys, const void* vals,
                                 const void* valid, void* sums, void* cnts,
                                 const int* args, void* stream) {
  const int rows = args[0], b = args[1], nk = args[2];
  const int want_counts = args[3], branch = args[4], grid = args[5];
  const int threads = args[6], smem = args[7], chunk = args[8];
  const int device = args[9];
  const bool aligned =
      ((reinterpret_cast<uintptr_t>(keys) | reinterpret_cast<uintptr_t>(vals)
        | reinterpret_cast<uintptr_t>(valid)) & 15) == 0;
  if (rows <= 0 || nk <= 0 || b < 0 || grid <= 0 || threads <= 0
      || threads > kMaxThreads || branch < kBulk || branch > kGlobal
      || (branch == kBulk && (!aligned || b % 16 != 0 || chunk <= 0
                              || chunk % 16 != 0)))
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
  const int32_t* v = static_cast<const int32_t*>(vals);
  const uint8_t* m = static_cast<const uint8_t*>(valid);
  int32_t* o = static_cast<int32_t*>(sums);
  int32_t* c = static_cast<int32_t*>(cnts);
  err = want_counts
      ? launch<true>(k, v, m, o, c, rows, b, nk, branch, grid, threads, smem,
                     chunk, device, s)
      : launch<false>(k, v, m, o, c, rows, b, nk, branch, grid, threads,
                      smem, chunk, device, s);
  if (prev != device) {
    const cudaError_t back = cudaSetDevice(prev);
    if (err == cudaSuccess) err = back;
  }
  return static_cast<int>(err);
}

extern "C" const char* keyed_hist_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// The device's shared-memory bytes one block may opt into and its SM
// count: what the launch plan is made from. Returns a cudaError_t.
extern "C" int keyed_hist_device_info(int device, int* smem_optin,
                                      int* sms) {
  cudaError_t err = cudaDeviceGetAttribute(
      smem_optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaDeviceGetAttribute(
      sms, cudaDevAttrMultiProcessorCount, device));
}
