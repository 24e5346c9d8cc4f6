// Keyed histogram (per-row segment sum) for NVIDIA Hopper (sm_90a).
//
// Replaces the Pallas TPU kernels of clonos_tpu/ops/histogram.py:
//   _hist_kernel       (histogram.py:34, launched by _hist_pallas at :112)
//   _hist_kernel_sums  (histogram.py:56, launched by _hist_pallas at :103)
// as ONE kernel with the count output as a template flag.
//
// Computes, for each row r of the flattened [R, B] int32 keys/vals and
// bool valid:
//   sums[r, k] = sum of vals[r, i] over valid records with keys[r, i] == k
//   cnts[r, k] = number of such records              (kCounts only)
// for k in [0, nk). Invalid records and out-of-range keys drop (the
// scatter mode="drop" contract of the reference's XLA fallback).
//
// Design. The TPU kernel tiles 8 rows x 128 records and does an
// O(R * B * nk) one-hot compare-accumulate on the VPU (4.3 G compares per
// call at the exchange shape). Here each thread block owns one row: the
// row's nk sums (and counts) live in dynamic shared memory, threads stride
// over the row's B records and atomicAdd int32 into shared memory, then the
// row is written out coalesced. Work is O(R * (B + nk)). int32 addition
// wraps and is associative mod 2^32, so the atomic order cannot change the
// result: the output is bit-exact against the plain scatter_add_ version.
// When the row's table does not fit the shared-memory budget, a second
// branch of the kernel adds straight into a zeroed output with global
// atomics.
//
// Bound. Memory traffic: R * B * 9 bytes in (keys, vals, valid) and
// R * nk * 4 bytes for each output. At the exchange shape (R=512, B=1024,
// nk=8192, counts) that is ~38 MB, ~11 us at 3.35 TB/s; at the window
// aggregation shape (R=4096, B=1024, nk=997, sums only) ~54 MB, ~16 us.
// The int32 adds (R * B per output) are far below the card's rate.
//
// Interface: plain C, loaded with ctypes. The launch returns
// cudaGetLastError() so the Python wrapper raises on a refused launch.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxDevices = 64;

template <bool kCounts>
__global__ void __launch_bounds__(kThreads)
hist_smem_kernel(const int32_t* __restrict__ keys,
                 const int32_t* __restrict__ vals,
                 const uint8_t* __restrict__ valid,
                 int32_t* __restrict__ sums, int32_t* __restrict__ cnts,
                 int rows, int b, int nk) {
  extern __shared__ int32_t smem[];
  int32_t* s_sum = smem;
  int32_t* s_cnt = smem + nk;
  const int width = kCounts ? 2 * nk : nk;
  for (int r = blockIdx.x; r < rows; r += gridDim.x) {
    for (int i = threadIdx.x; i < width; i += blockDim.x) smem[i] = 0;
    __syncthreads();
    const int64_t in0 = static_cast<int64_t>(r) * b;
    for (int i = threadIdx.x; i < b; i += blockDim.x) {
      const int64_t j = in0 + i;
      if (!valid[j]) continue;
      const int32_t k = keys[j];
      if (static_cast<uint32_t>(k) >= static_cast<uint32_t>(nk)) continue;
      atomicAdd(&s_sum[k], vals[j]);
      if (kCounts) atomicAdd(&s_cnt[k], 1);
    }
    __syncthreads();
    const int64_t out0 = static_cast<int64_t>(r) * nk;
    for (int i = threadIdx.x; i < nk; i += blockDim.x) {
      sums[out0 + i] = s_sum[i];
      if (kCounts) cnts[out0 + i] = s_cnt[i];
    }
    __syncthreads();
  }
}

// Large-nk branch: the outputs were zeroed by the launcher; every valid
// in-range record adds into its row's global slot.
template <bool kCounts>
__global__ void __launch_bounds__(kThreads)
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

struct DeviceInfo {
  int smem_optin;
  int sms;
};

cudaError_t device_info(DeviceInfo* out) {
  static DeviceInfo cache[kMaxDevices];
  static bool known[kMaxDevices] = {false};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev >= 0 && dev < kMaxDevices && known[dev]) {
    *out = cache[dev];
    return cudaSuccess;
  }
  DeviceInfo info;
  err = cudaDeviceGetAttribute(&info.smem_optin,
                               cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&info.sms, cudaDevAttrMultiProcessorCount,
                               dev);
  if (err != cudaSuccess) return err;
  if (dev >= 0 && dev < kMaxDevices) {
    cache[dev] = info;
    known[dev] = true;
  }
  *out = info;
  return cudaSuccess;
}

template <bool kCounts>
cudaError_t launch(const int32_t* keys, const int32_t* vals,
                   const uint8_t* valid, int32_t* sums, int32_t* cnts,
                   int rows, int b, int nk, cudaStream_t stream) {
  DeviceInfo info;
  cudaError_t err = device_info(&info);
  if (err != cudaSuccess) return err;
  const size_t smem = static_cast<size_t>(nk) * sizeof(int32_t)
                      * (kCounts ? 2 : 1);
  if (smem <= static_cast<size_t>(info.smem_optin)) {
    err = cudaFuncSetAttribute(hist_smem_kernel<kCounts>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem));
    if (err != cudaSuccess) return err;
    hist_smem_kernel<kCounts><<<rows, kThreads, smem, stream>>>(
        keys, vals, valid, sums, cnts, rows, b, nk);
    return cudaGetLastError();
  }
  const size_t out_bytes = static_cast<size_t>(rows) * nk * sizeof(int32_t);
  err = cudaMemsetAsync(sums, 0, out_bytes, stream);
  if (err != cudaSuccess) return err;
  if (kCounts) {
    err = cudaMemsetAsync(cnts, 0, out_bytes, stream);
    if (err != cudaSuccess) return err;
  }
  const int64_t total = static_cast<int64_t>(rows) * b;
  if (total == 0) return cudaGetLastError();
  int64_t blocks = (total + kThreads - 1) / kThreads;
  const int64_t cap = static_cast<int64_t>(info.sms) * 32;
  if (blocks > cap) blocks = cap;
  hist_global_kernel<kCounts><<<static_cast<int>(blocks), kThreads, 0,
                                stream>>>(keys, vals, valid, sums, cnts,
                                          total, b, nk);
  return cudaGetLastError();
}

}  // namespace

extern "C" int keyed_hist_launch(const void* keys, const void* vals,
                                 const void* valid, void* sums, void* cnts,
                                 int rows, int b, int nk, int want_counts,
                                 void* stream) {
  if (rows <= 0 || nk <= 0 || b < 0) return static_cast<int>(
      cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int32_t* k = static_cast<const int32_t*>(keys);
  const int32_t* v = static_cast<const int32_t*>(vals);
  const uint8_t* m = static_cast<const uint8_t*>(valid);
  int32_t* o = static_cast<int32_t*>(sums);
  int32_t* c = static_cast<int32_t*>(cnts);
  cudaError_t err = want_counts
      ? launch<true>(k, v, m, o, c, rows, b, nk, s)
      : launch<false>(k, v, m, o, c, rows, b, nk, s);
  return static_cast<int>(err);
}

extern "C" const char* keyed_hist_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// Bytes of dynamic shared memory one block may opt into on the current
// device (the branch point between the two kernel branches), or -1.
extern "C" int keyed_hist_smem_budget() {
  DeviceInfo info;
  if (device_info(&info) != cudaSuccess) return -1;
  return info.smem_optin;
}
