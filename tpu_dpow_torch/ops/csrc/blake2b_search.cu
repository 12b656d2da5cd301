// Batched Nano PoW nonce search: the CUDA kernel for sm_90a (H100).
//
// Replaces the Pallas TPU kernels of tpu_dpow/ops/pallas_kernel.py —
// `_kernel_single`, `_kernel_batched` and `_kernel_blocks`, with their shared
// body `_search_core` — as ONE kernel. The contract is theirs: for every row
// b of params uint32[B, 12] and every offset in [0, span),
//
//   nonce = base + offset                    (64-bit carry)
//   value = LE_u64(blake2b_8(nonce_le || hash))
//   out[b] = lowest offset with value >= difficulty, else 0xFFFFFFFF.
//
// Geometry. One thread tests one nonce per step. The grid is
// (blocks_per_row, B); each block walks its row's whole span with a
// grid-stride loop, so the TPU's `sublanes`, `iters`, `nblocks` and `group`
// only define the span (the wrapper multiplies them out). blocks_per_row is
// chosen here so that all rows together fill every SM at full occupancy.
//
// Lowest offset, whatever order blocks run in. Each warp reduces its 32
// candidates with __reduce_min_sync and does one atomicMin on out[b]. Before
// each stride a warp reads out[b] (volatile) and stops once the smallest
// offset it would test next is not below it: that skips only work that
// cannot lower the minimum, so the result is deterministic. CUDA blocks run
// concurrently, unlike the TPU's sequential grid, so `_kernel_blocks`'
// found-flag-in-SMEM has no counterpart; a pad row (difficulty 0) hits at
// offset 0 and every warp of it drains after one stride.
//
// What bounds it. The work is pure 64-bit integer ALU: 48 bytes in and 4 out
// per row, no matrix product. So the bound is the integer issue rate:
// int32 instructions per nonce x nonces / (SMs x INT32 lanes per SM per
// clock x clock), with the instruction count read from this kernel's SASS
// (chip_smoke.py derives it with cuobjdump). nvcc puts some adds and moves
// on the FMA pipe as IMAD, which issues beside the ALU pipe's IADD3, LOP3
// and SHF, so the count is split by pipe and the slower pipe bounds it. The
// design keeps every word of m[] and v[] in registers (compile-time indices
// only, see the .cuh) so that no load or store sits on the hot path.
//
// The wrapper (ops/cuda_kernel.py) fills out[] with 0xFFFFFFFF, launches on
// PyTorch's current stream and raises if b2_search_launch returns nonzero.

#include <cuda_runtime.h>
#include <stdint.h>

#include "blake2b_search.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kParamsLen = 12;
constexpr uint32_t kSentinel = 0xFFFFFFFFu;
constexpr int kMaxDevices = 64;

__global__ void __launch_bounds__(kThreads)
    b2_search_kernel(const uint32_t* __restrict__ params, uint32_t* out, uint32_t span) {
  const uint32_t* p = params + static_cast<size_t>(blockIdx.y) * kParamsLen;
  const uint64_t m1 = p[0] | (static_cast<uint64_t>(p[1]) << 32);
  const uint64_t m2 = p[2] | (static_cast<uint64_t>(p[3]) << 32);
  const uint64_t m3 = p[4] | (static_cast<uint64_t>(p[5]) << 32);
  const uint64_t m4 = p[6] | (static_cast<uint64_t>(p[7]) << 32);
  const uint64_t difficulty = p[8] | (static_cast<uint64_t>(p[9]) << 32);
  const uint64_t base = p[10] | (static_cast<uint64_t>(p[11]) << 32);
  uint32_t* row_out = out + blockIdx.y;
  const uint32_t lane = threadIdx.x & 31u;
  const uint32_t warp_first = threadIdx.x & ~31u;
  // span < 2^31 and stride < 2^31, so `start + stride` never wraps.
  const uint32_t stride = gridDim.x * kThreads;
  for (uint32_t start = blockIdx.x * kThreads; start < span; start += stride) {
    uint32_t best = 0;
    if (lane == 0) best = *reinterpret_cast<volatile uint32_t*>(row_out);
    best = __shfl_sync(0xFFFFFFFFu, best, 0);
    if (best <= start + warp_first) break;  // nothing left here can lower it
    const uint32_t offset = start + threadIdx.x;
    uint32_t cand = kSentinel;
    if (offset < span && b2pow::pow_value(base + offset, m1, m2, m3, m4) >= difficulty) {
      cand = offset;
    }
    cand = __reduce_min_sync(0xFFFFFFFFu, cand);
    if (lane == 0 && cand != kSentinel) atomicMin(row_out, cand);
  }
}

// Resident blocks per SM for this kernel, and SM count, per device.
int g_resident[kMaxDevices];

cudaError_t resident_blocks(int* total) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < 0 || dev >= kMaxDevices) return cudaErrorInvalidDevice;
  if (g_resident[dev] == 0) {
    int sms = 0, per_sm = 0;
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return err;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, b2_search_kernel, kThreads, 0);
    if (err != cudaSuccess) return err;
    g_resident[dev] = sms * (per_sm > 0 ? per_sm : 1);
  }
  *total = g_resident[dev];
  return cudaSuccess;
}

// Blocks one row gets: the card's resident block count shared over the
// rows, rounded down so that every block of the grid is resident in one
// wave (a rounded-up share leaves a few blocks to run alone after the
// rest), and never more than the span needs.
int blocks_per_row(int total, int rows, uint32_t span) {
  long long per_row = total / rows;
  const long long need = (static_cast<long long>(span) + kThreads - 1) / kThreads;
  if (per_row > need) per_row = need;
  return per_row < 1 ? 1 : static_cast<int>(per_row);
}

}  // namespace

extern "C" {

int b2_abi_version() { return 2; }

const char* b2_error_string(int err) { return cudaGetErrorString(static_cast<cudaError_t>(err)); }

// Grid width a launch of `rows` rows over `span` offsets uses (0 on error).
int b2_blocks_per_row(int rows, unsigned int span) {
  int total = 0;
  if (rows <= 0 || resident_blocks(&total) != cudaSuccess) return 0;
  return blocks_per_row(total, rows, span);
}

// params: int32/uint32 [rows, 12] on the current device; out: [rows], filled
// with 0xFFFFFFFF by the caller. Returns the launch's cudaError_t.
int b2_search_launch(const void* params, void* out, int rows, unsigned int span, void* stream) {
  if (rows <= 0 || rows > 65535 || span == 0 || span >= (1u << 31)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  int total = 0;
  const cudaError_t err = resident_blocks(&total);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(blocks_per_row(total, rows, span), rows);
  b2_search_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(params), static_cast<uint32_t*>(out), span);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
