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
// What bounds it. The work is pure 64-bit integer arithmetic: 48 bytes in
// and 4 out per row, no matrix product. So the bound is the integer issue
// rate: int32 instructions per nonce x nonces / (SMs x lanes per SM per
// clock x clock), with the instruction count read from this kernel's SASS
// (chip_smoke.py derives it with cuobjdump), split by pipe: the ALU pipe
// (LOP3, SHF, IADD3) and the FMA pipe (IMAD, IDP) issue side by side, and
// the header moves what it can of the body onto the FMA pipe (see its
// note). The design keeps every word of m[] and v[] in registers
// (compile-time indices only, see the .cuh) so that no load or store sits
// on the hot path.
//
// Stopping a row. The same re-read lets the host stop a running row: a
// write of 0 into out[b] (an async copy on another stream) ends every warp
// of that row within one stride. A stopped row's out[b] then says nothing
// of a hit, so the host counts what the row ran from `scanned`: at exit,
// lane 0 of each warp adds to scanned[b] the offsets below `span` that its
// warp tested, derived from the loop's index after the loop, so the loop
// does no counting. scanned == nullptr skips it.
//
// The wrapper (ops/cuda_kernel.py) fills out[] with 0xFFFFFFFF (and zeroes
// scanned[]), launches on PyTorch's current stream and raises if
// b2_search_launch returns nonzero.

#include <cuda_runtime.h>
#include <stdint.h>

#include "blake2b_search.cuh"

namespace {

constexpr int kThreads = 256;
// Blocks per SM the kernel is built for: 64 registers a thread (4 blocks of
// 256), which the FMA-pipe rotations of blake2b_search.cuh need to schedule
// both pipes; at 48 (5 blocks) the loop ran 3 % slower.
constexpr int kMinBlocks = 4;
constexpr int kParamsLen = 12;
constexpr uint32_t kSentinel = 0xFFFFFFFFu;
constexpr int kMaxDevices = 64;

__global__ void __launch_bounds__(kThreads, kMinBlocks)
    b2_search_kernel(const uint32_t* __restrict__ params, uint32_t* out, uint32_t* scanned,
                     uint32_t span) {
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
  const uint32_t first = blockIdx.x * kThreads;
  uint32_t start = first;
  for (; start < span; start += stride) {
    uint32_t best = 0;
    if (lane == 0) best = *reinterpret_cast<volatile uint32_t*>(row_out);
    best = __shfl_sync(0xFFFFFFFFu, best, 0);
    // Nothing left here can lower it. Every lane holds the same `best`; the
    // vote says so to nvcc, which otherwise takes the exit as divergent and,
    // since `start` is read after the loop, keeps it per lane in the loop's
    // registers (3 more integer instructions per nonce).
    if (__all_sync(0xFFFFFFFFu, best <= start + warp_first)) break;
    const uint32_t offset = start + threadIdx.x;
    uint32_t cand = kSentinel;
    if (offset < span && b2pow::pow_value(base + offset, m1, m2, m3, m4) >= difficulty) {
      cand = offset;
    }
    cand = __reduce_min_sync(0xFFFFFFFFu, cand);
    if (lane == 0 && cand != kSentinel) atomicMin(row_out, cand);
  }
  // `start` is the first stride this warp did not test (the one it broke
  // at, or the first at or past span). Every stride before the last one
  // tested lies wholly below span (stride >= kThreads), so only the last
  // can be partial.
  if (scanned != nullptr && lane == 0 && start > first) {
    const uint32_t last = start - stride + warp_first;
    const uint32_t tail = last < span ? min(span - last, 32u) : 0u;
    const uint32_t n = (start - stride - first) / stride * 32u + tail;
    if (n != 0) atomicAdd(scanned + blockIdx.y, n);
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

int b2_abi_version() { return 3; }

const char* b2_error_string(int err) { return cudaGetErrorString(static_cast<cudaError_t>(err)); }

// Grid width a launch of `rows` rows over `span` offsets uses (0 on error).
int b2_blocks_per_row(int rows, unsigned int span) {
  int total = 0;
  if (rows <= 0 || resident_blocks(&total) != cudaSuccess) return 0;
  return blocks_per_row(total, rows, span);
}

// params: int32/uint32 [rows, 12] on the current device; out: [rows], filled
// with 0xFFFFFFFF by the caller; scanned: [rows], zeroed by the caller, or
// nullptr. Returns the launch's cudaError_t.
int b2_search_launch(const void* params, void* out, void* scanned, int rows, unsigned int span,
                     void* stream) {
  if (rows <= 0 || rows > 65535 || span == 0 || span >= (1u << 31)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  int total = 0;
  const cudaError_t err = resident_blocks(&total);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(blocks_per_row(total, rows, span), rows);
  b2_search_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(params), static_cast<uint32_t*>(out),
      static_cast<uint32_t*>(scanned), span);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
