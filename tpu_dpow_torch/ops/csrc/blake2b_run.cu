// Persistent multi-window Nano PoW search with a mapped-memory control
// channel: the CUDA kernel for sm_90a (H100).
//
// Replaces tpu_dpow/ops/runloop.py's `run_loop_core` (the while_loop of
// windows around the Pallas search kernel, reached through
// `search_run_batch` and `search_run_batch_controlled`), including its
// control poll through `io_callback`, and the same loop as each device of
// tpu_dpow/parallel/fan_search.py runs it (`_fan_run_fn`,
// `_fan_controlled_fn`): windows of `window` nonces whose bases advance by
// a `stride` (see "Strided windows" below). One cooperative grid runs the whole
// launch; per-row state (difficulty, base, done, seq, winning nonce and the
// poll block's best offset) lives in device memory. Each outer iteration:
//
//   1. The leader (block 0, thread 0) polls the host when a mailbox is
//      attached: it writes k and done[] into mapped pinned memory, fences,
//      bumps req_seq and spins on resp_seq; then it applies the host's
//      control words to the live rows as run_loop_core does (cancel: done,
//      difficulty 0; raise and rebase only on a fresh seq, never on a row
//      cancelled in the same poll). It then lists the rows still live, in
//      row order, and their count n_live (see "Blocks and rows" below).
//   2. Grid barrier.
//   3. Every block scans its live row's next windows, up to the next poll
//      (k + poll_steps) or max_steps, as ONE contiguous span from the row's
//      base; done rows get no block. A run of windows at one target has the
//      same first hit as the window-by-window loop, so results are
//      bit-equal to it. A span is cut at 2^30 offsets (several windows, or
//      one window when a window is larger), and the rest of the poll block
//      runs as further spans without a poll between them: offsets stay
//      32-bit, and the scan loop is blake2b_search.cu's. Each warp reduces
//      its hit offsets with __reduce_min_sync and does one atomicMin on the
//      row's best; a warp stops once its next offset is not below the best
//      (it skips only work that cannot lower it).
//   4. Grid barrier; the leader folds each row's best into done / nonce,
//      advances live rows' bases by the span (by
//      the stride for strided windows), and advances k.
//
// Strided windows (stride > window): a device of a fan scans its own
// `window` nonces of every `stride` (window k covers [base + k * stride,
// + window)), so a run of windows is no longer one contiguous span. Each
// window is then a span of its own (one window per outer iteration), and
// the leader advances a live row's base by `stride` after it: the first hit
// is the lowest k, then the lowest offset in that window, as in the
// window-by-window loop. With stride == window the loop is the contiguous
// one above, unchanged.
//
// The loop ends when every row is done or k == max_steps. It polls when k
// reaches the next multiple of poll_steps (k = 0 included) with a row still
// live, so the polls and the k values the host sees are those of the
// reference loop: LaunchControl's bookkeeping (polls, last_k, done_at_k,
// delivered) comes out identical. Without a mailbox the kernel never polls
// (`search_run_batch`).
//
// The channel is a synchronous handshake (mirroring io_callback): device ->
// host req_seq, k, done[B]; host -> device resp_seq, ctrl[B, 6]. The device
// orders its writes before req_seq with __threadfence_system and reads
// resp_seq before the control words, all volatile; the host writes the words
// before resp_seq (b2_mailbox_answer). The launch thread on the host serves
// each request through ops/control.py's poll_slot (ops/cuda_kernel.py). A
// controlled launch also writes its results (and poll statistics) into the
// mailbox, so the launch thread reads them without a device-to-host copy:
// such a copy would queue on the launches' one stream behind a successor
// kernel that needs another thread to serve its polls.
//
// Blocks and rows: the grid is one dimension of G blocks, the card's
// co-resident count (cooperative launch), dealt anew at every span over the
// n_live rows the leader listed at step 1: block g scans row live[g % n_live]
// as block g / n_live of that row's ceil((G - g % n_live) / n_live) blocks.
// With every row live this is the even split blake2b_search.cu makes; once a
// row is done (hit, cancelled, or a pad row that started done), its share of
// the grid goes to the rows still live from the next span on, so a launch
// scans at the whole card's rate until its slowest row hits. The first hit
// of a span is its lowest hitting offset whatever number of blocks scans it,
// so the nonces and every poll are those of the even split. The kernel
// counts the windows it ran, and of those the windows whose span was dealt
// over fewer rows than the launch holds (re-granted), in its out statistics.
//
// What bounds it: the same 64-bit integer ALU work as blake2b_search.cu
// (the Blake2b body is the shared header), so the integer issue rate of the
// scan loop's SASS; polls and barriers add a host round trip per poll block.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

#include <atomic>
#include <chrono>

#include "blake2b_search.cuh"

namespace cg = cooperative_groups;

namespace {

// Built for 3 blocks per SM (80 registers): capped at 48 or 64 registers
// (5 or 4 blocks, as blake2b_search.cu) the scan loop spills to local
// memory; with no minimum ptxas also takes 80 but spills outside the loop,
// and the loop ran 4 % slower.
constexpr int kThreads = 256;
constexpr int kMinBlocks = 3;
constexpr int kParamsLen = 12;
constexpr int kCtrlWords = 6;
constexpr uint32_t kFlagCancel = 1u, kFlagRaise = 2u, kFlagRebase = 4u;
constexpr unsigned long long kNone = ~0ull;
constexpr uint32_t kSentinel = 0xFFFFFFFFu;
constexpr uint64_t kMaxSpan = 1ull << 30;  // offsets per scanned span
constexpr int kMaxDevices = 64;
constexpr int kSpinCheck = 4096;  // host spins between clock reads

// Mailbox words (uint32, mapped pinned host memory), as ops/cuda_kernel.py
// lays them out: req_seq, resp_seq, k, a spare word, done[rows],
// ctrl[rows, 6], then the launch's `out` (see b2_run_launch).
constexpr int kMbReq = 0, kMbResp = 1, kMbK = 2, kMbDone = 4;
// Words of `out` after the lo and hi words: polls, poll_ns (lo, hi),
// poll_ns_max (lo, hi), windows run, and of those the re-granted ones.
constexpr int kOutStats = 7;

// Per-row state, device memory (six 64-bit words).
struct RowState {
  unsigned long long diff;
  unsigned long long base;
  unsigned long long nonce;  // winning nonce; all-ones while unsolved
  unsigned int best;         // lowest hit offset of the current span
  unsigned int done;
  unsigned int seq;          // newest applied command generation
  unsigned int pad;
  unsigned long long pad2;
};

// Launch-wide state, device memory (ten 64-bit words), before the rows; the
// live list (uint32 [rows]) follows the rows.
struct RunShared {
  unsigned long long span;          // offsets each live row scans next (< 2^31)
  unsigned long long poll_ns;       // summed device-side poll round trip
  unsigned long long poll_ns_max;
  unsigned int exit;
  unsigned int polls;
  unsigned long long k;             // windows run so far
  unsigned long long next_poll_k;   // k of the next poll
  unsigned long long span_steps;    // windows per span (kMaxSpan / window, >= 1)
  unsigned long long advance;       // base advance of a live row after the span
  unsigned int n_live;              // rows listed live for the current span
  unsigned int windows;             // windows run so far
  unsigned int regranted;           // of those, windows dealt over fewer rows than nrows
  unsigned int pad;
};

static_assert(sizeof(RowState) == 48, "RowState is six words");
static_assert(sizeof(RunShared) == 80, "RunShared is ten words");

__device__ __forceinline__ uint64_t u64(uint32_t lo, uint32_t hi) {
  return lo | (static_cast<uint64_t>(hi) << 32);
}

__device__ __forceinline__ unsigned long long globaltimer() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}

__device__ bool all_done(volatile RowState* rows, int nrows) {
  for (int r = 0; r < nrows; ++r) {
    if (!rows[r].done) return false;
  }
  return true;
}

// The leader's poll: post (k, done[]) to the host, wait for its answer, and
// apply the control words to the live rows (runloop.py:142-176).
__device__ void poll_host(volatile uint32_t* mb, volatile RowState* rows, int nrows,
                          uint64_t k, volatile RunShared* sh) {
  const unsigned int n = sh->polls + 1;
  mb[kMbK] = static_cast<uint32_t>(k);
  for (int r = 0; r < nrows; ++r) mb[kMbDone + r] = rows[r].done;
  __threadfence_system();
  const unsigned long long t0 = globaltimer();
  mb[kMbReq] = n;
  while (mb[kMbResp] != n) __nanosleep(1000);
  __threadfence_system();
  const unsigned long long dt = globaltimer() - t0;
  sh->poll_ns = sh->poll_ns + dt;
  if (dt > sh->poll_ns_max) sh->poll_ns_max = dt;
  sh->polls = n;
  volatile const uint32_t* ctrl = mb + kMbDone + nrows;
  for (int r = 0; r < nrows; ++r) {
    if (rows[r].done) continue;
    volatile const uint32_t* c = ctrl + r * kCtrlWords;
    const uint32_t flags = c[0];
    if (flags & kFlagCancel) {
      rows[r].done = 1;
      rows[r].diff = 0;
      continue;
    }
    const uint32_t seq = c[1];
    if (seq == rows[r].seq) continue;
    if (flags & kFlagRaise) rows[r].diff = u64(c[2], c[3]);
    if (flags & kFlagRebase) rows[r].base = u64(c[4], c[5]);
    rows[r].seq = seq;
  }
}

// Block `part` of the `parts` blocks that scan a row's span (step 3 above):
// blake2b_search.cu's loop.
__device__ __forceinline__ void scan_span(uint32_t span, uint64_t base, uint64_t diff,
                                          uint64_t m1, uint64_t m2, uint64_t m3, uint64_t m4,
                                          unsigned int* best_p, uint32_t part, uint32_t parts) {
  const uint32_t lane = threadIdx.x & 31u;
  const uint32_t warp_first = threadIdx.x & ~31u;
  // span < 2^31 and stride < 2^31, so `start + stride` never wraps.
  const uint32_t stride = parts * kThreads;
  for (uint32_t start = part * kThreads; start < span; start += stride) {
    uint32_t best = 0;
    if (lane == 0) best = *reinterpret_cast<volatile unsigned int*>(best_p);
    best = __shfl_sync(0xFFFFFFFFu, best, 0);
    if (best <= start + warp_first) break;  // nothing left here can lower it
    const uint32_t offset = start + threadIdx.x;
    uint32_t cand = kSentinel;
    if (offset < span && b2pow::pow_value(base + offset, m1, m2, m3, m4) >= diff) {
      cand = offset;
    }
    cand = __reduce_min_sync(0xFFFFFFFFu, cand);
    if (lane == 0 && cand != kSentinel) atomicMin(best_p, cand);
  }
}

__global__ void __launch_bounds__(kThreads, kMinBlocks)
    b2_run_kernel(const uint32_t* __restrict__ params, const uint8_t* __restrict__ active,
                  RunShared* shared, RowState* rows, unsigned int* live, uint32_t* out,
                  int nrows, uint32_t window, uint32_t stride, int max_steps, int poll_steps,
                  uint32_t* mbox) {
  const bool leader = blockIdx.x == 0 && threadIdx.x == 0;
  volatile RowState* vrows = rows;
  volatile RunShared* sh = shared;
  volatile unsigned int* vlive = live;
  for (int r = blockIdx.x * kThreads + threadIdx.x; r < nrows; r += gridDim.x * kThreads) {
    // Inactive (padding) rows start done at difficulty 0 (runloop.py:106-119).
    const uint32_t* p = params + static_cast<size_t>(r) * kParamsLen;
    const bool on = active == nullptr || active[r] != 0;
    vrows[r].best = kSentinel;
    vrows[r].diff = on ? u64(p[8], p[9]) : 0;
    vrows[r].base = u64(p[10], p[11]);
    vrows[r].nonce = kNone;
    vrows[r].done = on ? 0 : 1;
    vrows[r].seq = 0;
  }
  if (leader) {
    sh->poll_ns = 0;
    sh->poll_ns_max = 0;
    sh->polls = 0;
    sh->k = 0;
    sh->next_poll_k = 0;
    sh->windows = 0;
    sh->regranted = 0;
    // Strided windows are one span each; contiguous ones are cut at kMaxSpan.
    sh->span_steps = stride != window || window >= kMaxSpan ? 1 : kMaxSpan / window;
  }
  cg::this_grid().sync();

  // Launch-wide values live in device memory (`sh`), not in registers
  // across the scan.
  while (true) {
    if (leader) {
      const uint64_t k = sh->k;  // kept in device memory: no register across the scan
      bool exit = k >= static_cast<uint64_t>(max_steps) || all_done(vrows, nrows);
      if (!exit && mbox != nullptr && k == sh->next_poll_k) {
        poll_host(mbox, vrows, nrows, k, sh);
        exit = all_done(vrows, nrows);
        sh->next_poll_k = k + poll_steps;
      }
      uint64_t end = static_cast<uint64_t>(max_steps);
      if (mbox != nullptr && sh->next_poll_k < end) end = sh->next_poll_k;
      const uint64_t steps = end - k < sh->span_steps ? end - k : sh->span_steps;
      // The rows the span deals the grid over: at least one unless exit.
      unsigned int n_live = 0;
      for (int r = 0; r < nrows; ++r) {
        if (!vrows[r].done) vlive[n_live++] = r;
      }
      if (!exit) {
        sh->windows = sh->windows + static_cast<unsigned int>(steps);
        if (n_live < static_cast<unsigned int>(nrows)) {
          sh->regranted = sh->regranted + static_cast<unsigned int>(steps);
        }
      }
      sh->n_live = n_live;
      sh->span = steps * window;
      sh->advance = steps * stride;  // == span when stride == window
      sh->exit = exit ? 1u : 0u;
      sh->k = k + steps;
    }
    cg::this_grid().sync();
    if (sh->exit) break;
    {
      const uint32_t n_live = sh->n_live;
      const uint32_t slot = blockIdx.x % n_live;
      const unsigned int row = vlive[slot];
      // The row's message words, loaded per span: a block's row changes as
      // rows finish.
      const uint32_t* p = params + static_cast<size_t>(row) * kParamsLen;
      scan_span(static_cast<uint32_t>(sh->span), vrows[row].base, vrows[row].diff,
                u64(p[0], p[1]), u64(p[2], p[3]), u64(p[4], p[5]), u64(p[6], p[7]),
                &rows[row].best, blockIdx.x / n_live, (gridDim.x - slot + n_live - 1) / n_live);
    }
    cg::this_grid().sync();
    if (leader) {
      const unsigned long long advance = sh->advance;
      for (int r = 0; r < nrows; ++r) {
        if (vrows[r].done) continue;
        const uint32_t best = vrows[r].best;
        if (best != kSentinel) {
          vrows[r].done = 1;
          vrows[r].nonce = vrows[r].base + best;  // 64-bit carry, wraps at 2^64
        } else {
          vrows[r].base = vrows[r].base + advance;
        }
        vrows[r].best = kSentinel;
      }
    }
  }
  if (leader) {
    volatile uint32_t* o = out;
    for (int r = 0; r < nrows; ++r) {
      const unsigned long long nonce = vrows[r].nonce;
      o[r] = static_cast<uint32_t>(nonce);
      o[nrows + r] = static_cast<uint32_t>(nonce >> 32);
    }
    volatile uint32_t* stats = o + 2 * nrows;
    stats[0] = sh->polls;
    stats[1] = static_cast<uint32_t>(sh->poll_ns);
    stats[2] = static_cast<uint32_t>(sh->poll_ns >> 32);
    stats[3] = static_cast<uint32_t>(sh->poll_ns_max);
    stats[4] = static_cast<uint32_t>(sh->poll_ns_max >> 32);
    stats[5] = sh->windows;
    stats[6] = sh->regranted;
    __threadfence_system();
  }
}

// Co-resident blocks of this kernel on the current device, per device.
int g_resident[kMaxDevices];

cudaError_t resident_blocks(int* total) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < 0 || dev >= kMaxDevices) return cudaErrorInvalidDevice;
  if (g_resident[dev] == 0) {
    int sms = 0, per_sm = 0, coop = 0;
    err = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev);
    if (err != cudaSuccess) return err;
    if (!coop) return cudaErrorNotSupported;
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return err;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, b2_run_kernel, kThreads, 0);
    if (err != cudaSuccess) return err;
    if (per_sm < 1) return cudaErrorCooperativeLaunchTooLarge;
    g_resident[dev] = sms * per_sm;
  }
  *total = g_resident[dev];
  return cudaSuccess;
}

}  // namespace

extern "C" {

int b2_abi_version() { return 4; }

const char* b2_error_string(int err) { return cudaGetErrorString(static_cast<cudaError_t>(err)); }

// 64-bit words of the state buffer a launch of `rows` rows needs: the
// launch-wide state, the rows, and the live list (uint32 [rows], rounded up).
int b2_run_state_words(int rows) {
  return static_cast<int>((sizeof(RunShared) + rows * sizeof(RowState) + 4 * rows + 7) / 8);
}

// uint32 words of a launch's `out`.
int b2_run_out_words(int rows) { return 2 * rows + kOutStats; }

// Blocks each row gets at least while every row is live: the co-resident
// count shared over the rows, rounded down (0 on error or too many rows).
int b2_run_blocks_per_row(int rows) {
  int total = 0;
  if (rows <= 0 || resident_blocks(&total) != cudaSuccess) return 0;
  return total / rows;
}

// params: uint32 [rows, 12]; active: uint8 [rows] or null (every row live);
// state: b2_run_state_words(rows) 64-bit words of device scratch; out:
// b2_run_out_words(rows) uint32 words, device memory or the mailbox's mapped
// tail (lo words, hi words, then the statistics); window: nonces each
// row scans per step; stride: the base advance per step (window <= stride <
// 2^31; stride == window is the contiguous scan); mbox: the mailbox's
// device pointer, or null for a launch without control. Returns the
// launch's cudaError_t.
int b2_run_launch(const void* params, const void* active, void* state, void* out, int rows,
                  unsigned int window, unsigned int stride, int max_steps, int poll_steps,
                  void* mbox, void* stream) {
  if (rows <= 0 || rows > 65535 || window == 0 || window >= (1u << 31) || stride < window ||
      stride >= (1u << 31) || max_steps < 0 || (mbox != nullptr && poll_steps < 1)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  int total = 0;
  const cudaError_t err = resident_blocks(&total);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (rows > total) return static_cast<int>(cudaErrorCooperativeLaunchTooLarge);
  const uint32_t* p = static_cast<const uint32_t*>(params);
  const uint8_t* a = static_cast<const uint8_t*>(active);
  RunShared* shared = static_cast<RunShared*>(state);
  RowState* row_state = reinterpret_cast<RowState*>(shared + 1);
  unsigned int* live = reinterpret_cast<unsigned int*>(row_state + rows);
  uint32_t* o = static_cast<uint32_t*>(out);
  uint32_t* mb = static_cast<uint32_t*>(mbox);
  void* args[] = {&p,    &a,      &shared, &row_state, &live,      &o,
                  &rows, &window, &stride, &max_steps, &poll_steps, &mb};
  const dim3 grid(total);
  return static_cast<int>(cudaLaunchCooperativeKernel(reinterpret_cast<void*>(b2_run_kernel), grid,
                                                      dim3(kThreads), args, 0,
                                                      static_cast<cudaStream_t>(stream)));
}

// A zeroed mailbox of `words` uint32 words in mapped pinned host memory:
// *host for the launch thread, *dev for the kernels of the current device.
// Portable, so the pinning holds in every device's context; the caller keys
// a mailbox by the device it was made on and hands it only to that
// device's kernels.
int b2_mailbox_alloc(int words, void** host, void** dev) {
  if (words <= 0) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaHostAlloc(host, static_cast<size_t>(words) * 4,
                                  cudaHostAllocPortable | cudaHostAllocMapped);
  if (err != cudaSuccess) return static_cast<int>(err);
  memset(*host, 0, static_cast<size_t>(words) * 4);
  err = cudaHostGetDevicePointer(dev, *host, 0);
  if (err != cudaSuccess) cudaFreeHost(*host);
  return static_cast<int>(err);
}

// Clear the handshake words before a launch reuses the mailbox.
void b2_mailbox_reset(void* host) {
  volatile uint32_t* mb = static_cast<volatile uint32_t*>(host);
  mb[kMbReq] = 0;
  mb[kMbResp] = 0;
  std::atomic_thread_fence(std::memory_order_seq_cst);
}

// Wait up to `spin_us` microseconds for a request newer than `served`,
// spinning (the caller's thread holds no Python lock meanwhile: ctypes
// releases it). Returns the request's seq, with *k and done[] holding what
// the kernel posted with it; or `served` when none came. Spinning, not
// sleeping: the kernel stalls for as long as its poll goes unanswered, and a
// sleep's wake-up can take hundreds of microseconds.
unsigned int b2_mailbox_take(const void* host, int rows, unsigned int served, int spin_us,
                             unsigned int* k, uint8_t* done) {
  const volatile uint32_t* mb = static_cast<const volatile uint32_t*>(host);
  const auto until = std::chrono::steady_clock::now() + std::chrono::microseconds(spin_us);
  unsigned int n = mb[kMbReq];
  for (unsigned int spins = 1; n == served; ++spins) {
    if (spins % kSpinCheck == 0 && std::chrono::steady_clock::now() >= until) return served;
#if defined(__x86_64__)
    __builtin_ia32_pause();
#endif
    n = mb[kMbReq];
  }
  std::atomic_thread_fence(std::memory_order_seq_cst);
  *k = mb[kMbK];
  for (int r = 0; r < rows; ++r) done[r] = mb[kMbDone + r] != 0;
  return n;
}

// Write the answer's control words (uint32 [rows, 6]), then resp_seq = seq.
void b2_mailbox_answer(void* host, const void* ctrl, int rows, unsigned int seq) {
  uint32_t* mb = static_cast<uint32_t*>(host);
  memcpy(mb + kMbDone + rows, ctrl, static_cast<size_t>(rows) * kCtrlWords * 4);
  std::atomic_thread_fence(std::memory_order_seq_cst);
  static_cast<volatile uint32_t*>(mb)[kMbResp] = seq;
  std::atomic_thread_fence(std::memory_order_seq_cst);
}

}  // extern "C"
