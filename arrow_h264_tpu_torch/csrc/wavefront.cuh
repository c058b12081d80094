// Work tickets, per-MB ready flags and per-row progress counters of the
// persistent kernels: the knight-move wavefront (intra_phase.cu,
// deblock_phase.cu) and the row pipeline (intra_raster.cu,
// deblock_raster.cu).
//
// Wavefront kernels.  A launch gets `scratch`: int32 ready flags, B * n
// per part of an MB that the kernel chains on its own (K1: luma and
// chroma; K2: one), followed by one ticket counter, all zeroed on the
// launch stream before the kernel runs.  A worker (a block in K1, a warp
// in K2) takes ticket t with atomicAdd on the counter; u = t / parts names
// stream u % B, MB order[u / B], where `order` is the frame's MBs sorted by
// knight phase 2 * my + mx (ops/kernels/wavefront.py::wavefront_order),
// and t % parts the part.  Before its body the worker waits (acquire) on
// the flags of that part of the neighbours its body reads; after the body
// and a barrier it sets its own flag (release).
//
// Deadlock freedom: every neighbour an MB waits on has a smaller phase,
// so a smaller position in `order` and, in the same stream and part, a
// smaller ticket.  Tickets are handed out in increasing order and only to
// workers that are running, which never give up their ticket, so by
// induction on the ticket every wait ends, whatever the grid size and
// however the blocks are scheduled.  A spin that outlasts kMaxPolls polls
// (seconds, where an honest wait is microseconds to a few milliseconds)
// is a bug, and __trap() turns it into a launch error instead of a hung
// card.
//
// Row-pipelined kernels.  `scratch` holds one progress counter, "MBs of
// this row finished", per (stream, part, MB row), then the ticket counter.
// A ticket names a whole MB row of one stream and part; tickets run row by
// row, streams and parts interleaved within a row, so a row's counter is
// waited on only by the next row of its stream and part, which holds a
// larger ticket: the induction above holds as it stands.  The worker
// publishes its count (release) after each MB body, and the count of MBs
// it passed without a body before its next wait and at the row's end; a
// waiter keeps the last value it read (`seen`) and polls only for a
// target beyond it.

#pragma once

#include <cuda/atomic>
#include <cuda_runtime.h>
#include <stdint.h>

namespace wavefront {

constexpr long kMaxPolls = 1L << 25;

using Flag = cuda::atomic_ref<int, cuda::thread_scope_device>;

// Spin until *counter >= target, then an acquire fence.  `seen` is the
// value this thread read last, and takes the value read now: a target at
// or below it returns at once, since the fence after that read already
// ordered what it published.  The polls are relaxed loads, which read the
// counter from L2: an acquire load invalidates the SM's L1 each time,
// which would slow down every other block there.
__device__ __forceinline__ void wait_count(int* counter, int target,
                                           int& seen) {
  if (target <= seen) return;
  Flag f(*counter);
  unsigned ns = 8;
  for (long i = 0; (seen = f.load(cuda::memory_order_relaxed)) < target;
       ++i) {
    if (i == kMaxPolls) __trap();
    __nanosleep(ns);
    if (ns < 128) ns *= 2;
  }
  cuda::atomic_thread_fence(cuda::memory_order_acquire,
                            cuda::thread_scope_device);
}

// Store `value` with release order: the caller's barrier before this
// makes the writes of the whole block (or warp) visible with it.
__device__ __forceinline__ void publish(int* counter, int value) {
  Flag(*counter).store(value, cuda::memory_order_release);
}

// A ready flag is a counter that goes from 0 to 1.
__device__ __forceinline__ void wait(int* flag) {
  int seen = 0;
  wait_count(flag, 1, seen);
}

__device__ __forceinline__ void release(int* flag) { publish(flag, 1); }

// Grid of a persistent kernel: the blocks the card holds resident at
// once, and no more than `blocks_of_work`.
template <class Kernel>
cudaError_t resident_grid(Kernel kernel, int threads, long blocks_of_work,
                          int* grid) {
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                        threads, 0);
  const long g = (long)sms * per_sm;
  *grid = (int)(g < blocks_of_work ? g : blocks_of_work);
  if (*grid < 1) *grid = 1;
  return err;
}

}  // namespace wavefront
