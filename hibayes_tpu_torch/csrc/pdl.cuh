// Launch helpers shared by the sweep kernels: Hopper's programmatic
// dependent launch, asynchronous copies into shared memory, and the flags
// that order work between the CTAs of one persistent grid.
//
// Programmatic dependent launch: a kernel launched with `overlap` may start
// while the kernel before it on the stream still runs.  It first loads what
// no earlier launch of the sweep writes, then calls wait_previous()
// (griddepcontrol.wait: the kernel before it has finished and its writes are
// visible) before it reads that kernel's output.  release_next() lets the
// next launch of the stream start.  Every grid has at least one thread that
// waits, so a grid never finishes before the one it follows.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace hb {

// Wait until the launch before this one has finished and its writes are
// visible (a no-op for an ordinary launch).
__device__ __forceinline__ void wait_previous() {
  asm volatile("griddepcontrol.wait;" ::: "memory");
}

// Let the next launch of the stream start (if it allows overlap).
__device__ __forceinline__ void release_next() {
  asm volatile("griddepcontrol.launch_dependents;" ::: "memory");
}

// Launch `kernel` on `stream`; with `overlap` it may start before the
// kernel before it has finished (it must wait_previous() before reading
// that kernel's output).
template <typename... P, typename... A>
cudaError_t launch(bool overlap, void (*kernel)(P...), dim3 grid, int threads,
                   size_t smem, cudaStream_t stream, A... args) {
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr.val.programmaticStreamSerializationAllowed = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cfg.attrs = &attr;
  cfg.numAttrs = overlap ? 1 : 0;
  const cudaError_t e = cudaLaunchKernelEx(&cfg, kernel, static_cast<P>(args)...);
  return e != cudaSuccess ? e : cudaGetLastError();
}

// Asynchronous copies global -> shared (cp.async): 4 bytes through L1,
// 16 bytes through L2 only.  Completion is tracked per commit group.
__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;" ::"r"(d), "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;" ::"r"(d), "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;" ::: "memory");
}

// Wait until at most N of this thread's commit groups are still in flight.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;" ::"n"(N) : "memory");
}

// Bulk copies global -> shared by the Tensor Memory Accelerator
// (cp.async.bulk): one thread asks for a whole contiguous block, the copy
// engine moves it, and its bytes are counted against an mbarrier in shared
// memory, which completes one phase when they have all landed.  No other
// thread spends an instruction on it.
__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;" ::"r"(smem_addr(bar)) : "memory");
  asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
}

// One thread: `bytes` of bulk copies follow against bar's current phase.
__device__ __forceinline__ void mbar_expect(uint64_t* bar, unsigned bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;"
               ::"r"(smem_addr(bar)), "r"(bytes) : "memory");
}

// Copy `bytes` (a multiple of 16, both addresses 16-byte aligned).  Shared
// memory that generic loads read before must be released to the copy
// engine first (fence_async).
__device__ __forceinline__ void bulk_copy(void* dst, const void* src, unsigned bytes,
                                          uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];"
      ::"r"(smem_addr(dst)), "l"(src), "r"(bytes), "r"(smem_addr(bar)) : "memory");
}

__device__ __forceinline__ void fence_async() {
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
}

// Wait until bar has completed the phase of this parity.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, unsigned parity) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%0], %1;\n"
      "@!p bra WAIT;\n"
      "}\n" ::"r"(smem_addr(bar)), "r"(parity) : "memory");
}

// Ask the copy engine to bring `bytes` at src into L2 (a hint: nothing is
// written to shared memory and nothing waits for it).  Both a multiple of 16.
__device__ __forceinline__ void bulk_prefetch_l2(const void* src, unsigned bytes) {
  asm volatile("cp.async.bulk.prefetch.L2.global [%0], %1;" ::"l"(src), "r"(bytes) : "memory");
}

// Prefetch the whole of [p, p + bytes) into L2 in 64 KB pieces, where p is
// 16-byte aligned (a trailing part under 16 bytes is left to the loads).
__device__ __forceinline__ void prefetch_l2(const void* p, long long bytes) {
  if (p == nullptr || (reinterpret_cast<uintptr_t>(p) & 15) != 0) return;
  const char* c = static_cast<const char*>(p);
  for (long long o = 0; o + 16 <= bytes; o += 65536) {
    const long long left = bytes - o;
    bulk_prefetch_l2(c + o, static_cast<unsigned>((left < 65536 ? left : 65536) & ~15LL));
  }
}

// Bring the 128-byte line at p into L2 (a hint, one instruction a line).
__device__ __forceinline__ void prefetch_line_l2(const void* p) {
  asm volatile("prefetch.global.L2 [%0];" ::"l"(p));
}

// Named barriers between warps of one CTA (ids 1-15; id 0 is
// __syncthreads).  `threads` counts every thread that arrives or waits, a
// multiple of 32.  A producer arrives (and goes on); a consumer waits until
// all have arrived, and then sees the shared and global writes the
// producers made before they arrived.
__device__ __forceinline__ void bar_arrive(int id, int threads) {
  asm volatile("bar.arrive %0, %1;" ::"r"(id), "r"(threads) : "memory");
}

__device__ __forceinline__ void bar_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;" ::"r"(id), "r"(threads) : "memory");
}

// Flags between the CTAs of one grid, at device scope.  A writer makes its
// data visible to the whole CTA's threads' stores first (__syncthreads, then
// one thread calls publish); a reader's one thread spins in await, then the
// CTA synchronises before it reads.  Data read after an await is read with
// __ldcg (L2, never a stale L1 line).  Values compare modulo 2^32, so a
// counter may run on across sweeps.
__device__ __forceinline__ unsigned load_acquire(const unsigned* p) {
  unsigned v;
  asm volatile("ld.acquire.gpu.global.u32 %0, [%1];" : "=r"(v) : "l"(p) : "memory");
  return v;
}

__device__ __forceinline__ void publish(unsigned* p, unsigned v) {
  __threadfence();
  asm volatile("st.release.gpu.global.u32 [%0], %1;" ::"l"(p), "r"(v) : "memory");
}

__device__ __forceinline__ long long global_ns() {
  long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}

// Spin until *p has reached `target` (modulo 2^32).  A wait of more than
// 10 s can only be a fault (a schedule that does not match the layout, or
// a CTA that is not resident): the kernel traps, so the launch fails with
// an error instead of hanging the card.
__device__ __forceinline__ void await(const unsigned* p, unsigned target) {
  unsigned ns = 32;
  long long t0 = 0;
  while (static_cast<int>(load_acquire(p) - target) < 0) {
    __nanosleep(ns);
    if (ns < 256) {
      ns *= 2;
      t0 = global_ns();
    } else if (global_ns() - t0 > 10000000000LL) {
      __trap();
    }
  }
  __threadfence();
}

// Spin until *p has reached `target` (modulo 2^32) by acquire loads, with
// await's 10 s trap but without its sleeps and trailing fence, for a
// reader on the critical path: the acquire orders this thread's later
// loads, the other threads read after a barrier with it (__syncwarp or
// __syncthreads), and what they read after the flag is read from L2
// (__ldcg).
__device__ __forceinline__ void spin_acquire(const unsigned* p, unsigned target) {
  long long t0 = 0;
  while (static_cast<int>(load_acquire(p) - target) < 0) {
    if (t0 == 0) t0 = global_ns();
    else if (global_ns() - t0 > 10000000000LL) __trap();
  }
}

// Spin until *p has reached `target` (modulo 2^32) by relaxed loads, a
// short nap between them, then one acquire load: for a reader beside a
// latency-bound warp of its CTA, which keeps the issue slots and the
// memory pipe; await's 10 s trap.
__device__ __forceinline__ void await_nap(const unsigned* p, unsigned target) {
  long long t0 = 0;
  for (;;) {
    unsigned v;
    asm volatile("ld.relaxed.gpu.global.u32 %0, [%1];" : "=r"(v) : "l"(p) : "memory");
    if (static_cast<int>(v - target) >= 0) break;
    __nanosleep(64);
    if (t0 == 0) t0 = global_ns();
    else if (global_ns() - t0 > 10000000000LL) __trap();
  }
  (void)load_acquire(p);
}

}  // namespace hb
