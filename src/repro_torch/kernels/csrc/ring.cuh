// A ring of shared-memory slabs fed by the copy engine, shared by
// fused_pipeline.cu, native_scan.cu and select_boundaries.cu.
//
// One producer thread streams a row into kSlabs slabs of kSlab bytes with
// cp.async.bulk; each slab's arrival completes its own `full` mbarrier and
// the consumer hands it back on its own `empty` mbarrier, so the copies run
// ahead of the consumer at the card's bandwidth and wait on it only when
// the ring is full.  Bulk copies move 16-byte units from 16-byte addresses,
// so a row that starts anywhere is held from its 16-byte floor: row byte p
// is virtual byte p + a (a = row & 15), slab j holds virtual bytes
// [j * kSlab, (j + 1) * kSlab) in slot j % kSlabs.  Bytes before the row
// or past its end are copied but never read.
#pragma once

#include <cstdint>
#include <cuda_runtime.h>

namespace ring {

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_addr(bar)),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(
                   smem_addr(bar))
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, int bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::
                   "r"(smem_addr(bar)),
               "r"(bytes)
               : "memory");
}

// waits for the completion of the barrier's phase of the given parity
__device__ __forceinline__ void mbar_wait(uint64_t* bar, unsigned parity) {
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(smem_addr(bar)), "r"(parity)
        : "memory");
  }
}

// bytes global -> shared by the copy engine, completion on bar
__device__ __forceinline__ void bulk_copy(void* dst, const void* src,
                                          int bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(smem_addr(dst)),
      "l"(src), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}

// The ring over the kernel's shared buf[kSlab * kSlabs], full[kSlabs] and
// empty[kSlabs]; each consumer thread keeps its own copy of ready and
// released (the same values in every thread that calls need).
template <int kSlab_, int kSlabs_>
struct Ring {
  static constexpr int kSlab = kSlab_;
  static constexpr int kSlabs = kSlabs_;
  static constexpr int kBytes = kSlab * kSlabs;  // a power of two
  static_assert(kSlab % 16 == 0, "bulk copies move 16-byte units");
  static_assert((kBytes & (kBytes - 1)) == 0, "positions wrap by a mask");

  uint8_t* buf;
  uint64_t* full;
  uint64_t* empty;
  long long ready = 0;     // slabs [0, ready) have arrived
  long long released = 0;  // slabs [0, released) are handed back

  static __device__ __forceinline__ long long slabs(long long vlen) {
    return (vlen + kSlab - 1) / kSlab;
  }

  // By one thread, then a CTA barrier before any other use.
  __device__ __forceinline__ void init() const {
    for (int i = 0; i < kSlabs; ++i) {
      mbar_init(&full[i], 1);
      mbar_init(&empty[i], 1);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }

  // The producer thread: virtual bytes [0, vlen) from base (16-byte
  // aligned), slab after slab, each as soon as its slot is handed back.
  __device__ __forceinline__ void produce(const uint8_t* base,
                                          long long vlen) const {
    const long long n = slabs(vlen);
    for (long long j = 0; j < n; ++j) {
      const int slot = (int)(j % kSlabs);
      if (j >= kSlabs)  // slab j - kSlabs handed back
        mbar_wait(&empty[slot], (unsigned)((j / kSlabs) & 1) ^ 1u);
      const long long left = vlen - j * kSlab;
      const int bytes = ((int)(left < kSlab ? left : kSlab) + 15) & ~15;
      mbar_expect_tx(&full[slot], bytes);
      bulk_copy(buf + slot * kSlab, base + j * kSlab, bytes, &full[slot]);
    }
  }

  // The consumer: make slabs [.., hi] resident and hand back those below
  // lo (leader: the one thread that arrives).  A slab is handed back only
  // after it has arrived, and before waiting on slab r every arrived slab
  // below min(r, lo) is handed back, so the producer (which needs slab
  // r - kSlabs back to copy slab r) always can.  hi - lo < kSlabs.  A warp
  // that reads the ring syncs before the call, so that no lane still reads
  // what is handed back.
  __device__ __forceinline__ void need(long long lo, long long hi,
                                       bool leader) {
    for (;;) {
      const long long upto = lo < ready ? lo : ready;
      for (; released < upto; ++released)
        if (leader) mbar_arrive(&empty[released % kSlabs]);
      if (ready > hi) break;
      mbar_wait(&full[ready % kSlabs], (unsigned)((ready / kSlabs) & 1));
      ++ready;
    }
  }
};

}  // namespace ring
