// Clock stamps inside a kernel, for tools/kernel_probe.py.
//
// Off unless the source is compiled with -DKERNEL_PROBE (the tool builds
// such a copy through _build.build(..., defines=("KERNEL_PROBE",))): a
// normal build expands PROBE and PROBE_NS to nothing and holds no probe
// code.  On, PROBE(cond, slot) writes the SM's clock64 and PROBE_NS(cond,
// slot) the globaltimer (ns) to slot `slot` of a device array where `cond`
// holds, and the C entry probe_read copies the first n slots to the host.

#pragma once

#ifdef KERNEL_PROBE

#include <cuda_runtime.h>

__device__ long long g_probe[1 << 16];

__device__ __forceinline__ void probe_clock(int slot) {
  long long c;
  asm volatile("mov.u64 %0, %%clock64;" : "=l"(c));
  g_probe[slot] = c;
}

__device__ __forceinline__ void probe_time(int slot) {
  long long c;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(c));
  g_probe[slot] = c;
}

extern "C" int probe_read(long long* out, int n) {
  return cudaMemcpyFromSymbol(out, g_probe, n * sizeof(long long));
}

#define PROBE(cond, slot) \
  do {                    \
    if (cond) probe_clock(slot); \
  } while (0)
#define PROBE_NS(cond, slot) \
  do {                       \
    if (cond) probe_time(slot); \
  } while (0)

#else

#define PROBE(cond, slot) \
  do {                    \
  } while (0)
#define PROBE_NS(cond, slot) \
  do {                       \
  } while (0)

#endif
