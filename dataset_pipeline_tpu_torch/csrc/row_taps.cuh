// Tap reads of the row extraction kernels (row_extract.cu,
// row_extract_packed.cu): two adjacent floats p[0], p[1] of a row that no
// other observation reads.
//
// One 8-byte load where p is 8-byte aligned, else two 4-byte loads. The
// address decides, never the lane: a row starts unaligned when its width is
// odd or the tensor is a view. The loads take the read-only path (__ldg).
//
// Measured on an H100 (PERF.md), and not kept: a 16-byte load of the aligned
// unit for every pair inside one (E6 3 % and E7 12 % slower; nvcc narrows
// such a load to two 4-byte loads unless all four floats are used);
// evict-first (__ldcs) and L1::no_allocate loads (no faster in turns, 8 %
// slower when other work ran just before; __ldg does not move).
#pragma once

#include <cstdint>

__device__ __forceinline__ float2 tap_pair(const float* p) {
  if ((reinterpret_cast<uintptr_t>(p) & 7) == 0) return __ldg(reinterpret_cast<const float2*>(p));
  return make_float2(__ldg(p), __ldg(p + 1));
}
