// Host emulation of CUDA's pipeline primitives (cp.async) for
// tests/test_torch_kernels_emulated.py. Each emulated CUDA thread (a
// std::thread) keeps its own queue: `__pipeline_memcpy_async` records a copy
// in the open group, `__pipeline_commit` closes the group, and
// `__pipeline_wait_prior(n)` performs the copies of every closed group but
// the n newest. A copy therefore lands only when the kernel waits for it, so
// a kernel that reads a slot before waiting reads the NaN fill of the
// emulated shared memory.
#pragma once
#include <cstddef>
#include <cstring>
#include <deque>
#include <vector>

struct EmuAsyncCopy {
  void* dst;
  const void* src;
  size_t size, zfill;
};

inline thread_local std::vector<EmuAsyncCopy> emu_open_group;
inline thread_local std::deque<std::vector<EmuAsyncCopy>> emu_closed_groups;

inline void __pipeline_memcpy_async(void* dst, const void* src, size_t size, size_t zfill = 0) {
  emu_open_group.push_back({dst, src, size, zfill});
}

inline void __pipeline_commit() {
  emu_closed_groups.push_back(std::move(emu_open_group));
  emu_open_group.clear();
}

inline void __pipeline_wait_prior(size_t prior) {
  while (emu_closed_groups.size() > prior) {
    for (const EmuAsyncCopy& c : emu_closed_groups.front()) {
      std::memcpy(c.dst, c.src, c.size - c.zfill);
      std::memset(static_cast<char*>(c.dst) + (c.size - c.zfill), 0, c.zfill);
    }
    emu_closed_groups.pop_front();
  }
}
