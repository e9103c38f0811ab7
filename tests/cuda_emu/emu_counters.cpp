// The emulation's load counters (cuda_runtime.h), for the tests: loads not
// aligned to their own size, and vector loads, since the last reset.
#include "cuda_runtime.h"

extern "C" long long emu_misaligned_loads() { return emu_misaligned.load(); }
extern "C" long long emu_vector_load_count() { return emu_vector_loads.load(); }
extern "C" void emu_reset_load_counts() {
  emu_misaligned = 0;
  emu_vector_loads = 0;
}
