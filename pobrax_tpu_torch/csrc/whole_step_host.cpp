// whole_step_host.cpp — the kernel's per-env step built for the CPU.
//
// Test-only: tests/test_torch_kernel_host.py compiles this with g++ into a
// small shared library and holds ws::step_env, the exact phases an env's
// CUDA lanes run, against the plain PyTorch step, so the kernel's arithmetic
// is checked where no GPU exists. An env's lanes are emulated by running
// each phase for lanes 0..kLanes-1 one after another (or backwards with
// `reversed` set), each lane with its own registers (ws::Own), the env's
// scratch on the stack. No entry point of the package loads it.
#include <math.h>

#include "whole_step.cuh"

namespace {

// the largest per-env scratch physics/step_tables.py lays out: one block's
// 227 KB of shared memory
constexpr int kMaxScratchWords = 232448 / 4;

struct HostLanes {
  ws::Own own[ws::kLanes];
  bool reversed;
  void run(ws::Phase p, const ws::Ctx& c) {
    for (int i = 0; i < ws::kLanes; ++i) {
      const int lane = reversed ? ws::kLanes - 1 - i : i;
      ws::run_phase(p, lane, own[lane], c);
    }
  }
};

}  // namespace

extern "C" {

// Returns 0, or 1 if the tables' scratch does not fit kMaxScratchWords.
int ws_whole_step_host(const void* tables, int B,
                       const float* pos, const float* rot, const float* vel,
                       const float* ang, const float* act,
                       float* pos_out, float* rot_out, float* vel_out, float* ang_out,
                       float* cvel, float* cang, float* jvel, float* jang,
                       float* avel, float* aang, int reversed) {
  float scratch[kMaxScratchWords];
  ws::Ctx c;
  c.T = ws::tables_of(tables);
  if (c.T.H->scratch_words > kMaxScratchWords) return 1;
  c.scr = scratch;
  float* info[6] = {cvel, cang, jvel, jang, avel, aang};
  HostLanes lanes;
  lanes.reversed = reversed != 0;
  for (int b = 0; b < B; ++b) {
    // NaN everywhere, so a record read before it is written shows
    for (int w = 0; w < c.T.H->scratch_words; ++w) scratch[w] = NAN;
    c.io = ws::io_of(*c.T.H, b, pos, rot, vel, ang, act, pos_out, rot_out, vel_out, ang_out,
                     info);
    ws::step_env(lanes, c);
  }
  return 0;
}

int ws_layout_words(int* out) { return ws::layout_words(out); }

}  // extern "C"
