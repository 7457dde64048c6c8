// whole_step_host.cpp — the kernel's per-env step built for the CPU.
//
// Test-only: tests/test_torch_kernel_host.py compiles this with g++ into a
// small shared library and holds ws::step_env, the exact function each CUDA
// thread runs, against the plain PyTorch step, so the kernel's arithmetic is
// checked where no GPU exists. No entry point of the package loads it.
#include "whole_step.cuh"

extern "C" {

int ws_whole_step_host(const void* tables, int B,
                       const float* pos, const float* rot, const float* vel,
                       const float* ang, const float* act,
                       float* pos_out, float* rot_out, float* vel_out, float* ang_out,
                       float* cvel, float* cang, float* jvel, float* jang,
                       float* avel, float* aang) {
  float* info[6] = {cvel, cang, jvel, jang, avel, aang};
  for (int b = 0; b < B; ++b) {
    ws::step_env(tables, b, pos, rot, vel, ang, act, pos_out, rot_out, vel_out, ang_out, info);
  }
  return 0;
}

int ws_layout_words(int* out) { return ws::layout_words(out); }

}  // extern "C"
