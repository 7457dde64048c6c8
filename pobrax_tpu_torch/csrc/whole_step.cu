// whole_step.cu — the CUDA kernel and its C launch function.
//
// One thread per environment runs ws::step_env (whole_step.cuh): the whole
// control step, all substeps, with the System's constant tables read from
// one device buffer. See whole_step.cuh for which TPU kernel this replaces,
// what bounds it and what the design does about that.
//
// Built by physics/whole_step.py with
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC -Xptxas -v
// into a shared library with a plain C interface, loaded with ctypes.
#include <cuda_runtime.h>

#include "whole_step.cuh"

namespace {

constexpr int kThreads = 32;  // one warp per block: 4096 envs -> 128 SMs

__global__ void __launch_bounds__(kThreads)
whole_step_kernel(const void* __restrict__ tables, int B,
                  const float* __restrict__ pos, const float* __restrict__ rot,
                  const float* __restrict__ vel, const float* __restrict__ ang,
                  const float* __restrict__ act,
                  float* pos_out, float* rot_out, float* vel_out, float* ang_out,
                  float* cvel, float* cang, float* jvel, float* jang,
                  float* avel, float* aang) {
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= B) return;
  float* info[6] = {cvel, cang, jvel, jang, avel, aang};
  ws::step_env(tables, b, pos, rot, vel, ang, act, pos_out, rot_out, vel_out, ang_out, info);
}

}  // namespace

extern "C" {

// Launches the step for B envs on `stream`; returns the launch's error
// (cudaSuccess, 0, when the launch was accepted).
cudaError_t ws_whole_step(const void* tables, int B,
                          const float* pos, const float* rot, const float* vel,
                          const float* ang, const float* act,
                          float* pos_out, float* rot_out, float* vel_out, float* ang_out,
                          float* cvel, float* cang, float* jvel, float* jang,
                          float* avel, float* aang, void* stream) {
  if (B <= 0) return cudaSuccess;
  const int blocks = (B + kThreads - 1) / kThreads;
  whole_step_kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      tables, B, pos, rot, vel, ang, act, pos_out, rot_out, vel_out, ang_out,
      cvel, cang, jvel, jang, avel, aang);
  return cudaGetLastError();
}

int ws_layout_words(int* out) { return ws::layout_words(out); }

}  // extern "C"
