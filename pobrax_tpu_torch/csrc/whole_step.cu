// whole_step.cu — the CUDA kernel and its C launch function.
//
// ws::kLanes lanes of a warp run ws::step_env (whole_step.cuh) for one
// environment: the whole control step, all substeps, each phase with a
// __syncwarp() after it (a half-warp per env, so the warp's two envs sync
// together). A block of kWarps warps holds kEnvs envs; it first
// stages the System's constant tables into shared memory, after which its
// envs share nothing. See whole_step.cuh for which TPU kernel this replaces, what bounds
// it and what the design does about that.
//
// Built by physics/whole_step.py with
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC -Xptxas -v
// into a shared library with a plain C interface, loaded with ctypes.
#include <cuda_runtime.h>

#include "whole_step.cuh"

namespace {

constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int kEnvs = kThreads / ws::kLanes;  // per block: step_tables.py::ENVS_PER_BLOCK
// at least 4 blocks (16 warps) per SM: at most 128 registers a thread, and
// 4096 envs in one wave over the 132 SMs with a half-warp per env
constexpr int kMinBlocks = 4;

struct WarpLanes {
  int lane;
  ws::Own own;
  __host__ __device__ __forceinline__ void run(ws::Phase p, const ws::Ctx& c) {
    ws::run_phase(p, lane, own, c);
#if defined(__CUDA_ARCH__)
    __syncwarp();
#endif
  }
};

// Dynamic shared memory: the tables (table_words, padded to 16 bytes), then
// one scratch of scratch_words per env.
__global__ void __launch_bounds__(kThreads, kMinBlocks)
whole_step_kernel(const int* __restrict__ tables, int table_words, int B,
                  const float* __restrict__ pos, const float* __restrict__ rot,
                  const float* __restrict__ vel, const float* __restrict__ ang,
                  const float* __restrict__ act,
                  float* pos_out, float* rot_out, float* vel_out, float* ang_out,
                  float* cvel, float* cang, float* jvel, float* jang,
                  float* avel, float* aang) {
  extern __shared__ int smem[];
  for (int w = threadIdx.x; w < table_words; w += kThreads) smem[w] = tables[w];
  __syncthreads();
  const int env = threadIdx.x / ws::kLanes;  // in the block
  const int b = blockIdx.x * kEnvs + env;
  // the ragged last block: a warp with no env leaves (no block-wide sync
  // follows); an env slot past B in a half-filled warp steps env B - 1
  // alongside, for the warp's syncs, and stores nothing
  if (blockIdx.x * kEnvs + (threadIdx.x / 32) * (32 / ws::kLanes) >= B) return;
  ws::Ctx c;
  c.T = ws::tables_of(smem);
  const int base = (table_words + 3) & ~3;
  c.scr = reinterpret_cast<float*>(smem + base) + env * c.T.H->scratch_words;
  float* info[6] = {cvel, cang, jvel, jang, avel, aang};
  c.io = ws::io_of(*c.T.H, b < B ? b : B - 1, pos, rot, vel, ang, act, pos_out, rot_out,
                   vel_out, ang_out, info);
  c.io.store = b < B;
  WarpLanes lanes{static_cast<int>(threadIdx.x % ws::kLanes), {}};
  ws::step_env(lanes, c);
}

int shared_bytes(int table_words, int scratch_words) {
  return 4 * (((table_words + 3) & ~3) + kEnvs * scratch_words);
}

// raise the kernel's dynamic shared-memory limit to `bytes` where it is
// above the default 48 KB (once per size reached)
cudaError_t allow_shared(int bytes) {
  static int allowed = 48 * 1024;
  if (bytes <= allowed) return cudaSuccess;
  cudaError_t err = cudaFuncSetAttribute(whole_step_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err == cudaSuccess) allowed = bytes;
  return err;
}

}  // namespace

extern "C" {

// Launches the step for B envs on `stream`; returns the launch's error
// (cudaSuccess, 0, when the launch was accepted).
cudaError_t ws_whole_step(const void* tables, int table_words, int scratch_words, int B,
                          const float* pos, const float* rot, const float* vel,
                          const float* ang, const float* act,
                          float* pos_out, float* rot_out, float* vel_out, float* ang_out,
                          float* cvel, float* cang, float* jvel, float* jang,
                          float* avel, float* aang, void* stream) {
  if (B <= 0) return cudaSuccess;
  const int bytes = shared_bytes(table_words, scratch_words);
  cudaError_t err = allow_shared(bytes);
  if (err != cudaSuccess) return err;
  const int blocks = (B + kEnvs - 1) / kEnvs;
  whole_step_kernel<<<blocks, kThreads, bytes, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(tables), table_words, B, pos, rot, vel, ang, act,
      pos_out, rot_out, vel_out, ang_out, cvel, cang, jvel, jang, avel, aang);
  return cudaGetLastError();
}

// The warps of this kernel an SM holds at once with `bytes` of dynamic
// shared memory per block, in *warps; returns the CUDA error.
cudaError_t ws_resident_warps(int bytes, int* warps) {
  cudaError_t err = allow_shared(bytes);
  if (err != cudaSuccess) return err;
  int blocks = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, whole_step_kernel, kThreads,
                                                      bytes);
  *warps = blocks * kWarps;
  return err;
}

int ws_envs_per_block() { return kEnvs; }

int ws_layout_words(int* out) { return ws::layout_words(out); }

}  // extern "C"
