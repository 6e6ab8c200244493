// BGMV — batched gathered LoRA delta: out[w] = (h[w] @ A[ids[w]]) @ B[ids[w]].
//
// Replaces ray_lightning_tpu/ops/lora.py::bgmv_pallas, the Pallas kernel of
// multi-tenant LoRA serving.  Shapes: h (W, d), A (N, d, r), B (N, r, k),
// ids (W,) int32, out (W, k).  The LoRA scale is already folded into B.
// Inputs and output are f32 or bf16; every sum is accumulated in f32 and
// the output is rounded once (round-to-nearest-even for bf16).
//
// What bounds it: memory.  The work is 2·W·r·(d + k) operations against the
// W·(d + k) activations plus the factors of the U distinct adapters of the
// batch (U·r·(d + k) elements).  At decode (W = the engine's slot count,
// r = 16) that is under one operation per byte, far below the ~20 f32
// operations per byte where the H100's CUDA cores would become the limit,
// so the least time is the bytes over the memory rate — well under a
// microsecond at GPT-2-small widths — and the launch itself dominates.
//
// Design (simple first): blocks of 1024 threads over (row w, tile of
// columns of k).
//   1. Read ids[w].
//   2. t = h[w] @ A[id]: threads are laid over r, which is contiguous in A,
//      in groups strided over d, so each step of the block reads whole
//      consecutive rows of A; the per-group partial sums meet in shared
//      memory and r threads reduce them into t (f32, in shared memory).
//      This walk is a chain of dependent load rounds, one per d/groups
//      step: 1024 threads (64 groups at r = 16) cut it to 12 rounds at
//      d = 768, where 256 threads took 48.
//   3. out[w, tile] = t @ B[id, :, tile]: threads stride over the tile's
//      columns, neighbouring threads on neighbouring columns, so every row
//      of B is read coalesced.
// With few rows (decode: W = 8) one block per row would leave most SMs
// idle, so the launch splits k into column tiles of at least one column
// per thread, up to about two blocks per SM; each tile's block recomputes
// its row's t (the A factor is small and read from L2).  With many rows
// (prefill) every row is one block and t is computed once.
// Any r <= 128 and any d, k work; the ragged tails are masked by the loop
// bounds.  Rows that share an adapter each read its factors again (from
// L2 after the first); the next step groups rows by adapter (SGMV) so each
// factor crosses memory once.
//
// A row whose id lies outside [0, N) reads no factor and is written as NaN,
// so a bad id shows in the output instead of reading outside the buffers.
//
// The kernel allocates nothing and does not synchronise.  The C entry point
// launches on the caller's stream and returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <algorithm>
#include <cstddef>

namespace {

constexpr int kThreads = 1024;
constexpr int kMaxRank = 128;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    bgmv_kernel(const T* __restrict__ h, const T* __restrict__ a,
                const T* __restrict__ b, const int* __restrict__ ids,
                T* __restrict__ out, int d, int r, int k, int n_adapters,
                int cols_per_tile) {
  __shared__ float partial[kThreads];
  __shared__ float t[kMaxRank];

  const int w = blockIdx.x;
  const int tid = threadIdx.x;
  const int id = ids[w];
  T* out_row = out + static_cast<size_t>(w) * k;
  const int c_begin = blockIdx.y * cols_per_tile;
  const int c_end = min(k, c_begin + cols_per_tile);
  if (id < 0 || id >= n_adapters) {
    // Uniform across the block: every thread leaves before any barrier.
    const float nan = __int_as_float(0x7fc00000);
    for (int c = c_begin + tid; c < c_end; c += kThreads) {
      out_row[c] = from_f32<T>(nan);
    }
    return;
  }
  const T* h_row = h + static_cast<size_t>(w) * d;
  const T* a_id = a + static_cast<size_t>(id) * d * r;
  const T* b_id = b + static_cast<size_t>(id) * r * k;

  // 2. t = h[w] @ A[id].  groups >= 8 because r <= 128; the threads past
  // groups * r (when r does not divide the block) idle in this phase.
  const int groups = kThreads / r;
  const int j = tid % r;
  const int g = tid / r;
  float acc = 0.f;
  if (g < groups) {
#pragma unroll 4
    for (int i = g; i < d; i += groups) {
      acc += to_f32(h_row[i]) * to_f32(a_id[static_cast<size_t>(i) * r + j]);
    }
  }
  partial[tid] = acc;
  __syncthreads();
  if (tid < r) {
    float s = 0.f;
    for (int gg = 0; gg < groups; ++gg) s += partial[gg * r + tid];
    t[tid] = s;
  }
  __syncthreads();

  // 3. out[w, tile] = t @ B[id, :, tile].
  for (int c = c_begin + tid; c < c_end; c += kThreads) {
    float s = 0.f;
#pragma unroll 8
    for (int jj = 0; jj < r; ++jj) {
      s += t[jj] * to_f32(b_id[static_cast<size_t>(jj) * k + c]);
    }
    out_row[c] = from_f32<T>(s);
  }
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (h, A, B and out share it).
extern "C" int rlt_bgmv(const void* h, const void* a, const void* b,
                        const void* ids, void* out, int W, int d, int r,
                        int k, int n_adapters, int dtype, int device,
                        void* stream) {
  if (W < 1 || d < 1 || k < 1 || r < 1 || r > kMaxRank || n_adapters < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  int sms = 0;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return static_cast<int>(err);
  // Column tiles: about two blocks per SM over all rows, at least one
  // column per thread each, a multiple of 32 wide.
  const int max_tiles = (k + kThreads - 1) / kThreads;
  const int want = std::max(1, std::min(max_tiles, (2 * sms + W - 1) / W));
  const int cols = ((k + want - 1) / want + 31) / 32 * 32;
  const dim3 grid(W, (k + cols - 1) / cols);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    bgmv_kernel<float><<<grid, kThreads, 0, s>>>(
        static_cast<const float*>(h), static_cast<const float*>(a),
        static_cast<const float*>(b), static_cast<const int*>(ids),
        static_cast<float*>(out), d, r, k, n_adapters, cols);
  } else if (dtype == 1) {
    bgmv_kernel<__nv_bfloat16><<<grid, kThreads, 0, s>>>(
        static_cast<const __nv_bfloat16*>(h),
        static_cast<const __nv_bfloat16*>(a),
        static_cast<const __nv_bfloat16*>(b), static_cast<const int*>(ids),
        static_cast<__nv_bfloat16*>(out), d, r, k, n_adapters, cols);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
