// LayerNorm forward and backward over the rows of x (n, d).
//
// Replaces ray_lightning_tpu/ops/layer_norm.py::_ln_fwd_pallas (body
// _ln_fwd_kernel) and ::_ln_bwd_pallas (body _ln_bwd_kernel), the Pallas
// kernels at every LayerNorm site of the GPT training step.  x, y, dy and dx
// are f32 or bf16 (one dtype); g, b, the saved statistics and dg/db are f32.
// Every sum is taken in f32.
//
// Forward: mu = mean(x), var = mean((x - mu)^2), rstd = rsqrt(var + 1e-5),
// y = (x - mu)·rstd·g + b, written in x's dtype; mu and rstd (n,) f32 are
// written only when the caller asks for them (the no-grad call writes y
// alone, as the JAX package's eval variant does).
// Backward: x̂ = (x - mu)·rstd, dx = (dy·g - mean(dy·g) - x̂·mean(dy·g·x̂))
// ·rstd; dg = Σ dy·x̂ and db = Σ dy over the rows.
//
// What bounds it: memory.  The forward reads x once and writes y once
// (2·n·d elements, about 50 MB at n = 16384, d = 768, bf16) against ~8
// operations per element, far below the card's operations-per-byte line;
// the backward reads x and dy and writes dx.
//
// Design (simple first): one warp per row.  A lane walks the columns
// lane, lane + 32, ...; the row's sums meet by shuffles.  The forward reads
// the row three times (sum, centered sum of squares, output); the second
// and third reads come from L1, which holds the block's eight rows.  The
// TPU kernel's 512-row tiles keep a whole tile in VMEM; here a block is
// eight rows, so n / 8 blocks fill the 132 SMs many times over.
// The cross-row dg/db sums are deterministic: each block adds its rows'
// dy·x̂ and dy into per-warp f32 columns in shared memory, folds its warps
// into one partial row of a (blocks, d) buffer, and a second kernel sums
// the partial rows column by column in a fixed order — the JAX kernel's
// per-block partials summed by one reduction.
//
// The kernels allocate nothing and do not synchronise.  The C entry points
// launch on the caller's stream and return cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>

namespace {

constexpr int kWarps = 8;       // rows per forward block
constexpr float kEps = 1e-5f;
// Shared memory a backward block may use for its per-warp dg/db columns.
constexpr int kBwdSmemCap = 200 * 1024;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

template <typename T>
__global__ void __launch_bounds__(kWarps * 32)
ln_fwd_kernel(const T* __restrict__ x, const float* __restrict__ g,
              const float* __restrict__ b, T* __restrict__ y,
              float* __restrict__ mu_out, float* __restrict__ rs_out,
              long long n, int d) {
  const int lane = threadIdx.x & 31;
  const long long row =
      static_cast<long long>(blockIdx.x) * kWarps + (threadIdx.x >> 5);
  if (row >= n) return;
  const T* xr = x + row * d;
  const float fd = static_cast<float>(d);
  float s = 0.f;
  for (int c = lane; c < d; c += 32) s += to_f32(xr[c]);
  const float mu = warp_sum(s) / fd;
  float q = 0.f;
  for (int c = lane; c < d; c += 32) {
    const float t = to_f32(xr[c]) - mu;
    q += t * t;
  }
  const float rs = rsqrtf(warp_sum(q) / fd + kEps);
  T* yr = y + row * d;
  for (int c = lane; c < d; c += 32) {
    const float xh = (to_f32(xr[c]) - mu) * rs;
    yr[c] = from_f32<T>(xh * g[c] + b[c]);
  }
  if (mu_out != nullptr && lane == 0) {
    mu_out[row] = mu;
    rs_out[row] = rs;
  }
}

// Grid-stride over rows, `warps` warps a block; part is (gridDim.x, 2, d):
// the block's dg partial row, then its db partial row.
template <typename T>
__global__ void ln_bwd_kernel(const T* __restrict__ x,
                              const float* __restrict__ g,
                              const T* __restrict__ dy,
                              const float* __restrict__ mu,
                              const float* __restrict__ rs,
                              T* __restrict__ dx, float* __restrict__ part,
                              long long n, int d) {
  extern __shared__ float acc[];  // [warps][2][d]
  const int warps = blockDim.x >> 5;
  const int w = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  float* dg_acc = acc + static_cast<size_t>(w) * 2 * d;
  float* db_acc = dg_acc + d;
  for (int c = lane; c < d; c += 32) {
    dg_acc[c] = 0.f;
    db_acc[c] = 0.f;
  }
  const float fd = static_cast<float>(d);
  for (long long row = static_cast<long long>(blockIdx.x) * warps + w;
       row < n; row += static_cast<long long>(gridDim.x) * warps) {
    const T* xr = x + row * d;
    const T* dyr = dy + row * d;
    const float m = mu[row];
    const float r = rs[row];
    float s1 = 0.f, s2 = 0.f;
    for (int c = lane; c < d; c += 32) {
      const float xh = (to_f32(xr[c]) - m) * r;
      const float dyg = to_f32(dyr[c]) * g[c];
      s1 += dyg;
      s2 += dyg * xh;
    }
    const float m1 = warp_sum(s1) / fd;
    const float m2 = warp_sum(s2) / fd;
    T* dxr = dx + row * d;
    for (int c = lane; c < d; c += 32) {
      const float xh = (to_f32(xr[c]) - m) * r;
      const float dyv = to_f32(dyr[c]);
      const float dyg = dyv * g[c];
      dxr[c] = from_f32<T>((dyg - m1 - xh * m2) * r);
      dg_acc[c] += dyv * xh;  // each warp owns its columns: no race
      db_acc[c] += dyv;
    }
  }
  __syncthreads();
  float* out = part + static_cast<size_t>(blockIdx.x) * 2 * d;
  for (int c = threadIdx.x; c < 2 * d; c += blockDim.x) {
    float t = 0.f;
    for (int v = 0; v < warps; ++v) t += acc[static_cast<size_t>(v) * 2 * d + c];
    out[c] = t;
  }
}

// out[c] = Σ_blk part[blk][c] for the 2·d columns (dg then db), in block
// order.
__global__ void ln_col_sum_kernel(const float* __restrict__ part, int blocks,
                                  int d, float* __restrict__ dg,
                                  float* __restrict__ db) {
  const int c = blockIdx.x * blockDim.x + threadIdx.x;
  if (c >= 2 * d) return;
  float t = 0.f;
  for (int blk = 0; blk < blocks; ++blk) {
    t += part[static_cast<size_t>(blk) * 2 * d + c];
  }
  if (c < d) {
    dg[c] = t;
  } else {
    db[c - d] = t;
  }
}

template <typename T>
cudaError_t launch_bwd(const void* x, const float* g, const void* dy,
                       const float* mu, const float* rs, void* dx,
                       float* part, float* dg, float* db, long long n, int d,
                       int blocks, cudaStream_t s) {
  int warps = 8;
  while (warps > 1 && static_cast<size_t>(warps) * 2 * d * sizeof(float) >
                          static_cast<size_t>(kBwdSmemCap)) {
    warps >>= 1;
  }
  const size_t smem = static_cast<size_t>(warps) * 2 * d * sizeof(float);
  if (smem > static_cast<size_t>(kBwdSmemCap)) return cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      ln_bwd_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  ln_bwd_kernel<T><<<blocks, warps * 32, smem, s>>>(
      static_cast<const T*>(x), g, static_cast<const T*>(dy), mu, rs,
      static_cast<T*>(dx), part, n, d);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  ln_col_sum_kernel<<<(2 * d + 255) / 256, 256, 0, s>>>(part, blocks, d, dg,
                                                        db);
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (x and y).  mu and rs may both be null:
// then only y is written.
extern "C" int rlt_ln_fwd(const void* x, const void* g, const void* b,
                          void* y, void* mu, void* rs, long long n, int d,
                          int dtype, int device, void* stream) {
  if (n < 1 || d < 1 || (mu == nullptr) != (rs == nullptr)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long blocks = (n + kWarps - 1) / kWarps;
  if (blocks > 2147483647LL) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* gf = static_cast<const float*>(g);
  const float* bf = static_cast<const float*>(b);
  float* muf = static_cast<float*>(mu);
  float* rsf = static_cast<float*>(rs);
  if (dtype == 0) {
    ln_fwd_kernel<float><<<static_cast<unsigned>(blocks), kWarps * 32, 0, s>>>(
        static_cast<const float*>(x), gf, bf, static_cast<float*>(y), muf,
        rsf, n, d);
  } else if (dtype == 1) {
    ln_fwd_kernel<__nv_bfloat16>
        <<<static_cast<unsigned>(blocks), kWarps * 32, 0, s>>>(
            static_cast<const __nv_bfloat16*>(x), gf, bf,
            static_cast<__nv_bfloat16*>(y), muf, rsf, n, d);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

// part: f32 scratch of blocks·2·d elements.  dg, db: (d,) f32.
extern "C" int rlt_ln_bwd(const void* x, const void* g, const void* dy,
                          const void* mu, const void* rs, void* dx,
                          void* part, void* dg, void* db, long long n, int d,
                          int blocks, int dtype, int device, void* stream) {
  if (n < 1 || d < 1 || blocks < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* gf = static_cast<const float*>(g);
  const float* muf = static_cast<const float*>(mu);
  const float* rsf = static_cast<const float*>(rs);
  float* pf = static_cast<float*>(part);
  float* dgf = static_cast<float*>(dg);
  float* dbf = static_cast<float*>(db);
  if (dtype == 0) {
    err = launch_bwd<float>(x, gf, dy, muf, rsf, dx, pf, dgf, dbf, n, d,
                            blocks, s);
  } else if (dtype == 1) {
    err = launch_bwd<__nv_bfloat16>(x, gf, dy, muf, rsf, dx, pf, dgf, dbf, n,
                                    d, blocks, s);
  } else {
    err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}
