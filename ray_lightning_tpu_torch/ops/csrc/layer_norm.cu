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
// Forward and f32 backward (simple first): one warp per row.  A lane walks
// the columns lane, lane + 32, ...; the row's sums meet by shuffles.  The
// forward reads the row three times (sum, centered sum of squares, output);
// the second and third reads come from L1, which holds the block's eight
// rows.  The TPU kernel's 512-row tiles keep a whole tile in VMEM; here a
// block is eight rows, so n / 8 blocks fill the 132 SMs many times over.
// The f32 backward adds its rows' dy·x̂ and dy into per-warp f32 columns in
// shared memory, folds its warps into one partial row of a (blocks, 2·d)
// buffer, and ln_col_sum_kernel sums the partial rows column by column.
//
// bf16 backward (ln_bwd_rows_kernel, every d): the bytes are the bound, so
// x and dy are read 16 bytes (8 columns) a lane a load.  A lane owns the
// same columns in every row it visits: unit u = lane + 32·i is columns
// [8u, 8u + 8), and the d % 8 columns past the last unit are a scalar tail,
// one a lane.  Up to d = 1543 (6 units a lane) the narrow form reads each
// row from memory once and holds it in registers for both passes over it
// (the row's two means, then dx); g stays in the lane's registers, and so
// do its dg and db partial sums across all the warp's rows.  A wider row
// takes the wide form: the lane walks its units 4 at a time, reads each
// chunk of x, dy and g again for the second pass (from L1 or L2), and adds
// its dg and db into its warp's columns of the block's shared fold (held
// k-major, column 8u + k at k·nu + u, so that a warp's lanes touch
// consecutive words), which the narrow form fills once at the end.  Then the block's warps are folded,
// in warp order, into the block's partial row.  Rows whose start is not
// 16-byte aligned (d % 8 != 0) load each unit element by element into the
// same registers.  Blocks of up to 8 warps (fewer where the fold of a very
// wide row would not fit) grid-stride over the rows, two blocks an SM (16
// warps) at the main path's width.  The partial rows are summed by
// ln_col_sum_groups_kernel: each of 2·d/32 blocks owns 32 columns, its 8
// warps sum every 8th partial row in row order, and the 8 sums meet in warp
// order.  Every sum has a fixed order: dg and db are bitwise repeatable.
//
// The kernels allocate nothing and do not synchronise.  The C entry points
// launch on the caller's stream and return cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

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

using bf16 = __nv_bfloat16;

constexpr int kUnit = 8;       // bf16 columns of one 16-byte load
constexpr int kBwdWarps = 8;   // warps a bf16 backward block, at most
constexpr int kMaxUnits = 6;   // units a lane holds, narrow: d <= 8·32·6 + 7
constexpr int kWideUnits = 4;  // units a lane holds a chunk, wide
constexpr int kColTile = 32;   // columns of one column-sum block
constexpr int kColGroups = 8;  // partial-row groups of one column-sum block

template <bool kAligned>
__device__ __forceinline__ uint4 load_unit(const bf16* p) {
  if constexpr (kAligned) {
    return *reinterpret_cast<const uint4*>(p);
  } else {
    uint4 v;
    unsigned short* h = reinterpret_cast<unsigned short*>(&v);
    const unsigned short* q = reinterpret_cast<const unsigned short*>(p);
#pragma unroll
    for (int k = 0; k < kUnit; ++k) h[k] = q[k];
    return v;
  }
}

template <bool kAligned>
__device__ __forceinline__ void store_unit(bf16* p, uint4 v) {
  if constexpr (kAligned) {
    *reinterpret_cast<uint4*>(p) = v;
  } else {
    const unsigned short* h = reinterpret_cast<const unsigned short*>(&v);
    unsigned short* q = reinterpret_cast<unsigned short*>(p);
#pragma unroll
    for (int k = 0; k < kUnit; ++k) q[k] = h[k];
  }
}

__device__ __forceinline__ void unpack(uint4 v, float f[kUnit]) {
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&v);
#pragma unroll
  for (int k = 0; k < kUnit / 2; ++k) {
    const float2 t = __bfloat1622float2(h[k]);
    f[2 * k] = t.x;
    f[2 * k + 1] = t.y;
  }
}

__device__ __forceinline__ uint4 pack(const float f[kUnit]) {
  uint4 v;
  __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&v);
#pragma unroll
  for (int k = 0; k < kUnit / 2; ++k) {
    h[k] = __floats2bfloat162_rn(f[2 * k], f[2 * k + 1]);
  }
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

// The lane's units u0, u0 + 32, ... (NU of them) of one row, or of g.
template <int NU, bool kAligned>
__device__ __forceinline__ void load_units(uint4 (&v)[NU], const bf16* r,
                                           int u0, int nu) {
#pragma unroll
  for (int i = 0; i < NU; ++i) {
    const int u = u0 + 32 * i;
    if (u < nu) v[i] = load_unit<kAligned>(r + u * kUnit);
  }
}

template <int NU>
__device__ __forceinline__ void load_g(float (&gr)[NU][kUnit], const float* g,
                                       int u0, int nu) {
#pragma unroll
  for (int i = 0; i < NU; ++i) {
    const int u = u0 + 32 * i;
#pragma unroll
    for (int k = 0; k < kUnit; ++k) gr[i][k] = u < nu ? g[u * kUnit + k] : 0.f;
  }
}

// bf16 backward, NU units a lane (narrow) or a chunk (kWide).  part is
// (gridDim.x, 2, d): the block's dg partial row, then its db partial row.
template <int NU, bool kAligned, bool kWide>
__global__ void __launch_bounds__(kBwdWarps * 32, NU <= 3 ? 2 : 1)
ln_bwd_rows_kernel(const bf16* __restrict__ x, const float* __restrict__ g,
                   const bf16* __restrict__ dy, const float* __restrict__ mu,
                   const float* __restrict__ rs, bf16* __restrict__ dx,
                   float* __restrict__ part, long long n, int d) {
  extern __shared__ float fold[];  // [warps][2][d]
  const int warps = blockDim.x >> 5;
  const int w = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int nu = d / kUnit;
  const int c_tail = nu * kUnit;
  const bool tail = lane < d - c_tail;
  // Chunks of NU units a lane: one in the narrow form.
  const int chunks = kWide ? ((nu + 31) / 32 + NU - 1) / NU : 1;
  float* own = fold + static_cast<size_t>(w) * 2 * d;
  float gr[NU][kUnit], dgr[NU][kUnit], dbr[NU][kUnit];
  if constexpr (kWide) {
    for (int c = lane; c < 2 * d; c += 32) own[c] = 0.f;
    __syncwarp();  // each lane then adds into its own units' columns
  } else {
    load_g<NU>(gr, g, lane, nu);
#pragma unroll
    for (int i = 0; i < NU; ++i) {
#pragma unroll
      for (int k = 0; k < kUnit; ++k) dgr[i][k] = dbr[i][k] = 0.f;
    }
  }
  const float gt = tail ? g[c_tail + lane] : 0.f;
  float dgt = 0.f, dbt = 0.f;
  const float fd = static_cast<float>(d);
  for (long long row = static_cast<long long>(blockIdx.x) * warps + w;
       row < n; row += static_cast<long long>(gridDim.x) * warps) {
    const bf16* xr = x + row * d;
    const bf16* dyr = dy + row * d;
    const float m = mu[row];
    const float r = rs[row];
    uint4 xv[NU], dv[NU];
    float s1 = 0.f, s2 = 0.f;
    for (int ch = 0; ch < chunks; ++ch) {
      const int u0 = lane + 32 * NU * ch;
      load_units<NU, kAligned>(xv, xr, u0, nu);
      load_units<NU, kAligned>(dv, dyr, u0, nu);
      if constexpr (kWide) load_g<NU>(gr, g, u0, nu);
#pragma unroll
      for (int i = 0; i < NU; ++i) {
        if (u0 + 32 * i < nu) {
          float xf[kUnit], df[kUnit];
          unpack(xv[i], xf);
          unpack(dv[i], df);
#pragma unroll
          for (int k = 0; k < kUnit; ++k) {
            const float dyg = df[k] * gr[i][k];
            s1 += dyg;
            s2 += dyg * ((xf[k] - m) * r);
          }
        }
      }
    }
    const float xt = tail ? __bfloat162float(xr[c_tail + lane]) : 0.f;
    const float dyt = tail ? __bfloat162float(dyr[c_tail + lane]) : 0.f;
    if (tail) {
      const float dyg = dyt * gt;
      s1 += dyg;
      s2 += dyg * ((xt - m) * r);
    }
    const float m1 = warp_sum(s1) / fd;
    const float m2 = warp_sum(s2) / fd;
    bf16* dxr = dx + row * d;
    for (int ch = 0; ch < chunks; ++ch) {
      const int u0 = lane + 32 * NU * ch;
      if constexpr (kWide) {
        load_units<NU, kAligned>(xv, xr, u0, nu);
        load_units<NU, kAligned>(dv, dyr, u0, nu);
        load_g<NU>(gr, g, u0, nu);
      }
#pragma unroll
      for (int i = 0; i < NU; ++i) {
        const int u = u0 + 32 * i;
        if (u < nu) {
          float xf[kUnit], df[kUnit], o[kUnit];
          unpack(xv[i], xf);
          unpack(dv[i], df);
#pragma unroll
          for (int k = 0; k < kUnit; ++k) {
            const float xh = (xf[k] - m) * r;
            o[k] = (df[k] * gr[i][k] - m1 - xh * m2) * r;
            if constexpr (kWide) {
              // The warp's own columns, k-major (column 8u + k at
              // k·nu + u): a warp's lanes touch consecutive words.
              own[k * nu + u] += df[k] * xh;
              own[d + k * nu + u] += df[k];
            } else {
              dgr[i][k] += df[k] * xh;
              dbr[i][k] += df[k];
            }
          }
          store_unit<kAligned>(dxr + u * kUnit, pack(o));
        }
      }
    }
    if (tail) {
      const float xh = (xt - m) * r;
      dxr[c_tail + lane] = __float2bfloat16_rn((dyt * gt - m1 - xh * m2) * r);
      dgt += dyt * xh;
      dbt += dyt;
    }
  }
  // Fold the block's warps, in warp order, into its partial row.
  if constexpr (!kWide) {
#pragma unroll
    for (int i = 0; i < NU; ++i) {
      const int u = lane + 32 * i;
      if (u < nu) {
#pragma unroll
        for (int k = 0; k < kUnit; ++k) {
          own[u * kUnit + k] = dgr[i][k];
          own[d + u * kUnit + k] = dbr[i][k];
        }
      }
    }
  }
  if (tail) {
    own[c_tail + lane] = dgt;
    own[d + c_tail + lane] = dbt;
  }
  __syncthreads();
  float* out = part + static_cast<size_t>(blockIdx.x) * 2 * d;
  for (int c = threadIdx.x; c < 2 * d; c += blockDim.x) {
    int p = c;  // where column c of dg, then of db, lies in the fold
    if constexpr (kWide) {
      const int cc = c < d ? c : c - d;
      if (cc < c_tail) p = c - cc + (cc % kUnit) * nu + cc / kUnit;
    }
    float t = 0.f;
    for (int v = 0; v < warps; ++v) t += fold[static_cast<size_t>(v) * 2 * d + p];
    out[c] = t;
  }
}

// out[c] = Σ_blk part[blk][c] for the 2·d columns (dg then db): kColTile
// columns a block; warp k sums partial rows k, k + kColGroups, ... in row
// order, and the kColGroups sums meet in warp order.
__global__ void __launch_bounds__(kColTile * kColGroups)
ln_col_sum_groups_kernel(const float* __restrict__ part, int blocks, int d,
                         float* __restrict__ dg, float* __restrict__ db) {
  __shared__ float sums[kColGroups][kColTile + 1];
  const int tx = threadIdx.x % kColTile;
  const int grp = threadIdx.x / kColTile;
  const int c = blockIdx.x * kColTile + tx;
  float t = 0.f;
  if (c < 2 * d) {
#pragma unroll 4
    for (int blk = grp; blk < blocks; blk += kColGroups) {
      t += part[static_cast<size_t>(blk) * 2 * d + c];
    }
  }
  sums[grp][tx] = t;
  __syncthreads();
  if (grp == 0 && c < 2 * d) {
    float s = 0.f;
#pragma unroll
    for (int k = 0; k < kColGroups; ++k) s += sums[k][tx];
    if (c < d) {
      dg[c] = s;
    } else {
      db[c - d] = s;
    }
  }
}

// Units a lane holds at width d in the narrow bf16 backward; 0 beyond
// kMaxUnits (the wide form).
int units_per_lane(int d) {
  const int nu = d / kUnit;
  const int per_lane = nu > 0 ? (nu + 31) / 32 : 1;
  return per_lane <= kMaxUnits ? per_lane : 0;
}

size_t fold_smem(int warps, int d) {
  return static_cast<size_t>(warps) * 2 * d * sizeof(float);
}

// Warps a bf16 backward block at width d: kBwdWarps, fewer where the fold
// would not fit; 0 where one warp's does not.
int bwd_warps(int d) {
  int warps = kBwdWarps;
  while (warps > 1 && fold_smem(warps, d) > static_cast<size_t>(kBwdSmemCap)) {
    warps >>= 1;
  }
  return fold_smem(warps, d) <= static_cast<size_t>(kBwdSmemCap) ? warps : 0;
}

using RowsKernel = void (*)(const bf16*, const float*, const bf16*,
                            const float*, const float*, bf16*, float*,
                            long long, int);

template <int NU, bool kWide>
RowsKernel rows_kernel(bool aligned) {
  return aligned ? ln_bwd_rows_kernel<NU, true, kWide>
                 : ln_bwd_rows_kernel<NU, false, kWide>;
}

// The bf16 backward's row kernel for width d (16-byte aligned rows or
// not), or null.
RowsKernel bwd_bf16_kernel(int d, bool aligned) {
  switch (units_per_lane(d)) {
    case 0: return rows_kernel<kWideUnits, true>(aligned);
    case 1: return rows_kernel<1, false>(aligned);
    case 2: return rows_kernel<2, false>(aligned);
    case 3: return rows_kernel<3, false>(aligned);
    case 4: return rows_kernel<4, false>(aligned);
    case 5: return rows_kernel<5, false>(aligned);
    case 6: return rows_kernel<6, false>(aligned);
    default: return nullptr;
  }
}

bool aligned16(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

cudaError_t launch_bwd_bf16(const void* x, const float* g, const void* dy,
                            const float* mu, const float* rs, void* dx,
                            float* part, float* dg, float* db, long long n,
                            int d, int blocks, cudaStream_t s) {
  const bool aligned = d % kUnit == 0 && aligned16(x) && aligned16(dy) &&
                       aligned16(dx);
  const RowsKernel kernel = bwd_bf16_kernel(d, aligned);
  const int warps = bwd_warps(d);
  if (kernel == nullptr || warps == 0) return cudaErrorInvalidValue;
  const size_t smem = fold_smem(warps, d);
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  kernel<<<blocks, warps * 32, smem, s>>>(
      static_cast<const bf16*>(x), g, static_cast<const bf16*>(dy), mu, rs,
      static_cast<bf16*>(dx), part, n, d);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  ln_col_sum_groups_kernel<<<(2 * d + kColTile - 1) / kColTile,
                             kColTile * kColGroups, 0, s>>>(part, blocks, d,
                                                            dg, db);
  return cudaGetLastError();
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
    err = launch_bwd_bf16(x, gf, dy, muf, rsf, dx, pf, dgf, dbf, n, d,
                          blocks, s);
  } else {
    err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}

// For the record: registers a thread, threads and dynamic shared bytes a
// block of the bf16 backward at width d (16-byte aligned rows when d % 8 is
// 0), and the blocks the current device keeps resident per SM.
extern "C" int rlt_ln_bwd_occupancy(int d, int* regs, int* threads,
                                    int* smem_bytes, int* blocks_per_sm) {
  const RowsKernel kernel = bwd_bf16_kernel(d, d % kUnit == 0);
  const int warps = bwd_warps(d);
  if (kernel == nullptr || warps == 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const size_t smem = fold_smem(warps, d);
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaFuncAttributes attr;
  err = cudaFuncGetAttributes(&attr, kernel);
  if (err != cudaSuccess) return static_cast<int>(err);
  *regs = attr.numRegs;
  *threads = warps * 32;
  *smem_bytes = static_cast<int>(smem);
  return static_cast<int>(cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      blocks_per_sm, kernel, warps * 32, smem));
}
