// Causal flash attention, forward and backward, on (B, S, H, D) tensors.
//
// Replaces ray_lightning_tpu/ops/flash_attention.py::_flash_fwd_bhsd (body
// _fwd_kernel) and ::_flash_bwd_bhsd (body _bwd_kernel), the Pallas kernels
// at every attention site of the GPT training step.  q, k, v, out, dout,
// dq, dk and dv are f32 or bf16 (one dtype); lse (B·H, S) and every sum are
// f32.  Numerics follow the JAX kernels: scores q·kᵀ in f32 with `scale`
// applied to the f32 scores (not folded into q), hidden keys set to -1e30
// (not -inf), the probabilities rounded to v's dtype before the P·V product,
// ds = p·(dp - delta)·scale rounded to q's dtype before the dK and dQ
// products, and lse = m + log(l).
//
// What bounds it: operations.  At GPT-2-small (B·H = 192, S = 1024,
// D = 64) the forward's causal half of Q·Kᵀ and P·V is ~25.8 GFLOP against
// ~100 MB of q, k, v and out, over 250 operations per byte; the backward
// does about 2.5 times the forward's products.
//
// Design.  Tiles are 64 queries by 64 keys.  Two routes, chosen by dtype:
// bf16 runs the products on the tensor cores through WMMA (16x16x16, f32
// accumulation; the TC kernels below); f32 runs them on the CUDA cores in
// f32 (the SIMT kernels), since TF32 would not keep f32's precision.
//   SIMT: a block of 256 threads is a 16 x 16 grid in which thread
//   (ty, tx) owns score rows ty·4 + i and columns tx + 16·j (i, j < 4),
//   and output rows ty·4 + i, columns tx + 16·jj (jj < D/16).  Tiles live
//   in shared memory as f32 with rows padded to D + 1 floats, so the
//   threads of a warp reading one column of a tile hit distinct banks.
//   TC: a block of four warps; warp w owns rows 16w..16w+15 of every
//   score tile, so the softmax needs only warp-level synchronisation.
//   Tiles stay bf16 in shared memory; scores (and the forward's output
//   accumulator, which the online softmax rescales per row) round-trip
//   through f32 shared memory.
// Both routes follow the same plan:
//   Forward: one block per (b·h, query tile), heaviest tiles first.  It
//   walks the key tiles up to the diagonal with the online softmax
//   (running max m and sum l per row, f32), masks only the diagonal
//   tile, and writes out = acc / l and lse.  The TPU kernel keeps K and V
//   of a whole head in VMEM; here a block streams 64-key tiles.
//   Backward: a first kernel computes delta = rowsum(dO·O) (B·H, S) f32.
//   Then one block per (b·h, key tile) walks the query tiles from the
//   diagonal down, recomputing p = exp(s - lse) and dp = dO·Vᵀ, and keeps
//   dK and dV in registers.  dQ cannot ride along as the TPU kernel's
//   per-key-block partial planes without an S/64-fold buffer, so each
//   block adds its dQ contribution into an f32 buffer with atomics (sums in
//   an order that changes from run to run); for bf16 a last kernel rounds
//   that buffer to dq.
// q, k and v are read in place through their strides, so the per-head
// views of a fused (B, S, 3·H·D) projection need no copy; every other
// tensor is contiguous (B, S, H, D).
//
// The kernels allocate nothing and do not synchronise (the backward clears
// its dQ buffer with cudaMemsetAsync).  The C entry points launch on the
// caller's stream and return cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>

#include <cstddef>
#include <type_traits>

namespace {

constexpr int kTile = 64;        // queries and keys per tile
constexpr int kThreads = 256;    // 16 x 16
constexpr int kPS = kTile + 1;   // padded row of a score tile
constexpr float kNegInf = -1e30f;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

// Sum and max over the 16 threads of one row group (lanes tx = 0..15 of
// the same ty share a half-warp).
__device__ __forceinline__ float group_sum(float v) {
  for (int o = 8; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}
__device__ __forceinline__ float group_max(float v) {
  for (int o = 8; o > 0; o >>= 1) {
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  }
  return v;
}

// Strides (in elements) of a (B, S, H, D) tensor whose D axis is
// contiguous.
struct Strides {
  long long b, s, h;
};

// Load rows [row0, row0 + 64) of head (b, h) into a padded f32 tile.
template <int D>
__device__ __forceinline__ void load_tile(float* tile, const float* base,
                                          Strides st, int b, int h,
                                          int row0) {
  const float* p = base + b * st.b + h * st.h;
  for (int idx = threadIdx.x; idx < kTile * D; idx += kThreads) {
    const int r = idx / D;
    const int c = idx % D;
    tile[r * (D + 1) + c] = p[(row0 + r) * st.s + c];
  }
}

template <int D>
constexpr size_t fwd_smem_bytes() {
  return sizeof(float) * (3 * kTile * (D + 1) + kTile * kPS);
}
template <int D>
constexpr size_t bwd_smem_bytes() {
  return sizeof(float) * (4 * kTile * (D + 1) + 2 * kTile * kPS + 2 * kTile);
}

template <int D>
__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(const float* __restrict__ q, const float* __restrict__ k,
                 const float* __restrict__ v, float* __restrict__ out,
                 float* __restrict__ lse, Strides sq, Strides sk, Strides sv,
                 int H, int S, float scale) {
  constexpr int P = D + 1;
  constexpr int JD = D / 16;
  extern __shared__ float smem[];
  float* Qs = smem;
  float* Ks = Qs + kTile * P;
  float* Vs = Ks + kTile * P;
  float* Ps = Vs + kTile * P;

  const int bh = blockIdx.y;
  const int b = bh / H;
  const int h = bh % H;
  const int qt = gridDim.x - 1 - blockIdx.x;  // heaviest tiles first
  const int q0 = qt * kTile;
  const int ty = threadIdx.x >> 4;
  const int tx = threadIdx.x & 15;

  load_tile<D>(Qs, q, sq, b, h, q0);

  float m[4], l[4], acc[4][JD];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int jj = 0; jj < JD; ++jj) acc[i][jj] = 0.f;
  }

  for (int kt = 0; kt <= qt; ++kt) {
    __syncthreads();  // the previous tile's readers are done
    load_tile<D>(Ks, k, sk, b, h, kt * kTile);
    load_tile<D>(Vs, v, sv, b, h, kt * kTile);
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
    }
    for (int c = 0; c < D; ++c) {
      float qv[4], kv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) qv[i] = Qs[(ty * 4 + i) * P + c];
#pragma unroll
      for (int j = 0; j < 4; ++j) kv[j] = Ks[(tx + 16 * j) * P + c];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] += qv[i] * kv[j];
      }
    }
    const bool diag = kt == qt;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float mx = kNegInf;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        s[i][j] *= scale;
        if (diag && tx + 16 * j > ty * 4 + i) s[i][j] = kNegInf;
        mx = fmaxf(mx, s[i][j]);
      }
      const float m_new = fmaxf(m[i], group_max(mx));
      const float corr = expf(m[i] - m_new);
      float psum = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = expf(s[i][j] - m_new);
        psum += p;
        Ps[(ty * 4 + i) * kPS + tx + 16 * j] = p;
      }
      l[i] = l[i] * corr + group_sum(psum);
      m[i] = m_new;
#pragma unroll
      for (int jj = 0; jj < JD; ++jj) acc[i][jj] *= corr;
    }
    __syncthreads();
    for (int c = 0; c < kTile; ++c) {
      float pv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) pv[i] = Ps[(ty * 4 + i) * kPS + c];
#pragma unroll
      for (int jj = 0; jj < JD; ++jj) {
        const float vv = Vs[c * P + tx + 16 * jj];
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[i][jj] += pv[i] * vv;
      }
    }
  }

  // out is contiguous (B, S, H, D).
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + ty * 4 + i;
    float* o = out + ((static_cast<long long>(b) * S + row) * H + h) * D;
#pragma unroll
    for (int jj = 0; jj < JD; ++jj) o[tx + 16 * jj] = acc[i][jj] / l[i];
    if (lse != nullptr && tx == 0) {
      lse[static_cast<long long>(bh) * S + row] = m[i] + logf(l[i]);
    }
  }
}

// delta[bh, s] = Σ_d dO·O in f32; one warp per row.  o and dout are
// contiguous (B, S, H, D).
template <typename T, int D>
__global__ void flash_delta_kernel(const T* __restrict__ out,
                                   const T* __restrict__ dout,
                                   float* __restrict__ delta, int B, int H,
                                   int S) {
  const long long row =
      static_cast<long long>(blockIdx.x) * (blockDim.x >> 5) +
      (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (row >= static_cast<long long>(B) * H * S) return;
  const long long bh = row / S;
  const int s = static_cast<int>(row % S);
  const long long b = bh / H;
  const int h = static_cast<int>(bh % H);
  const long long off = ((b * S + s) * H + h) * D;
  float t = 0.f;
  for (int c = lane; c < D; c += 32) {
    t += to_f32(dout[off + c]) * to_f32(out[off + c]);
  }
  for (int o = 16; o > 0; o >>= 1) t += __shfl_xor_sync(0xffffffffu, t, o);
  if (lane == 0) delta[row] = t;
}

template <int D>
__global__ void __launch_bounds__(kThreads)
flash_bwd_kernel(const float* __restrict__ q, const float* __restrict__ k,
                 const float* __restrict__ v, const float* __restrict__ dout,
                 const float* __restrict__ lse,
                 const float* __restrict__ delta, float* __restrict__ dq_acc,
                 float* __restrict__ dk, float* __restrict__ dv, Strides sq,
                 Strides sk, Strides sv, int H, int S, float scale) {
  constexpr int P = D + 1;
  constexpr int JD = D / 16;
  extern __shared__ float smem[];
  float* Ks = smem;
  float* Vs = Ks + kTile * P;
  float* Qs = Vs + kTile * P;
  float* dOs = Qs + kTile * P;
  float* Ps = dOs + kTile * P;
  float* dSs = Ps + kTile * kPS;
  float* lse_s = dSs + kTile * kPS;
  float* delta_s = lse_s + kTile;

  const int bh = blockIdx.y;
  const int b = bh / H;
  const int h = bh % H;
  const int kt = blockIdx.x;  // key tile 0 walks the most query tiles
  const int k0 = kt * kTile;
  const int n_tiles = S / kTile;
  const int ty = threadIdx.x >> 4;
  const int tx = threadIdx.x & 15;
  const Strides sc = {static_cast<long long>(S) * H * D,
                      static_cast<long long>(H) * D, D};

  load_tile<D>(Ks, k, sk, b, h, k0);
  load_tile<D>(Vs, v, sv, b, h, k0);

  float dk_acc[4][JD], dv_acc[4][JD];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int jj = 0; jj < JD; ++jj) {
      dk_acc[i][jj] = 0.f;
      dv_acc[i][jj] = 0.f;
    }
  }

  for (int qt = kt; qt < n_tiles; ++qt) {
    const int q0 = qt * kTile;
    __syncthreads();  // the previous tile's readers are done
    load_tile<D>(Qs, q, sq, b, h, q0);
    load_tile<D>(dOs, dout, sc, b, h, q0);
    if (threadIdx.x < kTile) {
      lse_s[threadIdx.x] = lse[static_cast<long long>(bh) * S + q0 + threadIdx.x];
      delta_s[threadIdx.x] =
          delta[static_cast<long long>(bh) * S + q0 + threadIdx.x];
    }
    __syncthreads();

    // Score rows are queries ty·4 + i, columns keys tx + 16·j.
    float s[4][4], dp[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        s[i][j] = 0.f;
        dp[i][j] = 0.f;
      }
    }
    for (int c = 0; c < D; ++c) {
      float qv[4], gv[4], kv[4], vv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        qv[i] = Qs[(ty * 4 + i) * P + c];
        gv[i] = dOs[(ty * 4 + i) * P + c];
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        kv[j] = Ks[(tx + 16 * j) * P + c];
        vv[j] = Vs[(tx + 16 * j) * P + c];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          s[i][j] += qv[i] * kv[j];
          dp[i][j] += gv[i] * vv[j];
        }
      }
    }
    const bool diag = qt == kt;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qi = ty * 4 + i;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int kj = tx + 16 * j;
        float sv_ = s[i][j] * scale;
        if (diag && kj > qi) sv_ = kNegInf;
        const float p = expf(sv_ - lse_s[qi]);
        const float ds = p * (dp[i][j] - delta_s[qi]) * scale;
        Ps[qi * kPS + kj] = p;
        dSs[qi * kPS + kj] = ds;
      }
    }
    __syncthreads();

    // dV += Pᵀ·dO and dK += dSᵀ·Q over this tile's queries; rows are keys
    // ty·4 + i, columns tx + 16·jj.
    for (int c = 0; c < kTile; ++c) {
      float pv[4], dsv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        pv[i] = Ps[c * kPS + ty * 4 + i];
        dsv[i] = dSs[c * kPS + ty * 4 + i];
      }
#pragma unroll
      for (int jj = 0; jj < JD; ++jj) {
        const float gv = dOs[c * P + tx + 16 * jj];
        const float qv = Qs[c * P + tx + 16 * jj];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          dv_acc[i][jj] += pv[i] * gv;
          dk_acc[i][jj] += dsv[i] * qv;
        }
      }
    }
    // dQ[q] += dS·K for this key tile; rows are queries ty·4 + i.
    float dq_part[4][JD];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
#pragma unroll
      for (int jj = 0; jj < JD; ++jj) dq_part[i][jj] = 0.f;
    }
    for (int c = 0; c < kTile; ++c) {
      float dsv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) dsv[i] = dSs[(ty * 4 + i) * kPS + c];
#pragma unroll
      for (int jj = 0; jj < JD; ++jj) {
        const float kv = Ks[c * P + tx + 16 * jj];
#pragma unroll
        for (int i = 0; i < 4; ++i) dq_part[i][jj] += dsv[i] * kv;
      }
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float* dst = dq_acc + ((static_cast<long long>(b) * S + q0 + ty * 4 + i) * H + h) * D;
#pragma unroll
      for (int jj = 0; jj < JD; ++jj) atomicAdd(dst + tx + 16 * jj, dq_part[i][jj]);
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const long long off = ((static_cast<long long>(b) * S + k0 + ty * 4 + i) * H + h) * D;
#pragma unroll
    for (int jj = 0; jj < JD; ++jj) {
      dk[off + tx + 16 * jj] = dk_acc[i][jj];
      dv[off + tx + 16 * jj] = dv_acc[i][jj];
    }
  }
}


// ---------------------------------------------------------------------------
// bf16 on the tensor cores (WMMA 16x16x16, f32 accumulation).  The same
// 64 x 64 tiles, a block of four warps; warp w owns score rows
// 16w..16w+15, so the online softmax needs no block-wide barrier.  Tiles
// stay bf16 in shared memory (rows padded by 8 elements, 16-byte vector
// loads); scores and the forward's output accumulator round-trip through
// f32 shared memory, where the per-row softmax arithmetic runs in f32.
// ---------------------------------------------------------------------------

namespace wm = nvcuda::wmma;
using bf16 = __nv_bfloat16;
constexpr int kTcWarps = 4;
constexpr int kTcThreads = 32 * kTcWarps;
constexpr int kLS = kTile + 4;   // f32 score row (WMMA ldm: multiple of 4)
constexpr int kLP = kTile + 8;   // bf16 probability row (multiple of 8)

constexpr size_t tc_align(size_t x) { return (x + 127) / 128 * 128; }

// Row lengths and the byte sizes of the shared arrays, each 128-byte
// aligned (WMMA wants 32-byte aligned fragment pointers).
template <int D>
struct Tc {
  static constexpr int LT = D + 8;  // bf16 tile row
  static constexpr int LO = D + 4;  // f32 output row
  static constexpr size_t tile = tc_align(sizeof(bf16) * kTile * LT);
  static constexpr size_t scores = tc_align(sizeof(float) * kTile * kLS);
  static constexpr size_t probs = tc_align(sizeof(bf16) * kTile * kLP);
  static constexpr size_t outs = tc_align(sizeof(float) * kTile * LO);
  static constexpr size_t rowvec = tc_align(sizeof(float) * kTile);
  static constexpr size_t fwd_bytes = 3 * tile + scores + probs + outs +
                                      rowvec;
  static constexpr size_t bwd_bytes = 4 * tile + 2 * scores + 2 * probs +
                                      outs + 2 * rowvec;
};

using FragA = wm::fragment<wm::matrix_a, 16, 16, 16, bf16, wm::row_major>;
using FragAT = wm::fragment<wm::matrix_a, 16, 16, 16, bf16, wm::col_major>;
using FragB = wm::fragment<wm::matrix_b, 16, 16, 16, bf16, wm::row_major>;
using FragBT = wm::fragment<wm::matrix_b, 16, 16, 16, bf16, wm::col_major>;
using FragC = wm::fragment<wm::accumulator, 16, 16, 16, float>;

// Rows [row0, row0 + 64) of head (b, h), 16 bytes a load (the wrapper
// checks the alignment).
template <int D>
__device__ __forceinline__ void tc_load_tile(bf16* tile, const bf16* base,
                                             Strides st, int b, int h,
                                             int row0) {
  constexpr int kVecs = D / 8;
  const bf16* p = base + b * st.b + h * st.h;
  for (int idx = threadIdx.x; idx < kTile * kVecs; idx += kTcThreads) {
    const int r = idx / kVecs;
    const int c = (idx % kVecs) * 8;
    *reinterpret_cast<uint4*>(tile + r * Tc<D>::LT + c) =
        *reinterpret_cast<const uint4*>(p + (row0 + r) * st.s + c);
  }
}

template <int D>
__global__ void __launch_bounds__(kTcThreads)
tc_flash_fwd_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                    const bf16* __restrict__ v, bf16* __restrict__ out,
                    float* __restrict__ lse, Strides sq, Strides sk,
                    Strides sv, int H, int S, float scale) {
  using L = Tc<D>;
  constexpr int LT = L::LT, LO = L::LO;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  bf16* Qs = reinterpret_cast<bf16*>(smem_raw);
  bf16* Ks = reinterpret_cast<bf16*>(smem_raw + L::tile);
  bf16* Vs = reinterpret_cast<bf16*>(smem_raw + 2 * L::tile);
  float* Ss = reinterpret_cast<float*>(smem_raw + 3 * L::tile);
  bf16* Ps = reinterpret_cast<bf16*>(smem_raw + 3 * L::tile + L::scores);
  float* Os = reinterpret_cast<float*>(smem_raw + 3 * L::tile + L::scores +
                                       L::probs);
  float* Ls = reinterpret_cast<float*>(smem_raw + 3 * L::tile + L::scores +
                                       L::probs + L::outs);

  const int bh = blockIdx.y;
  const int b = bh / H;
  const int h = bh % H;
  const int qt = gridDim.x - 1 - blockIdx.x;  // heaviest tiles first
  const int q0 = qt * kTile;
  const int w = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  // Softmax layout: lanes 2r and 2r+1 share row 16w + r, columns 2i + hf.
  const int row = 16 * w + (lane >> 1);
  const int hf = lane & 1;

  tc_load_tile<D>(Qs, q, sq, b, h, q0);
  for (int c = hf; c < D; c += 2) Os[row * LO + c] = 0.f;
  float m = kNegInf, l = 0.f;

  for (int kt = 0; kt <= qt; ++kt) {
    __syncthreads();  // the previous tile's readers are done
    tc_load_tile<D>(Ks, k, sk, b, h, kt * kTile);
    tc_load_tile<D>(Vs, v, sv, b, h, kt * kTile);
    __syncthreads();

    FragC acc[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) wm::fill_fragment(acc[j], 0.f);
#pragma unroll
    for (int kk = 0; kk < D; kk += 16) {
      FragA a;
      wm::load_matrix_sync(a, Qs + 16 * w * LT + kk, LT);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        FragBT bt;  // Kᵀ: column n of B is key row n
        wm::load_matrix_sync(bt, Ks + 16 * j * LT + kk, LT);
        wm::mma_sync(acc[j], a, bt, acc[j]);
      }
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      wm::store_matrix_sync(Ss + 16 * w * kLS + 16 * j, acc[j], kLS,
                            wm::mem_row_major);
    }
    __syncwarp();

    const bool diag = kt == qt;
    float mx = kNegInf;
    for (int c = hf; c < kTile; c += 2) {
      float s = Ss[row * kLS + c] * scale;
      if (diag && c > row) s = kNegInf;
      Ss[row * kLS + c] = s;
      mx = fmaxf(mx, s);
    }
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
    const float m_new = fmaxf(m, mx);
    const float corr = expf(m - m_new);
    float psum = 0.f;
    for (int c = hf; c < kTile; c += 2) {
      const float p = expf(Ss[row * kLS + c] - m_new);
      psum += p;
      Ps[row * kLP + c] = __float2bfloat16_rn(p);
    }
    psum += __shfl_xor_sync(0xffffffffu, psum, 1);
    l = l * corr + psum;
    m = m_new;
    for (int c = hf; c < D; c += 2) Os[row * LO + c] *= corr;
    __syncwarp();

#pragma unroll
    for (int n0 = 0; n0 < D; n0 += 16) {
      FragC o;
      wm::load_matrix_sync(o, Os + 16 * w * LO + n0, LO, wm::mem_row_major);
#pragma unroll
      for (int kk = 0; kk < kTile; kk += 16) {
        FragA a;
        FragB bv;
        wm::load_matrix_sync(a, Ps + 16 * w * kLP + kk, kLP);
        wm::load_matrix_sync(bv, Vs + kk * LT + n0, LT);
        wm::mma_sync(o, a, bv, o);
      }
      wm::store_matrix_sync(Os + 16 * w * LO + n0, o, LO, wm::mem_row_major);
    }
    __syncwarp();
  }

  if (hf == 0) {
    Ls[row] = l;
    if (lse != nullptr) {
      lse[static_cast<long long>(bh) * S + q0 + row] = m + logf(l);
    }
  }
  __syncwarp();
  // The warp's 16 rows, written row by row (out is contiguous).
  for (int r = 16 * w; r < 16 * w + 16; ++r) {
    bf16* o = out + ((static_cast<long long>(b) * S + q0 + r) * H + h) * D;
    for (int c = lane; c < D; c += 32) {
      o[c] = __float2bfloat16_rn(Os[r * LO + c] / Ls[r]);
    }
  }
}

// One block per (b·h, key tile); warp w owns key rows 16w..16w+15 of the
// transposed scores and of dK, dV (kept as WMMA accumulators), and query
// rows 16w..16w+15 of the tile's dQ contribution.
template <int D>
__global__ void __launch_bounds__(kTcThreads)
tc_flash_bwd_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                    const bf16* __restrict__ v, const bf16* __restrict__ dout,
                    const float* __restrict__ lse,
                    const float* __restrict__ delta,
                    float* __restrict__ dq_acc, bf16* __restrict__ dk,
                    bf16* __restrict__ dv, Strides sq, Strides sk,
                    Strides sv, int H, int S, float scale) {
  using L = Tc<D>;
  constexpr int LT = L::LT, LO = L::LO, JD = D / 16;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  unsigned char* p = smem_raw;
  bf16* Ks = reinterpret_cast<bf16*>(p);
  bf16* Vs = reinterpret_cast<bf16*>(p += L::tile);
  bf16* Qs = reinterpret_cast<bf16*>(p += L::tile);
  bf16* dOs = reinterpret_cast<bf16*>(p += L::tile);
  float* STs = reinterpret_cast<float*>(p += L::tile);
  float* dPTs = reinterpret_cast<float*>(p += L::scores);
  bf16* PTs = reinterpret_cast<bf16*>(p += L::scores);
  bf16* dSTs = reinterpret_cast<bf16*>(p += L::probs);
  float* Xs = reinterpret_cast<float*>(p += L::probs);  // dQ, then dK/dV
  float* lse_s = reinterpret_cast<float*>(p += L::outs);
  float* delta_s = reinterpret_cast<float*>(p += L::rowvec);

  const int bh = blockIdx.y;
  const int b = bh / H;
  const int h = bh % H;
  const int kt = blockIdx.x;  // key tile 0 walks the most query tiles
  const int k0 = kt * kTile;
  const int n_tiles = S / kTile;
  const int w = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int krow = 16 * w + (lane >> 1);  // elementwise: key row
  const int hf = lane & 1;
  const Strides sc = {static_cast<long long>(S) * H * D,
                      static_cast<long long>(H) * D, D};

  tc_load_tile<D>(Ks, k, sk, b, h, k0);
  tc_load_tile<D>(Vs, v, sv, b, h, k0);
  FragC dk_acc[JD], dv_acc[JD];
#pragma unroll
  for (int n = 0; n < JD; ++n) {
    wm::fill_fragment(dk_acc[n], 0.f);
    wm::fill_fragment(dv_acc[n], 0.f);
  }

  for (int qt = kt; qt < n_tiles; ++qt) {
    const int q0 = qt * kTile;
    __syncthreads();  // the previous tile's readers are done
    tc_load_tile<D>(Qs, q, sq, b, h, q0);
    tc_load_tile<D>(dOs, dout, sc, b, h, q0);
    if (threadIdx.x < kTile) {
      lse_s[threadIdx.x] = lse[static_cast<long long>(bh) * S + q0 + threadIdx.x];
      delta_s[threadIdx.x] =
          delta[static_cast<long long>(bh) * S + q0 + threadIdx.x];
    }
    __syncthreads();

    // Sᵀ = K·Qᵀ and dPᵀ = V·dOᵀ for the warp's 16 keys x 64 queries.
    FragC st[4], dpt[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      wm::fill_fragment(st[j], 0.f);
      wm::fill_fragment(dpt[j], 0.f);
    }
#pragma unroll
    for (int kk = 0; kk < D; kk += 16) {
      FragA ak, av;
      wm::load_matrix_sync(ak, Ks + 16 * w * LT + kk, LT);
      wm::load_matrix_sync(av, Vs + 16 * w * LT + kk, LT);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        FragBT bq, bo;
        wm::load_matrix_sync(bq, Qs + 16 * j * LT + kk, LT);
        wm::load_matrix_sync(bo, dOs + 16 * j * LT + kk, LT);
        wm::mma_sync(st[j], ak, bq, st[j]);
        wm::mma_sync(dpt[j], av, bo, dpt[j]);
      }
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      wm::store_matrix_sync(STs + 16 * w * kLS + 16 * j, st[j], kLS,
                            wm::mem_row_major);
      wm::store_matrix_sync(dPTs + 16 * w * kLS + 16 * j, dpt[j], kLS,
                            wm::mem_row_major);
    }
    __syncwarp();

    const bool diag = qt == kt;
    for (int c = hf; c < kTile; c += 2) {  // c: query within the tile
      float s = STs[krow * kLS + c] * scale;
      if (diag && krow > c) s = kNegInf;
      const float pr = expf(s - lse_s[c]);
      const float ds = pr * (dPTs[krow * kLS + c] - delta_s[c]) * scale;
      PTs[krow * kLP + c] = __float2bfloat16_rn(pr);
      dSTs[krow * kLP + c] = __float2bfloat16_rn(ds);
    }
    __syncwarp();

    // dV += Pᵀ·dO and dK += dSᵀ·Q for the warp's keys.
#pragma unroll
    for (int kk = 0; kk < kTile; kk += 16) {
      FragA ap, ads;
      wm::load_matrix_sync(ap, PTs + 16 * w * kLP + kk, kLP);
      wm::load_matrix_sync(ads, dSTs + 16 * w * kLP + kk, kLP);
#pragma unroll
      for (int n = 0; n < JD; ++n) {
        FragB bo, bq;
        wm::load_matrix_sync(bo, dOs + kk * LT + 16 * n, LT);
        wm::load_matrix_sync(bq, Qs + kk * LT + 16 * n, LT);
        wm::mma_sync(dv_acc[n], ap, bo, dv_acc[n]);
        wm::mma_sync(dk_acc[n], ads, bq, dk_acc[n]);
      }
    }
    __syncthreads();  // every warp's rows of dSᵀ are written

    // dQ rows 16w.. of this query tile: dS·K over the tile's 64 keys.
#pragma unroll
    for (int n = 0; n < JD; ++n) {
      FragC dqc;
      wm::fill_fragment(dqc, 0.f);
#pragma unroll
      for (int kk = 0; kk < kTile; kk += 16) {
        FragAT ads;  // dS = (dSᵀ)ᵀ
        FragB bk;
        wm::load_matrix_sync(ads, dSTs + kk * kLP + 16 * w, kLP);
        wm::load_matrix_sync(bk, Ks + kk * LT + 16 * n, LT);
        wm::mma_sync(dqc, ads, bk, dqc);
      }
      wm::store_matrix_sync(Xs + 16 * w * LO + 16 * n, dqc, LO,
                            wm::mem_row_major);
    }
    __syncwarp();
    for (int r = 16 * w; r < 16 * w + 16; ++r) {
      float* dst = dq_acc + ((static_cast<long long>(b) * S + q0 + r) * H + h) * D;
      for (int c = lane; c < D; c += 32) atomicAdd(dst + c, Xs[r * LO + c]);
    }
  }

  // dK, then dV, through the warp's rows of the staging buffer.
#pragma unroll
  for (int pass = 0; pass < 2; ++pass) {
    __syncwarp();
#pragma unroll
    for (int n = 0; n < JD; ++n) {
      wm::store_matrix_sync(Xs + 16 * w * LO + 16 * n,
                            pass == 0 ? dk_acc[n] : dv_acc[n], LO,
                            wm::mem_row_major);
    }
    __syncwarp();
    bf16* dst_base = pass == 0 ? dk : dv;
    for (int r = 16 * w; r < 16 * w + 16; ++r) {
      bf16* dst = dst_base + ((static_cast<long long>(b) * S + k0 + r) * H + h) * D;
      for (int c = lane; c < D; c += 32) {
        dst[c] = __float2bfloat16_rn(Xs[r * LO + c]);
      }
    }
  }
}

__global__ void round_to_bf16_kernel(const float* __restrict__ src,
                                     __nv_bfloat16* __restrict__ dst,
                                     long long n) {
  const long long i = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i < n) dst[i] = __float2bfloat16_rn(src[i]);
}

template <typename T, int D>
cudaError_t fwd(const void* q, const void* k, const void* v, void* out,
                float* lse, Strides sq, Strides sk, Strides sv, int B, int H,
                int S, float scale, cudaStream_t st) {
  const dim3 grid(S / kTile, B * H);
  cudaError_t err;
  if constexpr (std::is_same<T, bf16>::value) {
    constexpr size_t smem = Tc<D>::fwd_bytes;
    err = cudaFuncSetAttribute(tc_flash_fwd_kernel<D>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem));
    if (err != cudaSuccess) return err;
    tc_flash_fwd_kernel<D><<<grid, kTcThreads, smem, st>>>(
        static_cast<const bf16*>(q), static_cast<const bf16*>(k),
        static_cast<const bf16*>(v), static_cast<bf16*>(out), lse, sq, sk,
        sv, H, S, scale);
  } else {
    constexpr size_t smem = fwd_smem_bytes<D>();
    err = cudaFuncSetAttribute(flash_fwd_kernel<D>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem));
    if (err != cudaSuccess) return err;
    flash_fwd_kernel<D><<<grid, kThreads, smem, st>>>(
        static_cast<const float*>(q), static_cast<const float*>(k),
        static_cast<const float*>(v), static_cast<float*>(out), lse, sq, sk,
        sv, H, S, scale);
  }
  return cudaGetLastError();
}

template <typename T, int D>
cudaError_t bwd(const void* q, const void* k, const void* v, const void* out,
                const void* dout, const float* lse, void* dq, void* dk,
                void* dv, float* dq_acc, float* delta, Strides sq,
                Strides sk, Strides sv, int B, int H, int S, float scale,
                cudaStream_t st) {
  const long long rows = static_cast<long long>(B) * H * S;
  const long long n = rows * D;
  cudaError_t err =
      cudaMemsetAsync(dq_acc, 0, static_cast<size_t>(n) * sizeof(float), st);
  if (err != cudaSuccess) return err;
  flash_delta_kernel<T, D><<<static_cast<unsigned>((rows + 7) / 8), 256, 0, st>>>(
      static_cast<const T*>(out), static_cast<const T*>(dout), delta, B, H,
      S);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const dim3 grid(S / kTile, B * H);
  if constexpr (std::is_same<T, bf16>::value) {
    constexpr size_t smem = Tc<D>::bwd_bytes;
    err = cudaFuncSetAttribute(tc_flash_bwd_kernel<D>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem));
    if (err != cudaSuccess) return err;
    tc_flash_bwd_kernel<D><<<grid, kTcThreads, smem, st>>>(
        static_cast<const bf16*>(q), static_cast<const bf16*>(k),
        static_cast<const bf16*>(v), static_cast<const bf16*>(dout), lse,
        delta, dq_acc, static_cast<bf16*>(dk), static_cast<bf16*>(dv), sq,
        sk, sv, H, S, scale);
  } else {
    constexpr size_t smem = bwd_smem_bytes<D>();
    err = cudaFuncSetAttribute(flash_bwd_kernel<D>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem));
    if (err != cudaSuccess) return err;
    flash_bwd_kernel<D><<<grid, kThreads, smem, st>>>(
        static_cast<const float*>(q), static_cast<const float*>(k),
        static_cast<const float*>(v), static_cast<const float*>(dout), lse,
        delta, dq_acc, static_cast<float*>(dk), static_cast<float*>(dv), sq,
        sk, sv, H, S, scale);
  }
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  if (static_cast<void*>(dq_acc) != dq) {
    round_to_bf16_kernel<<<static_cast<unsigned>((n + 255) / 256), 256, 0, st>>>(
        dq_acc, static_cast<__nv_bfloat16*>(dq), n);
    err = cudaGetLastError();
  }
  return err;
}

bool valid_shape(int B, int H, int S, int D) {
  // grid.y is B·H, at most 65535.
  return B >= 1 && H >= 1 && static_cast<long long>(B) * H <= 65535 &&
         S >= kTile && S % kTile == 0 && (D == 64 || D == 128);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  Strides are in elements, D contiguous;
// out is contiguous (B, S, H, D); lse (B·H, S) f32 may be null (no-grad
// call: out only).  S must be a multiple of 64 and D 64 or 128.
extern "C" int rlt_flash_fwd(const void* q, const void* k, const void* v,
                             void* out, void* lse, long long qb, long long qs,
                             long long qh, long long kb, long long ks,
                             long long kh, long long vb, long long vs,
                             long long vh, int B, int H, int S, int D,
                             float scale, int dtype, int device,
                             void* stream) {
  if (!valid_shape(B, H, S, D)) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const Strides sq = {qb, qs, qh}, sk = {kb, ks, kh}, sv = {vb, vs, vh};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* l = static_cast<float*>(lse);
  if (dtype == 0 && D == 64) {
    err = fwd<float, 64>(q, k, v, out, l, sq, sk, sv, B, H, S, scale, st);
  } else if (dtype == 0 && D == 128) {
    err = fwd<float, 128>(q, k, v, out, l, sq, sk, sv, B, H, S, scale, st);
  } else if (dtype == 1 && D == 64) {
    err = fwd<__nv_bfloat16, 64>(q, k, v, out, l, sq, sk, sv, B, H, S, scale,
                                 st);
  } else if (dtype == 1 && D == 128) {
    err = fwd<__nv_bfloat16, 128>(q, k, v, out, l, sq, sk, sv, B, H, S,
                                  scale, st);
  } else {
    err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}

// out, dout, dq, dk, dv contiguous (B, S, H, D); q, k, v through their
// strides.  dq_acc: f32 (B, S, H, D) scratch — for f32 pass dq itself.
// delta: f32 (B·H·S) scratch.
extern "C" int rlt_flash_bwd(const void* q, const void* k, const void* v,
                             const void* out, const void* dout,
                             const void* lse, void* dq, void* dk, void* dv,
                             void* dq_acc, void* delta, long long qb,
                             long long qs, long long qh, long long kb,
                             long long ks, long long kh, long long vb,
                             long long vs, long long vh, int B, int H, int S,
                             int D, float scale, int dtype, int device,
                             void* stream) {
  if (!valid_shape(B, H, S, D) || (dtype == 0 && dq_acc != dq) ||
      (dtype == 1 && dq_acc == dq)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  const Strides sq = {qb, qs, qh}, sk = {kb, ks, kh}, sv = {vb, vs, vh};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* l = static_cast<const float*>(lse);
  float* acc = static_cast<float*>(dq_acc);
  float* dl = static_cast<float*>(delta);
  if (dtype == 0 && D == 64) {
    err = bwd<float, 64>(q, k, v, out, dout, l, dq, dk, dv, acc, dl, sq, sk,
                         sv, B, H, S, scale, st);
  } else if (dtype == 0 && D == 128) {
    err = bwd<float, 128>(q, k, v, out, dout, l, dq, dk, dv, acc, dl, sq, sk,
                          sv, B, H, S, scale, st);
  } else if (dtype == 1 && D == 64) {
    err = bwd<__nv_bfloat16, 64>(q, k, v, out, dout, l, dq, dk, dv, acc, dl,
                                 sq, sk, sv, B, H, S, scale, st);
  } else if (dtype == 1 && D == 128) {
    err = bwd<__nv_bfloat16, 128>(q, k, v, out, dout, l, dq, dk, dv, acc, dl,
                                  sq, sk, sv, B, H, S, scale, st);
  } else {
    err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}
