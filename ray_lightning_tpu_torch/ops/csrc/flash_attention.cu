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
// products, and lse = m + log(l).  The bf16 kernels differ in two f32
// details: exp(x) is 2^(x·log2 e) on the special-function unit, with
// scale·log2 e folded into one FMA (one more rounding of the exponent's
// argument; results below 2^-126 flush to 0), and a hidden key's
// probability is set to 0 outright, which is what exp(-1e30 - m) gives.
//
// What bounds it, at GPT-2-small (B·H = 192, S = 1024, D = 64) in bf16
// (chip_smoke.py::flash_bounds): the forward's least time is 30.3 µs, set
// by its bytes (q, k, v read and out written once, ~100 MB; its causal
// half of Q·Kᵀ and P·V is 25.8 GFLOP, 26 µs at the tensor cores' peak);
// the backward's is 65.2 µs, set by its operations (Q·Kᵀ again, dO·Vᵀ,
// Pᵀ·dO, dSᵀ·Q, dS·K: 64.5 GFLOP).
//
// Design.  Two routes, chosen by dtype.  bf16 (the training path) runs on
// the tensor cores with mma.sync m16n8k16 and keeps every product's result
// in registers: a warp owns 16-row tiles of the scores, turns them into
// probabilities there, and feeds them to the next product as A fragments,
// so nothing but the inputs and dSᵀ goes through shared memory.  Tiles
// arrive by cp.async into rings of stages, so the next tile loads while
// this one is computed.  (The TPU kernel keeps K and V of a whole head in
// VMEM; here they stream as 64-key tiles.)  f32 runs the products on the
// CUDA cores in f32 (the SIMT kernels), since TF32 would not keep f32's
// precision: a block of 256 threads is a 16 x 16 grid in which thread
// (ty, tx) owns score rows ty·4 + i and columns tx + 16·j (i, j < 4), and
// output rows ty·4 + i, columns tx + 16·jj (jj < D/16), with f32 tiles in
// shared memory, rows padded to D + 1 floats.
// Both routes follow the same plan:
//   Forward: one block per (b·h, query tile), heaviest tiles first.  It
//   walks the key tiles up to the diagonal with the online softmax
//   (running max m and sum l per row, f32), masks only the diagonal
//   tiles, and writes out = acc / l and lse.
//   Backward: a first kernel computes delta = rowsum(dO·O) (B·H, S) f32
//   (the bf16 one also clears the dQ buffer).  Then one block per (b·h, key
//   tile) walks the query tiles from the diagonal down, recomputing
//   p = exp(s - lse) and dp = dO·Vᵀ, and keeps dK and dV in registers.  dQ
//   cannot ride along as the TPU kernel's per-key-block partial planes
//   without an S/64-fold buffer, so each block adds its dQ contribution
//   into an f32 buffer with atomics (sums in an order that changes from
//   run to run); for bf16 a last kernel rounds that buffer to dq.
// q, k and v are read in place through their strides, so the per-head
// views of a fused (B, S, 3·H·D) projection need no copy; every other
// tensor is contiguous (B, S, H, D).
//
// The kernels allocate nothing and do not synchronise (the f32 backward
// clears its dQ buffer with cudaMemsetAsync).  The C entry points launch on
// the caller's stream and return cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cmath>
#include <cstddef>
#include <cstdint>
#include <type_traits>

namespace {

constexpr int kTile = 64;        // queries and keys per tile
constexpr int kThreads = 256;    // 16 x 16
constexpr int kPS = kTile + 1;   // padded row of a score tile
constexpr float kNegInf = -1e30f;

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

// Load rows [row0, row0 + ROWS) of head (b, h) into a padded f32 tile.
template <int D, int ROWS = kTile>
__device__ __forceinline__ void load_tile(float* tile, const float* base,
                                          Strides st, int b, int h,
                                          int row0) {
  const float* p = base + b * st.b + h * st.h;
  for (int idx = threadIdx.x; idx < ROWS * D; idx += kThreads) {
    const int r = idx / D;
    const int c = idx % D;
    tile[r * (D + 1) + c] = p[(row0 + r) * st.s + c];
  }
}

template <int D>
constexpr size_t fwd_smem_bytes() {
  return sizeof(float) * (3 * kTile * (D + 1) + kTile * kPS);
}
// The f32 backward's key tile: 64 keys, 32 at D = 256, where four 64-row
// f32 tiles (K, V, Q, dO) would pass the 227 KB a block may hold.
template <int D>
__host__ __device__ constexpr int bwd_keys() {
  return D == 256 ? 32 : kTile;
}
template <int D>
constexpr size_t bwd_smem_bytes() {
  constexpr int KT = bwd_keys<D>();
  return sizeof(float) * (2 * KT * (D + 1) + 2 * kTile * (D + 1) +
                          2 * kTile * (KT + 1) + 2 * kTile);
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

// delta[bh, s] = Σ_d dO·O for the f32 route; one warp per row.  o and
// dout are contiguous (B, S, H, D).
template <int D>
__global__ void flash_delta_kernel(const float* __restrict__ out,
                                   const float* __restrict__ dout,
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
    t += dout[off + c] * out[off + c];
  }
  for (int o = 16; o > 0; o >>= 1) t += __shfl_xor_sync(0xffffffffu, t, o);
  if (lane == 0) delta[row] = t;
}

// One block per (key tile of KT keys, b·h); 64-query tiles.  Score rows
// are queries ty·4 + i, columns keys tx + 16·j (j < KT/16); dK and dV rows
// are keys ty·KR + i (i < KR = KT/16), columns tx + 16·jj.
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
  constexpr int KT = bwd_keys<D>();
  constexpr int KJ = KT / 16;    // score columns a thread owns
  constexpr int KR = KT / 16;    // dK, dV rows a thread owns
  constexpr int SP = KT + 1;     // padded row of a score tile
  extern __shared__ float smem[];
  float* Ks = smem;
  float* Vs = Ks + KT * P;
  float* Qs = Vs + KT * P;
  float* dOs = Qs + kTile * P;
  float* Ps = dOs + kTile * P;
  float* dSs = Ps + kTile * SP;
  float* lse_s = dSs + kTile * SP;
  float* delta_s = lse_s + kTile;

  const int bh = blockIdx.y;
  const int b = bh / H;
  const int h = bh % H;
  const int kt = blockIdx.x;  // key tile 0 walks the most query tiles
  const int k0 = kt * KT;
  const int n_tiles = S / kTile;
  const int ty = threadIdx.x >> 4;
  const int tx = threadIdx.x & 15;
  const Strides sc = {static_cast<long long>(S) * H * D,
                      static_cast<long long>(H) * D, D};

  load_tile<D, KT>(Ks, k, sk, b, h, k0);
  load_tile<D, KT>(Vs, v, sv, b, h, k0);

  float dk_acc[KR][JD], dv_acc[KR][JD];
#pragma unroll
  for (int i = 0; i < KR; ++i) {
#pragma unroll
    for (int jj = 0; jj < JD; ++jj) {
      dk_acc[i][jj] = 0.f;
      dv_acc[i][jj] = 0.f;
    }
  }

  for (int qt = k0 / kTile; qt < n_tiles; ++qt) {
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

    float s[4][KJ], dp[4][KJ];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
#pragma unroll
      for (int j = 0; j < KJ; ++j) {
        s[i][j] = 0.f;
        dp[i][j] = 0.f;
      }
    }
    for (int c = 0; c < D; ++c) {
      float qv[4], gv[4], kv[KJ], vv[KJ];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        qv[i] = Qs[(ty * 4 + i) * P + c];
        gv[i] = dOs[(ty * 4 + i) * P + c];
      }
#pragma unroll
      for (int j = 0; j < KJ; ++j) {
        kv[j] = Ks[(tx + 16 * j) * P + c];
        vv[j] = Vs[(tx + 16 * j) * P + c];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
#pragma unroll
        for (int j = 0; j < KJ; ++j) {
          s[i][j] += qv[i] * kv[j];
          dp[i][j] += gv[i] * vv[j];
        }
      }
    }
    // The tile that holds the diagonal: hide keys after the query.
    const bool diag = q0 < k0 + KT;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qi = ty * 4 + i;
#pragma unroll
      for (int j = 0; j < KJ; ++j) {
        const int kj = tx + 16 * j;
        float sv_ = s[i][j] * scale;
        if (diag && k0 + kj > q0 + qi) sv_ = kNegInf;
        const float p = expf(sv_ - lse_s[qi]);
        const float ds = p * (dp[i][j] - delta_s[qi]) * scale;
        Ps[qi * SP + kj] = p;
        dSs[qi * SP + kj] = ds;
      }
    }
    __syncthreads();

    // dV += Pᵀ·dO and dK += dSᵀ·Q over this tile's queries.
    for (int c = 0; c < kTile; ++c) {
      float pv[KR], dsv[KR];
#pragma unroll
      for (int i = 0; i < KR; ++i) {
        pv[i] = Ps[c * SP + ty * KR + i];
        dsv[i] = dSs[c * SP + ty * KR + i];
      }
#pragma unroll
      for (int jj = 0; jj < JD; ++jj) {
        const float gv = dOs[c * P + tx + 16 * jj];
        const float qv = Qs[c * P + tx + 16 * jj];
#pragma unroll
        for (int i = 0; i < KR; ++i) {
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
    for (int c = 0; c < KT; ++c) {
      float dsv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) dsv[i] = dSs[(ty * 4 + i) * SP + c];
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
  for (int i = 0; i < KR; ++i) {
    const long long off = ((static_cast<long long>(b) * S + k0 + ty * KR + i) * H + h) * D;
#pragma unroll
    for (int jj = 0; jj < JD; ++jj) {
      dk[off + tx + 16 * jj] = dk_acc[i][jj];
      dv[off + tx + 16 * jj] = dv_acc[i][jj];
    }
  }
}


// ---------------------------------------------------------------------------
// bf16 on the tensor cores: mma.sync m16n8k16 (bf16 in, f32 accumulation)
// on register fragments, tiles streamed by cp.async.  Tiles are bf16 in
// shared memory with rows padded by 8 elements (16 bytes), so the eight
// rows an ldmatrix reads fall in distinct banks.  Register fragments
// follow the PTX m16n8k16 layouts: lane = 4·g + t holds C elements (row g,
// cols 2t, 2t+1) and (row g + 8, same cols) of each 16 x 8 tile; the C
// fragments of two neighbouring n8 tiles are the A fragment of one k16
// step, so probabilities go from the scores' registers straight into the
// next product.
// ---------------------------------------------------------------------------

using bf16 = __nv_bfloat16;
constexpr int kFwdRows = 128;  // queries a forward block owns
constexpr int kBwdWarps = 4;
constexpr int kBwdThreads = 32 * kBwdWarps;
constexpr int kLP = kTile + 8;             // dSᵀ row (bf16)
constexpr float kLog2e = 1.4426950408889634f;

// Row length, ring depths and shared bytes of the tiles.
template <int D>
struct Tc {
  static constexpr int LT = D + 8;         // bf16 tile row
  static constexpr int tile = kTile * LT;  // one 64-row tile
  // Forward: m16 tiles a warp owns, warps and blocks per SM.
  static constexpr int fwd_mr = D == 64 ? 2 : 1;
  static constexpr int fwd_threads = 32 * (kFwdRows / 16 / fwd_mr);
  static constexpr int fwd_blocks = D == 64 ? 2 : 1;
  static constexpr int fwd_stages = 2;
  static constexpr int bwd_stages = 2;
  // Backward: warps that share 16 keys, each accumulating dK and dV for
  // D / bwd_split of the columns (two at D = 256, where one warp's would
  // be 256 f32 registers a thread), threads and blocks per SM.
  static constexpr int bwd_split = D == 256 ? 2 : 1;
  static constexpr int bwd_threads = kBwdThreads * bwd_split;
  static constexpr int bwd_blocks = D == 64 ? 3 : D == 128 ? 2 : 1;
  // The split warps' exchange of Sᵀ and dPᵀ partials: 2 x 16 x 16 f32 a
  // warp (a pass covers 16 queries at D >= 128).
  static constexpr int bwd_xfloats =
      bwd_split > 1 ? bwd_threads / 32 * 2 * 16 * 16 : 0;
  // Forward: Q (128 rows), then the stages of K and V.
  static constexpr size_t fwd_bytes =
      sizeof(bf16) * (2 * tile + fwd_stages * 2 * tile);
  // Backward: K, V, the stages of Q and dO, dSᵀ; the stages of lse, delta;
  // the exchange.
  static constexpr size_t bwd_bytes =
      sizeof(bf16) * (2 * tile + bwd_stages * 2 * tile + kTile * kLP) +
      sizeof(float) * (bwd_stages * 2 * kTile + bwd_xfloats);
};
static_assert(Tc<256>::fwd_bytes <= 232448 && Tc<256>::bwd_bytes <= 232448,
              "shared memory of the D = 256 kernels");

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void ldsm_x4(uint32_t r[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p))
      : "memory");
}

__device__ __forceinline__ void ldsm_x4_trans(uint32_t r[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p))
      : "memory");
}

__device__ __forceinline__ void mma_bf16(float c[4], const uint32_t a[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n"
               :
               : "r"(smem_u32(smem)), "l"(gmem)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// 2^x on the special-function unit; results below 2^-126 flush to 0.
__device__ __forceinline__ float fast_exp2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// Two f32 values rounded to nearest bf16, the first in the low half.
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// The C fragments of n8 tiles 2t and 2t + 1 as the bf16 A fragment of k16
// step t.
__device__ __forceinline__ void c_to_a(const float c0[4], const float c1[4],
                                       uint32_t a[4]) {
  a[0] = pack_bf16(c0[0], c0[1]);
  a[1] = pack_bf16(c0[2], c0[3]);
  a[2] = pack_bf16(c1[0], c1[1]);
  a[3] = pack_bf16(c1[2], c1[3]);
}

// The two warps of key group `kw` of a split backward block meet (named
// barrier 1 + kw; barrier 0 is __syncthreads).
__device__ __forceinline__ void pair_sync(int kw) {
  asm volatile("bar.sync %0, 64;\n" ::"r"(1 + kw) : "memory");
}

// Start copying rows [row0, row0 + nrows) of head (b, h) into a padded
// tile, 16 bytes a copy (the wrapper checks the alignment).
template <int D, int kThreadsT>
__device__ __forceinline__ void cp_tile(bf16* tile, const bf16* base,
                                        Strides st, int b, int h, int row0,
                                        int nrows) {
  constexpr int kVecs = D / 8;
  const bf16* p = base + b * st.b + h * st.h;
  for (int idx = threadIdx.x; idx < nrows * kVecs; idx += kThreadsT) {
    const int r = idx / kVecs;
    const int c = (idx % kVecs) * 8;
    cp_async16(tile + r * (D + 8) + c, p + (row0 + r) * st.s + c);
  }
}

// One block per (b·h, 128-query tile), heaviest tiles first; warp w owns
// MR m16 tiles, queries 16·MR·w .. 16·MR·(w + 1) − 1 (a last tile of 64
// queries leaves the upper half of the warps idle).  The warp keeps the
// scores, the probabilities and its MR x 16 x D output accumulator in
// registers for the whole walk over the key tiles, and each K or V
// fragment it loads feeds its MR m16 tiles.  Q, K and V tiles arrive by
// cp.async; K and V stream through a ring of stages, the next tiles
// loading while this one is computed.
template <int D>
__global__ void __launch_bounds__(Tc<D>::fwd_threads, Tc<D>::fwd_blocks)
tc_flash_fwd_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                    const bf16* __restrict__ v, bf16* __restrict__ out,
                    float* __restrict__ lse, Strides sq, Strides sk,
                    Strides sv, int H, int S, float scale) {
  using L = Tc<D>;
  constexpr int LT = L::LT, ND = D / 8, KD = D / 16;
  constexpr int MR = L::fwd_mr, kThreadsT = L::fwd_threads;
  constexpr int kStages = L::fwd_stages;
  constexpr int kStage = 2 * L::tile;  // K, then V
  extern __shared__ __align__(128) unsigned char smem_raw[];
  bf16* Qs = reinterpret_cast<bf16*>(smem_raw);
  bf16* KVs = Qs + 2 * L::tile;

  const int bh = blockIdx.x;
  const int b = bh / H;
  const int h = bh % H;
  // Heaviest tiles first, across all heads: the last wave holds the
  // lightest.
  const int qt = gridDim.y - 1 - blockIdx.y;
  const int q0 = qt * kFwdRows;
  const int nq = min(kFwdRows, S - q0);
  const int n_kt = (q0 + nq) / kTile;
  const int w = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2, tig = lane & 3;
  const int wr = 16 * MR * w;  // the warp's first query in the tile
  const int row0 = q0 + wr;
  const bool active = wr < nq;

  // Start copying key tile t's K and V into stage t % kStages.
  auto issue = [&](int t) {
    bf16* dst = KVs + (t % kStages) * kStage;
    cp_tile<D, kThreadsT>(dst, k, sk, b, h, t * kTile, kTile);
    cp_tile<D, kThreadsT>(dst + L::tile, v, sv, b, h, t * kTile, kTile);
  };
  cp_tile<D, kThreadsT>(Qs, q, sq, b, h, q0, nq);
#pragma unroll
  for (int t = 0; t < kStages - 1; ++t) {  // Q rides in the first group
    if (t < n_kt) issue(t);
    cp_async_commit();
  }

  float o[MR][ND][4];
  // Rows g and g + 8 of each m16 tile: running max (of the scaled scores)
  // and this lane's share of the running sum.
  float m[MR][2], l[MR][2];
#pragma unroll
  for (int mi = 0; mi < MR; ++mi) {
#pragma unroll
    for (int n = 0; n < ND; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) o[mi][n][e] = 0.f;
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      m[mi][r] = kNegInf;
      l[mi][r] = 0.f;
    }
  }
  const float sl2 = scale * kLog2e;
  const bf16* Qw = Qs + (wr + (lane & 15)) * LT + ((lane >> 4) << 3);

  for (int kt = 0; kt < n_kt; ++kt) {
    // This thread's copies of tile kt have landed (later groups may not);
    // after the barrier everyone's have, and tile kt - 1's stage is free.
    cp_async_wait<kStages - 2>();
    __syncthreads();
    if (kt + kStages - 1 < n_kt) issue(kt + kStages - 1);
    cp_async_commit();  // possibly empty: one group per iteration
    const int k0 = kt * kTile;
    // Every key hidden from the warp.  (Tiles are 64-aligned and m16
    // tiles 16-aligned, so a warp that sees the tile sees a key in every
    // row.)
    if (!active || k0 > row0 + 16 * MR - 1) continue;
    const bf16* Ks = KVs + (kt % kStages) * kStage;
    const bf16* Vs = Ks + L::tile;

    // S = Q·Kᵀ: per m16 tile, 16 queries x 64 keys, n8 tile j holding keys
    // 8j..8j+7.
    float s[MR][8][4];
#pragma unroll
    for (int mi = 0; mi < MR; ++mi) {
#pragma unroll
      for (int j = 0; j < 8; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) s[mi][j][e] = 0.f;
      }
    }
#pragma unroll
    for (int kk = 0; kk < KD; ++kk) {
      uint32_t qa[MR][4];
#pragma unroll
      for (int mi = 0; mi < MR; ++mi) {
        ldsm_x4(qa[mi], Qw + 16 * mi * LT + 16 * kk);
      }
#pragma unroll
      for (int jp = 0; jp < 4; ++jp) {
        uint32_t kb[4];
        ldsm_x4(kb, Ks + (16 * jp + (lane & 7) + ((lane >> 4) << 3)) * LT +
                        16 * kk + (((lane >> 3) & 1) << 3));
#pragma unroll
        for (int mi = 0; mi < MR; ++mi) {
          mma_bf16(s[mi][2 * jp], qa[mi], kb[0], kb[1]);
          mma_bf16(s[mi][2 * jp + 1], qa[mi], kb[2], kb[3]);
        }
      }
    }
    if (k0 + kTile - 1 > row0) {  // the diagonal: hide keys after the query
#pragma unroll
      for (int mi = 0; mi < MR; ++mi) {
#pragma unroll
        for (int j = 0; j < 8; ++j) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            if (k0 + 8 * j + 2 * tig + (e & 1) >
                row0 + 16 * mi + g + 8 * (e >> 1)) {
              s[mi][j][e] = -INFINITY;
            }
          }
        }
      }
    }
    // Online softmax.  max(s)·scale is the max of the scaled scores (f32
    // rounding is monotone), and p = exp(s·scale − m) is computed as
    // 2^(s·scale·log2 e − m·log2 e) in one FMA.
#pragma unroll
    for (int mi = 0; mi < MR; ++mi) {
      float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        mx[0] = fmaxf(mx[0], fmaxf(s[mi][j][0], s[mi][j][1]));
        mx[1] = fmaxf(mx[1], fmaxf(s[mi][j][2], s[mi][j][3]));
      }
      float corr[2], neg[2];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
        const float m_new = fmaxf(m[mi][r], mx[r] * scale);
        corr[r] = fast_exp2((m[mi][r] - m_new) * kLog2e);
        neg[r] = -m_new * kLog2e;
        m[mi][r] = m_new;
        l[mi][r] *= corr[r];
      }
#pragma unroll
      for (int j = 0; j < 8; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float p = fast_exp2(fmaf(s[mi][j][e], sl2, neg[e >> 1]));
          l[mi][e >> 1] += p;
          s[mi][j][e] = p;
        }
      }
#pragma unroll
      for (int n = 0; n < ND; ++n) {
        o[mi][n][0] *= corr[0];
        o[mi][n][1] *= corr[0];
        o[mi][n][2] *= corr[1];
        o[mi][n][3] *= corr[1];
      }
    }
    // O += P·V, P rounded to bf16 in registers.
#pragma unroll
    for (int t = 0; t < 4; ++t) {
      uint32_t pa[MR][4];
#pragma unroll
      for (int mi = 0; mi < MR; ++mi) {
        c_to_a(s[mi][2 * t], s[mi][2 * t + 1], pa[mi]);
      }
#pragma unroll
      for (int np = 0; np < D / 16; ++np) {
        uint32_t vb[4];
        ldsm_x4_trans(vb, Vs + (16 * t + (lane & 7) +
                                (((lane >> 3) & 1) << 3)) * LT +
                              16 * np + ((lane >> 4) << 3));
#pragma unroll
        for (int mi = 0; mi < MR; ++mi) {
          mma_bf16(o[mi][2 * np], pa[mi], vb[0], vb[1]);
          mma_bf16(o[mi][2 * np + 1], pa[mi], vb[2], vb[3]);
        }
      }
    }
  }
  if (!active) return;

  // out = O / l, through the warp's own rows of the Q tile, 16 bytes a
  // store (out is contiguous); lse = m + log l.
  bf16* Os = Qs + wr * LT;
#pragma unroll
  for (int mi = 0; mi < MR; ++mi) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      l[mi][r] += __shfl_xor_sync(0xffffffffu, l[mi][r], 1);
      l[mi][r] += __shfl_xor_sync(0xffffffffu, l[mi][r], 2);
    }
    if (lse != nullptr && tig == 0) {
      float* dst = lse + static_cast<long long>(bh) * S + row0 + 16 * mi + g;
      dst[0] = m[mi][0] + logf(l[mi][0]);
      dst[8] = m[mi][1] + logf(l[mi][1]);
    }
    bf16* Om = Os + 16 * mi * LT;
#pragma unroll
    for (int n = 0; n < ND; ++n) {
      *reinterpret_cast<uint32_t*>(Om + g * LT + 8 * n + 2 * tig) =
          pack_bf16(o[mi][n][0] / l[mi][0], o[mi][n][1] / l[mi][0]);
      *reinterpret_cast<uint32_t*>(Om + (g + 8) * LT + 8 * n + 2 * tig) =
          pack_bf16(o[mi][n][2] / l[mi][1], o[mi][n][3] / l[mi][1]);
    }
  }
  __syncwarp();
  for (int idx = lane; idx < 16 * MR * (D / 8); idx += 32) {
    const int r = idx / (D / 8);
    const int c = (idx % (D / 8)) * 8;
    const long long off =
        ((static_cast<long long>(b) * S + row0 + r) * H + h) * D + c;
    *reinterpret_cast<uint4*>(out + off) =
        *reinterpret_cast<const uint4*>(Os + r * LT + c);
  }
}

// One block per (b·h, 64-key tile), key tile 0 (the longest walk) first;
// warp w owns keys 16w..16w+15.  The warp keeps its K and V fragments
// (D = 64; at D >= 128 they are read from shared memory per query tile) and
// its dK, dV accumulators in registers for the whole walk down the query
// tiles from the diagonal; Q, dO, lse and delta tiles stream through a
// ring of cp.async stages.  Sᵀ = K·Qᵀ and dPᵀ = V·dOᵀ land in registers,
// where Pᵀ and dSᵀ are formed and fed to dV += Pᵀ·dO and dK += dSᵀ·Q as A
// fragments, in passes of 32 queries (16 at D >= 128) that keep the
// registers clear of spills.  dSᵀ also goes to shared memory as bf16:
// dQ = dS·K needs it transposed, and each warp then adds 16 queries' dQ
// into the f32 buffer with float4 atomics.
// At D = 256 (bwd_split = 2) two warps share 16 keys, 8 warps a block:
// warp w owns keys 16·(w/2).. and columns 128·(w%2).. of dK, dV and dQ.
// Each computes Sᵀ and dPᵀ over its half of D, the pair adds the two
// partials through shared memory (a + b in one warp, b + a in the other:
// the same f32 sums), and both form the same Pᵀ and dSᵀ.
template <int D>
__global__ void __launch_bounds__(Tc<D>::bwd_threads, Tc<D>::bwd_blocks)
tc_flash_bwd_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                    const bf16* __restrict__ v, const bf16* __restrict__ dout,
                    const float* __restrict__ lse,
                    const float* __restrict__ delta,
                    float* __restrict__ dq_acc, bf16* __restrict__ dk,
                    bf16* __restrict__ dv, Strides sq, Strides sk,
                    Strides sv, int H, int S, float scale) {
  using L = Tc<D>;
  constexpr int LT = L::LT, KD = D / 16;
  constexpr int QW = D == 64 ? 32 : 16;  // queries a register pass covers
  constexpr int NJ = QW / 8;
  constexpr bool kHoldKV = D == 64;
  constexpr int kStages = L::bwd_stages;
  constexpr int kStage = 2 * L::tile;  // Q, then dO
  constexpr int SPL = L::bwd_split, DH = D / SPL;  // a warp's columns
  constexpr int NDH = DH / 8, KDH = DH / 16;
  constexpr int kThreadsT = L::bwd_threads;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  bf16* Ks = reinterpret_cast<bf16*>(smem_raw);
  bf16* Vs = Ks + L::tile;
  bf16* QdO = Vs + L::tile;
  bf16* dSs = QdO + kStages * kStage;  // dSᵀ: [key][query]
  float* stats = reinterpret_cast<float*>(dSs + kTile * kLP);  // lse, delta
  float* xch = stats + kStages * 2 * kTile;  // the pairs' partials

  const int bh = blockIdx.y;
  const int b = bh / H;
  const int h = bh % H;
  const int kt = blockIdx.x;  // key tile 0 walks the most query tiles
  const int k0 = kt * kTile;
  const int n_tiles = S / kTile;
  const int w = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2, tig = lane & 3;
  const int kw = w / SPL;           // the warp's 16 keys: 16·kw ..
  const int c0 = DH * (w % SPL);    // and its first column of D
  const int krow = 16 * kw + g;  // the lane's keys: krow and krow + 8
  const Strides sc = {static_cast<long long>(S) * H * D,
                      static_cast<long long>(H) * D, D};
  const long long srow = static_cast<long long>(bh) * S;

  // Start copying query tile qt's Q, dO, lse and delta into stage
  // (qt - kt) % kStages.
  auto issue = [&](int qt) {
    const int stage = (qt - kt) % kStages;
    bf16* dst = QdO + stage * kStage;
    cp_tile<D, kThreadsT>(dst, q, sq, b, h, qt * kTile, kTile);
    cp_tile<D, kThreadsT>(dst + L::tile, dout, sc, b, h, qt * kTile, kTile);
    if (threadIdx.x < 32) {
      const int part = threadIdx.x >> 4, c = 4 * (threadIdx.x & 15);
      cp_async16(stats + (2 * stage + part) * kTile + c,
                 (part == 0 ? lse : delta) + srow + qt * kTile + c);
    }
  };

  cp_tile<D, kThreadsT>(Ks, k, sk, b, h, k0, kTile);
  cp_tile<D, kThreadsT>(Vs, v, sv, b, h, k0, kTile);
#pragma unroll
  for (int t = 0; t < kStages - 1; ++t) {  // K and V ride in the first group
    if (kt + t < n_tiles) issue(kt + t);
    cp_async_commit();
  }

  float dka[NDH][4], dva[NDH][4];
#pragma unroll
  for (int n = 0; n < NDH; ++n) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      dka[n][e] = 0.f;
      dva[n][e] = 0.f;
    }
  }
  uint32_t kf[KD][4], vf[KD][4];
  const float sl2 = scale * kLog2e;
  const int arow = 16 * kw + (lane & 15);  // A-fragment row of ldmatrix
  const int acol = c0 + ((lane >> 4) << 3);

  for (int qt = kt; qt < n_tiles; ++qt) {
    const int i = qt - kt;
    // This thread's copies of tile qt have landed (later groups may not);
    // after the barrier everyone's have, and tile qt - 1's stage and dSᵀ
    // are free.
    cp_async_wait<kStages - 2>();
    __syncthreads();
    if (qt + kStages - 1 < n_tiles) issue(qt + kStages - 1);
    cp_async_commit();  // possibly empty: one group per iteration
    if constexpr (kHoldKV) {
      if (i == 0) {
#pragma unroll
        for (int kk = 0; kk < KD; ++kk) {
          ldsm_x4(kf[kk], Ks + arow * LT + 16 * kk + acol);
          ldsm_x4(vf[kk], Vs + arow * LT + 16 * kk + acol);
        }
      }
    }
    const bf16* Qs = QdO + (i % kStages) * kStage;
    const bf16* dOs = Qs + L::tile;
    const float* lse_s = stats + 2 * (i % kStages) * kTile;
    const float* delta_s = lse_s + kTile;
    const bool diag = qt == kt;

#pragma unroll 1  // passes one after another: no spills
    for (int hq = 0; hq < kTile / QW; ++hq) {
      // Sᵀ and dPᵀ: the warp's 16 keys x QW queries.
      float st[NJ][4], dpt[NJ][4];
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          st[j][e] = 0.f;
          dpt[j][e] = 0.f;
        }
      }
#pragma unroll
      for (int kk = 0; kk < KDH; ++kk) {
        uint32_t ka[4], va[4];
        if constexpr (kHoldKV) {
#pragma unroll
          for (int x = 0; x < 4; ++x) {
            ka[x] = kf[kk][x];
            va[x] = vf[kk][x];
          }
        } else {
          ldsm_x4(ka, Ks + arow * LT + 16 * kk + acol);
          ldsm_x4(va, Vs + arow * LT + 16 * kk + acol);
        }
#pragma unroll
        for (int jp = 0; jp < QW / 16; ++jp) {
          uint32_t qb[4], ob[4];
          const int r = hq * QW + 16 * jp + (lane & 7) + ((lane >> 4) << 3);
          const int c = c0 + 16 * kk + (((lane >> 3) & 1) << 3);
          ldsm_x4(qb, Qs + r * LT + c);
          ldsm_x4(ob, dOs + r * LT + c);
          mma_bf16(st[2 * jp], ka, qb[0], qb[1]);
          mma_bf16(st[2 * jp + 1], ka, qb[2], qb[3]);
          mma_bf16(dpt[2 * jp], va, ob[0], ob[1]);
          mma_bf16(dpt[2 * jp + 1], va, ob[2], ob[3]);
        }
      }
      if constexpr (SPL > 1) {
        // The pair's partials over the two halves of D, lane by lane:
        // the partner's written, then read before either writes again.
        float* mine = xch + w * (2 * NJ * 4 * 32) + lane;
        const float* theirs = xch + (w ^ 1) * (2 * NJ * 4 * 32) + lane;
        pair_sync(kw);
#pragma unroll
        for (int j = 0; j < NJ; ++j) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            mine[(8 * j + e) * 32] = st[j][e];
            mine[(8 * j + 4 + e) * 32] = dpt[j][e];
          }
        }
        pair_sync(kw);
#pragma unroll
        for (int j = 0; j < NJ; ++j) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            st[j][e] += theirs[(8 * j + e) * 32];
            dpt[j][e] += theirs[(8 * j + 4 + e) * 32];
          }
        }
      }
      // Pᵀ = exp(s·scale − lse) (0 for keys after the query) and
      // dSᵀ = Pᵀ·(dPᵀ − delta)·scale, in place of Sᵀ and dPᵀ.
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int c = hq * QW + 8 * j + 2 * tig + (e & 1);  // query
          float p = fast_exp2(fmaf(st[j][e], sl2, -lse_s[c] * kLog2e));
          if (diag && krow + 8 * (e >> 1) > c) p = 0.f;
          const float ds = p * (dpt[j][e] - delta_s[c]) * scale;
          st[j][e] = p;
          dpt[j][e] = ds;
        }
      }
      if (c0 == 0) {  // one warp of a pair stores the pair's dSᵀ
#pragma unroll
        for (int j = 0; j < NJ; ++j) {
          const int c = hq * QW + 8 * j + 2 * tig;
          *reinterpret_cast<uint32_t*>(dSs + krow * kLP + c) =
              pack_bf16(dpt[j][0], dpt[j][1]);
          *reinterpret_cast<uint32_t*>(dSs + (krow + 8) * kLP + c) =
              pack_bf16(dpt[j][2], dpt[j][3]);
        }
      }
      // dV += Pᵀ·dO and dK += dSᵀ·Q over these queries.
#pragma unroll
      for (int t = 0; t < QW / 16; ++t) {
        uint32_t pa[4], da[4];
        c_to_a(st[2 * t], st[2 * t + 1], pa);
        c_to_a(dpt[2 * t], dpt[2 * t + 1], da);
        const int r = hq * QW + 16 * t + (lane & 7) + (((lane >> 3) & 1) << 3);
#pragma unroll
        for (int np = 0; np < KDH; ++np) {
          uint32_t ob[4], qb[4];
          const int c = c0 + 16 * np + ((lane >> 4) << 3);
          ldsm_x4_trans(ob, dOs + r * LT + c);
          ldsm_x4_trans(qb, Qs + r * LT + c);
          mma_bf16(dva[2 * np], pa, ob[0], ob[1]);
          mma_bf16(dva[2 * np + 1], pa, ob[2], ob[3]);
          mma_bf16(dka[2 * np], da, qb[0], qb[1]);
          mma_bf16(dka[2 * np + 1], da, qb[2], qb[3]);
        }
      }
    }
    __syncthreads();  // every warp's rows of dSᵀ are written

    // dQ of queries 16·kw..16·kw+15 of this tile (the warp's columns):
    // dS·K over the tile's 64 keys, 32 columns at a time, added with float4
    // atomics (each lane swaps half its pairs with its neighbour to hold 4
    // adjacent columns).
    uint32_t dsa[4][4];
#pragma unroll
    for (int t = 0; t < 4; ++t) {
      ldsm_x4_trans(dsa[t], dSs + (16 * t + (lane & 7) + ((lane >> 4) << 3)) *
                                      kLP + 16 * kw +
                                  (((lane >> 3) & 1) << 3));
    }
    const bool odd = tig & 1;
    float* dq_rows =
        dq_acc + ((static_cast<long long>(b) * S + qt * kTile + 16 * kw + g +
                   8 * odd) * H + h) * D + c0 + 4 * (tig >> 1);
#pragma unroll
    for (int nc = 0; nc < DH / 32; ++nc) {
      float dqc[4][4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) dqc[j][e] = 0.f;
      }
#pragma unroll
      for (int t = 0; t < 4; ++t) {
#pragma unroll
        for (int np = 0; np < 2; ++np) {
          uint32_t kb[4];
          ldsm_x4_trans(kb, Ks + (16 * t + (lane & 7) +
                                  (((lane >> 3) & 1) << 3)) * LT +
                                c0 + 32 * nc + 16 * np + ((lane >> 4) << 3));
          mma_bf16(dqc[2 * np], dsa[t], kb[0], kb[1]);
          mma_bf16(dqc[2 * np + 1], dsa[t], kb[2], kb[3]);
        }
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float s0 = odd ? dqc[j][0] : dqc[j][2];
        const float s1 = odd ? dqc[j][1] : dqc[j][3];
        const float r0 = __shfl_xor_sync(0xffffffffu, s0, 1);
        const float r1 = __shfl_xor_sync(0xffffffffu, s1, 1);
        const float4 v4 = odd ? make_float4(r0, r1, dqc[j][2], dqc[j][3])
                              : make_float4(dqc[j][0], dqc[j][1], r0, r1);
        float* dst = dq_rows + 32 * nc + 8 * j;
        atomicAdd(reinterpret_cast<float4*>(dst), v4);
      }
    }
  }

  // dK and dV through stage 0's rows of the warp, 16 bytes a store.
  __syncthreads();
  bf16* Dk = QdO + 16 * kw * LT;
  bf16* Dv = Dk + L::tile;
#pragma unroll
  for (int n = 0; n < NDH; ++n) {
    const int c = c0 + 8 * n + 2 * tig;
    *reinterpret_cast<uint32_t*>(Dk + g * LT + c) =
        pack_bf16(dka[n][0], dka[n][1]);
    *reinterpret_cast<uint32_t*>(Dk + (g + 8) * LT + c) =
        pack_bf16(dka[n][2], dka[n][3]);
    *reinterpret_cast<uint32_t*>(Dv + g * LT + c) =
        pack_bf16(dva[n][0], dva[n][1]);
    *reinterpret_cast<uint32_t*>(Dv + (g + 8) * LT + c) =
        pack_bf16(dva[n][2], dva[n][3]);
  }
  __syncwarp();
  for (int idx = lane; idx < 16 * NDH; idx += 32) {
    const int r = idx / NDH;
    const int c = c0 + (idx % NDH) * 8;
    const long long off =
        ((static_cast<long long>(b) * S + k0 + 16 * kw + r) * H + h) * D + c;
    *reinterpret_cast<uint4*>(dk + off) =
        *reinterpret_cast<const uint4*>(Dk + r * LT + c);
    *reinterpret_cast<uint4*>(dv + off) =
        *reinterpret_cast<const uint4*>(Dv + r * LT + c);
  }
}

// delta = rowsum(dO·O) for the bf16 route, D / 8 threads a row, 16 bytes
// a load; each row's f32 dQ buffer is cleared on the way.  Rows run in
// memory order, (b·S + s)·H + h.
template <int D>
__global__ void tc_delta_kernel(const bf16* __restrict__ out,
                                const bf16* __restrict__ dout,
                                float* __restrict__ delta,
                                float* __restrict__ dq_acc, int H, int S,
                                long long rows) {
  constexpr int kPer = D / 8;
  const long long gid =
      static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  const long long row = gid / kPer;
  const int part = static_cast<int>(gid % kPer);
  if (row >= rows) return;  // whole warps: rows·kPer is a multiple of 32
  const long long off = row * D + 8 * part;
  const uint4 a = *reinterpret_cast<const uint4*>(out + off);
  const uint4 c = *reinterpret_cast<const uint4*>(dout + off);
  const uint32_t aw[4] = {a.x, a.y, a.z, a.w}, cw[4] = {c.x, c.y, c.z, c.w};
  float t = 0.f;
#pragma unroll
  for (int x = 0; x < 4; ++x) {
    const float2 af = __bfloat1622float2(
        *reinterpret_cast<const __nv_bfloat162*>(&aw[x]));
    const float2 cf = __bfloat1622float2(
        *reinterpret_cast<const __nv_bfloat162*>(&cw[x]));
    t += cf.x * af.x + cf.y * af.y;
  }
#pragma unroll
  for (int o = kPer / 2; o > 0; o >>= 1) {
    t += __shfl_xor_sync(0xffffffffu, t, o);
  }
  float4* z = reinterpret_cast<float4*>(dq_acc + off);
  z[0] = make_float4(0.f, 0.f, 0.f, 0.f);
  z[1] = make_float4(0.f, 0.f, 0.f, 0.f);
  if (part == 0) {
    const long long bs = row / H;
    const long long bhrow = (bs / S * H + row % H) * S + bs % S;
    delta[bhrow] = t;
  }
}

// dq = the f32 buffer rounded to bf16, 8 values a thread.
__global__ void round_to_bf16_kernel(const float* __restrict__ src,
                                     bf16* __restrict__ dst, long long n8) {
  const long long i =
      static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (i >= n8) return;
  const float4 a = reinterpret_cast<const float4*>(src)[2 * i];
  const float4 b = reinterpret_cast<const float4*>(src)[2 * i + 1];
  reinterpret_cast<uint4*>(dst)[i] =
      make_uint4(pack_bf16(a.x, a.y), pack_bf16(a.z, a.w),
                 pack_bf16(b.x, b.y), pack_bf16(b.z, b.w));
}

template <typename T, int D>
cudaError_t fwd(const void* q, const void* k, const void* v, void* out,
                float* lse, Strides sq, Strides sk, Strides sv, int B, int H,
                int S, float scale, cudaStream_t st) {
  cudaError_t err;
  if constexpr (std::is_same<T, bf16>::value) {
    constexpr size_t smem = Tc<D>::fwd_bytes;
    err = cudaFuncSetAttribute(tc_flash_fwd_kernel<D>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem));
    if (err != cudaSuccess) return err;
    const dim3 grid(B * H, (S + kFwdRows - 1) / kFwdRows);
    tc_flash_fwd_kernel<D><<<grid, Tc<D>::fwd_threads, smem, st>>>(
        static_cast<const bf16*>(q), static_cast<const bf16*>(k),
        static_cast<const bf16*>(v), static_cast<bf16*>(out), lse, sq, sk,
        sv, H, S, scale);
  } else {
    const dim3 grid(S / kTile, B * H);
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
  cudaError_t err;
  if constexpr (std::is_same<T, bf16>::value) {
    const long long threads = rows * (D / 8);
    tc_delta_kernel<D><<<static_cast<unsigned>((threads + 255) / 256), 256, 0,
                         st>>>(static_cast<const bf16*>(out),
                               static_cast<const bf16*>(dout), delta, dq_acc,
                               H, S, rows);
  } else {
    err = cudaMemsetAsync(dq_acc, 0, static_cast<size_t>(n) * sizeof(float),
                          st);
    if (err != cudaSuccess) return err;
    flash_delta_kernel<D><<<static_cast<unsigned>((rows + 7) / 8), 256, 0,
                            st>>>(static_cast<const float*>(out),
                                  static_cast<const float*>(dout), delta, B,
                                  H, S);
  }
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  if constexpr (std::is_same<T, bf16>::value) {
    const dim3 grid(S / kTile, B * H);
    constexpr size_t smem = Tc<D>::bwd_bytes;
    err = cudaFuncSetAttribute(tc_flash_bwd_kernel<D>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem));
    if (err != cudaSuccess) return err;
    tc_flash_bwd_kernel<D><<<grid, Tc<D>::bwd_threads, smem, st>>>(
        static_cast<const bf16*>(q), static_cast<const bf16*>(k),
        static_cast<const bf16*>(v), static_cast<const bf16*>(dout), lse,
        delta, dq_acc, static_cast<bf16*>(dk), static_cast<bf16*>(dv), sq,
        sk, sv, H, S, scale);
  } else {
    const dim3 grid(S / bwd_keys<D>(), B * H);
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
    round_to_bf16_kernel<<<static_cast<unsigned>((n / 8 + 255) / 256), 256,
                           0, st>>>(dq_acc, static_cast<bf16*>(dq), n / 8);
    err = cudaGetLastError();
  }
  return err;
}

template <typename Kernel>
cudaError_t occupancy(Kernel kernel, int threads, size_t smem, int* regs,
                      int* blocks) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  cudaFuncAttributes attr;
  err = cudaFuncGetAttributes(&attr, kernel);
  if (err != cudaSuccess) return err;
  *regs = attr.numRegs;
  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks, kernel,
                                                       threads, smem);
}

// For the record: registers a thread, threads and dynamic shared bytes a
// block, and blocks resident per SM of a bf16 kernel (which: 0 forward,
// 1 backward; D 64, 128 or 256) on the current device.
template <int D>
cudaError_t tc_occupancy(int which, int* regs, int* threads, int* smem_bytes,
                         int* blocks_per_sm) {
  using L = Tc<D>;
  *threads = which == 0 ? L::fwd_threads : L::bwd_threads;
  *smem_bytes = static_cast<int>(which == 0 ? L::fwd_bytes : L::bwd_bytes);
  return which == 0 ? occupancy(tc_flash_fwd_kernel<D>, *threads,
                                *smem_bytes, regs, blocks_per_sm)
                    : occupancy(tc_flash_bwd_kernel<D>, *threads,
                                *smem_bytes, regs, blocks_per_sm);
}

bool valid_shape(int B, int H, int S, int D) {
  // grid.y is B·H, at most 65535.
  return B >= 1 && H >= 1 && static_cast<long long>(B) * H <= 65535 &&
         S >= kTile && S % kTile == 0 && (D == 64 || D == 128 || D == 256);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  Strides are in elements, D contiguous;
// out is contiguous (B, S, H, D); lse (B·H, S) f32 may be null (no-grad
// call: out only).  S must be a multiple of 64 and D 64, 128 or 256.
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
  } else if (dtype == 0 && D == 256) {
    err = fwd<float, 256>(q, k, v, out, l, sq, sk, sv, B, H, S, scale, st);
  } else if (dtype == 1 && D == 256) {
    err = fwd<__nv_bfloat16, 256>(q, k, v, out, l, sq, sk, sv, B, H, S,
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
  } else if (dtype == 0 && D == 256) {
    err = bwd<float, 256>(q, k, v, out, dout, l, dq, dk, dv, acc, dl, sq, sk,
                          sv, B, H, S, scale, st);
  } else if (dtype == 1 && D == 256) {
    err = bwd<__nv_bfloat16, 256>(q, k, v, out, dout, l, dq, dk, dv, acc, dl,
                                  sq, sk, sv, B, H, S, scale, st);
  } else {
    err = cudaErrorInvalidValue;
  }
  return static_cast<int>(err);
}

extern "C" int rlt_flash_tc_occupancy(int which, int D, int* regs,
                                      int* threads, int* smem_bytes,
                                      int* blocks_per_sm) {
  if (which != 0 && which != 1) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaErrorInvalidValue;
  if (D == 64) {
    err = tc_occupancy<64>(which, regs, threads, smem_bytes, blocks_per_sm);
  } else if (D == 128) {
    err = tc_occupancy<128>(which, regs, threads, smem_bytes, blocks_per_sm);
  } else if (D == 256) {
    err = tc_occupancy<256>(which, regs, threads, smem_bytes, blocks_per_sm);
  }
  return static_cast<int>(err);
}
