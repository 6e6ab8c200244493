// Fused tied-LM-head cross-entropy: forward, dx and dW.
//
// Replaces the three Pallas kernels of ray_lightning_tpu/ops/cross_entropy.py
// that the GPT training step runs on one chip:
//   rlt_ce_fwd    <- _ce_fwd_pallas     (pallas_call :248, body _ce_fwd_kernel :107)
//   rlt_ce_bwd_dx <- _ce_bwd_pallas     (pallas_call :424, body _ce_bwd_dx_kernel :336)
//   rlt_ce_bwd_dw <- _ce_bwd_pallas     (pallas_call :441, body _ce_bwd_dw_kernel :364)
// x (N, d) and w (V, d) are f32 or bf16 (one dtype, the compute dtype); the
// targets are int32; lse, g, loss, dx and dW are f32.  Numerics follow the
// JAX kernels: logits = x·wᵀ with f32 accumulation, vocab columns >= V
// masked out (the JAX kernel sets them to -1e30, whose exp adds exactly 0),
// loss = lse - gold with lse = m + log(s) over the online max m and sum s;
// dlogits = (exp(logits - lse) - onehot)·g rounded to the compute dtype
// before both products dx = dlogits·w and dW = dlogitsᵀ·x.  Token rows >= N
// and vocab rows >= V contribute nothing; nothing is padded in memory (the
// tile loads fill the ragged edge with zeros).
//
// What bounds it: operations.  At GPT-2-small (N = 16384 tokens, V = 50304,
// d = 768) one x·wᵀ is 2·N·V·d = 1.27 TFLOP against ~0.1 GB of x, w and the
// per-token vectors: the forward's bound is 1.28 ms at 989 TF/s (bf16), dx's
// and dW's 2.56 ms each (the logits recomputed, then the product).
//
// Design.  Blocks of 256 threads (8 warps, 2 along the tile's rows x 4 along
// its columns) compute 64 x 128 logits tiles, streaming d in chunks through
// shared memory (the next chunk is fetched into registers while the current
// one is multiplied).  bf16 runs the products on the tensor cores with
// mma.sync m16n8k16 (bf16 in, f32 accumulators in registers, fragments
// loaded with ldmatrix); f32 runs them on the CUDA cores in f32 (TF32 would
// not keep f32's precision).  Every output element has exactly one writer
// and every sum a fixed order: no atomics, deterministic results.
//   Forward: a block owns 64 tokens and walks all vocab tiles.  Each thread
//   keeps an online (max, sum-exp, gold) for each accumulator slot it owns,
//   over the columns it sees; at the end the 32 slots of each row are
//   combined in shared memory in a fixed order.  No logits reach memory.
//   dx: a block owns 64 tokens and a 256-wide slice of d, and walks all
//   vocab tiles: logits tile -> dlogits (rounded, to shared memory) ->
//   dx_slice += dlogits·w_tile[:, slice] with the 64 x 256 f32 accumulator
//   in registers (64 floats a thread).  A (64, d) f32 accumulator does not
//   fit (192 KiB at d = 768, 384 KiB at d = 1536); the split of d costs one
//   extra logits product per slice: ceil(d/256) products plus the dx product,
//   4 x 1.27 TFLOP at d = 768 instead of 2.
//   dW: the same kernel with the roles swapped: a block owns 64 vocab rows
//   and a slice of d and walks all token tiles, dW_slice += dlogitsᵀ·x.
// The TPU kernels carry their sums across a sequential grid in VMEM; here a
// loop inside each block takes the grid's sequential dimension.
//
// The kernels allocate nothing and do not synchronise.  The C entry points
// launch on the caller's stream and return cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>
#include <type_traits>

namespace {

using bf16 = __nv_bfloat16;

constexpr int kThreads = 256;  // 8 warps: 2 along rows x 4 along columns
constexpr int kBM = 64;        // rows of a block's tile
constexpr int kBN = 128;       // columns of one logits tile
constexpr int kDS = 256;       // columns of d one dx / dW block owns
constexpr int kSlots = 32;     // accumulator slots sharing one row
constexpr float kNegInf = -1e30f;

// d per staged chunk: 128 bytes of a row.  Rows are padded so that the
// eight rows an ldmatrix phase reads (bf16) or the rows a warp reads at one
// k (f32) fall on distinct banks.
template <typename T>
struct Cfg;
template <>
struct Cfg<bf16> {
  static constexpr int KC = 64;
  static constexpr int PAD = 8;
};
template <>
struct Cfg<float> {
  static constexpr int KC = 32;
  static constexpr int PAD = 1;
};

template <typename T>
__host__ __device__ constexpr int stage_ld() { return Cfg<T>::KC + Cfg<T>::PAD; }
template <typename T>
__host__ __device__ constexpr int stage_bytes() {
  return (kBM + kBN) * stage_ld<T>() * static_cast<int>(sizeof(T));
}
template <typename T>
__host__ __device__ constexpr int cs_ld() { return kDS + Cfg<T>::PAD; }
template <typename T>
__host__ __device__ constexpr int ds_ld() { return kBN + Cfg<T>::PAD; }
__host__ __device__ constexpr int cmax(int a, int b) { return a > b ? a : b; }

template <typename T>
__host__ __device__ constexpr int fwd_smem_bytes() {
  return cmax(stage_bytes<T>(), kBM * kSlots * 3 * 4);
}
template <typename T>
__host__ __device__ constexpr int grad_region0() {
  return cmax(stage_bytes<T>(), kBN * cs_ld<T>() * static_cast<int>(sizeof(T)));
}
template <typename T>
__host__ __device__ constexpr int grad_ds_bytes() {
  return kBM * ds_ld<T>() * static_cast<int>(sizeof(T));
}
template <typename T>
__host__ __device__ constexpr int grad_smem_bytes() {
  return grad_region0<T>() + grad_ds_bytes<T>() + 3 * kBN * 4;
}

// ---------------------------------------------------------------------------
// Accumulator layouts.  A warp's tile is (2·16) rows x (NJ·8) columns held as
// acc[i][j][e]: bf16 in the m16n8k16 C fragment order, f32 in a 4 x 8 lane
// grid.  row/col give an element's place in the warp's tile; slot gives
// which of the 8 slots (per warp) sharing its row it is.
// ---------------------------------------------------------------------------

template <typename T>
struct Layout;
template <>
struct Layout<bf16> {
  __device__ static int row(int i, int e, int lane) {
    return i * 16 + (lane >> 2) + ((e >> 1) << 3);
  }
  __device__ static int col(int j, int e, int lane) {
    return j * 8 + ((lane & 3) << 1) + (e & 1);
  }
  __device__ static int slot(int e, int lane) {
    return ((lane & 3) << 1) + (e & 1);
  }
};
template <>
struct Layout<float> {
  __device__ static int row(int i, int e, int lane) {
    return i * 16 + (lane >> 3) * 4 + e;
  }
  __device__ static int col(int j, int, int lane) { return j * 8 + (lane & 7); }
  __device__ static int slot(int, int lane) { return lane & 7; }
};

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

// The compute dtype's rounding of a dlogit (JAX: dlog.astype(x.dtype)).
__device__ __forceinline__ bf16 round_dlogit(float v, bf16*) {
  return __float2bfloat16_rn(v);
}
__device__ __forceinline__ float round_dlogit(float v, float*) { return v; }

// Store one 16-byte vector (8 bf16 or 4 f32) at smem row `dst`.
template <typename T>
__device__ __forceinline__ void store_vec(T* dst, uint4 v) {
  if constexpr (std::is_same<T, bf16>::value) {
    *reinterpret_cast<uint4*>(dst) = v;
  } else {
    dst[0] = __uint_as_float(v.x);
    dst[1] = __uint_as_float(v.y);
    dst[2] = __uint_as_float(v.z);
    dst[3] = __uint_as_float(v.w);
  }
}

// ---------------------------------------------------------------------------
// The logits tile: acc (this warp's 32 x 32 part of a 64 x 128 tile) =
// A[a0 : a0+64] · B[b0 : b0+128]ᵀ over K = d.  Rows past na / nb read as
// zeros.  Ends with __syncthreads(), so the caller may reuse the stage.
// ---------------------------------------------------------------------------

constexpr int kVecsPerRow = 8;  // 128-byte chunk rows = 8 x 16 bytes
constexpr int kFetch = (kBM + kBN) * kVecsPerRow / kThreads;  // 6

template <typename T>
__device__ __forceinline__ void fetch_chunk(uint4 reg[kFetch], const T* A,
                                            int a0, int na, const T* B,
                                            int b0, int nb, int d, int k0) {
  constexpr int VE = 16 / sizeof(T);
#pragma unroll
  for (int f = 0; f < kFetch; ++f) {
    const int v = threadIdx.x + f * kThreads;
    const int row = v / kVecsPerRow;
    const int cv = v % kVecsPerRow;
    const bool is_a = row < kBM;
    const int grow = is_a ? a0 + row : b0 + row - kBM;
    const bool ok = grow < (is_a ? na : nb);
    const T* src = (is_a ? A : B) + static_cast<long long>(grow) * d + k0 +
                   cv * VE;
    reg[f] = ok ? *reinterpret_cast<const uint4*>(src) : make_uint4(0, 0, 0, 0);
  }
}

template <typename T>
__device__ __forceinline__ void store_chunk(T* St, const uint4 reg[kFetch]) {
  constexpr int VE = 16 / sizeof(T);
#pragma unroll
  for (int f = 0; f < kFetch; ++f) {
    const int v = threadIdx.x + f * kThreads;
    store_vec<T>(St + (v / kVecsPerRow) * stage_ld<T>() +
                     (v % kVecsPerRow) * VE,
                 reg[f]);
  }
}

__device__ __forceinline__ void mma_chunk(float acc[2][4][4], const bf16* St,
                                          int wm, int wn, int lane) {
  constexpr int LD = stage_ld<bf16>();
#pragma unroll
  for (int kk = 0; kk < Cfg<bf16>::KC; kk += 16) {
    uint32_t a[2][4], b[4][2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      ldsm_x4(a[i], St + (wm * 32 + i * 16 + (lane & 15)) * LD + kk +
                        (lane >> 4) * 8);
    }
#pragma unroll
    for (int jj = 0; jj < 2; ++jj) {
      uint32_t r[4];
      ldsm_x4(r, St + (kBM + wn * 32 + jj * 16 + (lane & 7) +
                       ((lane >> 4) << 3)) * LD +
                     kk + ((lane >> 3) & 1) * 8);
      b[2 * jj][0] = r[0];
      b[2 * jj][1] = r[1];
      b[2 * jj + 1][0] = r[2];
      b[2 * jj + 1][1] = r[3];
    }
#pragma unroll
    for (int i = 0; i < 2; ++i) {
#pragma unroll
      for (int j = 0; j < 4; ++j) mma_bf16(acc[i][j], a[i], b[j][0], b[j][1]);
    }
  }
}

__device__ __forceinline__ void mma_chunk(float acc[2][4][4], const float* St,
                                          int wm, int wn, int lane) {
  constexpr int LD = stage_ld<float>();
  const int ly = lane >> 3;
  const int lx = lane & 7;
#pragma unroll 4
  for (int kk = 0; kk < Cfg<float>::KC; ++kk) {
    float a[2][4], b[4];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        a[i][e] = St[(wm * 32 + i * 16 + ly * 4 + e) * LD + kk];
      }
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      b[j] = St[(kBM + wn * 32 + j * 8 + lx) * LD + kk];
    }
#pragma unroll
    for (int i = 0; i < 2; ++i) {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          acc[i][j][e] = fmaf(a[i][e], b[j], acc[i][j][e]);
        }
      }
    }
  }
}

template <typename T>
__device__ void logits_tile(float acc[2][4][4], const T* A, int a0, int na,
                            const T* B, int b0, int nb, int d, T* St) {
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int wm = warp >> 2;
  const int wn = warp & 3;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;
    }
  }
  constexpr int KC = Cfg<T>::KC;
  uint4 reg[kFetch];
  fetch_chunk<T>(reg, A, a0, na, B, b0, nb, d, 0);
  store_chunk<T>(St, reg);
  __syncthreads();
  for (int k0 = 0; k0 < d; k0 += KC) {
    const bool more = k0 + KC < d;
    if (more) fetch_chunk<T>(reg, A, a0, na, B, b0, nb, d, k0 + KC);
    mma_chunk(acc, St, wm, wn, lane);
    __syncthreads();
    if (more) {
      store_chunk<T>(St, reg);
      __syncthreads();
    }
  }
}

// ---------------------------------------------------------------------------
// Forward: loss and lse of 64 tokens over the whole vocabulary.
// ---------------------------------------------------------------------------

template <typename T>
__global__ void __launch_bounds__(kThreads)
ce_fwd_kernel(const T* __restrict__ x, const T* __restrict__ w,
              const int* __restrict__ targets, float* __restrict__ loss,
              float* __restrict__ lse, int N, int V, int d) {
  extern __shared__ __align__(16) unsigned char smem[];
  T* St = reinterpret_cast<T*>(smem);
  using L = Layout<T>;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int wm = warp >> 2;
  const int wn = warp & 3;
  const int r0 = blockIdx.x * kBM;

  // One online (max, sum-exp, gold) per accumulator slot.
  float m[2][4], s[2][4], gold[2][4];
  int tgt[2][4];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int r = r0 + wm * 32 + L::row(i, e, lane);
      tgt[i][e] = r < N ? targets[r] : -1;
      m[i][e] = kNegInf;
      s[i][e] = 0.f;
      gold[i][e] = 0.f;
    }
  }

  for (int v0 = 0; v0 < V; v0 += kBN) {
    float acc[2][4][4];
    logits_tile<T>(acc, x, r0, N, w, v0, V, d, St);
#pragma unroll
    for (int i = 0; i < 2; ++i) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float mt = m[i][e];
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int vocab_col = v0 + wn * 32 + L::col(j, e, lane);
          if (vocab_col < V) mt = fmaxf(mt, acc[i][j][e]);
        }
        float sum = s[i][e] * __expf(m[i][e] - mt);
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int vocab_col = v0 + wn * 32 + L::col(j, e, lane);
          const bool in_vocab = vocab_col < V;
          if (in_vocab) sum += __expf(acc[i][j][e] - mt);
          if (vocab_col == tgt[i][e]) gold[i][e] += acc[i][j][e];
        }
        m[i][e] = mt;
        s[i][e] = sum;
      }
    }
  }

  // Combine the 32 slots of each row (the stage is free: logits_tile ended
  // with a barrier).
  float* comb = reinterpret_cast<float*>(smem);
#pragma unroll
  for (int i = 0; i < 2; ++i) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int row = wm * 32 + L::row(i, e, lane);
      float* c = comb + (row * kSlots + wn * 8 + L::slot(e, lane)) * 3;
      c[0] = m[i][e];
      c[1] = s[i][e];
      c[2] = gold[i][e];
    }
  }
  __syncthreads();
  const int row = threadIdx.x;
  if (row < kBM && r0 + row < N) {
    const float* c = comb + row * kSlots * 3;
    float mx = kNegInf;
    for (int k = 0; k < kSlots; ++k) mx = fmaxf(mx, c[3 * k]);
    float sum = 0.f, g = 0.f;
    for (int k = 0; k < kSlots; ++k) {
      sum += c[3 * k + 1] * __expf(c[3 * k] - mx);
      g += c[3 * k + 2];
    }
    const float l = mx + logf(sum);
    lse[r0 + row] = l;
    loss[r0 + row] = l - g;
  }
}

// ---------------------------------------------------------------------------
// Backward: dx (kDW false) or dW (kDW true) for 64 rows and one slice of d.
//   dx: rows = tokens (x), columns = vocab rows (w), out = dx (N, d).
//   dW: rows = vocab rows (w), columns = tokens (x), out = dW (V, d).
// ---------------------------------------------------------------------------

__device__ __forceinline__ void mma_slice(float acc[2][8][4], const bf16* Ds,
                                          const bf16* Cs, int wm, int wn,
                                          int lane) {
  constexpr int LDD = ds_ld<bf16>();
  constexpr int LDC = cs_ld<bf16>();
#pragma unroll
  for (int kk = 0; kk < kBN; kk += 16) {
    uint32_t a[2][4];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      ldsm_x4(a[i], Ds + (wm * 32 + i * 16 + (lane & 15)) * LDD + kk +
                        (lane >> 4) * 8);
    }
#pragma unroll
    for (int jj = 0; jj < 4; ++jj) {
      uint32_t r[4];
      ldsm_x4_trans(r, Cs + (kk + (lane & 15)) * LDC + wn * 64 + jj * 16 +
                           (lane >> 4) * 8);
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        mma_bf16(acc[i][2 * jj], a[i], r[0], r[1]);
        mma_bf16(acc[i][2 * jj + 1], a[i], r[2], r[3]);
      }
    }
  }
}

__device__ __forceinline__ void mma_slice(float acc[2][8][4], const float* Ds,
                                          const float* Cs, int wm, int wn,
                                          int lane) {
  constexpr int LDD = ds_ld<float>();
  constexpr int LDC = cs_ld<float>();
  const int ly = lane >> 3;
  const int lx = lane & 7;
#pragma unroll 4
  for (int kk = 0; kk < kBN; ++kk) {
    float a[2][4], b[8];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        a[i][e] = Ds[(wm * 32 + i * 16 + ly * 4 + e) * LDD + kk];
      }
    }
#pragma unroll
    for (int j = 0; j < 8; ++j) b[j] = Cs[kk * LDC + wn * 64 + j * 8 + lx];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
#pragma unroll
      for (int j = 0; j < 8; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          acc[i][j][e] = fmaf(a[i][e], b[j], acc[i][j][e]);
        }
      }
    }
  }
}

template <typename T, bool kDW>
__global__ void __launch_bounds__(kThreads)
ce_grad_kernel(const T* __restrict__ x, const T* __restrict__ w,
               const int* __restrict__ targets, const float* __restrict__ lse,
               const float* __restrict__ g, float* __restrict__ out, int N,
               int V, int d) {
  extern __shared__ __align__(16) unsigned char smem[];
  T* St = reinterpret_cast<T*>(smem);
  T* Cs = St;  // the slice of the columns' rows, once the stage is done
  T* Ds = reinterpret_cast<T*>(smem + grad_region0<T>());
  float* tok_lse = reinterpret_cast<float*>(smem + grad_region0<T>() +
                                            grad_ds_bytes<T>());
  float* tok_g = tok_lse + kBN;
  int* tok_tgt = reinterpret_cast<int*>(tok_g + kBN);
  using L = Layout<T>;
  constexpr int LDD = ds_ld<T>();
  constexpr int LDC = cs_ld<T>();
  constexpr int VE = 16 / sizeof(T);

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int wm = warp >> 2;
  const int wn = warp & 3;
  const T* R = kDW ? w : x;
  const T* C = kDW ? x : w;
  const int nR = kDW ? V : N;
  const int nC = kDW ? N : V;
  const int r0 = blockIdx.x * kBM;
  const int s0 = blockIdx.y * kDS;
  const int dcols = min(kDS, d - s0);

  // Per-token lse, g and target of the tile's tokens (dx: the rows, loaded
  // once; dW: the columns, loaded per token tile).
  auto load_tokens = [&](int t0, int count) {
    for (int k = threadIdx.x; k < count; k += kThreads) {
      const int t = t0 + k;
      const bool ok = t < N;
      tok_lse[k] = ok ? lse[t] : 0.f;
      tok_g[k] = ok ? g[t] : 0.f;
      tok_tgt[k] = ok ? targets[t] : -1;
    }
  };
  if (!kDW) load_tokens(r0, kBM);

  float acc2[2][8][4];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
#pragma unroll
    for (int j = 0; j < 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) acc2[i][j][e] = 0.f;
    }
  }

  for (int c0 = 0; c0 < nC; c0 += kBN) {
    if (kDW) load_tokens(c0, kBN);  // visible after logits_tile's barriers
    float acc[2][4][4];
    logits_tile<T>(acc, R, r0, nR, C, c0, nC, d, St);

    // dlogits of the tile, rounded to the compute dtype, into Ds.
#pragma unroll
    for (int i = 0; i < 2; ++i) {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int lr = wm * 32 + L::row(i, e, lane);
          const int lc = wn * 32 + L::col(j, e, lane);
          const int tk = kDW ? lc : lr;  // the token's place in tok_*
          const int vocab = kDW ? r0 + lr : c0 + lc;
          const int token = kDW ? c0 + lc : r0 + lr;
          float dl = 0.f;
          if (vocab < V && token < N) {
            const float p = __expf(acc[i][j][e] - tok_lse[tk]);
            const float hot = (vocab == tok_tgt[tk]) ? 1.f : 0.f;
            dl = (p - hot) * tok_g[tk];
          }
          Ds[lr * LDD + lc] = round_dlogit(dl, static_cast<T*>(nullptr));
        }
      }
    }

    // The columns' rows c0 .. c0+127, slice s0 .. s0+dcols, into Cs (rows
    // past nC as zeros).
    const int nv = dcols / VE;
    for (int v = threadIdx.x; v < kBN * nv; v += kThreads) {
      const int row = v / nv;
      const int cv = v % nv;
      const int grow = c0 + row;
      const uint4 val =
          grow < nC ? *reinterpret_cast<const uint4*>(
                          C + static_cast<long long>(grow) * d + s0 + cv * VE)
                    : make_uint4(0, 0, 0, 0);
      store_vec<T>(Cs + row * LDC + cv * VE, val);
    }
    __syncthreads();
    if (wn * 64 < dcols) {
      // This tile's 128-term sums first, then into the running total: the
      // total takes one add per tile, so a large term (the one-hot row)
      // does not absorb the small ones that follow it over all V (or N).
      float part[2][8][4];
#pragma unroll
      for (int i = 0; i < 2; ++i) {
#pragma unroll
        for (int j = 0; j < 8; ++j) {
#pragma unroll
          for (int e = 0; e < 4; ++e) part[i][j][e] = 0.f;
        }
      }
      mma_slice(part, Ds, Cs, wm, wn, lane);
#pragma unroll
      for (int i = 0; i < 2; ++i) {
#pragma unroll
        for (int j = 0; j < 8; ++j) {
#pragma unroll
          for (int e = 0; e < 4; ++e) acc2[i][j][e] += part[i][j][e];
        }
      }
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
#pragma unroll
    for (int j = 0; j < 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = r0 + wm * 32 + L::row(i, e, lane);
        const int c = wn * 64 + L::col(j, e, lane);
        if (r < nR && c < dcols) {
          out[static_cast<long long>(r) * d + s0 + c] = acc2[i][j][e];
        }
      }
    }
  }
}

// ---------------------------------------------------------------------------
// Launchers
// ---------------------------------------------------------------------------

template <typename T>
cudaError_t launch_fwd(const void* x, const void* w, const int* targets,
                       float* loss, float* lse, int N, int V, int d,
                       cudaStream_t st) {
  constexpr int smem = fwd_smem_bytes<T>();
  cudaError_t err = cudaFuncSetAttribute(
      ce_fwd_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((N + kBM - 1) / kBM);
  ce_fwd_kernel<T><<<grid, kThreads, smem, st>>>(
      static_cast<const T*>(x), static_cast<const T*>(w), targets, loss, lse,
      N, V, d);
  return cudaGetLastError();
}

template <typename T, bool kDW>
cudaError_t launch_grad(const void* x, const void* w, const int* targets,
                        const float* lse, const float* g, float* out, int N,
                        int V, int d, cudaStream_t st) {
  constexpr int smem = grad_smem_bytes<T>();
  cudaError_t err = cudaFuncSetAttribute(
      ce_grad_kernel<T, kDW>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (err != cudaSuccess) return err;
  const int rows = kDW ? V : N;
  const dim3 grid((rows + kBM - 1) / kBM, (d + kDS - 1) / kDS);
  ce_grad_kernel<T, kDW><<<grid, kThreads, smem, st>>>(
      static_cast<const T*>(x), static_cast<const T*>(w), targets, lse, g,
      out, N, V, d);
  return cudaGetLastError();
}

bool valid_shape(int N, int V, int d, int dtype) {
  return N >= 1 && V >= 1 && d >= 128 && d % 128 == 0 &&
         (dtype == 0 || dtype == 1) && (d + kDS - 1) / kDS <= 65535;
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (x and w).  x (N, d) and w (V, d)
// contiguous with 16-byte aligned rows; targets int32 (N,); loss and lse f32
// (N,).  d must be a multiple of 128.
extern "C" int rlt_ce_fwd(const void* x, const void* w, const void* targets,
                          void* loss, void* lse, int N, int V, int d,
                          int dtype, int device, void* stream) {
  if (!valid_shape(N, V, d, dtype)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int* t = static_cast<const int*>(targets);
  float* lo = static_cast<float*>(loss);
  float* ls = static_cast<float*>(lse);
  err = dtype == 1 ? launch_fwd<bf16>(x, w, t, lo, ls, N, V, d, st)
                   : launch_fwd<float>(x, w, t, lo, ls, N, V, d, st);
  return static_cast<int>(err);
}

// lse and g f32 (N,); dx f32 (N, d) contiguous, every element written.
extern "C" int rlt_ce_bwd_dx(const void* x, const void* w,
                             const void* targets, const void* lse,
                             const void* g, void* dx, int N, int V, int d,
                             int dtype, int device, void* stream) {
  if (!valid_shape(N, V, d, dtype)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int* t = static_cast<const int*>(targets);
  const float* l = static_cast<const float*>(lse);
  const float* gg = static_cast<const float*>(g);
  float* o = static_cast<float*>(dx);
  err = dtype == 1
            ? launch_grad<bf16, false>(x, w, t, l, gg, o, N, V, d, st)
            : launch_grad<float, false>(x, w, t, l, gg, o, N, V, d, st);
  return static_cast<int>(err);
}

// lse and g f32 (N,); dw f32 (V, d) contiguous, every element written.
extern "C" int rlt_ce_bwd_dw(const void* x, const void* w,
                             const void* targets, const void* lse,
                             const void* g, void* dw, int N, int V, int d,
                             int dtype, int device, void* stream) {
  if (!valid_shape(N, V, d, dtype)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int* t = static_cast<const int*>(targets);
  const float* l = static_cast<const float*>(lse);
  const float* gg = static_cast<const float*>(g);
  float* o = static_cast<float*>(dw);
  err = dtype == 1
            ? launch_grad<bf16, true>(x, w, t, l, gg, o, N, V, d, st)
            : launch_grad<float, true>(x, w, t, l, gg, o, N, V, d, st);
  return static_cast<int>(err);
}
