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
// and dW's 2.56 ms each (the logits, then the product).
//
// Design.  bf16 runs the products on the tensor cores with mma.sync
// m16n8k16 (bf16 in, f32 accumulators in registers, fragments loaded with
// ldmatrix); f32 runs them on the CUDA cores in f32 (TF32 would not keep
// f32's precision).  Every output element has exactly one writer and every
// sum a fixed order: no atomics, deterministic results.
//   Forward: blocks of 256 threads (8 warps, 2 along the tile's rows x 4
//   along its columns) own 64 tokens and walk all vocab tiles of 128,
//   streaming d in chunks through shared memory (the next chunk is fetched
//   into registers while the current one is multiplied).  Each thread keeps
//   an online (max, sum-exp, gold) for each accumulator slot it owns, over
//   the columns it sees; at the end the 32 slots of each row are combined in
//   shared memory in a fixed order.  No logits reach memory.
//   dx and dW, bf16: one logits product per tile for all of d, spread over
//   a thread-block cluster (ce_grad_cluster_kernel below).  A (64, d) f32
//   accumulator does not fit one block (192 KiB at d = 768), so the
//   ceil(d/384) blocks of a cluster each own a 384-wide slice of d, compute
//   the partial logits of their slice, and read each other's partials
//   through distributed shared memory: 2 x 1.27 TFLOP a kernel at d = 768,
//   as the JAX kernels do.
//   dx and dW, f32 (ce_grad_kernel): a block owns 64 rows and a 256-wide
//   slice of d and recomputes each 64 x 128 logits tile over all of d:
//   ceil(d/256) logits products plus its own.
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
// f32 backward: dx (kDW false) or dW (kDW true) for 64 rows and one slice of
// d, the logits tile recomputed over all of d.
//   dx: rows = tokens (x), columns = vocab rows (w), out = dx (N, d).
//   dW: rows = vocab rows (w), columns = tokens (x), out = dW (V, d).
// ---------------------------------------------------------------------------

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

template <bool kDW>
__global__ void __launch_bounds__(kThreads)
ce_grad_kernel(const float* __restrict__ x, const float* __restrict__ w,
               const int* __restrict__ targets, const float* __restrict__ lse,
               const float* __restrict__ g, float* __restrict__ out, int N,
               int V, int d) {
  using T = float;
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

    // dlogits of the tile into Ds.
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
          Ds[lr * LDD + lc] = dl;
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
// bf16 backward on a thread-block cluster: one logits product per tile for
// all of d.
//   dx: rows = tokens (x), streamed rows = vocab rows (w), out = dx (N, d).
//   dW: rows = vocab rows (w), streamed rows = tokens (x), out = dW (V, d).
// A cluster of ceil(d/kCS) blocks owns 64 rows; block `rank` owns columns
// rank·kCS .. of d.  It keeps its slice of the 64 rows in shared memory and
// streams its slice of kCV rows at a time through a ring of cp.async stages.
// Per tile t:
//   1. kCPW warps compute the partial logits of tile t + 1 over the block's
//      slice, rows · tileᵀ (64 x kCV, f32), on the tensor cores; after the
//      cluster barrier of tile t they store them in exchange buffer
//      (t + 1) % kXBuf and arrive for tile t + 1;
//   2. meanwhile the other warps wait for tile t, load its partials from
//      every block of the cluster (distributed shared memory; the block's
//      own locally) and sum them in rank order, so every block sees
//      bit-identical logits and dlogits; they form dlogits = (exp(logits -
//      lse) - onehot)·g, masked past V and N and rounded to bf16, into
//      shared memory, and start the copies of tile t + 2;
//   3. all warps add dlogits · tile[:, slice] (ldmatrix.trans of the same
//      stage) to the block's 64 x kCS f32 output, held in registers: the
//      tile's kCV-term sums first, in fresh registers, then one add into the
//      total, so the large one-hot term does not absorb the small ones that
//      follow it over all V (or N).
// Three exchange buffers let a block store tile t + 1's partial as soon as
// it has waited for tile t (the buffer held tile t - 2's, which every block
// had read before it arrived for tile t), so a barrier phase has almost a
// whole iteration to complete.  The roofline: per block and tile
// 4·64·kCV·kCS operations on kCV·kCS·2 bytes streamed from L2, and
// 64·kCV·4 bytes read from each peer.  What holds it back (measured on the
// card with chip_ce_variants.py, PERF.md): ldmatrix traffic in the partial
// product (four warps reload the rows' fragments), the cluster-scope
// release of each partial (1.2k-2.0k cycles a tile), the dlogits pass and
// the output product; 168 registers a thread (384 threads) leave no room
// for larger warp tiles.
// ---------------------------------------------------------------------------

// kCS, kCV, kCPM, kCPN, kRing and kXBuf are the knobs chip_ce_variants.py
// turns; the values here are its fastest readings.  A cluster of 2 at
// d = 768: 66 clusters fill the 132 SMs, where 256-wide slices (clusters of
// 3) fit 39 and read twice the peers' partials.
constexpr int kCS = 384;               // columns of d a block owns
constexpr int kCWarps = 2 * kCS / 64;  // output: 2 x kCS/64 warps, 32 x 64 each
constexpr int kCThreads = 32 * kCWarps;
constexpr int kCV = 48;                // streamed rows a tile
constexpr int kCPM = 4;                // partial logits: warps along the rows
constexpr int kCPN = 1;                // ... and along the tile
constexpr int kCPW = kCPM * kCPN;      // warps computing the partial
constexpr int kRing = 3;               // cp.async stages of the streamed tile
constexpr int kXBuf = 3;               // exchange buffers of the partials
constexpr int kMaxCluster = 8;         // the portable cluster size

struct Cl {
  static constexpr int LS = kCS + 8;  // bf16 row of a slice (16-byte pad)
  static constexpr int LX = kCV + 8;  // f32 row of an exchange buffer
  static constexpr int LD = kCV + 8;  // bf16 row of the dlogits tile
  static constexpr int PR = kBM / kCPM;  // rows of a warp's partial
  static constexpr int PC = kCV / kCPN;  // columns of a warp's partial
  static constexpr int PMI = PR / 16;
  static constexpr int PNJ = PC / 8;
  static constexpr int TOK = 3 * (kBM > kCV ? kBM : kCV);  // lse, g, target
  // The warps that form dlogits, and the float4s of the tile each thread
  // of theirs sums.
  static constexpr int DT = kCThreads - 32 * kCPW;
  static constexpr int VEC = (kBM * kCV / 4 + DT - 1) / DT;
  static constexpr int smem = 2 * (kBM + kRing * kCV) * LS +
                              4 * kXBuf * kBM * LX + 2 * kBM * LD +
                              4 * kRing * TOK;
};
static_assert(kCPW < kCWarps && Cl::PR % 16 == 0 && Cl::PC % 16 == 0 &&
                  kCS % 64 == 0 && kCV % 16 == 0,
              "warp tiling of the cluster kernel");
static_assert(kRing >= 2 && kXBuf >= 1 && kXBuf <= 3, "pipeline depth");
static_assert(Cl::smem <= 232448, "shared memory of the cluster kernel");

// ok false: the 16 (or 4) bytes are zero-filled and nothing is read.
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool ok) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :
               : "r"(smem_u32(dst)), "l"(src), "r"(ok ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          bool ok) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
               :
               : "r"(smem_u32(dst)), "l"(src), "r"(ok ? 4 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// The split cluster barrier: arrive releases this thread's shared-memory
// writes to the cluster, wait acquires every thread's that arrived.
__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
}
// Arrive without releasing anything: for threads that stored nothing the
// peers read.
__device__ __forceinline__ void cluster_arrive_relaxed() {
  asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}
__device__ __forceinline__ int cluster_rank() {
  int r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;\n" : "=r"(r));
  return r;
}
__device__ __forceinline__ int cluster_index() {
  int r;
  asm volatile("mov.u32 %0, %%clusterid.x;\n" : "=r"(r));
  return r;
}
// 16 bytes at the same offset as p in the shared memory of block `rank`
// of the cluster (`self`: this block's own, read locally).
__device__ __forceinline__ float4 ld_peer(const float* p, int rank,
                                          int self) {
  if (rank == self) return *reinterpret_cast<const float4*>(p);
  uint32_t a;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n"
               : "=r"(a)
               : "r"(smem_u32(p)), "r"(rank));
  float4 v;
  asm volatile("ld.shared::cluster.v4.f32 {%0, %1, %2, %3}, [%4];\n"
               : "=f"(v.x), "=f"(v.y), "=f"(v.z), "=f"(v.w)
               : "r"(a)
               : "memory");
  return v;
}

// Two dlogits rounded to nearest bf16 (JAX: dlog.astype(x.dtype)), the
// first in the low half.
__device__ __forceinline__ uint32_t round_pair(float lo, float hi) {
  const uint32_t l = __bfloat16_as_ushort(__float2bfloat16_rn(lo));
  const uint32_t h = __bfloat16_as_ushort(__float2bfloat16_rn(hi));
  return l | (h << 16);
}

// The warp's share of the partial logits: rows pm·PR .. of Rs times rows
// pn·PC .. of the stage, over the slice's first dcols columns.
__device__ __forceinline__ void partial_logits(
    float pl[Cl::PMI][Cl::PNJ][4], const bf16* Rs, const bf16* Ct,
    int dcols, int pm, int pn, int lane) {
#pragma unroll
  for (int i = 0; i < Cl::PMI; ++i) {
#pragma unroll
    for (int j = 0; j < Cl::PNJ; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) pl[i][j][e] = 0.f;
    }
  }
  const bf16* Ra = Rs + (pm * Cl::PR + (lane & 15)) * Cl::LS + (lane >> 4) * 8;
  const bf16* Cb = Ct + (pn * Cl::PC + (lane & 7) + ((lane >> 4) << 3)) *
                            Cl::LS + ((lane >> 3) & 1) * 8;
#pragma unroll 4
  for (int kk = 0; kk < dcols; kk += 16) {
    uint32_t a[Cl::PMI][4], b[Cl::PNJ][2];
#pragma unroll
    for (int i = 0; i < Cl::PMI; ++i) ldsm_x4(a[i], Ra + i * 16 * Cl::LS + kk);
#pragma unroll
    for (int jj = 0; jj < Cl::PNJ / 2; ++jj) {
      uint32_t r[4];
      ldsm_x4(r, Cb + jj * 16 * Cl::LS + kk);
      b[2 * jj][0] = r[0];
      b[2 * jj][1] = r[1];
      b[2 * jj + 1][0] = r[2];
      b[2 * jj + 1][1] = r[3];
    }
#pragma unroll
    for (int i = 0; i < Cl::PMI; ++i) {
#pragma unroll
      for (int j = 0; j < Cl::PNJ; ++j) mma_bf16(pl[i][j], a[i], b[j][0], b[j][1]);
    }
  }
}

__device__ __forceinline__ void store_partial(
    float* X, const float pl[Cl::PMI][Cl::PNJ][4], int pm, int pn, int lane) {
#pragma unroll
  for (int i = 0; i < Cl::PMI; ++i) {
#pragma unroll
    for (int j = 0; j < Cl::PNJ; ++j) {
      float* p = X + (pm * Cl::PR + i * 16 + (lane >> 2)) * Cl::LX +
                 pn * Cl::PC + j * 8 + ((lane & 3) << 1);
      *reinterpret_cast<float2*>(p) = make_float2(pl[i][j][0], pl[i][j][1]);
      *reinterpret_cast<float2*>(p + 8 * Cl::LX) =
          make_float2(pl[i][j][2], pl[i][j][3]);
    }
  }
}

// part (this warp's 32 x 64 of the 64 x kCS output) = Ds · Ct[:, wn·64 ..],
// over the kCV streamed rows.
__device__ __forceinline__ void tile_product(float part[2][8][4],
                                             const bf16* Ds, const bf16* Ct,
                                             int wm, int wn, int lane) {
#pragma unroll
  for (int kk = 0; kk < kCV; kk += 16) {
    uint32_t a[2][4];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      ldsm_x4(a[i], Ds + (wm * 32 + i * 16 + (lane & 15)) * Cl::LD + kk +
                        (lane >> 4) * 8);
    }
#pragma unroll
    for (int jj = 0; jj < 4; ++jj) {
      uint32_t r[4];
      ldsm_x4_trans(r, Ct + (kk + (lane & 15)) * Cl::LS + wn * 64 + jj * 16 +
                           (lane >> 4) * 8);
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        mma_bf16(part[i][2 * jj], a[i], r[0], r[1]);
        mma_bf16(part[i][2 * jj + 1], a[i], r[2], r[3]);
      }
    }
  }
}

template <bool kDW>
__global__ void __launch_bounds__(kCThreads, 1)
ce_grad_cluster_kernel(const bf16* __restrict__ x, const bf16* __restrict__ w,
                       const int* __restrict__ targets,
                       const float* __restrict__ lse,
                       const float* __restrict__ g, float* __restrict__ out,
                       int N, int V, int d) {
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* Rs = reinterpret_cast<bf16*>(smem);  // the rows' slice
  bf16* Ring = Rs + kBM * Cl::LS;            // the streamed tiles' slices
  float* Xb = reinterpret_cast<float*>(Ring + kRing * kCV * Cl::LS);
  bf16* Ds = reinterpret_cast<bf16*>(Xb + kXBuf * kBM * Cl::LX);
  // lse, g and target (as int bits) of the tokens: dx the rows', once;
  // dW each stage's.
  float* Tok = reinterpret_cast<float*>(Ds + kBM * Cl::LD);

  const int nranks = (d + kCS - 1) / kCS;  // the cluster's size
  const int rank = cluster_rank();
  const int r0 = cluster_index() * kBM;
  const int s0 = rank * kCS;
  const int dcols = min(kCS, d - s0);
  const bf16* R = kDW ? w : x;
  const bf16* C = kDW ? x : w;
  const int nR = kDW ? V : N;
  const int nC = kDW ? N : V;
  const int nt = (nC + kCV - 1) / kCV;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const bool pw = warp < kCPW;  // a warp of the partial logits
  const int pm = warp / kCPN, pn = warp % kCPN;  // its place in their grid
  const int wm = warp / (kCS / 64), wn = warp % (kCS / 64);  // the output's
  // The exchange buffer's float4s a dlogits thread sums: row v / (kCV/4),
  // columns 4·(v % (kCV/4)) .. for v = threadIdx.x - 32·kCPW + u·Cl::DT,
  // u < nvec.
  const int nvec = (kBM * kCV / 4 - (threadIdx.x - 32 * kCPW) + Cl::DT - 1) /
                   Cl::DT;
  int xoff[Cl::VEC];
#pragma unroll
  for (int u = 0; u < Cl::VEC; ++u) {
    const int v = threadIdx.x - 32 * kCPW + u * Cl::DT;
    xoff[u] = (v / (kCV / 4)) * Cl::LX + (v % (kCV / 4)) * 4;
  }

  // Rows [row0, row0 + nrows) of A's slice into a tile, zeros past nA,
  // by threads first .. first + count - 1.
  auto cp_rows = [&](bf16* dst, const bf16* A, int row0, int nrows, int nA,
                     int first, int count) {
    constexpr int kVecs = kCS / 8;
    for (int v = threadIdx.x - first; v < nrows * kVecs; v += count) {
      const int r = v / kVecs;
      const int c = (v % kVecs) * 8;
      const bool ok = row0 + r < nA;
      if (c < dcols) {
        cp_async16(dst + r * Cl::LS + c,
                   A + static_cast<long long>(ok ? row0 + r : 0) * d + s0 + c,
                   ok);
      }
    }
  };
  auto cp_tokens = [&](float* dst, int t0, int count, int first,
                       int threads) {
    for (int k = threadIdx.x - first; k < 3 * count; k += threads) {
      const int which = k / count;
      const int t = t0 + k % count;
      const bool ok = t < N;
      const int ts = ok ? t : 0;
      const void* src = which == 0   ? static_cast<const void*>(lse + ts)
                        : which == 1 ? static_cast<const void*>(g + ts)
                                     : static_cast<const void*>(targets + ts);
      cp_async4(dst + k, src, ok);
    }
  };
  // Start loading streamed tile t into stage t % kRing (one commit group,
  // possibly empty), by the dlogits warps: the partial warps' path is the
  // longer one.
  auto issue = [&](int t) {
    if (t < nt && !pw) {
      cp_rows(Ring + (t % kRing) * kCV * Cl::LS, C, t * kCV, kCV, nC,
              32 * kCPW, Cl::DT);
      if (kDW) {
        cp_tokens(Tok + (t % kRing) * 3 * kCV, t * kCV, kCV, 32 * kCPW,
                  Cl::DT);
      }
    }
    cp_async_commit();
  };

  cp_rows(Rs, R, r0, kBM, nR, 0, kCThreads);
  if (!kDW) cp_tokens(Tok, r0, kBM, 0, kCThreads);
#pragma unroll
  for (int t = 0; t < kRing - 1; ++t) issue(t);  // Rs rides in the first
  auto xbuf = [&](int t) { return Xb + (t % kXBuf) * kBM * Cl::LX; };
  float pl[Cl::PMI][Cl::PNJ][4];
  cp_async_wait<kRing - 2>();
  __syncthreads();
  if (pw) {
    partial_logits(pl, Rs, Ring, dcols, pm, pn, lane);
    store_partial(xbuf(0), pl, pm, pn, lane);
  }
  cluster_arrive();

  float acc[2][8][4];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
#pragma unroll
    for (int j = 0; j < 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;
    }
  }

  for (int t = 0; t < nt; ++t) {
    // Tile t + 1 has landed, and every warp is done with tile t - 1 (whose
    // stage the next load takes) and with the dlogits of tile t - 1.
    if constexpr (kRing >= 3) {
      cp_async_wait<kRing - 3>();
      __syncthreads();
    } else {
      __syncthreads();
      issue(t + 1);
      cp_async_wait<0>();
      __syncthreads();
    }
    const bf16* Ct = Ring + (t % kRing) * kCV * Cl::LS;
    const float* tok = kDW ? Tok + (t % kRing) * 3 * kCV : Tok;
    const int ntok = kDW ? kCV : kBM;
    const bool next = t + 1 < nt;
    // The partial warps compute tile t + 1's partial while the others form
    // tile t's dlogits.
    if (pw && next) {
      partial_logits(pl, Rs, Ring + ((t + 1) % kRing) * kCV * Cl::LS, dcols,
                     pm, pn, lane);
    }
    cluster_wait();  // every block's partial of tile t is stored

    // The logits of tile t are the partials summed in rank order.  The
    // dlogits warps start loading ranks 0 and 1 at once, before they arrive
    // and start the next tile's copies.
    const float* Xt = xbuf(t);
    float4 s[Cl::VEC], p[Cl::VEC];
    if (!pw) {
#pragma unroll
      for (int u = 0; u < Cl::VEC; ++u) {
        if (u < nvec) s[u] = ld_peer(Xt + xoff[u], 0, rank);
      }
#pragma unroll
      for (int u = 0; u < Cl::VEC; ++u) {
        if (u < nvec && nranks > 1) p[u] = ld_peer(Xt + xoff[u], 1, rank);
      }
    }
    if constexpr (kXBuf == 3) {
      // Tile t + 1's buffer held tile t - 2's partials, which every block
      // had read when it arrived for tile t.
      if (next) {
        if (pw) {
          store_partial(xbuf(t + 1), pl, pm, pn, lane);
          cluster_arrive();
        } else {
          // Nothing to release, and the loads above may stay in flight.
          cluster_arrive_relaxed();
        }
      }
    }
    // The next tile's loads start after the arrive: a release waits for
    // the thread's copies in flight.
    if constexpr (kRing >= 3) issue(t + kRing - 1);

    if (!pw) {
      for (int q = 1; q < nranks; ++q) {
        if (q > 1) {
#pragma unroll
          for (int u = 0; u < Cl::VEC; ++u) {
            if (u < nvec) p[u] = ld_peer(Xt + xoff[u], q, rank);
          }
        }
#pragma unroll
        for (int u = 0; u < Cl::VEC; ++u) {
          s[u].x += p[u].x;
          s[u].y += p[u].y;
          s[u].z += p[u].z;
          s[u].w += p[u].w;
        }
      }
#pragma unroll
      for (int u = 0; u < Cl::VEC; ++u) {
        const int v = threadIdx.x - 32 * kCPW + u * Cl::DT;
        const int row = v / (kCV / 4);
        const int col = (v % (kCV / 4)) * 4;
        if (u >= nvec) break;
        const float logit[4] = {s[u].x, s[u].y, s[u].z, s[u].w};
        float dl[4];
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          const int tk = kDW ? col + k : row;  // the token's place in tok
          const int vocab = kDW ? r0 + row : t * kCV + col + k;
          const int token = kDW ? t * kCV + col + k : r0 + row;
          const int tgt = __float_as_int(tok[2 * ntok + tk]);
          dl[k] = 0.f;
          if (vocab < V && token < N) {
            const float prob = __expf(logit[k] - tok[tk]);
            const float onehot = vocab == tgt ? 1.f : 0.f;
            dl[k] = (prob - onehot) * tok[ntok + tk];
          }
        }
        *reinterpret_cast<uint2*>(Ds + row * Cl::LD + col) =
            make_uint2(round_pair(dl[0], dl[1]), round_pair(dl[2], dl[3]));
      }
    }
    if constexpr (kXBuf == 1) cluster_arrive();  // done reading
    __syncthreads();

    if (wn * 64 < dcols) {
      float part[2][8][4];
#pragma unroll
      for (int i = 0; i < 2; ++i) {
#pragma unroll
        for (int j = 0; j < 8; ++j) {
#pragma unroll
          for (int e = 0; e < 4; ++e) part[i][j][e] = 0.f;
        }
      }
      tile_product(part, Ds, Ct, wm, wn, lane);
#pragma unroll
      for (int i = 0; i < 2; ++i) {
#pragma unroll
        for (int j = 0; j < 8; ++j) {
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[i][j][e] += part[i][j][e];
        }
      }
    }
    if constexpr (kXBuf < 3) {
      // One buffer: once the peers are done reading it; two: the buffer
      // held tile t - 1's partials, read before each block arrived here.
      if (next) {
        if constexpr (kXBuf == 1) cluster_wait();
        if (pw) store_partial(xbuf(t + 1), pl, pm, pn, lane);
        cluster_arrive();
      }
    }
  }
  // No block leaves while a peer may still read its exchange buffer.
  if constexpr (kXBuf >= 2) cluster_arrive();
  cluster_wait();

  if (wn * 64 < dcols) {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
#pragma unroll
      for (int j = 0; j < 8; ++j) {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int r = r0 + wm * 32 + i * 16 + (lane >> 2) + 8 * h;
          const int c = wn * 64 + j * 8 + ((lane & 3) << 1);
          if (r < nR) {
            *reinterpret_cast<float2*>(out + static_cast<long long>(r) * d +
                                       s0 + c) =
                make_float2(acc[i][j][2 * h], acc[i][j][2 * h + 1]);
          }
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

template <bool kDW>
cudaError_t launch_grad(const void* x, const void* w, const int* targets,
                        const float* lse, const float* g, float* out, int N,
                        int V, int d, cudaStream_t st) {
  constexpr int smem = grad_smem_bytes<float>();
  cudaError_t err = cudaFuncSetAttribute(
      ce_grad_kernel<kDW>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const int rows = kDW ? V : N;
  const dim3 grid((rows + kBM - 1) / kBM, (d + kDS - 1) / kDS);
  ce_grad_kernel<kDW><<<grid, kThreads, smem, st>>>(
      static_cast<const float*>(x), static_cast<const float*>(w), targets,
      lse, g, out, N, V, d);
  return cudaGetLastError();
}

// The launch of the cluster kernel: ceil(d/kCS) blocks a cluster, one
// cluster per 64 rows, along grid.x.
cudaLaunchConfig_t cluster_config(int rows, int d, cudaLaunchAttribute* attr,
                                  cudaStream_t st) {
  const int ranks = (d + kCS - 1) / kCS;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(((rows + kBM - 1) / kBM) * ranks);
  cfg.blockDim = dim3(kCThreads);
  cfg.dynamicSmemBytes = Cl::smem;
  cfg.stream = st;
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = ranks;
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

template <bool kDW>
cudaError_t launch_grad_cluster(const void* x, const void* w,
                                const int* targets, const float* lse,
                                const float* g, float* out, int N, int V,
                                int d, cudaStream_t st) {
  cudaError_t err = cudaFuncSetAttribute(
      ce_grad_cluster_kernel<kDW>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, Cl::smem);
  if (err != cudaSuccess) return err;
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg = cluster_config(kDW ? V : N, d, &attr, st);
  err = cudaLaunchKernelEx(&cfg, ce_grad_cluster_kernel<kDW>,
                           static_cast<const bf16*>(x),
                           static_cast<const bf16*>(w), targets, lse, g, out,
                           N, V, d);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

bool valid_shape(int N, int V, int d, int dtype) {
  return N >= 1 && V >= 1 && d >= 128 && d % 128 == 0 &&
         (dtype == 0 || dtype == 1) && (d + kDS - 1) / kDS <= 65535;
}

// The backward's slices of d: along grid.y (f32) or one portable cluster
// (bf16).
bool valid_bwd_shape(int N, int V, int d, int dtype) {
  return valid_shape(N, V, d, dtype) &&
         (dtype == 0 || (d + kCS - 1) / kCS <= kMaxCluster);
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
  if (!valid_bwd_shape(N, V, d, dtype)) {
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
            ? launch_grad_cluster<false>(x, w, t, l, gg, o, N, V, d, st)
            : launch_grad<false>(x, w, t, l, gg, o, N, V, d, st);
  return static_cast<int>(err);
}

// lse and g f32 (N,); dw f32 (V, d) contiguous, every element written.
extern "C" int rlt_ce_bwd_dw(const void* x, const void* w,
                             const void* targets, const void* lse,
                             const void* g, void* dw, int N, int V, int d,
                             int dtype, int device, void* stream) {
  if (!valid_bwd_shape(N, V, d, dtype)) {
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
            ? launch_grad_cluster<true>(x, w, t, l, gg, o, N, V, d, st)
            : launch_grad<true>(x, w, t, l, gg, o, N, V, d, st);
  return static_cast<int>(err);
}

// For the record: registers a thread, threads and dynamic shared bytes a
// block of the bf16 backward (which: 0 dx, 1 dW), the blocks a cluster has
// at this d and the clusters the current device keeps resident at once.
extern "C" int rlt_ce_bwd_occupancy(int which, int d, int* regs,
                                    int* threads, int* smem_bytes,
                                    int* cluster_size, int* clusters) {
  if ((which != 0 && which != 1) || !valid_bwd_shape(1, 1, d, 1)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const auto kernel = which == 0 ? ce_grad_cluster_kernel<false>
                                 : ce_grad_cluster_kernel<true>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, Cl::smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaFuncAttributes attr;
  err = cudaFuncGetAttributes(&attr, kernel);
  if (err != cudaSuccess) return static_cast<int>(err);
  *regs = attr.numRegs;
  *threads = kCThreads;
  *smem_bytes = Cl::smem;
  *cluster_size = (d + kCS - 1) / kCS;
  cudaLaunchAttribute cluster;
  const cudaLaunchConfig_t cfg = cluster_config(1 << 16, d, &cluster, 0);
  return static_cast<int>(
      cudaOccupancyMaxActiveClusters(clusters, kernel, &cfg));
}
