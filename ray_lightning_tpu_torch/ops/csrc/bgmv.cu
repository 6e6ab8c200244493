// BGMV — batched gathered LoRA delta: out[w] = (h[w] @ A[ids[w]]) @ B[ids[w]].
//
// Replaces ray_lightning_tpu/ops/lora.py::bgmv_pallas, the Pallas kernel of
// multi-tenant LoRA serving.  Shapes: h (W, d), A (N, d, r), B (N, r, k),
// ids (W,) int32, out (W, k).  The LoRA scale is already folded into B.
// Inputs and output are f32 or bf16; every sum is accumulated in f32, t =
// h·A stays f32 (as the JAX kernel's `t` times `b.astype(f32)`), and the
// output is rounded once (round-to-nearest-even for bf16).
//
// What bounds it: memory and latency.  The work is 2·W·r·(d + k)
// operations against the W·(d + k) activations plus the factors of the U
// distinct adapters of the batch (U·r·(d + k) elements): under one
// operation per byte, so the least time is the bytes over the memory rate,
// 0.08–1.9 µs at GPT-2-small's widths, below the launch itself.  What the
// card can do about the rest is to read each byte once, in 16-byte pieces,
// with as few dependent round trips to memory as possible.
//
// Design: which kernels run depends on the rows of the call.
//   A few rows (decode: W <= 16), aligned, rank r <= 16: bgmv_row_kernel,
//   one block a (row, slice of k) over the whole of d.  Each thread
//   issues all of its loads at once — its 16-byte pieces of A[id] with the
//   h values they meet, and its chunk of B[id]'s columns for every r — so
//   the block waits for one round trip after the id's; t meets in warp
//   shuffles and one shared-memory step in a fixed order.  Each slice of k
//   computes its row's t again: at a decode batch that is cheaper than any
//   exchange of partial sums between blocks.
//   More rows: two kernels, the second launched as a programmatic
//   dependent of the first, so that it starts (and copies its B) while
//   the first runs.
//   bgmv_t_kernel, grid (slices of d, tiles of rows).  A block copies its
//   rows' slice of h into shared memory (cp.async, 16 bytes a copy) while
//   one warp reads the tile's ids and finds the distinct ones with
//   __match_any_sync (ids are values, never shapes): each row gets a slot,
//   each slot an adapter.  It copies each slot's slice of A once and
//   applies it to every row of that slot, writing the partial t = h·A over
//   its slice of d (f32) to a scratch buffer.  So a prefill tile (one id
//   over its rows) reads its A once, not once a row.
//   bgmv_out_kernel, grid (slices of k, tiles of up to 64 rows).  Before
//   it waits for the first kernel it reads the ids and starts copying each
//   slot's slice of B; then it sums each row's partials over the slices of
//   d in one fixed order, keeps t in f32 in shared memory, and writes out
//   = t·B for its columns, one 16-byte store per chunk.  Rows of one
//   adapter share each B load, four rows at a time where every quad of
//   rows has one adapter.
// The scratch partials replace an exchange between the blocks of a
// thread-block cluster (distributed shared memory): a design that split d
// over a cluster, without the row kernel, was slower at every serving
// shape, and slower at decode than the earlier one-block-a-row kernel
// (PERF.md).
// Ragged shapes (d, r or k not a multiple of 16 bytes, or an unaligned
// pointer) take the two kernels with element-wise copies and stores
// (kAligned = false).  Where a slice's factors and h pass the
// shared-memory budget (make_plan: about 100 KB, two blocks an SM) a block
// walks its slice of d in chunks and its adapters in groups,
// synchronously; the serving path's shapes need one chunk and one group.
//
// A row whose id lies outside [0, N) reads no factor and is written as NaN,
// so a bad id shows in the output instead of reading outside the buffers.
// The null slot 0 (zero factors) gives exactly 0.0.
//
// The kernels allocate nothing and do not synchronise: the caller passes
// the partials' scratch (rlt_bgmv_scratch floats; the row kernel needs
// none).  The C entry point
// caches each device's SM count, launches on the caller's stream and
// returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <algorithm>
#include <cstddef>
#include <cstdint>
#include <type_traits>

namespace {

using bf16 = __nv_bfloat16;

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxRank = 128;
constexpr int kMaxRows = 64;     // rows a tile
constexpr int kMinSlice = 32;    // d columns a slice, at least
constexpr int kPartialBytes = 32 << 10;  // partials an out block reads
constexpr int kSmemBudget = 100 << 10;   // two blocks an SM
// The opt-in cap on dynamic shared memory (under the 227 KB a block may
// hold, beside the static arrays); a plan needs at most about half of it.
constexpr int kSmemCap = 200 << 10;
constexpr int kMaxDevices = 64;

// The launch's plan, computed on the host (make_plan).
struct Plan {
  int W, d, r, k, n;
  int rows;    // rows a tile of the out kernel
  int rp;      // r rounded up to a 16-byte chunk: A's row in shared memory
  int tq;      // a row of partial t (floats; r rounded up to 4)
  // bgmv_t_kernel: shared memory holds t's rows, h's chunk, then A.
  int rows1;   // rows a tile (a divisor of rows)
  int dsl;     // d columns a slice
  int dsplit;  // slices of d
  int dch;     // d columns staged at once
  int hs;      // h's row in shared memory (elements)
  int group1;  // adapters staged at once
  int off_h, off_a, smem1;  // bytes
  // bgmv_out_kernel: shared memory holds t transposed, then B.
  int ksl;     // k columns a block writes
  int kblocks; // blocks along k
  int bs;      // B's row in shared memory (elements)
  int tts;     // a row of t transposed (floats; rows rounded up to 4)
  int group2;  // adapters staged at once
  int off_b, smem2;  // bytes
  // bgmv_row_kernel (a few rows, small rank: rows > 0)
  int row_ksl;   // k columns a block writes, 0: the two kernels run
  int row_kblocks;
};

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(bf16 x) { return __bfloat162float(x); }

// 16 bytes of shared memory as f32.
__device__ __forceinline__ void load_vec(const float* p, float (&v)[4]) {
  const float4 x = *reinterpret_cast<const float4*>(p);
  v[0] = x.x;
  v[1] = x.y;
  v[2] = x.z;
  v[3] = x.w;
}
__device__ __forceinline__ void load_vec(const bf16* p, float (&v)[8]) {
  const uint4 x = *reinterpret_cast<const uint4*>(p);
  const uint32_t w[4] = {x.x, x.y, x.z, x.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f =
        __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&w[i]));
    v[2 * i] = f.x;
    v[2 * i + 1] = f.y;
  }
}

// 16 bytes held in registers as f32 (T tags the element type): a bf16 is
// the high half of an f32.
__device__ __forceinline__ void unpack(const uint4& x, float (&v)[4],
                                       float) {
  v[0] = __uint_as_float(x.x);
  v[1] = __uint_as_float(x.y);
  v[2] = __uint_as_float(x.z);
  v[3] = __uint_as_float(x.w);
}
__device__ __forceinline__ void unpack(const uint4& x, float (&v)[8], bf16) {
  const uint32_t w[4] = {x.x, x.y, x.z, x.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    v[2 * i] = __uint_as_float(w[i] << 16);
    v[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
  }
}

// n <= V values to out (16 bytes at once when n == V and aligned).
template <bool kAligned>
__device__ __forceinline__ void store_vec(float* o, const float (&v)[4],
                                          int n) {
  if (kAligned && n == 4) {
    *reinterpret_cast<float4*>(o) = make_float4(v[0], v[1], v[2], v[3]);
  } else {
    for (int i = 0; i < n; ++i) o[i] = v[i];
  }
}
template <bool kAligned>
__device__ __forceinline__ void store_vec(bf16* o, const float (&v)[8],
                                          int n) {
  if (kAligned && n == 8) {
    uint32_t w[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      __nv_bfloat162 p = __floats2bfloat162_rn(v[2 * i], v[2 * i + 1]);
      w[i] = *reinterpret_cast<uint32_t*>(&p);
    }
    *reinterpret_cast<uint4*>(o) = make_uint4(w[0], w[1], w[2], w[3]);
  } else {
    for (int i = 0; i < n; ++i) o[i] = __float2bfloat16_rn(v[i]);
  }
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
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

// Programmatic dependent launch: the t kernel lets its dependent start
// early; the out kernel waits for the t kernel's completion (and the
// visibility of its writes) before it reads the partials.
__device__ __forceinline__ void launch_dependents() {
  asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");
}
__device__ __forceinline__ void wait_for_primary() {
  asm volatile("griddepcontrol.wait;\n" ::: "memory");
}

// Copy `total` items — 16-byte pieces when aligned, else elements —
// where map(x, dst, src) gives item x's addresses.  A thread computes the
// addresses of a batch of its items first and then issues their copies
// (cp.async when aligned, element copies otherwise): a shared-memory load
// in `map` (an adapter's id) then never waits behind the thread's own
// copies in flight, as it would between them.
template <bool kAligned, typename T, typename Map>
__device__ __forceinline__ void copy_items(int total, Map map) {
  constexpr int K = 8;  // items a batch
  for (int x0 = threadIdx.x; x0 < total; x0 += K * kThreads) {
    T* dst[K];
    const T* src[K];
#pragma unroll
    for (int k = 0; k < K; ++k) {
      dst[k] = nullptr;
      if (x0 + k * kThreads < total) map(x0 + k * kThreads, dst[k], src[k]);
    }
#pragma unroll
    for (int k = 0; k < K; ++k) {
      if (dst[k] == nullptr) continue;
      if constexpr (kAligned) {
        cp_async16(dst[k], src[k]);
      } else {
        *dst[k] = *src[k];
      }
    }
  }
}

// The tile's slots, found by warp 0: each row's slot (-1: an out-of-range
// id) in slot[], each slot's adapter in uid[], in order of first
// appearance; the count in *u_out; *quads_out whether every quad of rows
// (rows 4q..4q+3 present) has one slot.  Lane l holds rows l and l + 32.
// Out-of-range ids key as -1, missing rows as -2.  The caller syncs.
__device__ __forceinline__ void find_slots(const int* __restrict__ ids,
                                           int row0, int nrows, int n,
                                           int* slot, int* uid, int* u_out,
                                           int* quads_out) {
  const int lane = threadIdx.x & 31;
  auto key = [&](int row) {
    if (row >= nrows) return -2;
    const int id = ids[row0 + row];
    return (id >= 0 && id < n) ? id : -1;
  };
  const unsigned full = 0xffffffffu;
  const int ka = key(lane), kb = key(lane + 32);
  const unsigned ma = __match_any_sync(full, ka);
  const int lead_a = __ffs(ma) - 1;
  const unsigned fa = __ballot_sync(full, lead_a == lane && ka >= 0);
  const int na = __popc(fa);
  const int slot_a = ka >= 0 ? __popc(fa & ((1u << lead_a) - 1)) : -1;
  if (lead_a == lane && ka >= 0) uid[slot_a] = ka;
  if (lane < nrows) slot[lane] = slot_a;
  int u = na;
  if (nrows > 32) {
    const unsigned mb = __match_any_sync(full, kb);
    const int lead_b = __ffs(mb) - 1;
    int in_a = -1;  // the slot of kb's id among the first 32 rows
    for (unsigned f = fa; f; f &= f - 1) {
      const int src = __ffs(f) - 1;
      if (kb == __shfl_sync(full, ka, src)) {
        in_a = __popc(fa & ((1u << src) - 1));
      }
    }
    const bool first_b = lead_b == lane && kb >= 0 && in_a < 0;
    const unsigned fb = __ballot_sync(full, first_b);
    const int slot_b = kb < 0      ? -1
                       : in_a >= 0 ? in_a
                                   : na + __popc(fb & ((1u << lead_b) - 1));
    if (first_b) uid[slot_b] = kb;
    if (lane + 32 < nrows) slot[lane + 32] = slot_b;
    u += __popc(fb);
  }
  __syncwarp();
  bool one = true;
  if (lane < (nrows + 3) / 4) {
    const int s0 = slot[4 * lane];
    one = s0 >= 0;
    for (int m = 1; m < 4 && 4 * lane + m < nrows; ++m) {
      one = one && slot[4 * lane + m] == s0;
    }
  }
  const bool quads = __all_sync(full, one);
  if (lane == 0) {
    *u_out = u;
    *quads_out = quads;
  }
}

// Partial t = h·A over one slice of d: grid (slices of d, tiles).
template <typename T, bool kAligned>
__global__ void __launch_bounds__(kThreads)
    bgmv_t_kernel(const T* __restrict__ h, const T* __restrict__ a,
                  const int* __restrict__ ids, float* __restrict__ partial,
                  const __grid_constant__ Plan p) {
  constexpr int V = 16 / sizeof(T);
  constexpr int VC = kAligned ? V : 1;  // elements a copy
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ int s_slot[kMaxRows];  // each row's slot; -1: no adapter
  __shared__ int s_uid[kMaxRows];   // each slot's adapter
  __shared__ int s_u, s_quads;
  float* tpart = reinterpret_cast<float*>(smem);  // [row][tq]
  T* hs = reinterpret_cast<T*>(smem + p.off_h);
  T* as = reinterpret_cast<T*>(smem + p.off_a);

  launch_dependents();  // the out kernel may start its copies
  const int tid = threadIdx.x;
  const int row0 = blockIdx.y * p.rows1;
  const int nrows = min(p.rows1, p.W - row0);
  const int i0 = blockIdx.x * p.dsl;
  const int nd = max(0, min(p.dsl, p.d - i0));
  const T* h_rows = h + static_cast<size_t>(row0) * p.d + i0;
  // Copies into shared memory, VC elements a piece: h's rows (chunk dc of
  // the slice), A's slice for slots g0.. (rows of r, back to back).
  auto stage_h = [&](int dc, int ndc) {
    const int nv = ndc / VC;
    copy_items<kAligned, T>(nrows * nv, [&](int x, T*& dst, const T*& src) {
      const int row = x / nv, c = (x - row * nv) * VC;
      dst = hs + row * p.hs + c;
      src = h_rows + static_cast<size_t>(row) * p.d + dc + c;
    });
  };
  auto stage_a = [&](int g0, int ng, int dc, int ndc) {
    const int per = ndc * p.r / VC;
    copy_items<kAligned, T>(ng * per, [&](int x, T*& dst, const T*& src) {
      const int s = x / per, e = (x - s * per) * VC;
      const int i = kAligned ? 0 : e / p.r, j = e - i * p.r;
      dst = as + s * p.dch * p.rp + i * p.rp + j;
      src = a + (static_cast<size_t>(s_uid[g0 + s]) * p.d + i0 + dc) * p.r +
            i * p.r + j;
    });
  };

  stage_h(0, min(nd, p.dch));  // it needs no id
  cp_async_commit();
  if (tid < 32) {
    find_slots(ids, row0, nrows, p.n, s_slot, s_uid, &s_u, &s_quads);
  }
  __syncthreads();
  const int U = s_u, G = p.group1;

  // A thread owns an item — R rows of one adapter and a chunk of V columns
  // of r — and 2^lg threads share an item, splitting the chunk of d
  // between them.  R = 4 (each A load serves four rows) where every quad
  // of rows has one adapter, as at prefill; else R = 1.  Lanes run over
  // the chunks of r first, then over the split of d, then over the items,
  // so the 8 lanes of a quarter warp read 128 contiguous bytes of A.
  const int nj = p.rp / V;
  int lj = 0;
  while ((1 << lj) < nj) ++lj;
  auto h_times_a = [&](auto rows_an_item, int g0, int ng, int dc, int ndc) {
    constexpr int R = decltype(rows_an_item)::value;
    const int nitem = (nrows + R - 1) / R;
    const int nitem_max = (p.rows1 + R - 1) / R;
    int lg = 0;  // the split of d: within a warp, filling the block
    while (lj + lg < 5 && (nitem_max << (lj + lg + 1)) <= kThreads) ++lg;
    const int split = 1 << lg;
    const int jc = tid & ((1 << lj) - 1);
    const int part = (tid >> lj) & (split - 1);
    for (int base = 0; base < nitem_max; base += kThreads >> (lj + lg)) {
      const int q = base + (tid >> (lj + lg));
      const int slot = q < nitem && jc < nj ? s_slot[R * q] : -1;
      const bool on = slot >= g0 && slot < g0 + ng;
      float acc[R][V];
#pragma unroll
      for (int m = 0; m < R; ++m) {
#pragma unroll
        for (int v = 0; v < V; ++v) acc[m][v] = 0.f;
      }
      if (on) {
        const T* hp = hs + R * q * p.hs;
        const T* ap = as + (slot - g0) * p.dch * p.rp + jc * V;
#pragma unroll 2
        for (int i = part; i < ndc; i += split) {
          float av[V];
          load_vec(ap + i * p.rp, av);
#pragma unroll
          for (int m = 0; m < R; ++m) {
            const float hv = to_f32(hp[m * p.hs + i]);
#pragma unroll
            for (int v = 0; v < V; ++v) acc[m][v] = fmaf(hv, av[v], acc[m][v]);
          }
        }
      }
      for (int o = split >> 1; o > 0; o >>= 1) {
#pragma unroll
        for (int m = 0; m < R; ++m) {
#pragma unroll
          for (int v = 0; v < V; ++v) {
            acc[m][v] += __shfl_xor_sync(0xffffffffu, acc[m][v], o << lj);
          }
        }
      }
      if (on && part == 0) {
#pragma unroll
        for (int m = 0; m < R; ++m) {
          if (R * q + m >= nrows) break;
          float* tp = tpart + (R * q + m) * p.tq + jc * V;
#pragma unroll
          for (int v = 0; v < V; ++v) {
            if (jc * V + v < p.r) {
              tp[v] = dc == 0 ? acc[m][v] : tp[v] + acc[m][v];
            }
          }
        }
      }
    }
  };
  for (int g0 = 0; g0 < U; g0 += G) {
    const int ng = min(G, U - g0);
    for (int dc = 0; dc == 0 || dc < nd; dc += p.dch) {
      const int ndc = max(0, min(p.dch, nd - dc));
      if (g0 > 0 || dc > 0) {
        __syncthreads();  // the last round's readers are done
        if (nd > p.dch) stage_h(dc, ndc);
      }
      stage_a(g0, ng, dc, ndc);
      cp_async_commit();
      cp_async_wait<0>();
      __syncthreads();
      if (s_quads) {
        h_times_a(std::integral_constant<int, 4>{}, g0, ng, dc, ndc);
      } else {
        h_times_a(std::integral_constant<int, 1>{}, g0, ng, dc, ndc);
      }
    }
  }
  cp_async_wait<0>();  // (U = 0) nothing left in flight
  __syncthreads();

  // The slice's partial rows, 16 bytes a store: partial[slice][row][tq].
  float* dst = partial + (static_cast<size_t>(blockIdx.x) * p.W + row0) * p.tq;
  const int nv = p.tq / 4;
  for (int x = tid; x < nrows * nv; x += kThreads) {
    if (s_slot[x / nv] < 0) continue;
    reinterpret_cast<float4*>(dst)[x] =
        reinterpret_cast<const float4*>(tpart)[x];
  }
}

// out = t·B over one slice of k: grid (slices of k, tiles).
template <typename T, bool kAligned>
__global__ void __launch_bounds__(kThreads)
    bgmv_out_kernel(const T* __restrict__ b, const int* __restrict__ ids,
                    const float* __restrict__ partial, T* __restrict__ out,
                    const __grid_constant__ Plan p) {
  constexpr int V = 16 / sizeof(T);
  constexpr int VC = kAligned ? V : 1;
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ int s_slot[kMaxRows];
  __shared__ int s_uid[kMaxRows];
  __shared__ int s_u, s_quads;
  float* tt = reinterpret_cast<float*>(smem);  // [r][tts]: t transposed
  T* bs = reinterpret_cast<T*>(smem + p.off_b);

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int row0 = blockIdx.y * p.rows;
  const int nrows = min(p.rows, p.W - row0);
  const int c0 = blockIdx.x * p.ksl;
  const int nk = max(0, min(p.ksl, p.k - c0));
  // B's columns c0.. of slots g0.., VC elements a piece.
  auto stage_b = [&](int g0, int ng) {
    const int nv = nk / VC, per = p.r * nv;
    copy_items<kAligned, T>(ng * per, [&](int x, T*& dst, const T*& src) {
      const int s = x / per, rem = x - s * per;
      const int j = rem / nv, c = (rem - j * nv) * VC;
      dst = bs + (s * p.r + j) * p.bs + c;
      src = b + (static_cast<size_t>(s_uid[g0 + s]) * p.r + j) * p.k + c0 + c;
    });
  };

  if (tid < 32) {
    find_slots(ids, row0, nrows, p.n, s_slot, s_uid, &s_u, &s_quads);
  }
  __syncthreads();
  const int U = s_u, G = p.group2;
  const bool b_early = U <= G;  // B lands while the t kernel runs
  if (b_early) {
    stage_b(0, U);
    cp_async_commit();
  }

  // t = the sum of the partials over the slices of d, in slice order:
  // 2^lp threads share a (row, 4 columns of r) item, each summing every
  // 2^lp-th slice, and their sums meet in a fixed tree.
  wait_for_primary();
  const int nj4 = p.tq / 4;
  const int items = p.rows * nj4;
  int lp = 0;
  while (lp < 5 && (1 << lp) < p.dsplit && (items << (lp + 1)) <= kThreads) {
    ++lp;
  }
  for (int base = 0; base < items; base += kThreads >> lp) {
    const int it = base + (tid >> lp), part = tid & ((1 << lp) - 1);
    const int row = it / nj4, j0 = (it - row * nj4) * 4;
    const bool on = it < items && row < nrows && s_slot[row] >= 0;
    float4 t = make_float4(0.f, 0.f, 0.f, 0.f);
    if (on) {
      const float* src =
          partial + (static_cast<size_t>(row0) + row) * p.tq + j0;
#pragma unroll 4
      for (int sl = part; sl < p.dsplit; sl += 1 << lp) {
        const float4 v = *reinterpret_cast<const float4*>(
            src + static_cast<size_t>(sl) * p.W * p.tq);
        t.x += v.x;
        t.y += v.y;
        t.z += v.z;
        t.w += v.w;
      }
    }
    for (int o = 1; o < (1 << lp); o <<= 1) {
      t.x += __shfl_xor_sync(0xffffffffu, t.x, o);
      t.y += __shfl_xor_sync(0xffffffffu, t.y, o);
      t.z += __shfl_xor_sync(0xffffffffu, t.z, o);
      t.w += __shfl_xor_sync(0xffffffffu, t.w, o);
    }
    if (on && part == 0) {
      const float tv[4] = {t.x, t.y, t.z, t.w};
#pragma unroll
      for (int v = 0; v < 4; ++v) {
        if (j0 + v < p.r) tt[(j0 + v) * p.tts + row] = tv[v];
      }
    }
  }

  // out = t·B over this block's columns: a warp takes 8 items (R rows of
  // one adapter, R = 4 where every quad of rows has one, else 1) x 4
  // chunks of V columns, so items of one adapter read each B chunk once,
  // and each load of it serves R rows (whose t it reads at once).
  const int nch = (nk + V - 1) / V;
  const int cbs = (nch + 3) / 4;
  auto t_times_b = [&](auto rows_an_item, int g0, int ng) {
    constexpr int R = decltype(rows_an_item)::value;
    const int nitem = (nrows + R - 1) / R;
    const int units = (nitem + 7) / 8 * cbs;
    for (int un = warp; un < units; un += kWarps) {
      const int q = (un / cbs) * 8 + (lane >> 2);
      const int ch = (un % cbs) * 4 + (lane & 3);
      if (q >= nitem || ch >= nch) continue;
      const int slot = s_slot[R * q];
      const int col = c0 + ch * V;
      const int ncol = min(V, c0 + nk - col);
      float acc[R][V];
      if (slot < 0) {  // an out-of-range id (R = 1): its row is NaN
        if (g0 != 0) continue;
#pragma unroll
        for (int v = 0; v < V; ++v) acc[0][v] = __int_as_float(0x7fc00000);
        store_vec<kAligned>(out + static_cast<size_t>(row0 + q) * p.k + col,
                            acc[0], ncol);
        continue;
      }
      if (slot < g0 || slot >= g0 + ng) continue;
#pragma unroll
      for (int m = 0; m < R; ++m) {
#pragma unroll
        for (int v = 0; v < V; ++v) acc[m][v] = 0.f;
      }
      const T* bp = bs + (slot - g0) * p.r * p.bs + ch * V;
      const float* tq = tt + R * q;
#pragma unroll 4
      for (int j = 0; j < p.r; ++j) {
        float bv[V], tv[R];
        load_vec(bp + j * p.bs, bv);
        if constexpr (R == 4) {
          const float4 t4 = *reinterpret_cast<const float4*>(tq + j * p.tts);
          tv[0] = t4.x;
          tv[1] = t4.y;
          tv[2] = t4.z;
          tv[3] = t4.w;
        } else {
          tv[0] = tq[j * p.tts];
        }
#pragma unroll
        for (int m = 0; m < R; ++m) {
#pragma unroll
          for (int v = 0; v < V; ++v) acc[m][v] = fmaf(tv[m], bv[v], acc[m][v]);
        }
      }
#pragma unroll
      for (int m = 0; m < R; ++m) {
        if (R * q + m >= nrows) break;
        store_vec<kAligned>(
            out + static_cast<size_t>(row0 + R * q + m) * p.k + col, acc[m],
            ncol);
      }
    }
  };
  for (int g0 = 0; g0 == 0 || g0 < U; g0 += G) {
    const int ng = max(0, min(G, U - g0));
    if (!b_early) {
      __syncthreads();  // the last group's readers are done
      stage_b(g0, ng);
      cp_async_commit();
    }
    cp_async_wait<0>();
    __syncthreads();  // t and B in place
    if (s_quads) {
      t_times_b(std::integral_constant<int, 4>{}, g0, ng);
    } else {
      t_times_b(std::integral_constant<int, 1>{}, g0, ng);
    }
  }
}

// A few rows (decode): one block a (row, slice of k), the whole of d.
// Every thread issues its loads at once — its 16-byte pieces of A[id] with
// the h values they meet, and its chunk of columns of B[id] for all r —
// so the block waits for one round trip after the id's; t meets in warp
// shuffles and one shared-memory step, in a fixed order.  Each block
// computes its row's t again (a row's slices of k do not share it): at a
// decode batch that costs less than any exchange of partial sums between
// blocks (PERF.md).  Aligned tensors; r <= 16, a power of two of 16-byte
// pieces a row of A.
constexpr int kRowA = 16;     // 16-byte pieces of A a thread holds at once
constexpr int kRowMaxR = 16;  // the rank it takes, at most
constexpr int kRowMaxW = 16;  // the rows of a call it takes, at most
template <typename T>
__global__ void __launch_bounds__(kThreads)
    bgmv_row_kernel(const T* __restrict__ h, const T* __restrict__ a,
                    const T* __restrict__ b, const int* __restrict__ ids,
                    T* __restrict__ out, const __grid_constant__ Plan p) {
  constexpr int V = 16 / sizeof(T);
  __shared__ float s_part[kWarps][32];
  __shared__ float s_t[32];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int w = blockIdx.y;
  const int c0 = blockIdx.x * p.row_ksl;
  const int nk = min(p.row_ksl, p.k - c0);
  const int id = ids[w];
  T* o = out + static_cast<size_t>(w) * p.k + c0;
  if (id < 0 || id >= p.n) {  // an out-of-range id: its row is NaN
    float nan[V];
#pragma unroll
    for (int v = 0; v < V; ++v) nan[v] = __int_as_float(0x7fc00000);
    for (int c = tid; c < nk; c += kThreads) store_vec<false>(o + c, nan, 1);
    return;
  }
  const int nj = p.r / V;  // 16-byte pieces a row of A (a power of two)
  const int lnj = __ffs(nj) - 1;
  const int jc = tid & (nj - 1);
  const T* hw = h + static_cast<size_t>(w) * p.d;
  const uint4* ai = reinterpret_cast<const uint4*>(
      a + static_cast<size_t>(id) * p.d * p.r);
  // This thread's chunk of columns: B for every j, in registers.
  const int ch = tid;
  const bool has_ch = ch * V < nk;
  uint4 braw[kRowMaxR];
  const T* bj = b + static_cast<size_t>(id) * p.r * p.k + c0 + ch * V;
#pragma unroll
  for (int j = 0; j < kRowMaxR; ++j) {
    if (j < p.r && has_ch) {
      braw[j] = *reinterpret_cast<const uint4*>(bj + static_cast<size_t>(j) *
                                                         p.k);
    }
  }
  // t's partial over this thread's pieces of A (rows i = piece / nj).
  float acc[V];
#pragma unroll
  for (int v = 0; v < V; ++v) acc[v] = 0.f;
  const int pieces = p.d * nj;
  for (int base = tid; base < pieces; base += kRowA * kThreads) {
    uint4 araw[kRowA];
    float hv[kRowA];
#pragma unroll
    for (int m = 0; m < kRowA; ++m) {
      const int c = base + m * kThreads;
      if (c < pieces) {
        araw[m] = ai[c];
        hv[m] = to_f32(hw[c >> lnj]);
      }
    }
#pragma unroll
    for (int m = 0; m < kRowA; ++m) {
      if (base + m * kThreads >= pieces) continue;
      float av[V];
      unpack(araw[m], av, T());
#pragma unroll
      for (int v = 0; v < V; ++v) acc[v] = fmaf(hv[m], av[v], acc[v]);
    }
  }
  // Lanes of one piece of r meet in the warp, then the warps in order.
  for (int o2 = nj; o2 < 32; o2 <<= 1) {
#pragma unroll
    for (int v = 0; v < V; ++v) {
      acc[v] += __shfl_xor_sync(0xffffffffu, acc[v], o2);
    }
  }
  if (lane < nj) {
#pragma unroll
    for (int v = 0; v < V; ++v) s_part[warp][jc * V + v] = acc[v];
  }
  __syncthreads();
  if (tid < p.r) {
    float t = 0.f;
#pragma unroll
    for (int q = 0; q < kWarps; ++q) t += s_part[q][tid];
    s_t[tid] = t;
  }
  __syncthreads();
  if (!has_ch) return;
  float res[V];
#pragma unroll
  for (int v = 0; v < V; ++v) res[v] = 0.f;
#pragma unroll
  for (int j = 0; j < kRowMaxR; ++j) {
    if (j >= p.r) break;
    float bv[V];
    unpack(braw[j], bv, T());
    const float t = s_t[j];
#pragma unroll
    for (int v = 0; v < V; ++v) res[v] = fmaf(t, bv[v], res[v]);
  }
  store_vec<true>(o + ch * V, res, V);
}

int ceil_div(int a, int b) { return (a + b - 1) / b; }
int round_up(int a, int b) { return ceil_div(a, b) * b; }

// The launch plan of one call (see the design note at the top).
// `target_blocks` is the block count each kernel's grid aims at.
Plan make_plan(int W, int d, int r, int k, int n, int es, int target_blocks) {
  const int V = 16 / es;
  Plan p = {};
  p.W = W;
  p.d = d;
  p.r = r;
  p.k = k;
  p.n = n;
  p.rp = round_up(r, V);
  p.tq = round_up(r, 4);
  // Rows a tile: up to 64, fewer at a large rank (t's buffers).
  p.rows = std::min(W, std::min(kMaxRows, std::max(8, 2048 / p.rp / 8 * 8)));
  const int tiles = ceil_div(W, p.rows);
  // The t kernel: slices of d of at least kMinSlice columns, as many as
  // fill the card, but no more partials a row than an out block reads in
  // kPartialBytes; then tiles of fewer rows until its grid fills the card
  // (a tile of fewer rows stages the A of fewer adapters).
  int ds = std::max(1, std::min(target_blocks / tiles, ceil_div(d, kMinSlice)));
  ds = std::min(ds, std::max(1, kPartialBytes / (p.rows * p.tq * 4)));
  p.dsl = round_up(ceil_div(d, ds), V);
  p.dsplit = ceil_div(d, p.dsl);
  p.rows1 = p.rows;
  while (p.rows1 % 2 == 0 && p.rows1 > 1 &&
         2 * ceil_div(W, p.rows1) * p.dsplit <= target_blocks) {
    p.rows1 /= 2;
  }
  const int rows4 = round_up(p.rows1, 4);
  // d staged at once: h's chunk at most 16K elements, A's 32 KB an adapter.
  const int dch_h = std::max(V, 16384 / p.rows1 / V * V);
  const int dch_a = std::max(V, 32768 / (p.rp * es) / V * V);
  p.dch = std::min(p.dsl, std::min(dch_h, dch_a));
  p.hs = p.dch + V;  // 16 bytes of padding spread a warp's rows over banks
  p.off_h = p.rows1 * p.tq * 4;
  p.off_a = p.off_h + rows4 * p.hs * es;  // h: whole quads of rows
  const int per_a = p.dch * p.rp * es;
  p.group1 = std::max(1, std::min({(kSmemBudget - p.off_a) / per_a, p.rows1,
                                   n}));
  p.smem1 = p.off_a + p.group1 * per_a;
  // The out kernel: about target_blocks blocks, at least V and at most
  // kmax columns a block (B's slice at most 4096 elements an adapter).
  const int kmax = std::max(V, 4096 / p.rp / V * V);
  int kb = std::max(1, target_blocks / tiles);
  kb = std::min(kb, ceil_div(k, V));
  kb = std::max(kb, ceil_div(k, kmax));
  p.ksl = round_up(ceil_div(k, kb), V);
  p.kblocks = ceil_div(k, p.ksl);
  p.bs = p.ksl;
  p.tts = round_up(p.rows, 4);
  p.off_b = p.r * p.tts * 4;
  const int per_b = p.r * p.bs * es;
  p.group2 = std::max(1, std::min({(kSmemBudget - p.off_b) / per_b, p.rows,
                                   n}));
  p.smem2 = p.off_b + p.group2 * per_b;
  // A few rows at a small rank (power-of-two 16-byte pieces a row of A):
  // the row kernel, about a quarter wave of blocks (each reads its row's
  // whole A), each a slice of k of at most one 16-byte chunk a thread.
  const int nj = r / V;
  if (W <= kRowMaxW && r % V == 0 && r <= kRowMaxR && (nj & (nj - 1)) == 0) {
    int rb = std::max(1, target_blocks / (4 * W));
    rb = std::max(rb, ceil_div(k, kThreads * V));
    p.row_ksl = round_up(ceil_div(k, rb), V);
    p.row_kblocks = ceil_div(k, p.row_ksl);
  }
  return p;
}

// Blocks each kernel's grid aims at: about one a streaming multiprocessor.
int target_blocks(int sms) { return sms; }

int sm_count(int device) {
  static int cached[kMaxDevices] = {};
  if (device < 0 || device >= kMaxDevices) return -1;
  if (cached[device] == 0) {
    int sms = 0;
    if (cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                               device) != cudaSuccess) {
      return -1;
    }
    cached[device] = sms;
  }
  return cached[device];
}

template <typename T, bool kAligned>
cudaError_t launch(const void* h, const void* a, const void* b,
                   const int* ids, void* out, float* partial, const Plan& p,
                   cudaStream_t st) {
  static bool attr_set = false;  // per instantiation
  if (!attr_set) {
    cudaError_t err = cudaFuncSetAttribute(
        bgmv_t_kernel<T, kAligned>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemCap);
    if (err == cudaSuccess) {
      err = cudaFuncSetAttribute(bgmv_out_kernel<T, kAligned>,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 kSmemCap);
    }
    if (err != cudaSuccess) return err;
    attr_set = true;
  }
  if (kAligned && p.row_ksl > 0) {
    bgmv_row_kernel<T><<<dim3(p.row_kblocks, p.W), kThreads, 0, st>>>(
        static_cast<const T*>(h), static_cast<const T*>(a),
        static_cast<const T*>(b), ids, static_cast<T*>(out), p);
    return cudaGetLastError();
  }
  const unsigned tiles = ceil_div(p.W, p.rows);
  bgmv_t_kernel<T, kAligned>
      <<<dim3(p.dsplit, ceil_div(p.W, p.rows1)), kThreads, p.smem1, st>>>(
          static_cast<const T*>(h), static_cast<const T*>(a), ids, partial,
          p);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(p.kblocks, tiles);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = p.smem2;
  cfg.stream = st;
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr.val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(&cfg, bgmv_out_kernel<T, kAligned>,
                            static_cast<const T*>(b), ids,
                            static_cast<const float*>(partial),
                            static_cast<T*>(out), p);
}

bool aligned16(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

// The plan of a call on `device`; false for a shape the kernels do not
// take.
bool plan_for(int W, int d, int r, int k, int n, int dtype, int device,
              Plan* p) {
  if (W < 1 || d < 1 || k < 1 || r < 1 || r > kMaxRank || n < 1 ||
      (dtype != 0 && dtype != 1) || (W + kMaxRows - 1) / kMaxRows > 65535) {
    return false;
  }
  const int sms = sm_count(device);
  if (sms < 1) return false;
  *p = make_plan(W, d, r, k, n, dtype == 0 ? 4 : 2, target_blocks(sms));
  return true;
}

}  // namespace

// f32 elements of the partials' scratch a call needs (0: a shape the
// kernels do not take).
extern "C" long long rlt_bgmv_scratch(int W, int d, int r, int k,
                                      int n_adapters, int dtype, int device) {
  Plan p;
  if (!plan_for(W, d, r, k, n_adapters, dtype, device, &p)) return 0;
  return static_cast<long long>(p.dsplit) * p.W * p.tq;
}

// dtype: 0 = float32, 1 = bfloat16 (h, A, B and out share it); scratch:
// rlt_bgmv_scratch f32 elements, 16-byte aligned.
extern "C" int rlt_bgmv(const void* h, const void* a, const void* b,
                        const void* ids, void* out, void* scratch, int W,
                        int d, int r, int k, int n_adapters, int dtype,
                        int device, void* stream) {
  int current = -1;
  cudaError_t err = cudaGetDevice(&current);
  if (err == cudaSuccess && current != device) err = cudaSetDevice(device);
  if (err != cudaSuccess) return static_cast<int>(err);
  Plan p;
  if (!plan_for(W, d, r, k, n_adapters, dtype, device, &p)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (!aligned16(scratch)) return static_cast<int>(cudaErrorInvalidValue);
  const int V = dtype == 0 ? 4 : 8;
  const bool aligned = d % V == 0 && r % V == 0 && k % V == 0 &&
                       aligned16(h) && aligned16(a) && aligned16(b) &&
                       aligned16(out);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* id = static_cast<const int*>(ids);
  float* part = static_cast<float*>(scratch);
  if (dtype == 0) {
    err = aligned ? launch<float, true>(h, a, b, id, out, part, p, s)
                  : launch<float, false>(h, a, b, id, out, part, p, s);
  } else {
    err = aligned ? launch<bf16, true>(h, a, b, id, out, part, p, s)
                  : launch<bf16, false>(h, a, b, id, out, part, p, s);
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

// For the record: the plan of one call on `device` — slices of d (the t
// kernel's blocks along d; 0: the row kernel runs alone), blocks along k
// (the out kernel's or the row kernel's), tiles of rows (rows, for the
// row kernel), the two kernels' dynamic shared bytes, and whether the
// 16-byte path (and so the row kernel) runs for contiguous, aligned
// tensors.
extern "C" int rlt_bgmv_plan(int W, int d, int r, int k, int n_adapters,
                             int dtype, int device, int* out6) {
  Plan p;
  if (!plan_for(W, d, r, k, n_adapters, dtype, device, &p)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int V = dtype == 0 ? 4 : 8;
  const bool row = p.row_ksl > 0;  // (for aligned tensors)
  out6[0] = row ? 0 : p.dsplit;
  out6[1] = row ? p.row_kblocks : p.kblocks;
  out6[2] = row ? W : ceil_div(W, p.rows);
  out6[3] = p.smem1;
  out6[4] = p.smem2;
  out6[5] = d % V == 0 && r % V == 0 && k % V == 0;
  return 0;
}
