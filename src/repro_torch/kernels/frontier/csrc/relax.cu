// The weighted lane's two pulls on Hopper (sm_90a), plain C interface.
//
// Both read a vertex-major (rows, B) state of B concurrent weighted
// searches through a relax plan (kernel.py build_relax_plan): the
// in-edge plan of the pull of K1 (frontier.cu frontier_pull_kernel), the
// edges' sources in destination order with each row's offsets and every
// row of more than `split` in-edges cut into items, plus the edge weights
// permuted once into the same order.  One group of lanes owns one
// destination row (or one item of a cut row): the lanes run over the B
// columns, 4 a lane with 16-byte loads when B % 4 == 0, else 1, and walk
// the row's in-edges in plan order, 4 at a time so that their loads
// overlap.  Each row is written once, no atomics; a cut row's items write
// partial rows that a combine kernel folds in item order.  Output row v
// is state row dst_offset + v: 0 on the replicated lane, the first held
// shard's first global row on the sharded lane, whose plan stacks the
// held shards' rows over global source ids.
//
// relax_pull_kernel (W1) is one delta-stepping relaxation round:
//
//   cand[v, b] = min over in-edges (u -> v) with active[u, b]
//                    of tent[u, b] + w(u, v)       (+inf when there is none)
//
// It is the counterpart of the XLA-only function
//   src/repro/kernels/frontier/ref.py: frontier_relax_batched_ref
// (the JAX package has no Pallas kernel for it).  `active` is the round's
// bucket membership, one byte a cell; a lane reads its 4 cells as one
// 4-byte load and the 4 tentative distances only on a hit.  The add is
// __fadd_rn (no contraction into anything) and min is exact and
// order-free, so every route, order and split gives the plain version's
// bits.
//
// dag_sigma_pull_kernel (W2) is one round of the shortest-path-DAG count
// on converged distances.  Edge (u -> v) is on the DAG of column b iff
// tent[u, b] is finite and tent[u, b] + w(u, v) == tent[v, b] (the exact
// float32 test of the reference's dag_sigma_batched_ref).  For every cell
// (v, b) not yet final it writes
//
//   sums[v, b]    = sum of sigma[u, b] over the on-DAG in-edges, in plan
//                   order (from +0, adding nothing for an off-DAG edge);
//   waiting[v, b] = 1 iff some on-DAG in-neighbour u is not final[u, b];
//
// and 0 / 0 where final[v, b].  The caller finalizes the cells that are
// not waiting: round k finalizes the vertices whose longest DAG path has
// k edges, so the rounds to exhaustion are the DAG's hop depth (the BFS
// level update step for step under unit weights).  It is the counterpart
// of the XLA-only dag_sigma_batched_ref, which the reference iterates to
// a fixed point that never comes once a column is rescaled.  A lane whose
// 4 cells of the row are all final walks nothing.  The sums add in a fixed
// order, so they are bitwise the plan-order plain version on any sigma.
//
// Bound on the card.  A round reads the plan (4-byte ids and weights,
// 8-byte offsets) once, the state rows of the sources it touches and
// writes (rows, B) outputs once; the compares and adds per (edge, column)
// are far below the card's arithmetic rate, so both kernels are bound by
// memory traffic.  A source's columns are read as contiguous 16-byte
// chunks of its row.
//
// Each entry point launches on the caller's stream and returns
// cudaGetLastError(); the caller raises on a non-zero code.

#include <cuda_runtime.h>
#include <math_constants.h>

namespace {

constexpr int kThreads = 256;
constexpr int kUnroll = 4;   // in-edges whose loads are in flight at once

// Lanes that share one row: every column of B <= 32 (rounded up to a
// power of two, so groups never straddle a warp), else a whole warp.
__host__ __device__ inline int row_lanes(int cols) {
  int g = 1;
  while (g < cols && g < 32) g <<= 1;
  return g;
}

template <int WIDTH>
__device__ __forceinline__ void load_cols(const float* __restrict__ p,
                                          float (&v)[WIDTH]) {
  if (WIDTH == 4) {
    const float4 t = __ldg(reinterpret_cast<const float4*>(p));
    v[0] = t.x;
    v[1] = t.y;
    v[2] = t.z;
    v[3] = t.w;
  } else {
    v[0] = __ldg(p);
  }
}

// Bit c set iff byte c of the cells at p is non-zero
template <int WIDTH>
__device__ __forceinline__ unsigned load_bits(
    const unsigned char* __restrict__ p) {
  if (WIDTH == 4) {
    const unsigned w = __ldg(reinterpret_cast<const unsigned*>(p));
    return ((w & 0xffu) != 0u) | (((w >> 8) & 0xffu) != 0u) << 1
           | (((w >> 16) & 0xffu) != 0u) << 2 | ((w >> 24) != 0u) << 3;
  }
  return __ldg(p) != 0 ? 1u : 0u;
}

template <int WIDTH>
__device__ __forceinline__ void store_cols(float* p, const float (&v)[WIDTH]) {
  if (WIDTH == 4) {
    *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
  } else {
    *p = v[0];
  }
}

template <int WIDTH>
__device__ __forceinline__ void store_bits(unsigned char* p, unsigned bits) {
  if (WIDTH == 4) {
    *reinterpret_cast<unsigned*>(p) = (bits & 1u) | (bits & 2u) << 7
                                      | (bits & 4u) << 14
                                      | (bits & 8u) << 21;
  } else {
    *p = (unsigned char)(bits & 1u);
  }
}

// The row (or item) a lane group owns: its in-edge range and the row it
// writes (an output row, or an item's partial row).  Returns false when
// the group owns nothing or a cut row, which the combine writes.
struct Unit {
  long long begin, end, out_row;  // out_row: output row, or -1 - item
  long long dst;                  // the destination's output row
};

__device__ __forceinline__ bool owned_unit(
    long long unit, const long long* __restrict__ offsets,
    const long long* __restrict__ item_begin,
    const long long* __restrict__ item_end,
    const int* __restrict__ item_row, long long n_items,
    long long plan_rows, long long split, Unit& u) {
  u.begin = 0;
  u.end = 0;
  if (unit < n_items) {
    u.begin = item_begin[unit];
    u.end = item_end[unit];
    u.out_row = -1 - unit;
    u.dst = item_row == nullptr ? -1 : item_row[unit];
    return true;
  }
  const long long v = unit - n_items;
  u.out_row = v;
  u.dst = v;
  if (v < plan_rows) {
    u.begin = offsets[v];
    u.end = offsets[v + 1];
    if (u.end - u.begin > split) return false;
  }
  return true;
}

// ---------------------------------------------------------------------------
// W1: the min-plus relaxation
// ---------------------------------------------------------------------------

template <int WIDTH>
__device__ __forceinline__ void relax_min(
    const int* __restrict__ ids, const float* __restrict__ w,
    long long begin, long long end, const float* __restrict__ tent,
    const unsigned char* __restrict__ active, int batch, int b,
    float (&acc)[WIDTH]) {
#pragma unroll
  for (int c = 0; c < WIDTH; ++c) acc[c] = CUDART_INF_F;
  for (long long e0 = begin; e0 < end; e0 += kUnroll) {
    long long u[kUnroll];
    float we[kUnroll];
    unsigned bits[kUnroll];
#pragma unroll
    for (int k = 0; k < kUnroll; ++k) {
      const bool in = e0 + k < end;
      u[k] = in ? __ldg(ids + e0 + k) : -1;
      we[k] = in ? __ldg(w + e0 + k) : 0.0f;
    }
#pragma unroll
    for (int k = 0; k < kUnroll; ++k)
      bits[k] = u[k] >= 0 ? load_bits<WIDTH>(active + u[k] * batch + b)
                          : 0u;
#pragma unroll
    for (int k = 0; k < kUnroll; ++k) {
      if (bits[k] == 0u) continue;
      float t[WIDTH];
      load_cols<WIDTH>(tent + u[k] * batch + b, t);
#pragma unroll
      for (int c = 0; c < WIDTH; ++c)
        if (bits[k] >> c & 1u) acc[c] = fminf(acc[c], __fadd_rn(t[c], we[k]));
    }
  }
}

template <int WIDTH>
__global__ void __launch_bounds__(kThreads) relax_pull_kernel(
    const long long* __restrict__ offsets, const int* __restrict__ ids,
    const float* __restrict__ w, const long long* __restrict__ item_begin,
    const long long* __restrict__ item_end, long long n_items,
    const float* __restrict__ tent, const unsigned char* __restrict__ active,
    float* __restrict__ out, float* __restrict__ partial, long long out_rows,
    long long plan_rows, long long split, int batch) {
  const int lanes = row_lanes(batch / WIDTH);
  const long long unit =
      ((long long)blockIdx.x * blockDim.x + threadIdx.x) / lanes;
  const int lane = threadIdx.x % lanes;
  if (unit >= n_items + out_rows) return;
  Unit u;
  if (!owned_unit(unit, offsets, item_begin, item_end, nullptr, n_items,
                  plan_rows, split, u))
    return;
  float* row = u.out_row >= 0 ? out + u.out_row * batch
                              : partial + (-1 - u.out_row) * batch;
  for (int b = lane * WIDTH; b < batch; b += lanes * WIDTH) {
    float acc[WIDTH];
    relax_min<WIDTH>(ids, w, u.begin, u.end, tent, active, batch, b, acc);
    store_cols<WIDTH>(row + b, acc);
  }
}

// One group per cut row: the min of its items' partial rows
template <int WIDTH>
__global__ void __launch_bounds__(kThreads) relax_pull_combine_kernel(
    const int* __restrict__ split_row,
    const long long* __restrict__ split_first, long long n_split,
    const float* __restrict__ partial, float* __restrict__ out, int batch) {
  const int lanes = row_lanes(batch / WIDTH);
  const long long q =
      ((long long)blockIdx.x * blockDim.x + threadIdx.x) / lanes;
  const int lane = threadIdx.x % lanes;
  if (q >= n_split) return;
  const long long p0 = split_first[q], p1 = split_first[q + 1];
  float* row = out + (long long)split_row[q] * batch;
  for (int b = lane * WIDTH; b < batch; b += lanes * WIDTH) {
    float4 acc = make_float4(CUDART_INF_F, CUDART_INF_F, CUDART_INF_F,
                             CUDART_INF_F);
    for (long long p = p0; p < p1; ++p) {
      const float* part = partial + p * batch + b;
      if (WIDTH == 4) {
        const float4 x = *reinterpret_cast<const float4*>(part);
        acc.x = fminf(acc.x, x.x);
        acc.y = fminf(acc.y, x.y);
        acc.z = fminf(acc.z, x.z);
        acc.w = fminf(acc.w, x.w);
      } else {
        acc.x = fminf(acc.x, *part);
      }
    }
    if (WIDTH == 4) {
      *reinterpret_cast<float4*>(row + b) = acc;
    } else {
      row[b] = acc.x;
    }
  }
}

// ---------------------------------------------------------------------------
// W2: one round of the DAG count
// ---------------------------------------------------------------------------

// The on-DAG sum and waiting bits of the in-edges [begin, end) for the
// columns in `todo` (the cells not final); `tv` the destination's tent
template <int WIDTH>
__device__ __forceinline__ void dag_sum(
    const int* __restrict__ ids, const float* __restrict__ w,
    long long begin, long long end, const float* __restrict__ tent,
    const float* __restrict__ sigma, const unsigned char* __restrict__ final,
    int batch, int b, const float (&tv)[WIDTH], unsigned todo,
    float (&acc)[WIDTH], unsigned& wait) {
#pragma unroll
  for (int c = 0; c < WIDTH; ++c) acc[c] = 0.0f;
  wait = 0u;
  if (todo == 0u) return;
  for (long long e0 = begin; e0 < end; e0 += kUnroll) {
    long long u[kUnroll];
    float we[kUnroll];
    float tu[kUnroll][WIDTH];
#pragma unroll
    for (int k = 0; k < kUnroll; ++k) {
      const bool in = e0 + k < end;
      u[k] = in ? __ldg(ids + e0 + k) : -1;
      we[k] = in ? __ldg(w + e0 + k) : 0.0f;
    }
#pragma unroll
    for (int k = 0; k < kUnroll; ++k) {
      if (u[k] >= 0) {
        load_cols<WIDTH>(tent + u[k] * batch + b, tu[k]);
      } else {
#pragma unroll
        for (int c = 0; c < WIDTH; ++c) tu[k][c] = CUDART_INF_F;
      }
    }
#pragma unroll
    for (int k = 0; k < kUnroll; ++k) {
      unsigned on = 0u;
#pragma unroll
      for (int c = 0; c < WIDTH; ++c)
        on |= (unsigned)(isfinite(tu[k][c])
                         && __fadd_rn(tu[k][c], we[k]) == tv[c]) << c;
      on &= todo;
      if (on == 0u) continue;
      float s[WIDTH];
      load_cols<WIDTH>(sigma + u[k] * batch + b, s);
      wait |= on & ~load_bits<WIDTH>(final + u[k] * batch + b);
#pragma unroll
      for (int c = 0; c < WIDTH; ++c)
        if (on >> c & 1u) acc[c] += s[c];
    }
  }
}

template <int WIDTH>
__global__ void __launch_bounds__(kThreads) dag_sigma_pull_kernel(
    const long long* __restrict__ offsets, const int* __restrict__ ids,
    const float* __restrict__ w, const long long* __restrict__ item_begin,
    const long long* __restrict__ item_end, const int* __restrict__ item_row,
    long long n_items, const float* __restrict__ tent,
    const float* __restrict__ sigma, const unsigned char* __restrict__ final,
    float* __restrict__ sums, unsigned char* __restrict__ waiting,
    float* __restrict__ psums, unsigned char* __restrict__ pwait,
    long long out_rows, long long plan_rows, long long split, int batch,
    long long dst_offset) {
  const int lanes = row_lanes(batch / WIDTH);
  const long long unit =
      ((long long)blockIdx.x * blockDim.x + threadIdx.x) / lanes;
  const int lane = threadIdx.x % lanes;
  if (unit >= n_items + out_rows) return;
  Unit u;
  if (!owned_unit(unit, offsets, item_begin, item_end, item_row, n_items,
                  plan_rows, split, u))
    return;
  const bool item = u.out_row < 0;
  const long long o = item ? (-1 - u.out_row) * batch : u.out_row * batch;
  const long long g = (dst_offset + u.dst) * batch;   // the state's row
  for (int b = lane * WIDTH; b < batch; b += lanes * WIDTH) {
    const unsigned todo = ~load_bits<WIDTH>(final + g + b)
                          & ((1u << WIDTH) - 1u);
    float tv[WIDTH];
    load_cols<WIDTH>(tent + g + b, tv);
    float acc[WIDTH];
    unsigned wait;
    dag_sum<WIDTH>(ids, w, u.begin, u.end, tent, sigma, final, batch, b, tv,
                   todo, acc, wait);
    store_cols<WIDTH>((item ? psums : sums) + o + b, acc);
    store_bits<WIDTH>((item ? pwait : waiting) + o + b, wait);
  }
}

// One group per cut row: its items' partial sums added in item order, the
// waiting bits or-ed; 0 / 0 where the cell is final
template <int WIDTH>
__global__ void __launch_bounds__(kThreads) dag_sigma_pull_combine_kernel(
    const int* __restrict__ split_row,
    const long long* __restrict__ split_first, long long n_split,
    const float* __restrict__ psums, const unsigned char* __restrict__ pwait,
    const unsigned char* __restrict__ final, float* __restrict__ sums,
    unsigned char* __restrict__ waiting, int batch, long long dst_offset) {
  const int lanes = row_lanes(batch / WIDTH);
  const long long q =
      ((long long)blockIdx.x * blockDim.x + threadIdx.x) / lanes;
  const int lane = threadIdx.x % lanes;
  if (q >= n_split) return;
  const long long p0 = split_first[q], p1 = split_first[q + 1];
  const long long v = split_row[q];
  for (int b = lane * WIDTH; b < batch; b += lanes * WIDTH) {
    const unsigned todo =
        ~load_bits<WIDTH>(final + (dst_offset + v) * batch + b)
        & ((1u << WIDTH) - 1u);
    float acc[WIDTH];
#pragma unroll
    for (int c = 0; c < WIDTH; ++c) acc[c] = 0.0f;
    unsigned wait = 0u;
    for (long long p = p0; p < p1; ++p) {
      float x[WIDTH];
      load_cols<WIDTH>(psums + p * batch + b, x);
#pragma unroll
      for (int c = 0; c < WIDTH; ++c) acc[c] += x[c];
      wait |= load_bits<WIDTH>(pwait + p * batch + b);
    }
#pragma unroll
    for (int c = 0; c < WIDTH; ++c)
      if (!(todo >> c & 1u)) acc[c] = 0.0f;
    store_cols<WIDTH>(sums + v * batch + b, acc);
    store_bits<WIDTH>(waiting + v * batch + b, wait & todo);
  }
}

long long grid_of(long long units, int batch, int width) {
  const int groups = kThreads / row_lanes(batch / width);
  return (units + groups - 1) / groups;
}

bool aligned(const void* p, unsigned long long to) {
  return ((unsigned long long)p & (to - 1ull)) == 0ull;
}

template <int WIDTH>
int relax_launch(const long long* offsets, const int* ids, const float* w,
                 const long long* item_begin, const long long* item_end,
                 long long n_items, const int* split_row,
                 const long long* split_first, long long n_split,
                 const float* tent, const unsigned char* active, float* out,
                 float* partial, long long out_rows, long long plan_rows,
                 long long split, int batch, cudaStream_t stream) {
  const long long blocks = grid_of(n_items + out_rows, batch, WIDTH);
  const long long combine = grid_of(n_split, batch, WIDTH);
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidConfiguration;
  if (blocks > 0) {
    relax_pull_kernel<WIDTH><<<(unsigned)blocks, kThreads, 0, stream>>>(
        offsets, ids, w, item_begin, item_end, n_items, tent, active, out,
        partial, out_rows, plan_rows, split, batch);
  }
  if (combine > 0) {
    relax_pull_combine_kernel<WIDTH>
        <<<(unsigned)combine, kThreads, 0, stream>>>(
            split_row, split_first, n_split, partial, out, batch);
  }
  return (int)cudaGetLastError();
}

template <int WIDTH>
int dag_launch(const long long* offsets, const int* ids, const float* w,
               const long long* item_begin, const long long* item_end,
               const int* item_row, long long n_items, const int* split_row,
               const long long* split_first, long long n_split,
               const float* tent, const float* sigma,
               const unsigned char* final, float* sums,
               unsigned char* waiting, float* psums, unsigned char* pwait,
               long long out_rows, long long plan_rows, long long split,
               int batch, long long dst_offset, cudaStream_t stream) {
  const long long blocks = grid_of(n_items + out_rows, batch, WIDTH);
  const long long combine = grid_of(n_split, batch, WIDTH);
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidConfiguration;
  if (blocks > 0) {
    dag_sigma_pull_kernel<WIDTH><<<(unsigned)blocks, kThreads, 0, stream>>>(
        offsets, ids, w, item_begin, item_end, item_row, n_items, tent,
        sigma, final, sums, waiting, psums, pwait, out_rows, plan_rows,
        split, batch, dst_offset);
  }
  if (combine > 0) {
    dag_sigma_pull_combine_kernel<WIDTH>
        <<<(unsigned)combine, kThreads, 0, stream>>>(
            split_row, split_first, n_split, psums, pwait, final, sums,
            waiting, batch, dst_offset);
  }
  return (int)cudaGetLastError();
}

}  // namespace

// One relaxation round (W1): relax_pull_kernel, then the combine when a
// row is cut, on `stream`.  The plan covers output rows [0, plan_rows) of
// `out_rows`; later rows are +inf.  `partial` holds max(n_items, 1) rows
// of B float32.
extern "C" int relax_pull_launch(
    const void* offsets, const void* ids, const void* w,
    const void* item_begin, const void* item_end, long long n_items,
    const void* split_row, const void* split_first, long long n_split,
    const void* tent, const void* active, void* out, void* partial,
    long long out_rows, long long plan_rows, long long split, int batch,
    void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (out_rows <= 0 || batch <= 0) return (int)cudaGetLastError();
  const bool vec = batch % 4 == 0 && aligned(tent, 16) && aligned(out, 16)
                   && aligned(partial, 16) && aligned(active, 4);
  auto* off = (const long long*)offsets;
  auto* id = (const int*)ids;
  auto* wt = (const float*)w;
  auto* ib = (const long long*)item_begin;
  auto* ie = (const long long*)item_end;
  auto* sr = (const int*)split_row;
  auto* sf = (const long long*)split_first;
  auto* t = (const float*)tent;
  auto* a = (const unsigned char*)active;
  if (vec) {
    return relax_launch<4>(off, id, wt, ib, ie, n_items, sr, sf, n_split, t,
                           a, (float*)out, (float*)partial, out_rows,
                           plan_rows, split, batch, s);
  }
  return relax_launch<1>(off, id, wt, ib, ie, n_items, sr, sf, n_split, t, a,
                         (float*)out, (float*)partial, out_rows, plan_rows,
                         split, batch, s);
}

// One round of the DAG count (W2): dag_sigma_pull_kernel, then the combine
// when a row is cut, on `stream`.  Output row v reads the destination's
// state row dst_offset + v; `psums` and `pwait` hold max(n_items, 1) rows.
extern "C" int dag_sigma_pull_launch(
    const void* offsets, const void* ids, const void* w,
    const void* item_begin, const void* item_end, const void* item_row,
    long long n_items, const void* split_row, const void* split_first,
    long long n_split, const void* tent, const void* sigma,
    const void* final, void* sums, void* waiting, void* psums, void* pwait,
    long long out_rows, long long plan_rows, long long split, int batch,
    long long dst_offset, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (out_rows <= 0 || batch <= 0) return (int)cudaGetLastError();
  const bool vec = batch % 4 == 0 && aligned(tent, 16) && aligned(sigma, 16)
                   && aligned(sums, 16) && aligned(psums, 16)
                   && aligned(final, 4) && aligned(waiting, 4)
                   && aligned(pwait, 4);
  auto* off = (const long long*)offsets;
  auto* id = (const int*)ids;
  auto* wt = (const float*)w;
  auto* ib = (const long long*)item_begin;
  auto* ie = (const long long*)item_end;
  auto* ir = (const int*)item_row;
  auto* sr = (const int*)split_row;
  auto* sf = (const long long*)split_first;
  auto* t = (const float*)tent;
  auto* sg = (const float*)sigma;
  auto* f = (const unsigned char*)final;
  if (vec) {
    return dag_launch<4>(off, id, wt, ib, ie, ir, n_items, sr, sf, n_split,
                         t, sg, f, (float*)sums, (unsigned char*)waiting,
                         (float*)psums, (unsigned char*)pwait, out_rows,
                         plan_rows, split, batch, dst_offset, s);
  }
  return dag_launch<1>(off, id, wt, ib, ie, ir, n_items, sr, sf, n_split, t,
                       sg, f, (float*)sums, (unsigned char*)waiting,
                       (float*)psums, (unsigned char*)pwait, out_rows,
                       plan_rows, split, batch, dst_offset, s);
}
