// Batched BFS frontier expansion on Hopper (sm_90a), plain C interface.
//
// Both routes compute one level of B concurrent BFS searches over a
// vertex-major (rows, B) state:
//
//   out[v, b] = sum of sigma[src[e], b]  over the edges e with dst[e] == v
//                                        and dist[src[e], b] == levels[b]
//
// Sink and padding rows hold dist -3, which no level equals, so padded
// edges (sink to sink) add nothing.  Both routes start with the words
// pass, frontier_words_kernel: it reads dist once and writes the frontier
// words, words[v, w] bit c set iff dist[v, 32 w + c] == levels[32 w + c]
// (W = ceil(B / 32) words a row).  An edge then asks "is my source on
// any frontier, and on which columns" with one 4-byte load, not a B-wide
// dist row: at R-MAT 2^20, B=64 the words are 8.4 MB, which the 50 MB L2
// holds.  Where B divides 32 or 32 divides B, each warp reads 32
// consecutive dist cells, coalesced, and one __ballot_sync makes the
// words; other B take one thread a word.  The node-blocked route has the
// pass write the zeros of `out` as well; the pull writes every output row
// itself and passes no `out`.
//
// frontier_pull_kernel replaces the TPU kernel
//   src/repro/kernels/frontier/kernel.py: frontier_expand_batched_pallas
// (body _flat_kernel).  The TPU pins the whole state in VMEM and scatters
// an edge block through a one-hot MXU matmul into one output tile that
// its sequential grid revisits.  The card's blocks run in no order, so
// the level is a pull over a plan built once per graph (kernel.py
// build_pull_plan, the gather-segment-sum kernel's segment plan): the
// edges' sources in destination order and each row's offsets.  One group
// of lanes owns one destination row: the lanes run over the B columns,
// 4 a lane with float4 loads when B % 4 == 0 (16 lanes at B=64), else 1.
// The group walks the row's sources in order, 4 at a time so that their
// loads overlap: each source's word of this lane's columns, then, only
// on a hit, its sigma columns, added in registers under the bits.  Then
// it writes the row once: no atomics and no zero pass; a row without
// in-edges, or past the plan's rows, is written as zeros.  R-MAT's hubs
// have in-degrees near 1e5, which would leave one group serial over them:
// a row with more than `split` in-edges is cut into items of at most
// `split`, one group an item writing a float32 partial row, and
// frontier_pull_combine_kernel adds each such row's partials in item
// order.  Both orders are fixed, so every run gives the same bits.
//
// frontier_nb_kernel replaces the TPU kernel
//   src/repro/kernels/frontier/kernel.py: frontier_expand_node_blocked_pallas
// (body _nb_kernel) on its replicated route (not wide_state).  A level is
// two launches:
//
// 1. the words pass, which also writes the zeros of `out`;
// 2. frontier_nb_kernel: one thread block per edge block of the
//    node-blocked CSC layout.  It stages the block's source and
//    destination ids in shared memory with 16-byte loads, reads each
//    staged source's words, marks the edges whose source is on no
//    frontier, and decides the TPU's block skip itself, exactly, with
//    __syncthreads_or: a block with no hit returns.  Then it sorts its
//    edges by destination, 1024 at a time: one key an edge, the
//    destination's offset in the edge block's node block above the
//    edge's slot, through a bitonic network (4 slots a thread in
//    registers, shuffles within a warp, shared memory across warps); the
//    misses sort last.  A group of lanes (2 at B=8, 16 at B=64: each
//    lane 4 columns when B % 4 == 0, with float4 sigma reads and float4
//    atomics, which Hopper has; else 1) walks a contiguous run of the
//    sorted hits, summing each destination's edges in registers and
//    adding the sum into out[dst, b..] once.  The reads and atomics of
//    an edge are row-contiguous, and no dist row is read.  The sort is
//    for R-MAT's hubs: an edge block holds some hundred edges into one
//    hub row, and one atomic an edge put them all on that row's L2
//    lines.  On a graph without hubs the sort costs more than it saves
//    (tools/frontier_nb_probe.py times the variants).
//
// The TPU's DMA double-buffering, staged source tiles and one-hot matmuls
// are fast-memory devices the card does not need: the output is zeroed by
// the words pass (in place of block_first zeroing) and accumulated in
// device memory.
//
// Bound on the card.  A level moves at least E * 8 bytes of edge indices
// plus (V+1) * B * 12 bytes of dist, sigma and out; it does E * B
// compares and at most E * B adds, far below the card's arithmetic rate,
// so both routes are bound by memory traffic.  Both replace the per-edge
// dist row (B * 4 bytes) by the source's words (W * 4 bytes), so only
// frontier hits touch sigma, and both read a source's sigma columns as
// one contiguous row.  The pull also writes each output row once, where
// the node-blocked route sums a destination's hits before one atomic.
//
// Float sums: the pull adds in a fixed order, so it gives the same bits
// on every run; the node-blocked route's atomics add in an order that
// varies from run to run.  While sigma holds exact integers below 2^24
// every order gives the same bits; beyond that results agree to float32
// rounding (rtol 1e-6).
//
// Each entry point launches on the caller's stream and returns
// cudaGetLastError(); the caller raises on a non-zero code.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxGrid = 132 * 64;  // SMs x resident blocks, grid-stride

// `out` may be null: then the pass writes only the words.
__global__ void frontier_words_kernel(const int* __restrict__ dist,
                                      const int* __restrict__ levels,
                                      unsigned* __restrict__ words,
                                      float* __restrict__ out,
                                      long long rows, int batch,
                                      int n_words, int by_warp) {
  const long long tid = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const long long stride = (long long)gridDim.x * blockDim.x;
  if (by_warp) {
    // B % 32 == 0 or 32 % B == 0: the 32 cells a warp reads (flat
    // index i = 32 * warp + lane) are whole words, so one ballot makes
    // them.  `base` is warp-uniform, so every lane takes each ballot.
    const long long n = rows * batch;
    const int lane = threadIdx.x & 31;
    for (long long base = tid - lane; base < n; base += stride) {
      const long long i = base + lane;
      int b;
      if (batch >= 32) {
        b = (int)((unsigned)(base >> 5) % (unsigned)n_words) * 32 + lane;
      } else {
        b = lane & (batch - 1);
      }
      bool hit = false;
      if (i < n) {
        hit = dist[i] == __ldg(levels + b);
        if (out != nullptr) out[i] = 0.0f;
      }
      const unsigned ballot = __ballot_sync(0xffffffffu, hit);
      if (batch >= 32) {
        if (lane == 0) words[base / 32] = ballot;
      } else if (b == 0 && i < n) {
        words[i / batch] = (ballot >> lane) & ((1u << batch) - 1u);
      }
    }
    return;
  }
  // any other B: one thread a (row, word)
  for (long long i = tid; i < rows * n_words; i += stride) {
    const long long v = i / n_words;
    const int b0 = (int)(i - v * n_words) * 32;
    const int nb = min(32, batch - b0);
    const int* d = dist + v * batch + b0;
    unsigned bits = 0u;
    for (int c = 0; c < nb; ++c) {
      bits |= (unsigned)(d[c] == __ldg(levels + b0 + c)) << c;
      if (out != nullptr) out[v * batch + b0 + c] = 0.0f;
    }
    words[i] = bits;
  }
}

// Lanes that share one edge or one row: every column of B <= 32 (rounded
// up to a power of two, so groups never straddle a warp), else a whole
// warp.
__host__ __device__ inline int edge_lanes(int batch) {
  int g = 1;
  while (g < batch && g < 32) g <<= 1;
  return g;
}

// Is row u on any frontier?
__device__ __forceinline__ bool on_frontier(const unsigned* __restrict__ words,
                                            int u, int n_words) {
  if (n_words == 1) return __ldg(words + u) != 0u;
  if (n_words == 2) {
    const uint2 w = __ldg(reinterpret_cast<const uint2*>(words) + u);
    return (w.x | w.y) != 0u;
  }
  unsigned w = 0u;
  for (int k = 0; k < n_words; ++k)
    w |= __ldg(words + (long long)u * n_words + k);
  return w != 0u;
}

constexpr int kSortSlots = 4 * kThreads;   // edges sorted at once
constexpr int kSlotBits = 10;              // log2(kSortSlots)

// slots lo < hi of this thread: the lower keeps the smaller key
__device__ __forceinline__ void order_pair(int (&k)[4], int lo, int hi) {
  const int a = k[lo], b = k[hi];
  k[lo] = min(a, b);
  k[hi] = max(a, b);
}

// Sorts key[0, n), n <= kSortSlots, in shared memory, ascending: a
// bitonic network over kSortSlots slots whose keys past n count as +inf
// (they never move: every pair keeps the smaller key at the lower slot).
// Each thread holds 4 consecutive slots in registers; steps within a
// thread run in registers, steps within a warp through shuffles, and the
// 6 of 55 that cross warps through shared memory.  Every thread of the
// block calls it.
__device__ void sort_block(int* key, int n) {
  const int t = threadIdx.x;
  int k[4];
#pragma unroll
  for (int e = 0; e < 4; ++e)
    k[e] = 4 * t + e < n ? key[4 * t + e] : 0x7fffffff;
  for (int size = 2; size <= kSortSlots; size <<= 1) {
    for (int d = size >> 1; d > 0; d >>= 1) {
      // the first step of a stage pairs a slot with its mirror in the
      // size-block, the others with the slot d away
      const bool mirror = d == (size >> 1);
      const int m = mirror ? size - 1 : d;       // partner slot = i ^ m
      if (m < 4) {
        if (m == 1) {
          order_pair(k, 0, 1);
          order_pair(k, 2, 3);
        } else if (m == 2) {
          order_pair(k, 0, 2);
          order_pair(k, 1, 3);
        } else {
          order_pair(k, 0, 3);
          order_pair(k, 1, 2);
        }
        continue;
      }
      // the partner of slot 4 t + e is slot e ^ 3 (mirror) or e of
      // thread t ^ (m >> 2)
      int pk[4];
      if ((m >> 2) < 32) {
#pragma unroll
        for (int e = 0; e < 4; ++e)
          pk[e] = __shfl_xor_sync(0xffffffffu, mirror ? k[e ^ 3] : k[e],
                                  m >> 2);
      } else {
        __syncthreads();
#pragma unroll
        for (int e = 0; e < 4; ++e)
          if (4 * t + e < n) key[4 * t + e] = k[e];
        __syncthreads();
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int j = (4 * t + e) ^ m;
          pk[e] = j < n ? key[j] : 0x7fffffff;
        }
      }
      const int high = mirror ? size >> 1 : d;   // clear in the lower slot
#pragma unroll
      for (int e = 0; e < 4; ++e)
        k[e] = ((4 * t + e) & high) == 0 ? min(k[e], pk[e])
                                          : max(k[e], pk[e]);
    }
  }
  __syncthreads();
#pragma unroll
  for (int e = 0; e < 4; ++e)
    if (4 * t + e < n) key[4 * t + e] = k[e];
  __syncthreads();
}

// out[v, b .. b + width) += acc
__device__ __forceinline__ void add_row(float* out, long long dst_row, int b,
                                        const float4& acc, int width) {
  if (width == 4) {
    atomicAdd(reinterpret_cast<float4*>(out + dst_row + b), acc);
  } else {
    atomicAdd(out + dst_row + b, acc.x);
  }
}

__global__ void __launch_bounds__(kThreads)
frontier_nb_kernel(const int* __restrict__ csc_src,
                   const int* __restrict__ csc_dst,
                   const unsigned* __restrict__ words,
                   const int* __restrict__ block_nb,
                   const float* __restrict__ sigma, float* __restrict__ out,
                   int block_e, int block_v, int batch, int n_words,
                   int vec_ids, int vec_cols) {
  // this edge block's ids; an edge whose source is on no frontier gets
  // the key INT_MAX, which sorts it past every hit
  extern __shared__ int stage[];
  int* s_src = stage;
  int* s_dst = stage + block_e;
  const long long base = (long long)blockIdx.x * block_e;
  int any = 0;
  auto put = [&](int e, int u, int v) {
    const bool hit = on_frontier(words, u, n_words);
    any |= hit;
    s_src[e] = u;
    s_dst[e] = hit ? v : 0x7fffffff;
  };
  for (int e = threadIdx.x * 4; e < block_e; e += kThreads * 4) {
    if (vec_ids && e + 4 <= block_e) {
      const int4 u = __ldg(reinterpret_cast<const int4*>(csc_src + base + e));
      const int4 v = __ldg(reinterpret_cast<const int4*>(csc_dst + base + e));
      put(e, u.x, v.x);
      put(e + 1, u.y, v.y);
      put(e + 2, u.z, v.z);
      put(e + 3, u.w, v.w);
    } else {
      for (int j = e; j < e + 4 && j < block_e; ++j)
        put(j, __ldg(csc_src + base + j), __ldg(csc_dst + base + j));
    }
  }
  // the exact block skip: no edge of this block has a frontier source
  if (!__syncthreads_or(any)) return;

  // The block's edges go in chunks of kSortSlots, each sorted by
  // destination (the misses sort past every hit).  A group of lanes
  // takes a contiguous run of a chunk's hits, each lane 4 columns when
  // B % 4 == 0 (float4 sigma reads and float4 atomics, which Hopper has)
  // and 1 otherwise.  It sums each destination's edges in registers and
  // adds the sum once, when the destination changes.
  const int width = vec_cols ? 4 : 1;
  const int lanes = edge_lanes(batch / width);
  const int slots = kThreads / lanes;
  const int lane = threadIdx.x % lanes;
  const unsigned mask = (1u << width) - 1u;
  // the sort's key: (destination - node block start) << kSlotBits | slot,
  // which fits an int below node blocks of 2^21 rows (the card's are
  // 2^14); wider ones walk their edges unsorted
  const bool sorted = block_v < (1 << (31 - kSlotBits));
  const int v0 = block_nb[blockIdx.x] * block_v;
  for (int c0 = 0; c0 < block_e; c0 += kSortSlots) {
    const int n = min(kSortSlots, block_e - c0);
    int n_walk = n;
    if (sorted) {
      for (int i = threadIdx.x; i < n; i += kThreads) {
        const int v = s_dst[c0 + i];
        if (v != 0x7fffffff) s_dst[c0 + i] = (v - v0) << kSlotBits | i;
      }
      __syncthreads();
      sort_block(s_dst + c0, n);
      // the hits lead the sorted chunk: the groups split them evenly
      n_walk = 0;
      for (int step = kSortSlots; step > 0; step >>= 1) {
        if (n_walk + step <= n
            && s_dst[c0 + n_walk + step - 1] != 0x7fffffff)
          n_walk += step;
      }
    }
    const int run = (n_walk + slots - 1) / slots;
    const int lo = c0 + threadIdx.x / lanes * run;
    const int hi = min(c0 + n_walk, lo + run);
    for (int b = lane * width; b < batch; b += lanes * width) {
      float4 acc = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      int cur = -1;
      bool pending = false;
      for (int e = lo; e < hi; ++e) {
        const int key = s_dst[e];
        if (key == 0x7fffffff) continue;
        const int v = sorted ? v0 + (key >> kSlotBits) : key;
        const long long u = sorted ? s_src[c0 + (key & (kSortSlots - 1))]
                                   : s_src[e];
        if (v != cur) {
          if (pending) add_row(out, (long long)cur * batch, b, acc, width);
          acc = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
          cur = v;
          pending = false;
        }
        const unsigned bits =
            (__ldg(words + u * n_words + (b >> 5)) >> (b & 31)) & mask;
        if (bits == 0u) continue;
        pending = true;
        if (width == 4) {
          const float4 x =
              __ldg(reinterpret_cast<const float4*>(sigma + u * batch + b));
          // +0 where a bit is clear, as the plain version's +0 terms
          acc.x += bits & 1u ? x.x : 0.0f;
          acc.y += bits & 2u ? x.y : 0.0f;
          acc.z += bits & 4u ? x.z : 0.0f;
          acc.w += bits & 8u ? x.w : 0.0f;
        } else {
          acc.x += __ldg(sigma + u * batch + b);
        }
      }
      if (pending) add_row(out, (long long)cur * batch, b, acc, width);
    }
  }
}

// ---------------------------------------------------------------------------
// The pull (K1)
// ---------------------------------------------------------------------------

constexpr int kPullUnroll = 4;   // sources whose loads are in flight at once

// The bits of columns b .. b + popcount(mask) - 1 of row u's frontier
__device__ __forceinline__ unsigned frontier_bits(
    const unsigned* __restrict__ words, long long u, int n_words, int b,
    unsigned mask) {
  return (__ldg(words + u * n_words + (b >> 5)) >> (b & 31)) & mask;
}

// The frontier-masked sum of sigma[u, b .. b + WIDTH) over the sources
// u = src_sorted[begin .. end), added in that order
template <int WIDTH>
__device__ __forceinline__ float4 pull_sum(
    const int* __restrict__ src_sorted, long long begin, long long end,
    const unsigned* __restrict__ words, const float* __restrict__ sigma,
    int batch, int n_words, int b) {
  constexpr unsigned mask = (1u << WIDTH) - 1u;
  float4 acc = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  for (long long e0 = begin; e0 < end; e0 += kPullUnroll) {
    long long u[kPullUnroll];
    unsigned bits[kPullUnroll];
    float4 x[kPullUnroll];
#pragma unroll
    for (int k = 0; k < kPullUnroll; ++k)
      u[k] = e0 + k < end ? __ldg(src_sorted + e0 + k) : -1;
#pragma unroll
    for (int k = 0; k < kPullUnroll; ++k)
      bits[k] = u[k] >= 0 ? frontier_bits(words, u[k], n_words, b, mask)
                          : 0u;
#pragma unroll
    for (int k = 0; k < kPullUnroll; ++k) {
      x[k] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      if (bits[k] != 0u) {
        if (WIDTH == 4) {
          x[k] = __ldg(reinterpret_cast<const float4*>(sigma + u[k] * batch
                                                       + b));
        } else {
          x[k].x = __ldg(sigma + u[k] * batch + b);
        }
      }
    }
    // +0 where a bit is clear, as the plain version's +0 terms
#pragma unroll
    for (int k = 0; k < kPullUnroll; ++k) {
      if (bits[k] == 0u) continue;
      acc.x += bits[k] & 1u ? x[k].x : 0.0f;
      if (WIDTH == 4) {
        acc.y += bits[k] & 2u ? x[k].y : 0.0f;
        acc.z += bits[k] & 4u ? x[k].z : 0.0f;
        acc.w += bits[k] & 8u ? x[k].w : 0.0f;
      }
    }
  }
  return acc;
}

template <int WIDTH>
__device__ __forceinline__ void store_cols(float* p, const float4& v) {
  if (WIDTH == 4) {
    *reinterpret_cast<float4*>(p) = v;
  } else {
    *p = v.x;
  }
}

// Groups [0, n_items) sum one item of a split row into its partial row;
// groups [n_items, n_items + rows) own one output row each: a row of at
// most `split` in-edges is summed and written, a longer one is left to
// frontier_pull_combine_kernel, a row at or past plan_rows is zeros.
template <int WIDTH>
__global__ void __launch_bounds__(kThreads) frontier_pull_kernel(
    const long long* __restrict__ offsets,
    const int* __restrict__ src_sorted,
    const long long* __restrict__ item_begin,
    const long long* __restrict__ item_end, long long n_items,
    const unsigned* __restrict__ words, const float* __restrict__ sigma,
    float* __restrict__ out, float* __restrict__ partial, long long rows,
    long long plan_rows, long long split, int batch, int n_words) {
  const int lanes = edge_lanes(batch / WIDTH);
  const long long unit =
      ((long long)blockIdx.x * blockDim.x + threadIdx.x) / lanes;
  const int lane = threadIdx.x % lanes;
  if (unit >= n_items + rows) return;
  long long begin = 0, end = 0;
  float* row;
  if (unit < n_items) {
    begin = item_begin[unit];
    end = item_end[unit];
    row = partial + unit * batch;
  } else {
    const long long v = unit - n_items;
    row = out + v * batch;
    if (v < plan_rows) {
      begin = offsets[v];
      end = offsets[v + 1];
      if (end - begin > split) return;
    }
  }
  for (int b = lane * WIDTH; b < batch; b += lanes * WIDTH) {
    store_cols<WIDTH>(row + b, pull_sum<WIDTH>(src_sorted, begin, end, words,
                                               sigma, batch, n_words, b));
  }
}

// One group per split row: its items' partial rows split_first[q] ..
// split_first[q+1] - 1, added in item order.
template <int WIDTH>
__global__ void __launch_bounds__(kThreads) frontier_pull_combine_kernel(
    const int* __restrict__ split_row,
    const long long* __restrict__ split_first, long long n_split,
    const float* __restrict__ partial, float* __restrict__ out, int batch) {
  const int lanes = edge_lanes(batch / WIDTH);
  const long long q =
      ((long long)blockIdx.x * blockDim.x + threadIdx.x) / lanes;
  const int lane = threadIdx.x % lanes;
  if (q >= n_split) return;
  const long long p0 = split_first[q], p1 = split_first[q + 1];
  float* row = out + (long long)split_row[q] * batch;
  for (int b = lane * WIDTH; b < batch; b += lanes * WIDTH) {
    float4 acc = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    for (long long p = p0; p < p1; ++p) {
      const float* part = partial + p * batch + b;
      if (WIDTH == 4) {
        const float4 x = *reinterpret_cast<const float4*>(part);
        acc.x += x.x;
        acc.y += x.y;
        acc.z += x.z;
        acc.w += x.w;
      } else {
        acc.x += *part;
      }
    }
    store_cols<WIDTH>(row + b, acc);
  }
}

template <int WIDTH>
int pull_launch(const long long* offsets, const int* src_sorted,
                const long long* item_begin, const long long* item_end,
                long long n_items, const int* split_row,
                const long long* split_first, long long n_split,
                const unsigned* words, const float* sigma, float* out,
                float* partial, long long rows, long long plan_rows,
                long long split, int batch, cudaStream_t stream) {
  const int groups = kThreads / edge_lanes(batch / WIDTH);
  const long long blocks = (n_items + rows + groups - 1) / groups;
  const long long combine_blocks = (n_split + groups - 1) / groups;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidConfiguration;
  const int n_words = (batch + 31) / 32;
  if (blocks > 0) {
    frontier_pull_kernel<WIDTH><<<(unsigned)blocks, kThreads, 0, stream>>>(
        offsets, src_sorted, item_begin, item_end, n_items, words, sigma,
        out, partial, rows, plan_rows, split, batch, n_words);
  }
  if (combine_blocks > 0) {
    frontier_pull_combine_kernel<WIDTH>
        <<<(unsigned)combine_blocks, kThreads, 0, stream>>>(
            split_row, split_first, n_split, partial, out, batch);
  }
  return (int)cudaGetLastError();
}

int words_launch(const void* dist, const void* levels, void* words,
                 void* out, long long rows, int batch, cudaStream_t stream) {
  if (rows > 0 && batch > 0) {
    const int n_words = (batch + 31) / 32;
    // the ballot route's 32-bit word arithmetic holds below 2^37 cells
    const int by_warp = (batch % 32 == 0 || 32 % batch == 0)
        && rows * batch < (1ll << 37);
    const long long work = by_warp ? rows * batch : rows * n_words;
    long long blocks = (work + kThreads - 1) / kThreads;
    const int grid = (int)(blocks < kMaxGrid ? blocks : kMaxGrid);
    frontier_words_kernel<<<grid, kThreads, 0, stream>>>(
        (const int*)dist, (const int*)levels, (unsigned*)words, (float*)out,
        rows, batch, n_words, by_warp);
  }
  return (int)cudaGetLastError();
}

int nb_launch(const void* csc_src, const void* csc_dst,
              const void* block_nb, const void* words, const void* sigma,
              void* out, int n_edge_blocks, int block_e, int block_v,
              int batch, cudaStream_t stream) {
  const size_t smem = 2 * (size_t)block_e * sizeof(int);
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        frontier_nb_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  // 16-byte id loads need every block's first id on a 16-byte boundary
  const int vec_ids = block_e % 4 == 0
      && (((unsigned long long)csc_src | (unsigned long long)csc_dst)
          & 15ull) == 0;
  // float4 columns need B % 4 == 0 and 16-byte aligned rows
  const int vec_cols = batch % 4 == 0
      && (((unsigned long long)sigma | (unsigned long long)out) & 15ull) == 0;
  frontier_nb_kernel<<<n_edge_blocks, kThreads, smem, stream>>>(
      (const int*)csc_src, (const int*)csc_dst, (const unsigned*)words,
      (const int*)block_nb, (const float*)sigma, (float*)out, block_e,
      block_v, batch, (batch + 31) / 32, vec_ids, vec_cols);
  return (int)cudaGetLastError();
}

}  // namespace

// One pulled level: the words pass (which leaves `out` alone), then
// frontier_pull_kernel and, when a row is split, the combine; all on
// `stream`.  The plan (kernel.py build_pull_plan) covers rows
// [0, plan_rows) of the state's `rows`; `partial` holds max(n_items, 1)
// rows of B float32.
extern "C" int frontier_pull_launch(
    const void* dist, const void* levels, const void* sigma, void* words,
    void* out, void* partial, long long rows, int batch,
    const void* offsets, const void* src_sorted, long long plan_rows,
    long long split, const void* item_begin, const void* item_end,
    long long n_items, const void* split_row, const void* split_first,
    long long n_split, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (rows <= 0 || batch <= 0) return (int)cudaGetLastError();
  const int err = words_launch(dist, levels, words, nullptr, rows, batch, s);
  if (err != 0) return err;
  // float4 columns need B % 4 == 0 and 16-byte aligned rows
  const int vec = batch % 4 == 0
      && (((unsigned long long)sigma | (unsigned long long)out
           | (unsigned long long)partial) & 15ull) == 0;
  auto* off = (const long long*)offsets;
  auto* ids = (const int*)src_sorted;
  auto* ib = (const long long*)item_begin;
  auto* ie = (const long long*)item_end;
  auto* sr = (const int*)split_row;
  auto* sf = (const long long*)split_first;
  auto* w = (const unsigned*)words;
  auto* sg = (const float*)sigma;
  if (vec) {
    return pull_launch<4>(off, ids, ib, ie, n_items, sr, sf, n_split, w, sg,
                          (float*)out, (float*)partial, rows, plan_rows,
                          split, batch, s);
  }
  return pull_launch<1>(off, ids, ib, ie, n_items, sr, sf, n_split, w, sg,
                        (float*)out, (float*)partial, rows, plan_rows, split,
                        batch, s);
}

extern "C" int frontier_words_launch(const void* dist, const void* levels,
                                     void* words, void* out, long long rows,
                                     int batch, void* stream) {
  return words_launch(dist, levels, words, out, rows, batch,
                      (cudaStream_t)stream);
}

// One node-blocked level: the words pass (which zeroes out), then
// frontier_nb_kernel; both on `stream`.
extern "C" int frontier_nb_launch(const void* csc_src, const void* csc_dst,
                                  const void* block_nb, const void* dist,
                                  const void* levels, const void* sigma,
                                  void* words, void* out, long long rows,
                                  int n_edge_blocks, int block_e,
                                  int block_v, int batch, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  const int err = words_launch(dist, levels, words, out, rows, batch, s);
  if (err != 0 || n_edge_blocks <= 0 || batch <= 0) return err;
  return nb_launch(csc_src, csc_dst, block_nb, words, sigma, out,
                   n_edge_blocks, block_e, block_v, batch, s);
}
