// Batched BFS frontier expansion on Hopper (sm_90a), plain C interface.
//
// Both kernels compute one level of B concurrent BFS searches over a
// vertex-major (rows, B) state:
//
//   out[v, b] += sigma[src[e], b]  for every edge e with dst[e] == v
//                                  and dist[src[e], b] == levels[b]
//
// `out` starts at zero (the flat route's caller zero-fills it; the
// node-blocked route's words pass writes the zeros).  Padded edges point
// at the sink row, whose dist (-3) never equals a level, so they add
// nothing.
//
// frontier_flat_kernel replaces the TPU kernel
//   src/repro/kernels/frontier/kernel.py: frontier_expand_batched_pallas
// (body _flat_kernel).  The TPU pins the whole state in VMEM and scatters
// through a one-hot MXU matmul; here the state stays in device memory and
// the scatter is a direct atomic add.
//
// frontier_nb_kernel replaces the TPU kernel
//   src/repro/kernels/frontier/kernel.py: frontier_expand_node_blocked_pallas
// (body _nb_kernel) on its replicated route (not wide_state).  A level is
// two launches:
//
// 1. frontier_words_kernel reads dist once and writes the frontier words,
//    words[v, w] bit c set iff dist[v, 32 w + c] == levels[32 w + c]
//    (W = ceil(B / 32) words a row; sink and padding rows hold -3, which
//    no level equals), and writes the zeros of `out` in the same pass.
//    This is what the TPU's block bitmap was for, at row grain: an edge
//    asks "is my source on any frontier, and on which columns" with W
//    4-byte loads, not a B-wide dist row.  At R-MAT 2^20, B=64 the words
//    are 8.4 MB, which the 50 MB L2 holds.  Where B divides 32 or 32
//    divides B, each warp reads 32 consecutive dist cells, coalesced, and
//    one __ballot_sync makes the words; other B take one thread a word.
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
// so both routes are bound by memory traffic.  The flat kernel's answer:
// lanes of a thread group run over the B columns of one edge, so the
// reads of dist[src, :] and sigma[src, :] are one contiguous row, and the
// source-sorted edge order keeps consecutive edges on the same or nearby
// rows, which the L1/L2 caches serve.  The node-blocked route replaces
// the per-edge dist row (B * 4 bytes) by the source's words (W * 4
// bytes), so only frontier hits touch sigma, and sums a destination's
// hits before its atomic.
//
// Float sums: atomics add in an order that varies from run to run.
// While sigma holds exact integers below 2^24 every order gives the same
// bits; beyond that results agree to float32 rounding (rtol 1e-6).
//
// Each entry point launches on the caller's stream and returns
// cudaGetLastError(); the caller raises on a non-zero code.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxGrid = 132 * 64;  // SMs x resident blocks, grid-stride

// Column lanes per edge: up to one warp's worth; the rest of the block
// runs over edges.
inline dim3 block_shape(int batch) {
  int bx = batch < 32 ? batch : 32;
  if (bx < 1) bx = 1;
  return dim3(bx, kThreads / bx);
}

__device__ __forceinline__ void expand_edge(
    long long u, long long v, const int* __restrict__ dist,
    const float* __restrict__ sigma, const int* __restrict__ levels,
    float* __restrict__ out, int batch) {
  const long long src_row = u * batch;
  const long long dst_row = v * batch;
  for (int b = threadIdx.x; b < batch; b += blockDim.x) {
    if (dist[src_row + b] == levels[b]) {
      atomicAdd(out + dst_row + b, sigma[src_row + b]);
    }
  }
}

__global__ void frontier_flat_kernel(const int* __restrict__ src,
                                     const int* __restrict__ dst,
                                     const int* __restrict__ dist,
                                     const float* __restrict__ sigma,
                                     const int* __restrict__ levels,
                                     float* __restrict__ out,
                                     long long n_edges, int batch) {
  const long long stride = (long long)gridDim.x * blockDim.y;
  for (long long e = (long long)blockIdx.x * blockDim.y + threadIdx.y;
       e < n_edges; e += stride) {
    expand_edge(src[e], dst[e], dist, sigma, levels, out, batch);
  }
}

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
        out[i] = 0.0f;
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
    float* o = out + v * batch + b0;
    unsigned bits = 0u;
    for (int c = 0; c < nb; ++c) {
      bits |= (unsigned)(d[c] == __ldg(levels + b0 + c)) << c;
      o[c] = 0.0f;
    }
    words[i] = bits;
  }
}

// Lanes that share one edge: every column of B <= 32 (rounded up to a
// power of two, so groups never straddle a warp), else a whole warp.
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

extern "C" int frontier_flat_launch(const void* src, const void* dst,
                                    const void* dist, const void* sigma,
                                    const void* levels, void* out,
                                    long long n_edges, int batch,
                                    void* stream) {
  if (n_edges > 0 && batch > 0) {
    const dim3 block = block_shape(batch);
    long long blocks = (n_edges + block.y - 1) / block.y;
    const int grid = (int)(blocks < kMaxGrid ? blocks : kMaxGrid);
    frontier_flat_kernel<<<grid, block, 0, (cudaStream_t)stream>>>(
        (const int*)src, (const int*)dst, (const int*)dist,
        (const float*)sigma, (const int*)levels, (float*)out, n_edges,
        batch);
  }
  return (int)cudaGetLastError();
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
