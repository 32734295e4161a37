// Fused gather + weighted segment sum on Hopper (sm_90a), plain C
// interface:
//
//   out[s, :] = sum_{i : seg[i] == s} w[i] * table[ids[i], :]
//
// accumulated in float32 and rounded once to the table's type (float32
// or bfloat16).  Message passing calls it with ids = edge source and
// seg = edge destination; its gradient with respect to the table is the
// same function with ids and seg exchanged.
//
// Replaces the TPU kernel
//   src/repro/kernels/segsum/kernel.py: gather_segment_sum_pallas
// (body _kernel).  The TPU pins the table in VMEM, streams blocks of
// entries through a sequential grid and scatters with a one-hot MXU
// matmul into one output tile that the grid revisits.  None of that
// carries over: the card's blocks run in no order and a 1 GB table does
// not fit any on-chip memory.  Here the entries are pre-sorted by
// segment once per (ids, seg) pair (the plan, built in PyTorch and
// cached by the caller), so each output row has one owner that reads
// its entries in order and writes the row once: no atomics, and every
// run gives the same bits.
//
// Layout.  One warp per (segment, column panel) of 32 * VEC columns,
// VEC columns a lane (VEC = 4: 16-byte float32 or 8-byte bfloat16 loads,
// so a 128-column row is one warp's panel).  The warp loads 32 entries'
// (id, w) at a time, one a lane, and broadcasts them with shuffles;
// kUnroll table rows are in flight before they are added.  A segment
// with more than `split` entries (the hubs of a skewed graph would leave
// one warp serial over ~1e5 rows) is cut into items of at most `split`
// entries: one warp per item writes a float32 partial row, then
// segsum_combine_kernel adds each segment's partials in item order.
// Both orders are fixed, so the result is deterministic.  Row offsets
// are 64-bit (the table passes 2^31 cells).
//
// Bound on the card.  The function must read the plan's ids (4 bytes an
// entry) and offsets (8 bytes a segment), w (4 bytes an entry), the
// table once, and write the output once; its 2 N D operations are far
// below the float32 rate, so it is bound by memory (0.79 ms at the
// GraphSAGE layer's shape, R-MAT 2^21 x 15, D = 128).  But a gather
// reads one table row per entry, ~30 GB of row requests there, 10x the
// unique bytes: L2 and its misses rule.  tools/segsum_probe.py measured
// what moves that time (H100 80GB HBM3, 700 W; PERF.md):
//
// * the weight read as w[order[j]] cost a random 32-byte sector an
//   entry, 1.5 ms of the forward call: the kernel reads w already in
//   plan order (the wrapper permutes it once per weight tensor and
//   version, and the plan keeps the copy), so `order` is not read here;
// * every gather an L2 hit would take 3.8 ms, uniformly random ids
//   11.7 ms: misses, not L2 bandwidth, hold the kernel.  R-MAT's hot
//   sources carry most entries (the top 16,384 of 2^21 carry 48%), so
//   the plan marks the entries of its `n_hot` hottest sources (bit 31 of
//   the id), and the kernel reads those rows under an L2 evict_last
//   policy (createpolicy + ld.global.nc.L2::cache_hint) so the colder
//   rows streaming through do not push them out; the rest load plainly
//   (an evict_first policy on them was slower: they too are reused).
//   The hot tier is 16,384 rows, 8 MB of 512-byte rows, the best of 4
//   to 40 MB (every size tried beat no tier; the mark alone decides
//   which rows take the policy);
// * shared-memory copies of the hottest rows (1,536 rows of a 32-column
//   panel, or 384 whole rows, one copy a block), 8 rows in flight a
//   warp, and an L2 prefetch ahead of use were all slower.
//
// Products and sums use __fmul_rn and __fadd_rn so nvcc fuses nothing
// into an FMA: each term is rounded as the plain PyTorch version rounds
// it, and only the summation order differs.
//
// Each entry point launches on the caller's stream and returns
// cudaGetLastError(); the caller raises on a non-zero code.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kUnroll = 4;
constexpr unsigned kFull = 0xffffffffu;
constexpr int kIdMask = 0x7fffffff;  // bit 31 of a plan id marks a hot row

__device__ __forceinline__ uint64_t evict_last_policy() {
  uint64_t p;
  asm("createpolicy.fractional.L2::evict_last.b64 %0, 1.0;" : "=l"(p));
  return p;
}

// VEC values of T at p as float32 (p aligned to VEC elements); `keep`
// loads them under the L2 policy `pol`
template <typename T, int VEC>
__device__ __forceinline__ void load_vec(const T* __restrict__ p, bool keep,
                                         uint64_t pol, float (&v)[VEC]) {
  if constexpr (std::is_same<T, float>::value) {
    if constexpr (VEC == 4) {
      float4 q;
      if (keep) {
        asm("ld.global.nc.L2::cache_hint.v4.f32 {%0, %1, %2, %3}, [%4], %5;"
            : "=f"(q.x), "=f"(q.y), "=f"(q.z), "=f"(q.w)
            : "l"(p), "l"(pol));
      } else {
        q = __ldg(reinterpret_cast<const float4*>(p));
      }
      v[0] = q.x; v[1] = q.y; v[2] = q.z; v[3] = q.w;
    } else {
      if (keep) {
        asm("ld.global.nc.L2::cache_hint.f32 %0, [%1], %2;"
            : "=f"(v[0]) : "l"(p), "l"(pol));
      } else {
        v[0] = __ldg(p);
      }
    }
  } else {
    // a bfloat16 is the high half of a float32: exact widening
    if constexpr (VEC == 4) {
      uint2 q;
      if (keep) {
        asm("ld.global.nc.L2::cache_hint.v2.u32 {%0, %1}, [%2], %3;"
            : "=r"(q.x), "=r"(q.y) : "l"(p), "l"(pol));
      } else {
        q = __ldg(reinterpret_cast<const uint2*>(p));
      }
      v[0] = __uint_as_float(q.x << 16);
      v[1] = __uint_as_float(q.x & 0xffff0000u);
      v[2] = __uint_as_float(q.y << 16);
      v[3] = __uint_as_float(q.y & 0xffff0000u);
    } else {
      unsigned short bits;
      if (keep) {
        asm("ld.global.nc.L2::cache_hint.u16 %0, [%1], %2;"
            : "=h"(bits) : "l"(p), "l"(pol));
      } else {
        bits = __ldg(reinterpret_cast<const unsigned short*>(p));
      }
      v[0] = __uint_as_float((unsigned)bits << 16);
    }
  }
}

template <typename T, int VEC>
__device__ __forceinline__ void store_vec(T* __restrict__ p,
                                          const float (&v)[VEC]) {
  if constexpr (std::is_same<T, float>::value) {
    if constexpr (VEC == 4) {
      *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
    } else {
      p[0] = v[0];
    }
  } else {
#pragma unroll
    for (int k = 0; k < VEC; ++k) p[k] = __float2bfloat16_rn(v[k]);
  }
}

// Warps [0, n_items * P) sum one column panel of an item of a split
// segment into its float32 scratch row; the next n_segments * P warps
// one panel of a segment of at most `split` entries into its output row
// (longer segments are left to segsum_combine_kernel).  P = panels a
// row, warp g takes panel g % P of work g / P.  Entry j of the plan adds
// w_sorted[j] * table[ids_sorted[j] & kIdMask] in plan order; its rows
// are read under the evict_last policy when bit 31 of its id is set.
template <typename T, int VEC>
__global__ void __launch_bounds__(kThreads) segsum_kernel(
    const long long* __restrict__ offsets, const int* __restrict__ ids_sorted,
    const float* __restrict__ w_sorted, const T* __restrict__ table,
    T* __restrict__ out, int d, long long n_segments, long long split,
    const long long* __restrict__ item_begin,
    const long long* __restrict__ item_end, long long n_items,
    float* __restrict__ scratch) {
  const int n_panels = (d + 32 * VEC - 1) / (32 * VEC);
  const long long warp =
      ((long long)blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  const long long work = warp / n_panels;
  if (work >= n_items + n_segments) return;
  const int col = (int)(warp % n_panels) * 32 * VEC + lane * VEC;
  const bool active = col < d;
  const bool is_item = work < n_items;
  long long begin, end, row;
  if (is_item) {
    begin = item_begin[work];
    end = item_end[work];
    row = work;
  } else {
    row = work - n_items;
    begin = offsets[row];
    end = offsets[row + 1];
    if (end - begin > split) return;
  }
  const uint64_t pol = evict_last_policy();
  float acc[VEC];
#pragma unroll
  for (int c = 0; c < VEC; ++c) acc[c] = 0.0f;
  for (long long base = begin; base < end; base += 32) {
    const long long left = end - base;
    const int n = left < 32 ? (int)left : 32;
    int my_id = 0;
    float my_w = 0.0f;
    if (lane < n) {
      my_id = ids_sorted[base + lane];
      my_w = w_sorted[base + lane];
    }
    for (int k = 0; k < n; k += kUnroll) {
      float rows[kUnroll][VEC];
      float ws[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int id = __shfl_sync(kFull, my_id, k + u);
        ws[u] = __shfl_sync(kFull, my_w, k + u);
        if (active && k + u < n) {
          load_vec<T, VEC>(table + (long long)(id & kIdMask) * d + col,
                           id < 0, pol, rows[u]);
        } else {
#pragma unroll
          for (int c = 0; c < VEC; ++c) rows[u][c] = 0.0f;
        }
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        if (k + u < n) {
#pragma unroll
          for (int c = 0; c < VEC; ++c) {
            acc[c] = __fadd_rn(acc[c], __fmul_rn(ws[u], rows[u][c]));
          }
        }
      }
    }
  }
  if (active) {
    if (is_item) {
      store_vec<float, VEC>(scratch + row * d + col, acc);
    } else {
      store_vec<T, VEC>(out + row * d + col, acc);
    }
  }
}

// One warp per split segment: its items' partial rows
// split_first[q] .. split_first[q+1] - 1, added in item order.
template <typename T, int VEC>
__global__ void __launch_bounds__(kThreads) segsum_combine_kernel(
    const int* __restrict__ split_seg, const long long* __restrict__ split_first,
    long long n_split, const float* __restrict__ scratch, T* __restrict__ out,
    int d) {
  const long long q = ((long long)blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (q >= n_split) return;
  const long long s = split_seg[q];
  const long long p0 = split_first[q], p1 = split_first[q + 1];
  for (int c0 = 0; c0 < d; c0 += 32 * VEC) {
    const int col = c0 + lane * VEC;
    if (col >= d) continue;
    float acc[VEC];
#pragma unroll
    for (int c = 0; c < VEC; ++c) acc[c] = 0.0f;
    for (long long p = p0; p < p1; ++p) {
      float part[VEC];
      load_vec<float, VEC>(scratch + p * d + col, false, 0, part);
#pragma unroll
      for (int c = 0; c < VEC; ++c) acc[c] = __fadd_rn(acc[c], part[c]);
    }
    store_vec<T, VEC>(out + s * d + col, acc);
  }
}

template <typename T, int VEC>
int launch(const long long* offsets, const int* ids_sorted,
           const float* w_sorted, const void* table, void* out, int d,
           long long n_segments, long long split,
           const long long* item_begin, const long long* item_end,
           long long n_items, const int* split_seg,
           const long long* split_first, long long n_split, float* scratch,
           cudaStream_t stream) {
  const long long n_panels = (d + 32 * VEC - 1) / (32 * VEC);
  const long long blocks =
      ((n_items + n_segments) * n_panels + kWarps - 1) / kWarps;
  const long long combine_blocks = (n_split + kWarps - 1) / kWarps;
  if (blocks > 0x7fffffffLL || combine_blocks > 0x7fffffffLL) {
    return (int)cudaErrorInvalidConfiguration;
  }
  if (blocks > 0) {
    segsum_kernel<T, VEC><<<(unsigned)blocks, kThreads, 0, stream>>>(
        offsets, ids_sorted, w_sorted, (const T*)table, (T*)out, d,
        n_segments, split, item_begin, item_end, n_items, scratch);
  }
  if (combine_blocks > 0) {
    segsum_combine_kernel<T, VEC>
        <<<(unsigned)combine_blocks, kThreads, 0, stream>>>(
            split_seg, split_first, n_split, scratch, (T*)out, d);
  }
  return (int)cudaGetLastError();
}

}  // namespace

// dtype: 0 float32, 1 bfloat16.  vec: 4 (d % 4 == 0, table and out
// aligned to 4 elements) or 1.  ids_sorted and w_sorted: the plan's ids
// (bit 31 marks a hot row) and the weights in plan order.
extern "C" int segsum_launch(const void* offsets, const void* ids_sorted,
                             const void* w_sorted, const void* table,
                             void* out, int dtype, int d, int vec,
                             long long n_segments, long long split,
                             const void* item_begin, const void* item_end,
                             long long n_items, const void* split_seg,
                             const void* split_first, long long n_split,
                             void* scratch, void* stream) {
  const auto* off = (const long long*)offsets;
  const auto* ids = (const int*)ids_sorted;
  const auto* wt = (const float*)w_sorted;
  const auto* ib = (const long long*)item_begin;
  const auto* ie = (const long long*)item_end;
  const auto* ss = (const int*)split_seg;
  const auto* sf = (const long long*)split_first;
  auto* scr = (float*)scratch;
  auto st = (cudaStream_t)stream;
  if (dtype == 0 && vec == 4) {
    return launch<float, 4>(off, ids, wt, table, out, d, n_segments, split,
                            ib, ie, n_items, ss, sf, n_split, scr, st);
  }
  if (dtype == 0 && vec == 1) {
    return launch<float, 1>(off, ids, wt, table, out, d, n_segments, split,
                            ib, ie, n_items, ss, sf, n_split, scr, st);
  }
  if (dtype == 1 && vec == 4) {
    return launch<__nv_bfloat16, 4>(off, ids, wt, table, out, d, n_segments,
                                    split, ib, ie, n_items, ss, sf, n_split,
                                    scr, st);
  }
  if (dtype == 1 && vec == 1) {
    return launch<__nv_bfloat16, 1>(off, ids, wt, table, out, d, n_segments,
                                    split, ib, ie, n_items, ss, sf, n_split,
                                    scr, st);
  }
  return (int)cudaErrorInvalidValue;
}
