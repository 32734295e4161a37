"""What bounds the gather-segment-sum kernel (K4) on the card, and what
keeping hot table rows on the chip can buy.

Times the GraphSAGE layer's call (R-MAT 2^21 x 15 from
``rmat_graph(21, 15, seed=0)``, ``graph_to_batch``, D = 128 float32,
``batch.segment_plan()``), forward (ids = src, seg = dst) and transposed
(ids = dst, seg = src), ms a call with CUDA events after warm-up, for
these variants.  They are kernels of this file's own CUDA source
(``PROBE_SOURCE``), one template, so that every variant adds the same
entries in the same order (the plan's) and all of them give the same
bits:

* ``(a) first port``: the kernel as first ported: one warp a segment,
  4 columns a lane, the weight read as ``w[order[j]]``;
* ``(b) w in plan order``: (a) reading the weights already permuted;
* ``(c) ids in an L2 window``: (a) on ``ids % 16384`` (8 MB of rows):
  every gather can hit L2, the floor of any design that fetches one row
  an entry through L2;
* ``(d) uniform ids``: (a) on ids drawn uniformly: almost every gather
  misses L2;
* ``(e) L2 policy, H``: (b) with the H sources of most entries read
  under an ``evict_last`` L2 policy and the rest under ``evict_first``
  (``createpolicy`` + ``ld.global.nc.L2::cache_hint``), H rows of 16,
  32 and 40 MB;
* ``(f) smem + L2 policy``: 32-column panels (one block a panel, a
  persistent grid of 1,024-thread blocks): each block stages the panel
  of the 1,536 hottest rows (192 KB) in shared memory once and reads
  those entries there, the next tier under ``evict_last`` as in (e);
* ``(g) panels``: (f)'s layout alone: no shared memory, no policy;
* ``(h) panels + smem``: (f) without the L2 policy;
* ``(i) full-row smem + L2 policy``: (f) with whole 128-column rows
  staged (384 rows, 192 KB) and 4 columns a lane;
* ``(k)``: (b) with 8 rows in flight a warp in place of 4;
* ``(l) L2 prefetch``: (b), each row sent to L2 by one bulk prefetch
  (``cp.async.bulk.prefetch.L2``) 8 or 16 entries before its use;
* ``(m)``: (k) with the prefetch 16 ahead;
* ``(n)``: (b) with a hot tier of 4 to 40 MB under ``evict_last`` and
  the rest plain (the design built, at 16 MB);
* ``(o)``: (b) with only the top 384 rows (192 KB) allocated in L1;
* ``(j) as built``: the committed kernel through its wrapper.

Beside them the share of entries the top H sources carry, and
``torch.sparse.mm`` on the plan's CSR matrix.  Every variant is held
bitwise against the plain version on integer-valued inputs (its own
ids for (c) and (d)).  Needs a CUDA card and nvcc:

    PYTHONPATH=src python tools/segsum_probe.py
"""
from __future__ import annotations

import ctypes
import subprocess
import sys
from pathlib import Path

import torch

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))

import chip_smoke as cs  # noqa: E402
import repro_torch.core as tc  # noqa: E402
from repro_torch.configs._families import GNN_SHAPES  # noqa: E402
from repro_torch.configs.graphsage_reddit import (  # noqa: E402
    cfg_for_shape, make_config)
from repro_torch.data import graph_to_batch  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels.segsum import kernel as sk  # noqa: E402

# an entry's code: a table row, bit 30 set for the L2-hot tier; a
# negative code ~r is slot r of the shared-memory panel
HOT_BIT = 1 << 30
WINDOW = 16384
SMEM_BYTES = 192 * 1024
L2_HOT_MB = (16, 32, 40)
TIER_MB = (4, 8, 16, 24, 32, 40)
L1_ROWS = 384

PROBE_SOURCE = r'''
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kHotBit = 1 << 30;
constexpr int kIdMask = kHotBit - 1;

__device__ __forceinline__ uint64_t policy(bool keep) {
  uint64_t p;
  if (keep) {
    asm("createpolicy.fractional.L2::evict_last.b64 %0, 1.0;" : "=l"(p));
  } else {
    asm("createpolicy.fractional.L2::evict_first.b64 %0, 1.0;" : "=l"(p));
  }
  return p;
}

// HINT 0: plain loads; 1: flagged rows under an evict_last L2 policy,
// the rest evict_first; 2: flagged rows evict_last, the rest plain; 3:
// flagged rows plain, the rest not allocated in L1
template <int VEC, int HINT>
__device__ __forceinline__ void load_row(const float* p, bool flagged,
                                         uint64_t keep, uint64_t pass,
                                         float (&v)[VEC]) {
  static_assert(VEC == 4 || HINT == 0 || HINT == 1, "hint at VEC 4 only");
  const bool hinted = (HINT == 1) || (HINT == 2 && flagged);
  const bool no_l1 = HINT == 3 && !flagged;
  if constexpr (VEC == 4) {
    if (hinted) {
      asm("ld.global.nc.L2::cache_hint.v4.f32 {%0, %1, %2, %3}, [%4], %5;"
          : "=f"(v[0]), "=f"(v[1]), "=f"(v[2]), "=f"(v[3])
          : "l"(p), "l"(flagged ? keep : pass));
    } else if (no_l1) {
      asm("ld.global.nc.L1::no_allocate.v4.f32 {%0, %1, %2, %3}, [%4];"
          : "=f"(v[0]), "=f"(v[1]), "=f"(v[2]), "=f"(v[3]) : "l"(p));
    } else {
      const float4 q = __ldg(reinterpret_cast<const float4*>(p));
      v[0] = q.x; v[1] = q.y; v[2] = q.z; v[3] = q.w;
    }
  } else {
    if (hinted) {
      asm("ld.global.nc.L2::cache_hint.f32 %0, [%1], %2;"
          : "=f"(v[0]) : "l"(p), "l"(flagged ? keep : pass));
    } else {
      v[0] = __ldg(p);
    }
  }
}

// the whole row at p into L2, no registers (one bulk prefetch)
__device__ __forceinline__ void prefetch_row(const float* p, unsigned bytes) {
  asm volatile("cp.async.bulk.prefetch.L2.global [%0], %1;"
               :: "l"(p), "r"(bytes) : "memory");
}

template <int VEC, int UNROLL, bool W_SORTED, int HINT, bool SMEM,
          bool PERSIST, int AHEAD>
__global__ void __launch_bounds__(PERSIST ? 1024 : 256) probe_kernel(
    const long long* __restrict__ offsets, const int* __restrict__ codes,
    const long long* __restrict__ order, const float* __restrict__ w,
    const float* __restrict__ table, float* __restrict__ out, int d,
    long long n_segments, long long split,
    const long long* __restrict__ item_begin,
    const long long* __restrict__ item_end, long long n_items,
    float* __restrict__ scratch, const int* __restrict__ hot_rows,
    int n_hot) {
  constexpr int PW = 32 * VEC;
  extern __shared__ float panel_rows[];
  const int n_panels = d / PW;
  const int lane = threadIdx.x & 31;
  const int wib = threadIdx.x >> 5, nwb = blockDim.x >> 5;
  const long long n_work = n_items + n_segments;
  int panel;
  long long first, stride;
  if (PERSIST) {
    panel = blockIdx.x % n_panels;
    first = (long long)(blockIdx.x / n_panels) * nwb + wib;
    stride = (long long)(gridDim.x / n_panels) * nwb;
  } else {
    const long long g =
        ((long long)blockIdx.x * blockDim.x + threadIdx.x) >> 5;
    panel = (int)(g % n_panels);
    first = g / n_panels;
    stride = n_work;
  }
  const int col = panel * PW + lane * VEC;
  if (SMEM) {
    for (int r = wib; r < n_hot; r += nwb) {
      float v[VEC];
      load_row<VEC, 0>(table + (long long)hot_rows[r] * d + col, false, 0, 0,
                       v);
#pragma unroll
      for (int c = 0; c < VEC; ++c) panel_rows[r * PW + lane * VEC + c] = v[c];
    }
    __syncthreads();
  }
  const uint64_t keep = HINT == 1 || HINT == 2 ? policy(true) : 0;
  const uint64_t pass = HINT == 1 ? policy(false) : 0;
  for (long long work = first; work < n_work; work += stride) {
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
      if (end - begin > split) continue;
    }
    float acc[VEC];
#pragma unroll
    for (int c = 0; c < VEC; ++c) acc[c] = 0.0f;
    for (long long base = begin; base < end; base += 32) {
      const long long left = end - base;
      const int n = left < 32 ? (int)left : 32;
      int my_code = 0;
      float my_w = 0.0f;
      if (lane < n) {
        my_code = codes[base + lane];
        my_w = W_SORTED ? w[base + lane] : w[order[base + lane]];
      }
      // rows AHEAD entries ahead of their use go to L2 first: lanes
      // [UNROLL, AHEAD) now, lanes [k + AHEAD, k + AHEAD + UNROLL) as
      // group k is loaded
      const float* my_row =
          table + (long long)(my_code & kIdMask) * d + panel * PW;
      if (AHEAD > 0 && lane >= UNROLL && lane < AHEAD && lane < n &&
          my_code >= 0) {
        prefetch_row(my_row, PW * sizeof(float));
      }
      for (int k = 0; k < n; k += UNROLL) {
        if (AHEAD > 0 && lane >= k + AHEAD && lane < k + AHEAD + UNROLL &&
            lane < n && my_code >= 0) {
          prefetch_row(my_row, PW * sizeof(float));
        }
        float rows[UNROLL][VEC];
        float ws[UNROLL];
#pragma unroll
        for (int u = 0; u < UNROLL; ++u) {
          const int c = __shfl_sync(kFull, my_code, k + u);
          ws[u] = __shfl_sync(kFull, my_w, k + u);
          if (k + u < n) {
            if (SMEM && c < 0) {
#pragma unroll
              for (int e = 0; e < VEC; ++e) {
                rows[u][e] = panel_rows[(~c) * PW + lane * VEC + e];
              }
            } else {
              load_row<VEC, HINT>(table + (long long)(c & kIdMask) * d + col,
                                  (c & kHotBit) != 0, keep, pass, rows[u]);
            }
          } else {
#pragma unroll
            for (int e = 0; e < VEC; ++e) rows[u][e] = 0.0f;
          }
        }
#pragma unroll
        for (int u = 0; u < UNROLL; ++u) {
          if (k + u < n) {
#pragma unroll
            for (int e = 0; e < VEC; ++e) {
              acc[e] = __fadd_rn(acc[e], __fmul_rn(ws[u], rows[u][e]));
            }
          }
        }
      }
    }
    float* dst = (is_item ? scratch : out) + row * d + col;
#pragma unroll
    for (int e = 0; e < VEC; ++e) dst[e] = acc[e];
  }
}

__global__ void __launch_bounds__(256) probe_combine_kernel(
    const int* __restrict__ split_seg, const long long* __restrict__ split_first,
    long long n_split, const float* __restrict__ scratch,
    float* __restrict__ out, int d) {
  const long long q = ((long long)blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (q >= n_split) return;
  const long long s = split_seg[q];
  for (int col = lane; col < d; col += 32) {
    float acc = 0.0f;
    for (long long p = split_first[q]; p < split_first[q + 1]; ++p) {
      acc = __fadd_rn(acc, scratch[p * d + col]);
    }
    out[s * d + col] = acc;
  }
}

template <int VEC, int UNROLL, bool W_SORTED, int HINT, bool SMEM,
          bool PERSIST, int AHEAD = 0>
int run(const long long* offsets, const int* codes, const long long* order,
        const float* w, const float* table, float* out, int d,
        long long n_segments, long long split, const long long* item_begin,
        const long long* item_end, long long n_items, float* scratch,
        const int* hot_rows, int n_hot, cudaStream_t stream) {
  auto kernel =
      probe_kernel<VEC, UNROLL, W_SORTED, HINT, SMEM, PERSIST, AHEAD>;
  const int n_panels = d / (32 * VEC);
  const long long n_work = n_items + n_segments;
  const size_t smem = SMEM ? (size_t)n_hot * 32 * VEC * sizeof(float) : 0;
  long long blocks;
  int threads;
  if (PERSIST) {
    threads = 1024;
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    int per_sm = 0, dev = 0, sms = 0;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                        threads, smem);
    if (err != cudaSuccess) return (int)err;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    blocks = (long long)per_sm * sms / n_panels * n_panels;
    if (blocks < n_panels) return (int)cudaErrorInvalidConfiguration;
  } else {
    threads = 256;
    blocks = (n_work * n_panels + 7) / 8;
  }
  if (blocks > 0) {
    kernel<<<(unsigned)blocks, threads, smem, stream>>>(
        offsets, codes, order, w, table, out, d, n_segments, split,
        item_begin, item_end, n_items, scratch, hot_rows, n_hot);
  }
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int probe_launch(int variant, const long long* offsets,
                            const int* codes, const long long* order,
                            const float* w, const float* table, float* out,
                            int d, long long n_segments, long long split,
                            const long long* item_begin,
                            const long long* item_end, long long n_items,
                            const int* split_seg,
                            const long long* split_first, long long n_split,
                            float* scratch, const int* hot_rows, int n_hot,
                            cudaStream_t stream) {
#define PROBE_ARGS offsets, codes, order, w, table, out, d, n_segments, \
    split, item_begin, item_end, n_items, scratch, hot_rows, n_hot, stream
  int code;
  switch (variant) {
    case 0: code = run<4, 4, false, 0, false, false>(PROBE_ARGS); break;
    case 1: code = run<4, 4, true, 0, false, false>(PROBE_ARGS); break;
    case 2: code = run<4, 4, true, 1, false, false>(PROBE_ARGS); break;
    case 3: code = run<1, 16, true, 1, true, true>(PROBE_ARGS); break;
    case 4: code = run<1, 16, true, 0, false, true>(PROBE_ARGS); break;
    case 5: code = run<1, 16, true, 0, true, true>(PROBE_ARGS); break;
    case 6: code = run<4, 4, true, 1, true, true>(PROBE_ARGS); break;
    case 7: code = run<4, 8, true, 0, false, false>(PROBE_ARGS); break;
    case 8: code = run<4, 4, true, 0, false, false, 8>(PROBE_ARGS); break;
    case 9: code = run<4, 4, true, 0, false, false, 16>(PROBE_ARGS); break;
    case 10: code = run<4, 8, true, 0, false, false, 16>(PROBE_ARGS); break;
    case 11: code = run<4, 4, true, 2, false, false>(PROBE_ARGS); break;
    case 12: code = run<4, 4, true, 3, false, false>(PROBE_ARGS); break;
    default: return (int)cudaErrorInvalidValue;
  }
#undef PROBE_ARGS
  if (code != 0) return code;
  if (n_split > 0) {
    probe_combine_kernel<<<(unsigned)((n_split + 7) / 8), 256, 0, stream>>>(
        split_seg, split_first, n_split, scratch, out, d);
  }
  return (int)cudaGetLastError();
}
'''

# variant letter -> its instantiation in probe_launch
KERNELS = {"a": 0, "b": 1, "e": 2, "f": 3, "g": 4, "h": 5, "i": 6, "k": 7,
           "l8": 8, "l16": 9, "m": 10, "n": 11, "o": 12}


def probe_library() -> ctypes.CDLL:
    _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    path = _build.BUILD_DIR / "segsum_probe.cu"
    path.write_text(PROBE_SOURCE)

    def declare(lib):
        p, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        lib.probe_launch.argtypes = [i32, p, p, p, p, p, p, i32, i64, i64, p,
                                     p, i64, p, p, i64, p, p, i32, p]
        lib.probe_launch.restype = i32
    return _build.load("segsum_probe", path, declare)


def call(lib, variant: str, plan, codes, order, w, table, hot_rows, n_hot):
    """One call of probe kernel ``variant`` over ``plan`` with the
    per-entry ``codes`` (in plan order)."""
    n_segments, d = plan.n_segments, table.shape[1]
    out = torch.empty((n_segments, d), dtype=torch.float32,
                      device=table.device)
    scratch = torch.empty((max(plan.n_items, 1), d), dtype=torch.float32,
                          device=table.device)
    _build.check(lib.probe_launch(
        KERNELS[variant], plan.offsets.data_ptr(), codes.data_ptr(),
        order.data_ptr(), w.data_ptr(), table.data_ptr(), out.data_ptr(), d,
        n_segments, plan.split, plan.item_begin.data_ptr(),
        plan.item_end.data_ptr(), plan.n_items, plan.split_seg.data_ptr(),
        plan.split_first.data_ptr(), plan.split_seg.shape[0],
        scratch.data_ptr(), hot_rows.data_ptr(), n_hot,
        _build.raw_stream(table.device)), f"probe {variant}")
    return out


def ranking(ids, n_rows: int):
    """(sources by entry count, most first; each source's rank; the
    entry counts in that order)."""
    counts = torch.bincount(ids.long(), minlength=n_rows)
    by_count = torch.sort(counts, descending=True, stable=True).indices
    rank = torch.empty_like(by_count)
    rank[by_count] = torch.arange(n_rows, device=ids.device)
    return by_count, rank, counts[by_count]


def probe_call(label: str, lib, ids, seg, w, table, plan) -> None:
    n, v, d = ids.shape[0], table.shape[0], table.shape[1]
    from repro_torch.kernels.segsum import gather_segment_sum_ref
    order = plan.order.long()
    ids_sorted = ids.index_select(0, order).to(torch.int32)
    w_sorted = w.index_select(0, order).contiguous()
    by_count, rank, sorted_counts = ranking(ids, v)
    cum = torch.cumsum(sorted_counts, 0)
    row_bytes = d * table.element_size()
    smem_rows = {32: SMEM_BYTES // (32 * 4), 128: SMEM_BYTES // (128 * 4)}
    l2_rows = {mb: int(mb * 2 ** 20) // row_bytes for mb in L2_HOT_MB}
    shares = {h: float(cum[min(h, v) - 1]) / n for h in
              sorted({*smem_rows.values(), *l2_rows.values(), 1 << 12,
                      1 << 14, 1 << 17})}
    print(f"{label}: N={n} entries, V1={v}, S={plan.n_segments}, D={d}; "
          f"share of entries the top H sources carry: "
          + ", ".join(f"H={h} ({h * row_bytes / 2 ** 20:.1f} MB of rows) "
                      f"{s:.3f}" for h, s in shares.items()), flush=True)
    hot_rows = by_count.to(torch.int32)
    r_sorted = rank.index_select(0, ids_sorted.long())

    def l2_codes(h):
        return torch.where(r_sorted < h, ids_sorted | HOT_BIT, ids_sorted)

    def smem_codes(h_smem, h_l2):
        base = l2_codes(h_l2) if h_l2 else ids_sorted
        return torch.where(r_sorted < h_smem, ~r_sorted.to(torch.int32),
                           base).contiguous()

    want = gather_segment_sum_ref(ids, seg, w, table, plan.n_segments)
    window = (ids % WINDOW).to(torch.int32)
    gen = torch.Generator(device=ids.device).manual_seed(cs.SEED + 5)
    uniform = torch.randint(0, v, (n,), generator=gen, device=ids.device,
                            dtype=torch.int32)
    want_window = gather_segment_sum_ref(window, seg, w, table,
                                         plan.n_segments)
    want_uniform = gather_segment_sum_ref(uniform, seg, w, table,
                                          plan.n_segments)
    runs = {
        "(a) first port": ("a", ids_sorted, w, 0, want),
        "(b) w in plan order": ("b", ids_sorted, w_sorted, 0, want),
        f"(c) ids % {WINDOW}": ("a", window.index_select(0, order), w, 0,
                                want_window),
        "(d) uniform ids": ("a", uniform.index_select(0, order), w, 0,
                            want_uniform),
    }
    for mb, h in l2_rows.items():
        runs[f"(e) L2 policy, {mb} MB hot"] = ("e", l2_codes(h), w_sorted, 0,
                                               want)
    h32, h128 = smem_rows[32], smem_rows[128]
    for mb in L2_HOT_MB[:2]:
        runs[f"(f) smem {h32} + L2 {mb} MB"] = (
            "f", smem_codes(h32, l2_rows[mb]), w_sorted, h32, want)
    runs["(g) panels"] = ("g", ids_sorted, w_sorted, 0, want)
    runs[f"(h) panels + smem {h32}"] = ("h", smem_codes(h32, 0), w_sorted,
                                        h32, want)
    runs[f"(i) full-row smem {h128} + L2 {L2_HOT_MB[1]} MB"] = (
        "i", smem_codes(h128, l2_rows[L2_HOT_MB[1]]), w_sorted, h128, want)
    runs["(k) (b), 8 rows in flight"] = ("k", ids_sorted, w_sorted, 0, want)
    for ahead in (8, 16):
        runs[f"(l) (b), L2 prefetch {ahead} ahead"] = (
            f"l{ahead}", ids_sorted, w_sorted, 0, want)
    runs["(m) (k) + L2 prefetch 16 ahead"] = ("m", ids_sorted, w_sorted, 0,
                                              want)
    for mb in TIER_MB:
        runs[f"(n) (b), evict_last {mb} MB, rest plain"] = (
            "n", l2_codes(int(mb * 2 ** 20) // row_bytes), w_sorted, 0, want)
    runs[f"(o) (b), L1 for the top {L1_ROWS} only"] = (
        "o", l2_codes(L1_ROWS), w_sorted, 0, want)
    for name, (variant, codes, wv, n_hot, ref) in runs.items():
        def fn(variant=variant, codes=codes.contiguous(), wv=wv, n_hot=n_hot):
            return call(lib, variant, plan, codes, order, wv, table,
                        hot_rows, n_hot)
        same = torch.equal(fn(), ref)
        torch.cuda.synchronize()
        ms = cs.cuda_time_ms(fn, 20)
        print(f"  {name:34s} {ms:8.3f} ms a call"
              f"{'; equal to the plain version' if same else '; DIFFERS'}",
              flush=True)
    built = lambda: sk.gather_segment_sum_cuda(ids, seg, w, table,  # noqa
                                               plan.n_segments, plan)
    same = torch.equal(built(), want)
    ms = cs.cuda_time_ms(built, 20)
    print(f"  {'(j) as built':34s} {ms:8.3f} ms a call"
          f"{'; equal to the plain version' if same else '; DIFFERS'}",
          flush=True)
    csr = torch.sparse_csr_tensor(plan.offsets, ids_sorted.long(), w_sorted,
                                  (plan.n_segments, v),
                                  check_invariants=False)
    lib_ms = cs.cuda_time_ms(lambda: torch.sparse.mm(csr, table), 10)
    print(f"  {'torch.sparse.mm':34s} {lib_ms:8.3f} ms a call; one row read "
          f"an entry at the HBM rate {n * row_bytes / cs.HBM_BYTES_PER_S * 1e3:.3f}"
          " ms", flush=True)


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA card")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    print(f"{torch.cuda.get_device_name(0)}; nvidia-smi: {smi}", flush=True)
    lib = probe_library()
    cfg = cfg_for_shape(make_config(), GNN_SHAPES[cs.GNN_CELL])
    graph = tc.rmat_graph(cs.GNN_SCALE, cs.GNN_EDGE_FACTOR, seed=cs.SEED,
                          device="cuda")
    batch = graph_to_batch(graph, d_feat=cfg.d_in, n_classes=cfg.n_classes,
                           seed=cs.SEED, device="cuda")
    del graph
    plan = batch.segment_plan()
    v, d = batch.n_nodes, cfg.d_hidden
    gen = torch.Generator(device="cuda").manual_seed(cs.SEED + 3)
    table = torch.randint(-8, 9, (v, d), generator=gen, device="cuda",
                          dtype=torch.float32)
    w = torch.randint(0, 4, (batch.n_edges,), generator=gen, device="cuda",
                      dtype=torch.float32)
    probe_call("forward (ids = src, seg = dst)", lib, batch.src, batch.dst,
               w, table, plan)
    torch.cuda.empty_cache()
    probe_call("transposed (ids = dst, seg = src)", lib, batch.dst,
               batch.src, w, table, plan.transpose)


if __name__ == "__main__":
    main()
