"""What bounds the flat frontier level (K1) on the card, and what each
part of the pull's design buys.

Times one mid-BFS level, B=64, of R-MAT 2^20 x 30 and of an
Erdos-Renyi graph of the same size (no hubs), a call as the path calls
it, for these variants.  The CUDA ones are built from the committed
source (``src/repro_torch/kernels/frontier/csrc/frontier.cu``), by text
edits or with a kernel appended:

* ``(a) push, atomics``: the flat kernel as it was before the pull
  (appended below): one thread group an edge over its B columns, the
  source's whole dist row read, one scalar atomic a frontier hit, into
  an output zero-filled with ``torch.zeros``;
* ``(b) pull, words``: the route as built (words pass, pull, combine);
* ``(c) pull, dist rows``: the pull reading each in-neighbour's B-wide
  dist row (and the levels from constant memory) in place of its words;
  no words pass;
* ``(d) pull, no hub split``: (b) over a plan whose split exceeds every
  row, so one lane group walks each hub alone;
* ``(e) push, words``: the words pass with the zeros, then one lane group
  a source (the CSR by source) with a frontier bit, its masked sigma
  columns added to each out-neighbour with float4 atomics (appended);
* ``(f) pull, 8 in flight`` / ``(g) split 128`` / ``(h) split 2048``: (b)
  with 8 sources' loads in flight in place of 4, or another split;
* ``(i) pull, 8 blocks an SM``: (b) with the pull's registers capped so
  that 8 blocks of 256 threads fit an SM (full occupancy).

Beside them the (edge, column) frontier hits of the level and
``torch.sparse.mm`` on it.  Every variant is held against the plain
version (bitwise: the level's sums are exact integers).  Needs a CUDA
card and nvcc:

    PYTHONPATH=src python tools/frontier_flat_probe.py
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
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels.frontier import kernel as fk  # noqa: E402
from repro_torch.kernels.frontier import (  # noqa: E402
    frontier_expand_batched_ref)

# (a): the flat kernel before the pull, and (e): a push over the words
APPENDED = r'''
namespace {
__global__ void probe_flat_kernel(const int* __restrict__ src,
                                  const int* __restrict__ dst,
                                  const int* __restrict__ dist,
                                  const float* __restrict__ sigma,
                                  const int* __restrict__ levels,
                                  float* __restrict__ out,
                                  long long n_edges, int batch) {
  const long long stride = (long long)gridDim.x * blockDim.y;
  for (long long e = (long long)blockIdx.x * blockDim.y + threadIdx.y;
       e < n_edges; e += stride) {
    const long long src_row = (long long)src[e] * batch;
    const long long dst_row = (long long)dst[e] * batch;
    for (int b = threadIdx.x; b < batch; b += blockDim.x) {
      if (dist[src_row + b] == levels[b]) {
        atomicAdd(out + dst_row + b, sigma[src_row + b]);
      }
    }
  }
}

__global__ void __launch_bounds__(kThreads) probe_push_kernel(
    const int* __restrict__ indptr, const int* __restrict__ indices,
    const unsigned* __restrict__ words, const float* __restrict__ sigma,
    float* __restrict__ out, long long n_src, int batch, int n_words) {
  const int lanes = edge_lanes(batch / 4);
  const long long u =
      ((long long)blockIdx.x * blockDim.x + threadIdx.x) / lanes;
  const int b = threadIdx.x % lanes * 4;
  if (u >= n_src || b >= batch) return;
  const unsigned bits = frontier_bits(words, u, n_words, b, 0xfu);
  if (bits == 0u) return;
  float4 x = __ldg(reinterpret_cast<const float4*>(sigma + u * batch + b));
  x.x = bits & 1u ? x.x : 0.0f;
  x.y = bits & 2u ? x.y : 0.0f;
  x.z = bits & 4u ? x.z : 0.0f;
  x.w = bits & 8u ? x.w : 0.0f;
  for (int e = indptr[u]; e < indptr[u + 1]; ++e) {
    atomicAdd(reinterpret_cast<float4*>(out + (long long)indices[e] * batch
                                        + b), x);
  }
}
}  // namespace

extern "C" int probe_flat_launch(const void* src, const void* dst,
                                 const void* dist, const void* sigma,
                                 const void* levels, void* out,
                                 long long n_edges, int batch, void* stream) {
  const int bx = batch < 32 ? batch : 32;
  const dim3 block(bx, kThreads / bx);
  const long long blocks = (n_edges + block.y - 1) / block.y;
  const int grid = (int)(blocks < kMaxGrid ? blocks : kMaxGrid);
  probe_flat_kernel<<<grid, block, 0, (cudaStream_t)stream>>>(
      (const int*)src, (const int*)dst, (const int*)dist,
      (const float*)sigma, (const int*)levels, (float*)out, n_edges, batch);
  return (int)cudaGetLastError();
}

extern "C" int probe_push_launch(const void* dist, const void* levels,
                                 const void* sigma, void* words, void* out,
                                 long long rows, int batch,
                                 const void* indptr, const void* indices,
                                 long long n_src, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  const int err = words_launch(dist, levels, words, out, rows, batch, s);
  if (err != 0) return err;
  const int groups = kThreads / edge_lanes(batch / 4);
  probe_push_kernel<<<(unsigned)((n_src + groups - 1) / groups), kThreads,
                      0, s>>>((const int*)indptr, (const int*)indices,
                              (const unsigned*)words, (const float*)sigma,
                              (float*)out, n_src, batch, (batch + 31) / 32);
  return (int)cudaGetLastError();
}
'''

# (c): dist rows in place of words
DIST_ROWS = (
    ("constexpr int kPullUnroll = 4;",
     "__constant__ int c_levels[1024];\nconstexpr int kPullUnroll = 4;"),
    ("  return (__ldg(words + u * n_words + (b >> 5)) >> (b & 31)) & mask;",
     "  const int* d =\n"
     "      reinterpret_cast<const int*>(words) + u * n_words + b;\n"
     "  unsigned bits = 0u;\n"
     "  if (mask == 0xfu) {\n"
     "    const int4 x = __ldg(reinterpret_cast<const int4*>(d));\n"
     "    bits = (unsigned)(x.x == c_levels[b])\n"
     "        | (unsigned)(x.y == c_levels[b + 1]) << 1\n"
     "        | (unsigned)(x.z == c_levels[b + 2]) << 2\n"
     "        | (unsigned)(x.w == c_levels[b + 3]) << 3;\n"
     "  } else {\n"
     "    bits = (unsigned)(__ldg(d) == c_levels[b]);\n"
     "  }\n"
     "  return bits;"),
    ("  const int err = words_launch(dist, levels, words, nullptr, rows, "
     "batch, s);",
     "  const int err = (int)cudaMemcpyToSymbolAsync(\n"
     "      c_levels, levels, batch * sizeof(int), 0,\n"
     "      cudaMemcpyDeviceToDevice, s);\n"
     "  words = const_cast<void*>(dist);"),
    ("  const int n_words = (batch + 31) / 32;\n  if (blocks > 0) {",
     "  const int n_words = batch;\n  if (blocks > 0) {"),
)
UNROLL_8 = (("constexpr int kPullUnroll = 4;",
             "constexpr int kPullUnroll = 8;"),)
FULL_OCCUPANCY = (("__global__ void __launch_bounds__(kThreads) "
                   "frontier_pull_kernel(",
                   "__global__ void __launch_bounds__(kThreads, 8) "
                   "frontier_pull_kernel("),)


def variant(name: str, edits=(), appended: str = "") -> ctypes.CDLL:
    text = fk.SOURCE.read_text()
    for old, new in edits:
        if old not in text:
            raise SystemExit(f"{name}: the source no longer holds {old!r}")
        text = text.replace(old, new)
    stem = "frontier_flat_probe_" + name
    _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    path = _build.BUILD_DIR / f"{stem}.cu"
    path.write_text(text + appended)

    def declare(lib):
        fk._declare(lib)
        if appended:
            p, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
            lib.probe_flat_launch.argtypes = [p, p, p, p, p, p, i64, i32, p]
            lib.probe_flat_launch.restype = i32
            lib.probe_push_launch.argtypes = [p, p, p, p, p, i64, i32, p, p,
                                              i64, p]
            lib.probe_push_launch.restype = i32
    return _build.load(stem, path, declare)


def pull(lib, plan, dist, sigma, levels):
    """One level through ``lib``'s frontier_pull_launch (the wrapper's
    call, on a probe library)."""
    rows, batch = dist.shape
    words = torch.empty((rows, -(-batch // 32)), dtype=torch.int32,
                        device=dist.device)
    out = torch.empty_like(sigma)
    partial = torch.empty((max(plan.n_items, 1), batch), dtype=torch.float32,
                          device=dist.device)
    _build.check(lib.frontier_pull_launch(
        dist.data_ptr(), levels.data_ptr(), sigma.data_ptr(),
        words.data_ptr(), out.data_ptr(), partial.data_ptr(), rows, batch,
        plan.offsets.data_ptr(), plan.ids_sorted.data_ptr(),
        plan.n_segments, plan.split, plan.item_begin.data_ptr(),
        plan.item_end.data_ptr(), plan.n_items, plan.split_seg.data_ptr(),
        plan.split_first.data_ptr(), plan.split_seg.shape[0],
        _build.raw_stream(dist.device)), "probe pull")
    return out


def level(label: str, graph, libs: dict, batch: int = 64) -> None:
    dist, sigma, levels = cs.mid_bfs_state(graph, batch)
    rows = dist.shape[0]
    words = fk.frontier_words(dist, levels)[0]
    bits = (words.long()[:, :, None]
            >> torch.arange(32, device=words.device)) & 1
    hits = int(bits.sum((1, 2))[graph.src[: graph.n_edges].long()].sum())
    del bits
    want = frontier_expand_batched_ref(graph.src, graph.dst, dist, sigma,
                                       levels)
    plans = {split: fk.build_pull_plan(graph.src, graph.dst, rows,
                                       split=split)
             for split in (fk.PULL_SPLIT, 128, 2048, graph.max_degree + 1)}
    print(f"{label}: V={graph.n_nodes} E={graph.n_edges} max degree "
          f"{graph.max_degree}, (edge, column) frontier hits {hits} "
          f"({hits / max(graph.n_edges, 1):.1f} an edge); rows above the "
          f"split {fk.PULL_SPLIT}: {plans[fk.PULL_SPLIT].split_seg.shape[0]}"
          f", {plans[fk.PULL_SPLIT].n_items} items", flush=True)
    stream = _build.raw_stream(dist.device)
    appended = libs["appended"]

    def old_flat():
        out = torch.zeros_like(sigma)
        _build.check(appended.probe_flat_launch(
            graph.src.data_ptr(), graph.dst.data_ptr(), dist.data_ptr(),
            sigma.data_ptr(), levels.data_ptr(), out.data_ptr(),
            graph.e_pad, batch, stream), "probe flat")
        return out

    def push_words():
        w = torch.empty((rows, -(-batch // 32)), dtype=torch.int32,
                        device=dist.device)
        out = torch.empty_like(sigma)
        _build.check(appended.probe_push_launch(
            dist.data_ptr(), levels.data_ptr(), sigma.data_ptr(),
            w.data_ptr(), out.data_ptr(), rows, batch,
            graph.indptr.data_ptr(), graph.indices.data_ptr(),
            graph.n_nodes, stream), "probe push")
        return out

    runs = {
        "(a) push, atomics": old_flat,
        "(b) pull, words": lambda: pull(libs["built"], plans[fk.PULL_SPLIT],
                                        dist, sigma, levels),
        "(c) pull, dist rows": lambda: pull(libs["dist rows"],
                                            plans[fk.PULL_SPLIT], dist,
                                            sigma, levels),
        "(d) pull, no hub split": lambda: pull(
            libs["built"], plans[graph.max_degree + 1], dist, sigma, levels),
        "(e) push, words": push_words,
        "(f) pull, 8 in flight": lambda: pull(
            libs["unroll 8"], plans[fk.PULL_SPLIT], dist, sigma, levels),
        "(g) pull, split 128": lambda: pull(libs["built"], plans[128], dist,
                                            sigma, levels),
        "(h) pull, split 2048": lambda: pull(libs["built"], plans[2048],
                                             dist, sigma, levels),
        "(i) pull, 8 blocks an SM": lambda: pull(
            libs["8 blocks"], plans[fk.PULL_SPLIT], dist, sigma, levels),
    }
    for name, fn in runs.items():
        same = torch.equal(fn(), want)
        torch.cuda.synchronize()
        ms = cs.cuda_time_ms(fn, 20)
        print(f"  {name:26s} {ms:8.3f} ms a level"
              f"{'; equal to the plain version' if same else '; DIFFERS'}",
              flush=True)
    cs.library_ms(graph, dist, sigma, levels)


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA card")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    print(f"{torch.cuda.get_device_name(0)}; nvidia-smi: {smi}", flush=True)
    libs = {"built": fk.library(),
            "appended": variant("appended", appended=APPENDED),
            "dist rows": variant("dist_rows", DIST_ROWS),
            "unroll 8": variant("unroll8", UNROLL_8),
            "8 blocks": variant("occupancy", FULL_OCCUPANCY)}
    rmat = tc.rmat_graph(20, 30, seed=cs.SEED, device="cuda")
    level("R-MAT 2^20 x 30, B=64", rmat, libs)
    del rmat
    torch.cuda.empty_cache()
    er = tc.erdos_renyi_graph(1 << 20, 54.0, seed=cs.SEED, device="cuda")
    level("Erdos-Renyi(2^20, 54), B=64", er, libs)


if __name__ == "__main__":
    main()
