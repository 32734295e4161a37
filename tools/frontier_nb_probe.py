"""What bounds the node-blocked frontier level (K2) on the card.

Builds variants of ``frontier_nb_kernel`` from the committed source
(``src/repro_torch/kernels/frontier/csrc/frontier.cu``) by text edits
and times each level (words pass + node-blocked kernel, one C call) at
one mid-BFS level, B=64, of R-MAT 2^20 x 30 and of an Erdos-Renyi graph
of the same size (no hubs):

* ``as built``: the kernel as committed;
* ``unsorted``: no edge block sorts its edges by destination, so each
  hit edge makes its own atomic wherever destinations are not already
  consecutive;
* ``unsorted, plain stores``: that, storing sigma in place of adding it
  (a wrong result; it shows what the atomics themselves cost);
* ``scalar columns``: one column a lane, in place of float4;
* ``staging pass only``: the edge ids, the frontier test and the block
  skip, with no sort and no column pass.

Beside them the (edge, column) frontier hits and ``torch.sparse.mm``
on the same level.  Needs a CUDA card and nvcc:

    PYTHONPATH=src python tools/frontier_nb_probe.py
"""
from __future__ import annotations

import sys
from pathlib import Path

import torch

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))

import chip_smoke as cs  # noqa: E402
import repro_torch.core as tc  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels.frontier import kernel as fk  # noqa: E402

UNSORTED = (("const bool sorted = block_v < (1 << (31 - kSlotBits));",
             "const bool sorted = false;"),)
STORES = (("atomicAdd(reinterpret_cast<float4*>(out + dst_row + b), acc);",
           "*reinterpret_cast<float4*>(out + dst_row + b) = acc;"),
          ("atomicAdd(out + dst_row + b, acc.x);",
           "out[dst_row + b] = acc.x;"))
NO_VEC = ("const int vec_cols = batch % 4 == 0", "const int vec_cols = 0")
STAGING_ONLY = ("if (!__syncthreads_or(any)) return;",
                "if (!__syncthreads_or(any) || vec_ids >= 0) return;")


def variant(name: str, *edits) -> object:
    text = fk.SOURCE.read_text()
    for old, new in edits:
        if old not in text:
            raise SystemExit(f"{name}: the source no longer holds {old!r}")
        text = text.replace(old, new)
    stem = "frontier_probe_" + name.replace(" ", "_")
    _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    path = _build.BUILD_DIR / f"{stem}.cu"
    path.write_text(text)
    return _build.load(stem, path, fk._declare)


def level(label: str, graph, libs: dict, batch: int = 64) -> None:
    csc = tc.build_csc_layout(graph)
    dist, sigma, levels = cs.mid_bfs_state(graph, batch)
    pad = csc.v_pad - dist.shape[0]
    dist = torch.cat([dist, dist.new_full((pad, batch), -3)]).contiguous()
    sigma = torch.cat([sigma, sigma.new_zeros((pad, batch))]).contiguous()
    words, out = fk.frontier_words(dist, levels)
    bits = (words.long()[:, :, None]
            >> torch.arange(32, device=words.device)) & 1
    hits = int(bits.sum((1, 2))[csc.src.long()].sum())
    del bits
    want = fk.frontier_expand_node_blocked_ref(csc, dist, sigma, levels)
    print(f"{label}: V={graph.n_nodes} E={graph.n_edges}, "
          f"{csc.n_edge_blocks} edge blocks, (edge, column) frontier hits "
          f"{hits} ({hits / max(graph.n_edges, 1):.1f} an edge)", flush=True)

    def run(lib):
        code = lib.frontier_nb_launch(
            csc.src.data_ptr(), csc.dst.data_ptr(), csc.block_nb.data_ptr(),
            dist.data_ptr(), levels.data_ptr(), sigma.data_ptr(),
            words.data_ptr(), out.data_ptr(), dist.shape[0],
            csc.n_edge_blocks, csc.block_e, csc.block_v, batch,
            torch.cuda.current_stream().cuda_stream)
        _build.check(code, "probe launch")

    for name, lib in libs.items():
        run(lib)
        torch.cuda.synchronize()
        same = torch.equal(out, want)
        ms = cs.cuda_time_ms(lambda: run(lib), 20)
        print(f"  {name:28s} {ms:8.3f} ms a level (words pass included)"
              f"{'; equal to the plain version' if same else ''}",
              flush=True)
    cs.library_ms(graph, dist, sigma, levels)


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA card")
    libs = {"as built": fk.library(),
            "unsorted": variant("unsorted", *UNSORTED),
            "unsorted, plain stores": variant("unsorted stores", *UNSORTED,
                                              *STORES),
            "scalar columns": variant("scalar columns", NO_VEC),
            "staging pass only": variant("staging only", STAGING_ONLY)}
    print(torch.cuda.get_device_name(0), flush=True)
    rmat = tc.rmat_graph(20, 30, seed=cs.SEED, device="cuda")
    level("R-MAT 2^20 x 30, B=64", rmat, libs)
    del rmat
    torch.cuda.empty_cache()
    er = tc.erdos_renyi_graph(1 << 20, 54.0, seed=cs.SEED, device="cuda")
    level("Erdos-Renyi(2^20, 54), B=64", er, libs)


if __name__ == "__main__":
    main()
