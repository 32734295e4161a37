"""The port stands alone: ``repro_torch`` imports neither JAX nor the JAX
package, and its entry points raise without a card unless the caller
asks for the CPU."""
import ast
import os
import pkgutil
import subprocess
import sys
import textwrap
from pathlib import Path

import pytest
import torch

import repro_torch
import repro_torch.core as tc
from repro_torch.configs.graphsage_reddit import make_smoke_config
from repro_torch.data import graph_to_batch
from repro_torch.models.gnn import (GraphBatch, sage_init,
                                    sage_params_from_numpy)

SRC = Path(repro_torch.__file__).resolve().parent


def _submodules():
    return sorted(m.name for m in pkgutil.walk_packages(
        [str(SRC)], prefix="repro_torch."))


def test_import_pulls_in_no_jax_and_no_repro():
    code = textwrap.dedent(f"""
        import importlib, sys
        for name in {_submodules()!r}:
            importlib.import_module(name)
        bad = sorted(m for m in sys.modules
                     if m == "jax" or m.startswith(("jax.", "jaxlib"))
                     or m == "repro" or m.startswith("repro."))
        assert not bad, bad
        print(len({_submodules()!r}))
    """)
    env = dict(os.environ, PYTHONPATH=str(SRC.parent))
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.strip()) >= 45


def test_guard_walks_the_forward_slice_modules():
    """The import guard above reaches every module of the forward stream
    and the stop-check kernel."""
    assert {"repro_torch.core.estimators.closeness",
            "repro_torch.core.estimators.harmonic",
            "repro_torch.kernels.stopcheck.kernel",
            "repro_torch.kernels.stopcheck.ops",
            "repro_torch.kernels.stopcheck.ref"} <= set(_submodules())


def test_sources_name_no_jax_and_no_repro():
    offenders = []
    for path in SRC.rglob("*.py"):
        tree = ast.parse(path.read_text())
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                names = [] if node.level else [node.module or ""]
            else:
                continue
            for name in names:
                root = name.split(".")[0]
                if root in ("jax", "jaxlib", "repro"):
                    offenders.append(f"{path.name}:{node.lineno} {name}")
    assert not offenders, offenders


def test_guard_walks_the_graphsage_slice_modules():
    """The import guard above reaches every module of the GraphSAGE slice
    and the gather-segment-sum kernel."""
    assert {"repro_torch.configs._families",
            "repro_torch.configs.graphsage_reddit",
            "repro_torch.data.pipeline",
            "repro_torch.kernels.segsum.kernel",
            "repro_torch.kernels.segsum.ops",
            "repro_torch.kernels.segsum.ref",
            "repro_torch.models.common",
            "repro_torch.models.gnn.convert",
            "repro_torch.models.gnn.message_passing",
            "repro_torch.models.gnn.models",
            "repro_torch.optim.adamw",
            "repro_torch.train.step",
            "repro_torch.tree"} <= set(_submodules())


@pytest.mark.parametrize("call", [
    lambda: tc.grid_graph(4, 4),
    lambda: tc.from_edge_list([[0, 1], [1, 2]]),
    lambda: tc.run_kadabra(tc.grid_graph(3, 3, device="cpu")),
    lambda: tc.run_adaptive(tc.grid_graph(3, 3, device="cpu")),
    lambda: tc.grid_graph(3, 3, device="cpu").to("cuda"),
    lambda: tc.run_fixed(tc.grid_graph(3, 3, device="cpu"), 8,
                         metrics=("closeness",)),
    lambda: tc.run_fixed_sampling(tc.grid_graph(3, 3, device="cpu"), 8),
    lambda: sage_init(torch.Generator(), make_smoke_config()),
    lambda: graph_to_batch(tc.grid_graph(3, 3, device="cpu"), d_feat=4,
                           n_classes=2),
    lambda: sage_params_from_numpy(
        sage_init(torch.Generator(), make_smoke_config(), device="cpu")),
    lambda: GraphBatch(*[torch.zeros(1)] * 10, n_graphs=1).to("cuda"),
], ids=["generator", "from_edge_list", "run_kadabra", "run_adaptive",
        "graph_to", "run_fixed", "run_fixed_sampling", "sage_init",
        "graph_to_batch", "sage_params_from_numpy", "graph_batch_to"])
def test_entry_points_raise_without_a_card(call, monkeypatch):
    """The default device is CUDA; with no card the call raises instead
    of running on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        call()
