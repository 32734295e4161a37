"""The port stands alone: ``repro_torch`` imports neither JAX nor the JAX
package, and its entry points raise without a card unless the caller
asks for the CPU."""
import ast
import importlib.util
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
import repro_torch.configs.llama3_2_3b as llama
import repro_torch.models.transformer as lm
from repro_torch.checkpoint import restore
from repro_torch.configs.graphsage_reddit import make_smoke_config
from repro_torch.data import graph_to_batch
from repro_torch.models.convert import lm_params_from_numpy
from repro_torch.models.gnn import (GraphBatch, sage_init,
                                    sage_params_from_numpy)

SRC = Path(repro_torch.__file__).resolve().parent
EXAMPLES = SRC.parents[1] / "examples"


def _quickstart():
    spec = importlib.util.spec_from_file_location(
        "quickstart_torch", EXAMPLES / "quickstart_torch.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _scaling():
    spec = importlib.util.spec_from_file_location(
        "betweenness_scaling_torch",
        EXAMPLES / "betweenness_scaling_torch.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


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
    assert int(out.stdout.strip()) >= 52


def test_guard_walks_the_forward_slice_modules():
    """The import guard above reaches every module of the forward stream
    and the stop-check kernel."""
    assert {"repro_torch.core.estimators.closeness",
            "repro_torch.core.estimators.harmonic",
            "repro_torch.kernels.stopcheck.kernel",
            "repro_torch.kernels.stopcheck.ops",
            "repro_torch.kernels.stopcheck.ref"} <= set(_submodules())


def test_sources_name_no_jax_and_no_repro():
    """The package, the card's smoke script and the port's examples."""
    offenders = []
    scripts = [SRC.parents[1] / "chip_smoke.py",
               *sorted(EXAMPLES.glob("*_torch.py"))]
    assert len(scripts) >= 3
    for path in [*SRC.rglob("*.py"), *scripts]:
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


def test_guard_walks_the_spmd_slice_modules():
    """The import guard reaches the aggregation and the launcher."""
    assert {"repro_torch.core.distributed", "repro_torch.launch",
            "repro_torch.launch.mesh"} <= set(_submodules())


def test_guard_walks_the_sharded_group_slice():
    """The import guard reaches the shard meshes and the partition, and
    the scripts a spawned shard rank or the card's phase imports name
    no JAX either."""
    assert {"repro_torch.core.shards", "repro_torch.core.partition",
            "repro_torch.core.bfs"} <= set(_submodules())
    root = SRC.parents[1]
    for path in (root / "tests" / "_torch_sharded_ranks.py",
                 root / "tools" / "sharded_group_phase.py"):
        for node in ast.walk(ast.parse(path.read_text())):
            if isinstance(node, (ast.Import, ast.ImportFrom)):
                names = ([a.name for a in node.names]
                         if isinstance(node, ast.Import)
                         else [node.module or ""])
                assert not any(n.split(".")[0] in ("jax", "jaxlib", "repro")
                               for n in names), (path.name, node.lineno)


def test_guard_walks_the_checkpoint_slice_modules():
    """The import guard reaches the store, the schema stamp's module and
    the betweenness config."""
    assert {"repro_torch.checkpoint",
            "repro_torch.checkpoint.store",
            "repro_torch.configs.betweenness",
            "repro_torch.core.epoch"} <= set(_submodules())


def test_guard_walks_the_lm_slice_modules():
    """The import guard above reaches every module of the LM serving
    slice and the flash-attention kernel, and the source scan below reads
    their files."""
    modules = {"repro_torch.configs.llama3_2_3b",
               "repro_torch.kernels.flashattn.kernel",
               "repro_torch.kernels.flashattn.ops",
               "repro_torch.kernels.flashattn.ref",
               "repro_torch.models.attention",
               "repro_torch.models.convert",
               "repro_torch.models.transformer"}
    assert modules <= set(_submodules())
    scanned = {p.relative_to(SRC.parent).with_suffix("").as_posix()
               .replace("/", ".") for p in SRC.rglob("*.py")}
    assert modules <= scanned


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
    lambda: lm.init_params(torch.Generator(), llama.make_smoke_config()),
    lambda: lm.init_cache(llama.make_smoke_config(), 1, 8),
    lambda: lm_params_from_numpy({"ln_f": torch.ones(2).numpy()}),
    lambda: restore("no-such-dir", (torch.zeros(1),)),
    lambda: _quickstart().main([]),
    lambda: _scaling().main([]),
], ids=["generator", "from_edge_list", "run_kadabra", "run_adaptive",
        "graph_to", "run_fixed", "run_fixed_sampling", "sage_init",
        "graph_to_batch", "sage_params_from_numpy", "graph_batch_to",
        "lm_init_params", "lm_init_cache", "lm_params_from_numpy",
        "checkpoint_restore", "quickstart_torch",
        "betweenness_scaling_torch"])
def test_entry_points_raise_without_a_card(call, monkeypatch):
    """The default device is CUDA; with no card the call raises instead
    of running on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        call()


def test_scaling_example_runs_on_the_cpu(capsys, monkeypatch):
    """examples/betweenness_scaling_torch.py with --device cpu on R-MAT
    2^8: 8 ranks of a gloo group, the three aggregations within eps of
    Brandes and bitwise alike on every rank."""
    # imported by its name, so that the ranks it spawns import it too
    monkeypatch.syspath_prepend(str(EXAMPLES))
    scaling = importlib.import_module("betweenness_scaling_torch")
    results = scaling.main(["--device", "cpu", "--scale", "8", "--half",
                            "spmd"])["spmd"]
    assert len(results) == 8
    out = capsys.readouterr().out
    assert out.rstrip().endswith("OK") and out.count("the same bits: True") \
        == 3


def test_guard_walks_the_weighted_slice():
    """The import guard reaches the weighted lane's modules (the relax
    kernels' wrappers, dispatchers and plain versions beside the BFS
    ones), its CUDA source is in the package, and the card's phase
    script and the ranks' helpers import no JAX; without a card the
    weighted entry points raise unless the CPU is asked for."""
    assert {"repro_torch.kernels.frontier.kernel",
            "repro_torch.kernels.frontier.ops",
            "repro_torch.kernels.frontier.ref", "repro_torch.core.bfs",
            "repro_torch.core.sampler", "repro_torch.core.diameter",
            "repro_torch.core.engine"} <= set(_submodules())
    assert (SRC / "kernels" / "frontier" / "csrc" / "relax.cu").exists()
    root = SRC.parents[1]
    for path in (root / "tools" / "weighted_phase.py",
                 root / "tests" / "_torch_spmd_ranks.py"):
        for node in ast.walk(ast.parse(path.read_text())):
            if isinstance(node, (ast.Import, ast.ImportFrom)):
                names = ([a.name for a in node.names]
                         if isinstance(node, ast.Import)
                         else [node.module or ""])
                assert not any(n.split(".")[0] in ("jax", "jaxlib", "repro")
                               for n in names), (path.name, node.lineno)
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable")
    g = tc.grid_graph(4, 4, device="cpu")
    g = tc.with_weights(g, torch.ones(g.n_edges))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tc.run_adaptive(g, stream="weighted")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tc.run_fixed(g, 4, stream="weighted")


def test_guard_walks_the_runtime_slice():
    """The import guard reaches the runtime's modules (events, telemetry,
    faults, supervisor), and the spawned ranks of its tests import no
    JAX either."""
    assert {"repro_torch.runtime", "repro_torch.runtime.events",
            "repro_torch.runtime.faults", "repro_torch.runtime.supervisor",
            "repro_torch.runtime.telemetry"} <= set(_submodules())
    path = SRC.parents[1] / "tests" / "_torch_runtime_ranks.py"
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, (ast.Import, ast.ImportFrom)):
            names = ([a.name for a in node.names]
                     if isinstance(node, ast.Import) else [node.module or ""])
            assert not any(n.split(".")[0] in ("jax", "jaxlib", "repro")
                           for n in names), (path.name, node.lineno)


def test_guard_walks_the_gnn_slice():
    """The import guard reaches the equivariant models, the irreps and
    the sampler; the card's [20] scripts name no JAX; without a card the
    GNN entry points raise unless the CPU is asked for."""
    assert {"repro_torch.models.gnn.irreps", "repro_torch.models.gnn.models",
            "repro_torch.configs.egnn", "repro_torch.configs.nequip",
            "repro_torch.configs.mace",
            "repro_torch.data.pipeline"} <= set(_submodules())
    root = SRC.parents[1]
    for path in (root / "tools" / "gnn_phase.py",
                 root / "tools" / "sage_forward_probe.py"):
        for node in ast.walk(ast.parse(path.read_text())):
            if isinstance(node, (ast.Import, ast.ImportFrom)):
                names = ([a.name for a in node.names]
                         if isinstance(node, ast.Import)
                         else [node.module or ""])
                assert not any(n.split(".")[0] in ("jax", "jaxlib", "repro")
                               for n in names), (path.name, node.lineno)
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable")
    from repro_torch.configs import egnn, mace, nequip
    from repro_torch.models import gnn
    for name, mod in (("egnn", egnn), ("nequip", nequip), ("mace", mace)):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            getattr(gnn, f"{name}_init")(torch.Generator().manual_seed(0),
                                         mod.make_smoke_config())
    from repro_torch.data import NeighborSampler
    graph = tc.grid_graph(4, 4, device="cpu")
    sampler = NeighborSampler(graph, (2,), 3)
    feats = torch.zeros(16, 2).numpy()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        sampler.to_graph_batch(sampler.sample(0), feats,
                               torch.zeros(16, dtype=torch.int32).numpy(),
                               n_classes=2)


def test_guard_walks_the_moe_and_recsys_slice():
    """The import guard reaches the MoE FFN, MIND, their converters and
    the new configs; the card's [21] script names no JAX; without a card
    their entry points raise unless the CPU is asked for."""
    assert {"repro_torch.models.moe", "repro_torch.models.recsys",
            "repro_torch.models.recsys.mind",
            "repro_torch.models.recsys.convert",
            "repro_torch.configs.granite_moe_3b_a800m",
            "repro_torch.configs.moonshot_v1_16b_a3b",
            "repro_torch.configs.qwen2_7b",
            "repro_torch.configs.mind"} <= set(_submodules())
    path = SRC.parents[1] / "tools" / "moe_recsys_phase.py"
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, (ast.Import, ast.ImportFrom)):
            names = ([a.name for a in node.names]
                     if isinstance(node, ast.Import) else [node.module or ""])
            assert not any(n.split(".")[0] in ("jax", "jaxlib", "repro")
                           for n in names), (path.name, node.lineno)
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable")
    from repro_torch.configs import granite_moe_3b_a800m, mind, qwen2_7b
    from repro_torch.data import recsys_batch_fn
    from repro_torch.models import moe, recsys
    gen = torch.Generator().manual_seed(0)
    calls = [
        lambda: lm.init_params(gen, granite_moe_3b_a800m.make_smoke_config()),
        lambda: lm.init_params(gen, qwen2_7b.make_smoke_config()),
        lambda: moe.init_moe_params(
            gen, granite_moe_3b_a800m.make_smoke_config().moe),
        lambda: recsys.init_params(gen, mind.make_smoke_config()),
        lambda: recsys.mind_params_from_numpy(
            {k: v.numpy() for k, v in recsys.init_params(
                gen, mind.make_smoke_config(), device="cpu").items()}),
        lambda: recsys_batch_fn(1024, 4, 10),
    ]
    for call in calls:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            call()


def test_guard_walks_the_gemma3_slice():
    """The import guard reaches gemma3's config; the card's [22] script
    names no JAX; without a card the config's weights and cache raise
    unless the CPU is asked for."""
    assert "repro_torch.configs.gemma3_27b" in set(_submodules())
    path = SRC.parents[1] / "tools" / "gemma_phase.py"
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, (ast.Import, ast.ImportFrom)):
            names = ([a.name for a in node.names]
                     if isinstance(node, ast.Import) else [node.module or ""])
            assert not any(n.split(".")[0] in ("jax", "jaxlib", "repro")
                           for n in names), (path.name, node.lineno)
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable")
    from repro_torch.configs import gemma3_27b
    cfg = gemma3_27b.make_smoke_config()
    for call in (lambda: lm.init_params(torch.Generator(), cfg),
                 lambda: lm.init_cache(cfg, 1, 8)):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            call()


def test_guard_walks_the_lm_training_slice():
    """The import guard reaches the training slice's modules (the
    launcher, the backward's wrapper); the training example names no
    JAX; without a card the launcher and the example raise unless the
    CPU is asked for."""
    assert {"repro_torch.launch.train", "repro_torch.kernels.flashattn.ops",
            "repro_torch.optim.adamw", "repro_torch.train.step",
            "repro_torch.data.pipeline"} <= set(_submodules())
    example = EXAMPLES / "train_lm_torch.py"
    for node in ast.walk(ast.parse(example.read_text())):
        if isinstance(node, (ast.Import, ast.ImportFrom)):
            names = ([a.name for a in node.names]
                     if isinstance(node, ast.Import) else [node.module or ""])
            assert not any(n.split(".")[0] in ("jax", "jaxlib", "repro")
                           for n in names), (example.name, node.lineno)
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable")
    from repro_torch.launch import train
    spec = importlib.util.spec_from_file_location("train_lm_torch", example)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    for call in (lambda: train.main(["--smoke", "--steps", "1"]),
                 lambda: mod.main(["--steps", "1"])):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            call()
