"""Shared pieces of the equivariant-GNN parity tests: the models at test
size in both packages, the batch of ``tests/test_gnn_models.py``, the
weight carrier and the outputs of a forward by name."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np

import repro.models.gnn.message_passing as jmp
import repro.models.gnn.models as jm
import repro_torch.models.gnn as tg


@dataclasses.dataclass(frozen=True)
class Model:
    name: str
    jcfg: object
    tcfg: object
    convert: object

    def j(self, what):
        return getattr(jm, f"{self.name}_{what}")

    def t(self, what):
        return getattr(tg, f"{self.name}_{what}")


def _model(name, **kw):
    jc = {"egnn": jm.EgnnConfig, "nequip": jm.NequipConfig,
          "mace": jm.MaceConfig}[name](**kw)
    tc = {"egnn": tg.EgnnConfig, "nequip": tg.NequipConfig,
          "mace": tg.MaceConfig}[name](**kw)
    return Model(name, jc, tc, getattr(tg, f"{name}_params_from_numpy"))


MODELS = {
    "egnn": _model("egnn", n_layers=2, d_hidden=16, d_in=16),
    "nequip": _model("nequip", n_layers=2, d_hidden=8),
    "mace": _model("mace", n_layers=2, d_hidden=8),
}
NAMES = list(MODELS)


def jbatch(n=40, e=160, f=16, n_graphs=4, seed=0):
    """The batch of ``tests/test_gnn_models.py``."""
    rng = np.random.default_rng(seed)
    src = rng.integers(0, n, e).astype(np.int32)
    dst = rng.integers(0, n, e).astype(np.int32)
    return jmp.GraphBatch(
        x=jnp.asarray(rng.standard_normal((n, f)), jnp.float32),
        z=jnp.asarray(rng.integers(0, 8, n), jnp.int32),
        pos=jnp.asarray(rng.standard_normal((n, 3)), jnp.float32),
        src=jnp.asarray(src), dst=jnp.asarray(dst),
        edge_mask=jnp.ones((e,), jnp.float32),
        node_mask=jnp.ones((n,), jnp.float32),
        labels=jnp.asarray(rng.integers(0, 5, n), jnp.int32),
        graph_id=jnp.asarray(rng.integers(0, n_graphs, n), jnp.int32),
        y=jnp.asarray(rng.standard_normal(n_graphs), jnp.float32),
        n_graphs=n_graphs,
    )




def carry(name, jparams):
    """The port's params of a JAX param tree (CPU)."""
    return MODELS[name].convert(jax.tree.map(np.asarray, jparams),
                                device="cpu")


def outputs(name, out):
    """(label, tensor) pairs of a forward: EGNN's h and positions, the
    others' features per l and energy."""
    if name == "egnn":
        return [("h", out[0]), ("pos", out[1])]
    feats, energy = out
    return [(f"feats[{l}]", feats[l]) for l in sorted(feats)] + \
        [("energy", energy)]
