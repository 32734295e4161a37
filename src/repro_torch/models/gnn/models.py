"""The four GNN architectures (``repro.models.gnn.models``), as plain
functions over param dicts with the JAX package's names and layout:

  graphsage  — 2 layers, mean aggregator (Hamilton et al. '17)
  egnn       — 4 layers, E(n)-equivariant (Satorras et al. '21)
  nequip     — 5 layers, l_max=2 tensor-product messages (Batzner '21)
  mace       — 2 layers, correlation-order-3 ACE messages (Batatia '22)

Every message sum is one ``gather_segment_sum`` call (K4 on the card,
its plain version on the CPU; ``use_kernel`` as there): GraphSAGE's
neighbour mean over the (src, dst) plan, the equivariant models' masked
edge-message sums over the batch's edge plan.  NequIP and MACE sum the
messages of l = 0, 1, 2 in one call a layer, concatenated column-wise as
(E, C | 3C | 5C): K4 sums every column alone in plan order, so this is
bitwise three calls.  MACE's symmetric contraction is iterated CG
products (B2 = A (x) A, B3 = B2 (x) A), as in the JAX package.
"""
from __future__ import annotations

import dataclasses
import math

import torch
import torch.nn.functional as F

from ...device import DEFAULT_DEVICE, resolve_device
from ..common import dense_init
from . import irreps
from .message_passing import (GraphBatch, graph_regression_loss,
                              node_classification_loss, scatter_edges,
                              scatter_edges_mean, scatter_mean)

__all__ = ["EgnnConfig", "MaceConfig", "NequipConfig", "SageConfig",
           "egnn_forward", "egnn_init", "egnn_loss", "mace_forward",
           "mace_init", "mace_loss", "nequip_forward", "nequip_init",
           "nequip_loss", "sage_forward", "sage_init", "sage_loss"]


@dataclasses.dataclass(frozen=True)
class SageConfig:
    n_layers: int = 2
    d_in: int = 602
    d_hidden: int = 128
    n_classes: int = 41
    n_types: int = 32          # fallback embedding when x is absent
    aggregator: str = "mean"
    # "sharded" | "replicated" in the JAX package's multi-device cells;
    # kept for the configs, no effect on one GPU
    node_sharding: str = "sharded"


def sage_init(generator: torch.Generator, cfg: SageConfig, *,
              device=DEFAULT_DEVICE) -> dict:
    """Float32 parameters drawn from ``generator`` in a fixed order
    (embed_in, embed_z, each layer's w_self and w_neigh, head)."""
    dev = resolve_device(device)

    def draw(shape):
        return dense_init(generator, shape, torch.float32, device=dev)

    params = {"embed_in": draw((cfg.d_in, cfg.d_hidden)),
              "embed_z": draw((cfg.n_types, cfg.d_hidden)),
              "layers": []}
    for _ in range(cfg.n_layers):
        params["layers"].append({
            "w_self": draw((cfg.d_hidden, cfg.d_hidden)),
            "w_neigh": draw((cfg.d_hidden, cfg.d_hidden))})
    params["head"] = draw((cfg.d_hidden, cfg.n_classes))
    return params


def sage_forward(params, batch: GraphBatch, cfg: SageConfig, *,
                 use_kernel=None):
    """(N, n_classes) logits.  Each layer's neighbour mean is one
    ``gather_segment_sum`` call (``use_kernel`` as there)."""
    if cfg.aggregator != "mean":
        raise NotImplementedError(f"aggregator {cfg.aggregator!r}: the JAX "
                                  "package implements mean only")
    h = batch.x.float() @ params["embed_in"] \
        + params["embed_z"][batch.z.long()]
    for lp in params["layers"]:
        neigh = scatter_mean(h, batch, use_kernel=use_kernel)
        h = torch.relu(h @ lp["w_self"] + neigh @ lp["w_neigh"])
        h = h / torch.clamp(torch.linalg.vector_norm(h, dim=-1, keepdim=True),
                            min=1e-6)
    return h @ params["head"]


def sage_loss(params, batch: GraphBatch, cfg: SageConfig, *,
              use_kernel=None):
    return node_classification_loss(
        sage_forward(params, batch, cfg, use_kernel=use_kernel), batch)


# ===========================================================================
# EGNN
# ===========================================================================

@dataclasses.dataclass(frozen=True)
class EgnnConfig:
    n_layers: int = 4
    d_hidden: int = 64
    n_types: int = 32
    d_in: int = 0              # optional extra features
    n_classes: int = 0         # 0 => graph regression head
    update_pos: bool = True
    # "sharded" | "replicated" in the JAX package's multi-device cells;
    # kept for the configs, no effect on one GPU
    node_sharding: str = "sharded"
    # dtype of the hidden states and edge messages: "f32" | "bf16" (K4
    # then sums a bfloat16 table in float32 and rounds once)
    agg_dtype: str = "f32"
    # the JAX package's explicit-collective forward; raises here
    partitioned: bool = False


def _draws(generator, dev):
    def draw(shape, scale: float = 1.0):
        return dense_init(generator, shape, torch.float32, scale, device=dev)
    return draw


def _mlp_init(draw, dims) -> list:
    return [draw((a, b)) for a, b in zip(dims[:-1], dims[1:])]


def _mlp(ws, x):
    for i, w in enumerate(ws):
        x = x @ w
        if i < len(ws) - 1:
            x = F.silu(x)
    return x


def egnn_init(generator: torch.Generator, cfg: EgnnConfig, *,
              device=DEFAULT_DEVICE) -> dict:
    """Float32 parameters drawn from ``generator`` in a fixed order
    (embed_z, embed_x, head, then each layer's edge, coord and node
    MLPs)."""
    draw = _draws(generator, resolve_device(device))
    d = cfg.d_hidden
    params = {"embed_z": draw((cfg.n_types, d)),
              "embed_x": draw((max(cfg.d_in, 1), d)),
              "head": draw((d, max(cfg.n_classes, 1))),
              "layers": []}
    for _ in range(cfg.n_layers):
        params["layers"].append({
            "edge_mlp": _mlp_init(draw, (2 * d + 1, d, d)),
            "coord_mlp": _mlp_init(draw, (d, d, 1)),
            "node_mlp": _mlp_init(draw, (2 * d, d, d))})
    return params


def egnn_forward(params, batch: GraphBatch, cfg: EgnnConfig, *,
                 use_kernel=None):
    """(h (N, d) in the message dtype, pos (N, 3) float32).  Each layer
    sums its messages in one ``gather_segment_sum`` call and, with
    ``update_pos``, its coordinate mean in a second (D = 3)."""
    if cfg.partitioned:
        raise NotImplementedError(
            "EgnnConfig(partitioned=True): the explicit-collective forward "
            "(egnn_forward_partitioned) waits for the rest of the sharded "
            "lane, ROADMAP item 12")
    h = params["embed_z"][batch.z.long()]
    if cfg.d_in:
        h = h + batch.x.float() @ params["embed_x"]
    pos = batch.pos.float()
    # bf16 mode: hidden states and edge messages in bfloat16, the
    # message sum accumulated in float32 and rounded once
    mdt = torch.bfloat16 if cfg.agg_dtype == "bf16" else torch.float32
    h = h.to(mdt)
    src, dst = batch.src.long(), batch.dst.long()
    mask = batch.edge_mask[:, None].to(mdt)
    for lp in params["layers"]:
        rel = pos[src] - pos[dst]
        d2 = torch.sum(rel * rel, dim=-1, keepdim=True)
        m_in = torch.cat([h[src], h[dst], d2.to(mdt)], dim=-1)
        m = _mlp([w.to(mdt) for w in lp["edge_mlp"]], m_in) * mask
        agg = scatter_edges(m, batch, use_kernel=use_kernel)
        h = h + _mlp([w.to(mdt) for w in lp["node_mlp"]],
                     torch.cat([h, agg], dim=-1))
        if cfg.update_pos:
            # E(n)-equivariant coordinate update on the receiver (dst):
            # x_i += mean_j (x_i - x_j) phi(m_ij), rel = x_src - x_dst
            coef = (_mlp([w.to(mdt) for w in lp["coord_mlp"]], m)
                    * mask).float()
            pos = pos + scatter_edges_mean(-rel * coef, batch,
                                           use_kernel=use_kernel)
    return h, pos


def egnn_loss(params, batch: GraphBatch, cfg: EgnnConfig, *,
              use_kernel=None):
    h, _pos = egnn_forward(params, batch, cfg, use_kernel=use_kernel)
    out = h.float() @ params["head"]
    if cfg.n_classes:
        return node_classification_loss(out, batch)
    return graph_regression_loss(out[:, 0], batch)


# ===========================================================================
# NequIP
# ===========================================================================

@dataclasses.dataclass(frozen=True)
class NequipConfig:
    n_layers: int = 5
    d_hidden: int = 32          # channels per l
    l_max: int = 2
    n_rbf: int = 8
    cutoff: float = 5.0
    n_types: int = 32
    n_classes: int = 0
    # "sharded" | "replicated" in the JAX package's multi-device cells;
    # kept for the configs, no effect on one GPU
    node_sharding: str = "sharded"


def _radial_basis(r, n_rbf: int, cutoff: float):
    """Bessel-style radial basis with a smooth polynomial cutoff."""
    r = torch.clamp(r, min=1e-6)
    n = torch.arange(1, n_rbf + 1, dtype=torch.float32, device=r.device)
    basis = torch.sin(math.pi * n * r[:, None] / cutoff) / r[:, None]
    x = torch.clamp(r / cutoff, 0.0, 1.0)
    env = 1.0 - 10.0 * x ** 3 + 15.0 * x ** 4 - 6.0 * x ** 5
    return basis * env[:, None]


def _geometry(batch: GraphBatch, cfg):
    """Per edge: the radial basis (zero on padded and degenerate edges:
    a zero-length or self-loop edge has no direction, so Y_l(0) must not
    leak a non-equivariant constant) and the spherical harmonics of the
    unit vector src - dst."""
    src, dst = batch.src.long(), batch.dst.long()
    rel = (batch.pos[src] - batch.pos[dst]).float()
    r = torch.linalg.vector_norm(rel, dim=-1)
    unit = rel / torch.clamp(r, min=1e-6)[:, None]
    live = batch.edge_mask * (r > 1e-6)
    rbf = _radial_basis(r, cfg.n_rbf, cfg.cutoff) * live[:, None]
    return rbf, irreps.sh_all(unit, cfg.l_max)


def _edge_sums(msgs: dict, batch: GraphBatch, use_kernel) -> dict:
    """The masked destination sums of every l's messages (E, C, 2l+1) in
    one ``gather_segment_sum`` call: concatenated column-wise in l order,
    summed, split back to (N, C, 2l+1)."""
    ls = sorted(msgs)
    e = batch.n_edges
    flat = torch.cat([msgs[l].reshape(e, -1) for l in ls], dim=1)
    agg = scatter_edges(flat, batch, use_kernel=use_kernel)
    widths = [msgs[l].shape[1] * irreps.DIMS[l] for l in ls]
    n = batch.n_nodes
    return {l: part.reshape(n, -1, irreps.DIMS[l])
            for l, part in zip(ls, torch.split(agg, widths, dim=1))}


def _mix(x, w):
    """einsum("ncx,cd->ndx", x, w)."""
    return torch.einsum("ncx,cd->ndx", x, w)


def _messages(lp, feats: dict, batch: GraphBatch, rbf, ysh, l_max: int):
    """Tensor-product messages of the source features with Y, weighted
    per path by its radial MLP (only the paths whose l1 the features
    hold)."""
    src = batch.src.long()
    edge_feats = {l: f[src] for l, f in feats.items()}
    weights = {pq: _mlp(lp["radial"][pq], rbf) for pq in lp["radial"]
               if pq[0] in edge_feats}
    return irreps.tensor_product(edge_feats, ysh, weights, l_max)


def nequip_init(generator: torch.Generator, cfg: NequipConfig, *,
                device=DEFAULT_DEVICE) -> dict:
    """Float32 parameters drawn from ``generator``.  As in the JAX
    package, a layer's per-l mixers are one draw (the same key there)."""
    draw = _draws(generator, resolve_device(device))
    c = cfg.d_hidden
    pth = irreps.paths(cfg.l_max)
    params = {"embed_z": draw((cfg.n_types, c)),
              "head": _mlp_init(draw, (c, c, max(cfg.n_classes, 1))),
              "layers": []}
    for _ in range(cfg.n_layers):
        mix = draw((c, c), 1.0 / math.sqrt(cfg.n_layers))
        params["layers"].append({
            # post-aggregation per-l channel mixers
            "mix": {l: mix.clone() for l in range(cfg.l_max + 1)},
            "gate": draw((c, (cfg.l_max + 1) * c)),
            # radial MLP per path: n_rbf -> channels
            "radial": {pq: _mlp_init(draw, (cfg.n_rbf, c, c))
                       for pq in pth}})
    return params


def nequip_forward(params, batch: GraphBatch, cfg: NequipConfig, *,
                   use_kernel=None):
    """(feats {l: (N, C, 2l+1)}, energy (N, max(n_classes, 1))); one
    ``gather_segment_sum`` call a layer."""
    n = batch.n_nodes
    rbf, ysh = _geometry(batch, cfg)
    feats = {0: params["embed_z"][batch.z.long()][:, :, None]}
    for lp in params["layers"]:
        msgs = _messages(lp, feats, batch, rbf, ysh, cfg.l_max)
        new = {l: _mix(agg, lp["mix"][l])
               for l, agg in _edge_sums(msgs, batch, use_kernel).items()}
        gates = torch.sigmoid(feats[0][:, :, 0] @ lp["gate"]).reshape(
            n, cfg.l_max + 1, -1)
        out = {}
        for l in range(cfg.l_max + 1):
            upd = new.get(l)
            if upd is None:
                continue
            if l == 0:
                upd = F.silu(upd)
            upd = upd * gates[:, l, :, None]
            prev = feats.get(l)
            out[l] = upd if prev is None else prev + upd
        feats = out
    energy = _mlp(params["head"], feats[0][:, :, 0])
    return feats, energy


def nequip_loss(params, batch: GraphBatch, cfg: NequipConfig, *,
                use_kernel=None):
    _feats, out = nequip_forward(params, batch, cfg, use_kernel=use_kernel)
    if cfg.n_classes:
        return node_classification_loss(out, batch)
    return graph_regression_loss(out[:, 0], batch)


# ===========================================================================
# MACE
# ===========================================================================

@dataclasses.dataclass(frozen=True)
class MaceConfig:
    n_layers: int = 2
    d_hidden: int = 128
    l_max: int = 2
    correlation: int = 3
    n_rbf: int = 8
    cutoff: float = 5.0
    n_types: int = 32
    n_classes: int = 0
    # "sharded" | "replicated" in the JAX package's multi-device cells;
    # kept for the configs, no effect on one GPU
    node_sharding: str = "sharded"


def mace_init(generator: torch.Generator, cfg: MaceConfig, *,
              device=DEFAULT_DEVICE) -> dict:
    """Float32 parameters drawn from ``generator``.  As in the JAX
    package, a layer's per-l mixers of one correlation order are one
    draw."""
    draw = _draws(generator, resolve_device(device))
    c = cfg.d_hidden
    pth = irreps.paths(cfg.l_max)
    ls = range(cfg.l_max + 1)
    params = {"embed_z": draw((cfg.n_types, c)),
              "head": _mlp_init(draw, (c, c, max(cfg.n_classes, 1))),
              "layers": []}
    for _ in range(cfg.n_layers):
        mixes = [draw((c, c), scale) for scale in (1.0, 0.5, 0.25)]
        params["layers"].append({
            # per-correlation-order, per-l mixing weights
            "mix_a": {l: mixes[0].clone() for l in ls},
            "mix_b2": {l: mixes[1].clone() for l in ls},
            "mix_b3": {l: mixes[2].clone() for l in ls},
            "radial": {pq: _mlp_init(draw, (cfg.n_rbf, c, c)) for pq in pth},
            "update": draw((c, c))})
    return params


def mace_forward(params, batch: GraphBatch, cfg: MaceConfig, *,
                 use_kernel=None):
    """(feats {l: (N, C, 2l+1)}, energy (N, max(n_classes, 1))); the
    atomic basis A is one ``gather_segment_sum`` call a layer."""
    rbf, ysh = _geometry(batch, cfg)
    feats = {0: params["embed_z"][batch.z.long()][:, :, None]}
    for lp in params["layers"]:
        # atomic basis A_i: the summed TP of the neighbours with Y
        msgs = _messages(lp, feats, batch, rbf, ysh, cfg.l_max)
        A = _edge_sums(msgs, batch, use_kernel)
        # higher-order products (ACE, correlation 3 via iterated CG)
        B2 = irreps.tensor_product(A, A, {}, cfg.l_max)
        B3 = irreps.tensor_product(B2, A, {}, cfg.l_max)
        new = {}
        for l in range(cfg.l_max + 1):
            acc = None
            for tree, mix in ((A, "mix_a"), (B2, "mix_b2"), (B3, "mix_b3")):
                if l in tree:
                    term = _mix(tree[l], lp[mix][l])
                    acc = term if acc is None else acc + term
            if acc is None:
                continue
            if l == 0:
                acc = _mix(F.silu(acc), lp["update"])
            prev = feats.get(l)
            new[l] = acc if prev is None else prev + acc
        feats = new
    energy = _mlp(params["head"], feats[0][:, :, 0])
    return feats, energy


def mace_loss(params, batch: GraphBatch, cfg: MaceConfig, *,
              use_kernel=None):
    _feats, out = mace_forward(params, batch, cfg, use_kernel=use_kernel)
    if cfg.n_classes:
        return node_classification_loss(out, batch)
    return graph_regression_loss(out[:, 0], batch)
