"""Mixture-of-Experts FFN (``repro.models.moe``): top-k routing with a
per-group capacity, GShard semantics.

Used by granite-moe (40 experts, top-8) and moonshot (64 experts, top-6).
Tokens (T, d) are cut into G groups of S = min(group_size, T) rows; each
group routes alone:

  * router logits in float32, softmax over the E experts, the top k of
    each token (a stable descending sort: equal probabilities put the
    lower expert first, as ``jax.lax.top_k`` does), their gates
    renormalised over the k *before* capacity and never after a drop;
  * capacity C = ``capacity(S, cfg)`` slots an expert a group.  Slot
    rank j is the outer loop, token order the inner cumsum, and the fill
    of each expert carries across j: every token's first choice is
    placed before any token's second choice.  A choice beyond C drops;
  * the Switch load-balancing loss, E * sum(mean prob * mean top-1
    one-hot), times ``aux_loss_weight``.

The JAX package dispatches and combines with (G, S, E, C) one-hot
einsums, the form its partitioner can shard.  The port keeps an
(E, G, C) slot -> token table instead: dispatch is a gather of token
rows (exact, as a one-hot product is), the expert products are batched
matmuls over (E, G * C, d), and the combine adds each token's at most k
gated expert rows, the gates rounded to the model's type as the JAX
combine rounds them, summed in float32 and rounded once.  The einsums'
2 k cf S^2 d multiply-adds a group (4.3e12 a layer at granite's 2 x
32,768-token prefill) do not arise.

``moe_param_specs`` (the TPU ``PartitionSpec`` tree) waits for FSDP/TP
sharding (ROADMAP §1 item 16).
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple

import torch
import torch.nn.functional as F

from ..device import DEFAULT_DEVICE, resolve_device
from .common import DEFAULT_DTYPE, dense_init, swiglu

__all__ = ["MoEConfig", "Routing", "capacity", "init_moe_params", "moe_ffn",
           "route", "router_probs"]


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    n_experts: int
    top_k: int
    d_model: int
    d_ff: int            # per-expert hidden width
    capacity_factor: float = 1.25
    aux_loss_weight: float = 0.01
    group_size: int = 1024


def init_moe_params(generator: torch.Generator, cfg: MoEConfig,
                    dtype=DEFAULT_DTYPE, *, device=DEFAULT_DEVICE,
                    lead: tuple = ()) -> dict:
    """``router`` (d, E) float32 and the experts ``w_gate``, ``w_up`` (E,
    d, f) and ``w_down`` (E, f, d) in ``dtype``, each with ``lead`` axes
    in front (a stack over layer groups).  The experts' spread is the
    reference's: its ``dense_init`` takes fan in from ``shape[0]``, which
    for an (E, ., .) leaf is ``n_experts``, so std 1 / sqrt(E) (0.158 for
    granite), not 1 / sqrt(d).  The router's is 1 / sqrt(d)."""
    dev = resolve_device(device)
    e, d, f = cfg.n_experts, cfg.d_model, cfg.d_ff

    def draw(shape, dt):
        return dense_init(generator, lead + shape, dt, device=dev,
                          fan_in=shape[0])

    return {"router": draw((d, e), torch.float32),
            "w_gate": draw((e, d, f), dtype),
            "w_up": draw((e, d, f), dtype),
            "w_down": draw((e, f, d), dtype)}


def capacity(group_size: int, cfg: MoEConfig) -> int:
    """Slots an expert a group.  The reference rounds up to a multiple of
    8, at least 8, for its TPU tiles; that rounding decides which tokens
    drop, so it is kept."""
    c = int(group_size * cfg.top_k * cfg.capacity_factor / cfg.n_experts) + 1
    return max(8, ((c + 7) // 8) * 8)


class Routing(NamedTuple):
    """One layer's routing of (G, S) tokens: each token's k experts in
    rank order, their renormalised float32 gates, whether the choice has
    a slot, and its slot (its rank among the expert's tokens; meaningful
    where kept), all (G, S, k); and the auxiliary loss."""
    expert_ids: torch.Tensor
    gates: torch.Tensor
    keep: torch.Tensor
    pos: torch.Tensor
    aux: torch.Tensor


def router_probs(router, xg) -> torch.Tensor:
    """(G, S, d) tokens -> (G, S, E) float32 routing probabilities."""
    return torch.softmax(xg.float() @ router, dim=-1)


def route(probs, cfg: MoEConfig) -> Routing:
    """Top-k choice, gates, capacity slots and the aux loss from (G, S, E)
    float32 probabilities, the capacity that of S = ``probs.shape[1]``.

    The reference places rank j = 0 .. k-1 in turn, each rank's tokens
    in group order after the fill the ranks before it left: a choice's
    slot is that fill plus the number of earlier tokens of its group
    with the same expert at the same rank.  The fill before rank j is
    the choices of the ranks before j capped at C (a rank keeps
    min(count, C - fill)), so every rank is placed at once, bitwise the
    reference's loop."""
    g, s, e = probs.shape
    k, cap = cfg.top_k, capacity(s, cfg)
    vals, ids = torch.sort(probs, dim=-1, descending=True, stable=True)
    gates, expert_ids = vals[..., :k], ids[..., :k]
    gates = gates / torch.clamp(gates.sum(dim=-1, keepdim=True), min=1e-9)

    oh = F.one_hot(expert_ids, e)                             # (G, S, k, E)
    me = probs.mean(dim=(0, 1))
    ce = oh[:, :, 0].float().mean(dim=(0, 1))
    aux = cfg.aux_loss_weight * e * torch.sum(me * ce)

    ahead = (torch.cumsum(oh, dim=1) - oh).gather(
        3, expert_ids[..., None])[..., 0]                     # (G, S, k)
    count = oh.sum(dim=1)                                     # (G, k, E)
    fill = torch.clamp(torch.cumsum(count, dim=1) - count, max=cap)
    pos = fill.gather(2, expert_ids.transpose(1, 2)).transpose(1, 2) + ahead
    return Routing(expert_ids, gates, pos < cap, pos, aux)


def _group_rows(t: int, cfg: MoEConfig) -> int:
    s = min(cfg.group_size, t)
    if s == 0 or t % s:
        raise ValueError(f"moe_ffn: {t} tokens do not divide into groups of "
                         f"{s} (group_size {cfg.group_size})")
    return s


def moe_ffn(params, x, cfg: MoEConfig):
    """x (T, d) -> (out (T, d) in x's type, aux loss () float32).  T must
    divide into ``group_size`` rows, or be less than one group."""
    t, d = x.shape
    s = _group_rows(t, cfg)
    g, e = t // s, cfg.n_experts
    cap = capacity(s, cfg)
    xg = x.reshape(g, s, d)
    r = route(router_probs(params["router"], xg), cfg)

    # slot (e, g, c) -> row of the group's tokens; row s, zeros, is empty
    dev = x.device
    grp = torch.arange(g, device=dev)[:, None, None]
    tok = torch.arange(s, device=dev)[None, :, None]
    n_slots = e * g * cap
    slot = (r.expert_ids * g + grp) * cap + r.pos             # (G, S, k)
    # a dropped choice writes the spare entry past the table: no sync
    table = torch.full((n_slots + 1,), s, dtype=torch.int64, device=dev)
    table.scatter_(0, torch.where(r.keep, slot, n_slots).flatten(),
                   tok.expand_as(slot).flatten())
    rows = torch.cat([xg, xg.new_zeros((g, 1, d))], dim=1)   # (G, S+1, d)
    src = table[:n_slots].view(e, g, cap) + grp.view(1, g, 1) * (s + 1)
    din = rows.view(g * (s + 1), d)[src.view(-1)].view(e, g * cap, d)

    hidden = swiglu(torch.bmm(din, params["w_gate"]),
                    torch.bmm(din, params["w_up"]))
    out_e = torch.bmm(hidden, params["w_down"]).view(e * g * cap, d)

    # combine: the gates in out_e's type, float32 sums, one rounding
    w = torch.where(r.keep, r.gates.to(out_e.dtype).float(), 0.0)
    picked = out_e[torch.where(r.keep, slot, 0).reshape(t, cfg.top_k)]
    out = (w.reshape(t, cfg.top_k, 1) * picked.float()).sum(dim=1)
    return out.to(x.dtype), r.aux
