"""Decoder-only LM (``repro.models.transformer``): training (``lm_loss``,
its sequence-chunked form, remat) and serving (prefill and KV-cache
decode).

One config describes the family; the port serves the dense models
(llama3.2-3b, qwen2-7b with its QKV bias, gemma3-27b with its 5 local :
1 global pattern) and the MoE ones (granite-moe, moonshot:
``models/moe.py``).  Layers come in *groups*, one period of the
local/global pattern, then the remainder layers (gemma3: 10 groups of 6
and 2); each parameter leaf of a group is stacked over the groups, as
in the JAX package, so its param tree carries across unchanged
(``models.convert.lm_params_from_numpy``).  The JAX ``lax.scan`` over
groups is a Python loop here, over views ``leaf[g]`` (no copies).

On the card (CUDA tensors, ``use_kernel`` None or True) every layer's
attention goes through the flash-attention dispatcher
(``kernels/flashattn``), that is the CUDA kernel K5, whatever
``attn_impl`` says: a ``"local"`` layer in K5's sliding-window mode
(``window=cfg.window``), a ``"global"`` one causal.  The JAX package
computes the same functions in XLA (``dense_attention``,
``masked_chunk_attention`` or ``trapezoid_attention``) and calls its
Pallas kernel on no model path: a departure, held to the reference by
the CPU parity tests.  On the plain route (the CPU, or ``use_kernel=
False``) a global layer takes the dispatcher's plain version and a local
layer the reference's dispatch: ``dense_attention`` when ``attn_impl``
is ``"dense"`` or the prompt fits one ``attn_chunk``, else
``trapezoid_attention`` when ``attn_trapezoid``, else
``masked_chunk_attention``.

Training: ``lm_loss`` is the reference's causal LM loss (float32
logsumexp minus the gold logit, the padded vocab columns at -1e30, the
mean, plus the MoE aux loss), ``cfg.loss_chunk`` its sequence-chunked
form, whose (B, S, V) float32 logits never exist: each chunk's body runs
under ``torch.utils.checkpoint`` (non-reentrant), so its logits are
recomputed in the backward, as the reference's ``jax.checkpoint`` does.
On the card the gradient of every layer's attention is K5's backward
kernel (the dispatcher's autograd function).  With ``cfg.remat`` each
group's layers run under ``torch.utils.checkpoint`` and the remainder
layers outside it, as the reference's ``jax.checkpoint`` on its group
body: ``remat_policy="full"`` saves only the group's input;
``"save_qkv"`` and ``"save_proj"`` split each layer at the tensors the
reference names (``q``, ``k``, ``v``; and ``attn_out``, ``ffn_hidden``),
which are kept while the pieces between them are recomputed.  A split
layer also keeps its input and its residual after attention, which the
reference recomputes from the group's input.  Under "full" and
"save_qkv" the attention's forward, K5 on the card, runs again in the
backward (a llama step: 56 K5 launches and 28 of its backward); under
"save_proj" its output is kept and it runs once.  Remat changes memory,
never values: on the CPU every policy gives bitwise the same gradients.

Decode keeps a dense cache {"k", "v"} of (n_layers, B, S_max, KV, hd)
and "len", a Python int, so a step never syncs on it.  ``decode_step``
writes the new token's K and V into the cache in place: the JAX package
returns a new cache (aliased by donation under jit), and a copy here
would move the whole cache, 7.5 GB for two 32k prompts of llama3.2-3b,
every token.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Optional

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from ..device import DEFAULT_DEVICE, resolve_device
from ..kernels.flashattn import flash_attention
from .attention import (decode_attention, dense_attention,
                        masked_chunk_attention, trapezoid_attention)
from .common import (DEFAULT_DTYPE, apply_rope, dense_init, embed_init,
                     ones_init, rms_norm, silu_f32, zeros_init)
from .moe import MoEConfig, init_moe_params, moe_ffn

__all__ = ["REMAT_SAVED", "TransformerConfig", "decode_step", "forward",
           "grow_cache", "init_cache", "init_params", "lm_loss",
           "prefill_step"]

# the tensors each remat policy keeps, by the reference's names
REMAT_SAVED = {"full": (), "save_qkv": ("q", "k", "v"),
               "save_proj": ("q", "k", "v", "attn_out", "ffn_hidden")}


@dataclasses.dataclass(frozen=True)
class TransformerConfig:
    """The JAX package's config, field for field.  ``remat`` and
    ``remat_policy`` (one of ``REMAT_SAVED``) steer the backward's memory
    and ``loss_chunk`` (0: off; else a divisor of the sequence, or at
    least its length) the loss's; none of them moves a value, and none
    touches the serving path.  ``train_microbatch`` and ``batch_axes``
    steer the TPU mesh and have no effect here; ``attn_impl``,
    ``attn_chunk`` and ``attn_trapezoid`` pick the plain route's schedule
    for a local layer (the card's kernel route ignores them); FSDP raises
    until its slice lands."""

    name: str
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    head_dim: Optional[int] = None        # default d_model // n_heads
    moe: Optional[MoEConfig] = None       # None => dense FFN
    layer_pattern: tuple = ("global",)
    window: int = 1024                    # sliding window of "local" layers
    qkv_bias: bool = False
    rope_theta: float = 10_000.0
    tie_embeddings: bool = False
    dtype: Any = DEFAULT_DTYPE
    attn_impl: str = "chunk"              # "chunk" | "dense"
    attn_chunk: int = 1024
    remat: bool = True
    param_sharding: str = "tp"
    train_microbatch: int = 4
    attn_trapezoid: bool = False
    remat_policy: str = "full"
    loss_chunk: int = 0
    batch_axes: tuple = ("pod", "data")

    def __post_init__(self):
        if self.param_sharding == "fsdp":
            raise NotImplementedError(
                "param_sharding='fsdp' (FSDP and TP sharding on several "
                "GPUs): ROADMAP §1 item 16")
        if self.remat_policy not in REMAT_SAVED:
            raise ValueError(f"remat_policy must be one of "
                             f"{sorted(REMAT_SAVED)}, got "
                             f"{self.remat_policy!r}")

    @property
    def hd(self) -> int:
        return self.head_dim or self.d_model // self.n_heads

    @property
    def vocab_pad(self) -> int:
        """Vocab rows padded to a multiple of 256, as the JAX package
        pads them (the padded rows are drawn like the others)."""
        return ((self.vocab + 255) // 256) * 256

    @property
    def n_groups(self) -> int:
        return self.n_layers // len(self.layer_pattern)

    @property
    def n_remainder(self) -> int:
        return self.n_layers - self.n_groups * len(self.layer_pattern)

    def _layer_params(self) -> tuple:
        d, hd = self.d_model, self.hd
        n_attn = (self.n_heads + 2 * self.n_kv_heads) * hd * d \
            + self.n_heads * hd * d
        if self.moe is not None:    # the k routed experts a token runs
            return n_attn, 3 * self.moe.top_k * d * self.moe.d_ff
        return n_attn, 3 * d * self.d_ff

    def flops_per_token_fwd(self) -> float:
        """Analytic model FLOPs per token (forward): 2 N_active, the
        attention scores and the router left out, as in the JAX
        package."""
        n_attn, n_ffn = self._layer_params()
        return 2.0 * (self.n_layers * (n_attn + n_ffn)
                      + self.d_model * self.vocab)

    def active_params(self) -> float:
        n_attn, n_ffn = self._layer_params()
        return self.n_layers * (n_attn + n_ffn) + 2 * self.d_model * self.vocab


# ---------------------------------------------------------------------------
# Parameters
# ---------------------------------------------------------------------------

def _init_layer(generator, cfg: TransformerConfig, dev, n: Optional[int]):
    """One layer's leaves, each stacked over ``n`` groups (unstacked when
    ``n`` is None)."""
    d, hd = cfg.d_model, cfg.hd
    hq, hkv = cfg.n_heads, cfg.n_kv_heads
    lead = () if n is None else (n,)
    out_scale = 1.0 / (2 * cfg.n_layers) ** 0.5

    def dense(shape, scale=1.0):
        return dense_init(generator, lead + shape, cfg.dtype, scale,
                          device=dev, fan_in=shape[0])

    p = {"ln_attn": ones_init(lead + (d,), cfg.dtype, device=dev),
         "ln_ffn": ones_init(lead + (d,), cfg.dtype, device=dev),
         "wq": dense((d, hq * hd)),
         "wk": dense((d, hkv * hd)),
         "wv": dense((d, hkv * hd)),
         "wo": dense((hq * hd, d), out_scale)}
    if cfg.qkv_bias:
        for name, width in (("bq", hq * hd), ("bk", hkv * hd),
                            ("bv", hkv * hd)):
            p[name] = zeros_init(lead + (width,), cfg.dtype, device=dev)
    if cfg.moe is not None:
        p["moe"] = init_moe_params(generator, cfg.moe, cfg.dtype,
                                   device=dev, lead=lead)
    else:
        p["w_gate"] = dense((d, cfg.d_ff))
        p["w_up"] = dense((d, cfg.d_ff))
        p["w_down"] = dense((cfg.d_ff, d), out_scale)
    return p


def init_params(generator: torch.Generator, cfg: TransformerConfig, *,
                device=DEFAULT_DEVICE) -> dict:
    """The JAX package's param tree with the same shapes and scales:
    ``embed`` (vocab_pad, d), ``ln_f``, ``groups`` (one dict per pattern
    position, each leaf stacked over the groups), ``remainder`` and,
    unless tied, ``lm_head`` (d, vocab_pad).  Drawn from ``generator`` in
    a fixed order, on the generator's device (a CUDA generator draws the
    3.6e9 values of llama3.2-3b on the card in seconds), then moved to
    ``device``."""
    dev = resolve_device(device)
    params = {
        "embed": embed_init(generator, (cfg.vocab_pad, cfg.d_model),
                            cfg.dtype, device=dev),
        "ln_f": ones_init((cfg.d_model,), cfg.dtype, device=dev),
        "groups": [_init_layer(generator, cfg, dev, max(cfg.n_groups, 1))
                   for _ in cfg.layer_pattern],
        "remainder": [_init_layer(generator, cfg, dev, None)
                      for _ in range(cfg.n_remainder)],
    }
    if not cfg.tie_embeddings:
        params["lm_head"] = dense_init(generator,
                                       (cfg.d_model, cfg.vocab_pad),
                                       cfg.dtype, device=dev)
    return params


def _unbind(tree: dict) -> list:
    """The per-group dicts of a dict of stacked leaves (nested dicts, such
    as an MoE layer's ``moe``, included), as ``torch.unbind`` views: in a
    backward each leaf's gradient is the groups' gradients stacked once,
    where a view per group by indexing adds a zero-filled gradient of the
    whole leaf a group (18.7 GB of writes a llama step)."""
    leaves = {k: _unbind(v) if isinstance(v, dict) else v.unbind(0)
              for k, v in tree.items()}
    n = len(next(iter(leaves.values())))
    return [{k: v[g] for k, v in leaves.items()} for g in range(n)]


def _groups(params, cfg: TransformerConfig) -> list:
    """Each group's layer params in pattern order, views of the stacked
    leaves (``_unbind``)."""
    stacks = [_unbind(params["groups"][i])
              for i in range(len(cfg.layer_pattern))]
    return [[stack[g] for stack in stacks] for g in range(cfg.n_groups)]


def _layers(params, cfg: TransformerConfig):
    """(layer params, kind) in depth order: the groups' layers, then the
    remainder layers."""
    for gp in _groups(params, cfg):
        yield from zip(gp, cfg.layer_pattern)
    period = len(cfg.layer_pattern)
    for i, p in enumerate(params["remainder"]):
        yield p, cfg.layer_pattern[i % period]


# ---------------------------------------------------------------------------
# Forward
# ---------------------------------------------------------------------------

def _qkv(p, x, cfg: TransformerConfig, positions):
    """Normed projections, reshaped to heads, RoPE applied to q and k."""
    b, s, _ = x.shape
    h = rms_norm(x, p["ln_attn"])
    q, k, v = h @ p["wq"], h @ p["wk"], h @ p["wv"]
    if cfg.qkv_bias:
        q, k, v = q + p["bq"], k + p["bk"], v + p["bv"]
    q = apply_rope(q.reshape(b, s, cfg.n_heads, cfg.hd), positions,
                   cfg.rope_theta)
    k = apply_rope(k.reshape(b, s, cfg.n_kv_heads, cfg.hd), positions,
                   cfg.rope_theta)
    return q, k, v.reshape(b, s, cfg.n_kv_heads, cfg.hd)


def _attend(q, k, v, kind: str, cfg: TransformerConfig, use_kernel):
    """The layer's attention of q over k, v (module docstring's route)."""
    s = q.shape[1]
    window = cfg.window if kind == "local" else None
    kernel = q.is_cuda if use_kernel is None else use_kernel
    if kernel or window is None:
        return flash_attention(q, k, v, causal=True, window=window,
                               use_kernel=use_kernel)
    if cfg.attn_impl == "dense" or s <= cfg.attn_chunk:
        return dense_attention(q, k, v, causal=True, window=window)
    if cfg.attn_trapezoid:
        return trapezoid_attention(q, k, v, window=window,
                                   chunk=cfg.attn_chunk)
    return masked_chunk_attention(q, k, v, causal=True, window=window,
                                  chunk=cfg.attn_chunk)


def _attn_out(p, x, o, cfg: TransformerConfig):
    b, s, _ = x.shape
    return x + o.reshape(b, s, cfg.n_heads * cfg.hd) @ p["wo"]


def _attention_block(p, x, kind: str, cfg: TransformerConfig, positions, *,
                     use_kernel=None):
    """x + attention(x) @ wo, with the layer's k and v for the cache."""
    q, k, v = _qkv(p, x, cfg, positions)
    o = _attend(q, k, v, kind, cfg, use_kernel)
    return _attn_out(p, x, o, cfg), k, v


def _ffn_hidden(p, x, cfg: TransformerConfig):
    """swiglu(h @ w_gate, h @ w_up) of the normed x, with the activation
    taken before the up projection exists: the same values, and a 32k
    prefill's FFN holds one (S, d_ff) float32 temporary fewer at its
    peak."""
    h = rms_norm(x, p["ln_ffn"])
    return silu_f32(h @ p["w_gate"]) * (h @ p["w_up"])


def _ffn_block(p, x, cfg: TransformerConfig):
    """x + FFN(x) and the MoE aux loss (a float32 0 for a dense FFN).  An
    MoE layer routes the B * S tokens of the call: a prefill's in groups
    of ``group_size``, a decode step's B as one group."""
    if cfg.moe is not None:
        b, s, d = x.shape
        h = rms_norm(x, p["ln_ffn"])
        out, aux = moe_ffn(p["moe"], h.reshape(b * s, d), cfg.moe)
        return x + out.reshape(b, s, d), aux
    return x + _ffn_hidden(p, x, cfg) @ p["w_down"], \
        torch.zeros((), dtype=torch.float32, device=x.device)


def _head(x, params):
    head = params.get("lm_head")
    return x @ (params["embed"].T if head is None else head)


def forward(params, tokens, cfg: TransformerConfig, *, use_kernel=None):
    """tokens (B, S) -> (logits (B, S, vocab_pad), aux loss () float32,
    the layers' MoE aux losses summed: 0 for a dense FFN).
    ``use_kernel`` goes to the flash-attention dispatcher."""
    x, aux = _backbone(params, tokens, cfg, use_kernel=use_kernel)
    return _head(x, params), aux


def _ckpt(fn, *args):
    """``fn(*args)`` under non-reentrant activation checkpointing (the
    model draws no random numbers, so no RNG state is kept)."""
    return checkpoint(fn, *args, use_reentrant=False,
                      preserve_rng_state=False)


def _layer(p, x, kind: str, cfg: TransformerConfig, positions, use_kernel):
    x, _, _ = _attention_block(p, x, kind, cfg, positions,
                               use_kernel=use_kernel)
    return _ffn_block(p, x, cfg)


def _split_layer(p, x, kind: str, cfg: TransformerConfig, positions,
                 use_kernel, saved):
    """One layer cut at the tensors ``saved`` names, each piece between
    them under ``_ckpt``: the same operations as ``_layer``."""
    q, k, v = _ckpt(lambda x: _qkv(p, x, cfg, positions), x)
    if "attn_out" in saved:
        o = _attend(q, k, v, kind, cfg, use_kernel)
        x = _ckpt(lambda x, o: _attn_out(p, x, o, cfg), x, o)
    else:
        x = _ckpt(lambda x, q, k, v: _attn_out(
            p, x, _attend(q, k, v, kind, cfg, use_kernel), cfg), x, q, k, v)
    if "ffn_hidden" in saved and cfg.moe is None:
        hidden = _ckpt(lambda x: _ffn_hidden(p, x, cfg), x)
        x = _ckpt(lambda x, hidden: x + hidden @ p["w_down"], x, hidden)
        return x, torch.zeros((), dtype=torch.float32, device=x.device)
    return _ckpt(lambda x: _ffn_block(p, x, cfg), x)


def _group(gparams, x, cfg: TransformerConfig, positions, use_kernel):
    """One period of the pattern: (x, the group's aux summed)."""
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    saved = REMAT_SAVED[cfg.remat_policy] if cfg.remat else ()
    for p, kind in zip(gparams, cfg.layer_pattern):
        if saved:
            x, a = _split_layer(p, x, kind, cfg, positions, use_kernel, saved)
        else:
            x, a = _layer(p, x, kind, cfg, positions, use_kernel)
        aux = aux + a
    return x, aux


def _backbone(params, tokens, cfg: TransformerConfig, *, use_kernel=None):
    """tokens (B, S) -> (final normed hidden states (B, S, d), aux).  The
    groups in order (under remat, each through ``_ckpt`` or split at its
    policy's tensors), then the remainder layers without remat, as in the
    reference; aux summed a group, then over the groups and the
    remainder."""
    x = F.embedding(tokens, params["embed"])
    positions = torch.arange(tokens.shape[1], device=x.device)[None, :]
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    for gp in _groups(params, cfg):
        if cfg.remat and not REMAT_SAVED[cfg.remat_policy]:
            # gp bound now: the backward recomputes after the loop ends
            x, a = _ckpt(lambda x, gp=gp: _group(gp, x, cfg, positions,
                                                 use_kernel), x)
        else:
            x, a = _group(gp, x, cfg, positions, use_kernel)
        aux = aux + a
    period = len(cfg.layer_pattern)
    for i, p in enumerate(params["remainder"]):
        x, a = _layer(p, x, cfg.layer_pattern[i % period], cfg, positions,
                      use_kernel)
        aux = aux + a
    return rms_norm(x, params["ln_f"]), aux


# ---------------------------------------------------------------------------
# Training: the causal LM loss
# ---------------------------------------------------------------------------

def _token_nll(logits, targets, cfg: TransformerConfig):
    """Per-token -log p(target): float32 logits, the padded vocab columns
    at -1e30, logsumexp minus the gold logit."""
    logits = logits.float()
    if cfg.vocab_pad != cfg.vocab:
        pad = torch.arange(cfg.vocab_pad, device=logits.device) >= cfg.vocab
        logits = logits.masked_fill(pad, -1e30)
    logz = torch.logsumexp(logits, dim=-1)
    gold = logits.gather(-1, targets.long()[..., None])[..., 0]
    return logz - gold


def lm_loss(params, batch, cfg: TransformerConfig, *, use_kernel=None):
    """Causal LM loss, a float32 scalar; ``batch`` = {"tokens", "targets"},
    each (B, S).  The mean token NLL plus the MoE aux loss; with
    ``cfg.loss_chunk``, :func:`_lm_loss_chunked` (the same value)."""
    if cfg.loss_chunk:
        return _lm_loss_chunked(params, batch, cfg, use_kernel=use_kernel)
    logits, aux = forward(params, batch["tokens"], cfg, use_kernel=use_kernel)
    return _token_nll(logits, batch["targets"], cfg).mean() + aux


def _lm_loss_chunked(params, batch, cfg: TransformerConfig, *,
                     use_kernel=None):
    """The loss with a sequence-chunked head: each chunk of ``loss_chunk``
    positions computes its logits and NLL sum under ``_ckpt``, so the
    (B, S, V) float32 logits never exist and each chunk's are recomputed
    in the backward; the chunks' sums are added in order, then divided
    by B S."""
    x, aux = _backbone(params, batch["tokens"], cfg, use_kernel=use_kernel)
    head = params.get("lm_head")
    w = params["embed"].T if head is None else head          # (d, Vp)
    b, s, _ = x.shape
    cs = min(cfg.loss_chunk, s)
    if s % cs:
        raise ValueError(f"loss_chunk {cfg.loss_chunk} does not divide the "
                         f"sequence length {s}")
    targets = batch["targets"]

    def chunk_nll(xc, tc):
        return _token_nll(xc @ w, tc, cfg).sum()

    total = torch.zeros((), dtype=torch.float32, device=x.device)
    for lo in range(0, s, cs):
        total = total + _ckpt(chunk_nll, x[:, lo:lo + cs],
                              targets[:, lo:lo + cs])
    return total / (b * s) + aux


# ---------------------------------------------------------------------------
# Serving: prefill + single-token decode with a dense KV cache
# ---------------------------------------------------------------------------

def init_cache(cfg: TransformerConfig, batch: int, max_len: int,
               dtype=None, *, device=DEFAULT_DEVICE) -> dict:
    shape = (cfg.n_layers, batch, max_len, cfg.n_kv_heads, cfg.hd)
    dev = resolve_device(device)
    dtype = dtype or cfg.dtype
    return {"k": torch.zeros(shape, dtype=dtype, device=dev),
            "v": torch.zeros(shape, dtype=dtype, device=dev), "len": 0}


def grow_cache(cache: dict, extra: int) -> dict:
    """The cache with ``extra`` zero slots appended to its length (one
    copy), as ``examples/serve_lm.py`` pads it for generation."""
    pad = (0, 0, 0, 0, 0, extra)
    return {"k": F.pad(cache["k"], pad), "v": F.pad(cache["v"], pad),
            "len": cache["len"]}


def prefill_step(params, tokens, cfg: TransformerConfig, *, use_kernel=None):
    """Serving prefill: tokens (B, S) -> (last-token logits (B,
    vocab_pad), cache of length S).  Only the final position's logits
    are computed; each layer's K and V are written straight into the
    cache.  ``use_kernel`` goes to the flash-attention dispatcher:
    ``False`` runs the plain route on either device (for a local layer,
    the reference's dispatch, see the module docstring)."""
    b, s = tokens.shape
    x = F.embedding(tokens, params["embed"])
    positions = torch.arange(s, device=x.device)[None, :]
    cache = init_cache(cfg, b, s, dtype=x.dtype, device=x.device)
    for li, (p, kind) in enumerate(_layers(params, cfg)):
        x, k, v = _attention_block(p, x, kind, cfg, positions,
                                   use_kernel=use_kernel)
        cache["k"][li] = k
        cache["v"][li] = v
        x, _ = _ffn_block(p, x, cfg)
    x_last = rms_norm(x[:, -1:], params["ln_f"])
    cache["len"] = s
    return _head(x_last, params)[:, 0], cache


def decode_step(params, cache: dict, tokens, cfg: TransformerConfig):
    """One decode step: tokens (B, 1) + cache -> (logits (B, vocab_pad),
    cache).  Slot ``cache["len"]`` receives the new token's K and V, in
    place, and attention runs over the whole cache with the slots above
    it masked; the returned cache shares the tensors and has ``len + 1``.
    Raises when the cache is full (grow it first)."""
    pos = int(cache["len"])
    if pos >= cache["k"].shape[2]:
        raise ValueError(f"the cache holds {cache['k'].shape[2]} positions, "
                         "all used; grow it (grow_cache) before decoding")
    b = tokens.shape[0]
    x = F.embedding(tokens, params["embed"])               # (B, 1, d)
    positions = torch.full((b, 1), pos, device=x.device)
    for li, (p, kind) in enumerate(_layers(params, cfg)):
        q, k, v = _qkv(p, x, cfg, positions)
        cache["k"][li, :, pos] = k[:, 0]
        cache["v"][li, :, pos] = v[:, 0]
        window = cfg.window if kind == "local" else None
        o = decode_attention(q, cache["k"][li], cache["v"][li], pos,
                             window=window)
        x = x + o.reshape(b, 1, cfg.n_heads * cfg.hd) @ p["wo"]
        x, _ = _ffn_block(p, x, cfg)
    x = rms_norm(x, params["ln_f"])
    return _head(x, params)[:, 0], {"k": cache["k"], "v": cache["v"],
                                    "len": pos + 1}
