"""Decoder-only LM (``repro.models.transformer``), its serving path:
prefill and KV-cache decode.

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

from ..device import DEFAULT_DEVICE, resolve_device
from ..kernels.flashattn import flash_attention
from .attention import (decode_attention, dense_attention,
                        masked_chunk_attention, trapezoid_attention)
from .common import (DEFAULT_DTYPE, apply_rope, dense_init, embed_init,
                     ones_init, rms_norm, silu_f32, zeros_init)
from .moe import MoEConfig, init_moe_params, moe_ffn

__all__ = ["TransformerConfig", "decode_step", "forward", "grow_cache",
           "init_cache", "init_params", "prefill_step"]


@dataclasses.dataclass(frozen=True)
class TransformerConfig:
    """The JAX package's config, field for field.  ``remat``,
    ``remat_policy``, ``train_microbatch`` and ``batch_axes`` steer
    training and the TPU mesh and have no effect on the serving path;
    ``attn_impl``, ``attn_chunk`` and ``attn_trapezoid`` pick the plain
    route's schedule for a local layer (the card's kernel route ignores
    them); FSDP and the chunked loss raise until their slices land."""

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
        if self.loss_chunk:
            raise NotImplementedError(
                "loss_chunk (lm_loss and LM training): ROADMAP §1 item 16")

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


def _view(tree: dict, g: int) -> dict:
    """Group ``g``'s slice of a dict of stacked leaves (nested dicts, such
    as an MoE layer's ``moe``, included): views, no copies."""
    return {k: _view(v, g) if isinstance(v, dict) else v[g]
            for k, v in tree.items()}


def _layers(params, cfg: TransformerConfig):
    """(layer params, kind) in depth order: the groups' views, then the
    remainder layers."""
    period = len(cfg.layer_pattern)
    for g in range(cfg.n_groups):
        for i, kind in enumerate(cfg.layer_pattern):
            yield _view(params["groups"][i], g), kind
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


def _attention_block(p, x, kind: str, cfg: TransformerConfig, positions, *,
                     use_kernel=None):
    """x + attention(x) @ wo, with the layer's k and v for the cache."""
    b, s, _ = x.shape
    q, k, v = _qkv(p, x, cfg, positions)
    window = cfg.window if kind == "local" else None
    kernel = q.is_cuda if use_kernel is None else use_kernel
    if kernel or window is None:
        o = flash_attention(q, k, v, causal=True, window=window,
                            use_kernel=use_kernel)
    elif cfg.attn_impl == "dense" or s <= cfg.attn_chunk:
        o = dense_attention(q, k, v, causal=True, window=window)
    elif cfg.attn_trapezoid:
        o = trapezoid_attention(q, k, v, window=window, chunk=cfg.attn_chunk)
    else:
        o = masked_chunk_attention(q, k, v, causal=True, window=window,
                                   chunk=cfg.attn_chunk)
    return x + o.reshape(b, s, cfg.n_heads * cfg.hd) @ p["wo"], k, v


def _ffn_block(p, x, cfg: TransformerConfig):
    """x + FFN(x) and the MoE aux loss (a float32 0 for a dense FFN).  An
    MoE layer routes the B * S tokens of the call: a prefill's in groups
    of ``group_size``, a decode step's B as one group."""
    h = rms_norm(x, p["ln_ffn"])
    if cfg.moe is not None:
        b, s, d = x.shape
        out, aux = moe_ffn(p["moe"], h.reshape(b * s, d), cfg.moe)
        return x + out.reshape(b, s, d), aux
    # swiglu(h @ w_gate, h @ w_up) with the activation taken before the
    # up projection exists: the same values, and a 32k prefill's FFN
    # holds one (S, d_ff) float32 temporary fewer at its peak
    out = (silu_f32(h @ p["w_gate"]) * (h @ p["w_up"])) @ p["w_down"]
    return x + out, torch.zeros((), dtype=torch.float32, device=x.device)


def _head(x, params):
    head = params.get("lm_head")
    return x @ (params["embed"].T if head is None else head)


def forward(params, tokens, cfg: TransformerConfig):
    """tokens (B, S) -> (logits (B, S, vocab_pad), aux loss () float32,
    the layers' MoE aux losses summed: 0 for a dense FFN)."""
    x, aux = _backbone(params, tokens, cfg)
    return _head(x, params), aux


def _backbone(params, tokens, cfg: TransformerConfig):
    """tokens (B, S) -> (final normed hidden states (B, S, d), aux)."""
    x = F.embedding(tokens, params["embed"])
    positions = torch.arange(tokens.shape[1], device=x.device)[None, :]
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    for p, kind in _layers(params, cfg):
        x, _, _ = _attention_block(p, x, kind, cfg, positions)
        x, a = _ffn_block(p, x, cfg)
        aux = aux + a
    return rms_norm(x, params["ln_f"]), aux


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
