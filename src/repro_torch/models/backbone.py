"""Model assembly: the dense decoder-only LM, training forward and decode
path (port of the ``_lm_*`` paths of ``src/repro/models/backbone.py``).

Public API (used by train/serve/launch):
    model_spec(cfg)                          → param spec tree (models/params.P)
    forward_train(params, tokens, cfg, extra=None) → logits (B, S, V) f32
    loss_fn(params, batch, cfg)              → (loss, metrics)
    cache_spec(cfg, batch, s_max)            → decode cache (TensorSpecs)
    init_cache(cfg, batch, s_max, device)    → zero-filled decode cache
    compute_params(params, cfg)              → params with each weight cast once
    forward_decode(params, cache, tokens, pos, cfg) → (logits (B, V) f32, cache)

Layer stacks keep the JAX package's stacked ``(L, …)`` params and caches;
the layer loop is explicit (JAX scans it).  ``forward_decode`` writes the
new cache column of each layer in place and returns the same cache.
``remat="full"`` checkpoints each layer (``torch.utils.checkpoint``), as
``jax.checkpoint`` does; its backward runs the layer's forward again, the
attention kernel included.

Not ported yet, each raising ``NotImplementedError`` that names its roadmap
item: ``remat="dots"``, and the moe, vlm, ssm, hybrid and audio families.
"""
from __future__ import annotations

from typing import Any, Dict

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.models import attention as attn
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import (
    cdt,
    embed_apply,
    embed_spec,
    mlp_apply,
    mlp_spec,
    norm_apply,
    norm_spec,
    unembed_apply,
)
from repro_torch.kernels._lib import resolve_device
from repro_torch.models.params import P, map_specs

_REMAT_DOTS = (
    "remat='dots' is not ported yet (ROADMAP.md queue A, item 6: a checkpoint "
    "policy that keeps only the matmul outputs); use 'full' or 'none'"
)


def _family_not_ported(what: str) -> NotImplementedError:
    return NotImplementedError(
        f"{what} is not ported yet (ROADMAP.md queue A, item 6: the moe, vlm, ssm, "
        "hybrid and audio families)"
    )


# ---------------------------------------------------------------------------
# spec utilities
# ---------------------------------------------------------------------------


def stack_specs(spec, n: int):
    """Add a leading stacked-layers dim to every leaf."""
    return map_specs(
        lambda path, s: P((n,) + s.shape, ("layers",) + s.axes, s.init, s.scale, s.dtype),
        spec,
    )


# ---------------------------------------------------------------------------
# transformer block (dense GQA)
# ---------------------------------------------------------------------------


def block_spec(cfg, moe: bool = False):
    if moe:
        raise _family_not_ported("the MoE block")
    if cfg.attn == "mla":
        raise _family_not_ported("MLA attention")
    return {
        "ln1": norm_spec(cfg),
        "attn": attn.gqa_spec(cfg),
        "ln2": norm_spec(cfg),
        "ffn": mlp_spec(cfg),
    }


def block_apply(p, x, cfg, moe: bool = False):
    if moe:
        raise _family_not_ported("the MoE block")
    if cfg.attn == "mla":
        raise _family_not_ported("MLA attention")
    h = norm_apply(p["ln1"], x, cfg)
    h = attn.gqa_train(p["attn"], h, cfg)
    x = x + h
    h = norm_apply(p["ln2"], x, cfg)
    h = mlp_apply(p["ffn"], h, cfg)
    return x + h


def block_decode(p, x, cfg, cache, pos, moe: bool = False):
    if moe:
        raise _family_not_ported("the MoE block")
    if cfg.attn == "mla":
        raise _family_not_ported("MLA attention")
    h = norm_apply(p["ln1"], x, cfg)
    h, cache = attn.gqa_decode(p["attn"], h, cfg, cache, pos)
    x = x + h
    h = norm_apply(p["ln2"], x, cfg)
    h = mlp_apply(p["ffn"], h, cfg)
    return x + h, cache


def _layers(tree, n: int):
    """The ``n`` per-layer slices of a stacked ``(L, …)`` param tree (views;
    one ``unbind`` per leaf)."""
    if isinstance(tree, torch.Tensor):
        return tree.unbind(0)
    parts = {k: _layers(v, n) for k, v in tree.items()}
    return [{k: v[i] for k, v in parts.items()} for i in range(n)]


def _scan_stack(params, x, cfg, body):
    """x through the stacked-layer params, one layer after another (JAX's
    ``lax.scan``), each layer checkpointed under ``remat="full"``."""
    if cfg.remat == "dots":
        raise NotImplementedError(_REMAT_DOTS)
    for lp in _layers(params, cfg.n_layers):
        if cfg.remat == "full":
            x = checkpoint(body, lp, x, use_reentrant=False)
        else:
            x = body(lp, x)
    return x


# ---------------------------------------------------------------------------
# family: dense (decoder-only transformer LM)
# ---------------------------------------------------------------------------


def _lm_spec(cfg: ModelConfig):
    if cfg.n_experts:
        raise _family_not_ported("the moe family")
    if cfg.family == "vlm":
        raise _family_not_ported("the vlm family")
    s: Dict[str, Any] = {"embed": embed_spec(cfg), "ln_f": norm_spec(cfg)}
    s["layers"] = stack_specs(block_spec(cfg, moe=False), cfg.n_layers)
    return s


def _lm_forward(params, tokens, cfg: ModelConfig):
    x = embed_apply(params["embed"], tokens, cfg)
    x = _scan_stack(params["layers"], x, cfg, lambda p, h: block_apply(p, h, cfg))
    x = norm_apply(params["ln_f"], x, cfg)
    return unembed_apply(params["embed"], x, cfg)


def _lm_cache_spec(cfg, batch, s_max):
    if cfg.attn == "mla":
        raise _family_not_ported("MLA attention")
    return {"layers": attn.gqa_cache_spec(cfg, batch, s_max, layers=cfg.n_layers)}


def _lm_decode(params, cache, tokens, pos, cfg):
    x = embed_apply(params["embed"], tokens[:, None], cfg)
    kv = cache["layers"]
    n = cfg.n_layers
    for lp, k, v in zip(_layers(params["layers"], n), kv.k.unbind(0), kv.v.unbind(0)):
        x, _ = block_decode(lp, x, cfg, attn.KVCache(k, v), pos)
    x = norm_apply(params["ln_f"], x, cfg)
    logits = unembed_apply(params["embed"], x, cfg)
    return logits[:, 0], cache


# ---------------------------------------------------------------------------
# public dispatch
# ---------------------------------------------------------------------------


def _dense(cfg: ModelConfig):
    if cfg.family != "dense":
        raise _family_not_ported(f"the {cfg.family} family")


def model_spec(cfg: ModelConfig):
    _dense(cfg)
    return _lm_spec(cfg)


def cache_spec(cfg: ModelConfig, batch: int, s_max: int):
    _dense(cfg)
    return _lm_cache_spec(cfg, batch, s_max)


def init_cache(cfg: ModelConfig, batch: int, s_max: int, device=None):
    """A zero-filled decode cache on ``device`` (default the CUDA card;
    raises without one)."""
    device = resolve_device(device, "init_cache")
    spec = cache_spec(cfg, batch, s_max)
    return {
        name: attn.KVCache(
            *(torch.zeros(s.shape, dtype=s.dtype, device=device) for s in kv)
        )
        for name, kv in spec.items()
    }


_NORMS = {"ln1", "ln2", "ln_f"}


def compute_params(params, cfg: ModelConfig):
    """``params`` with every weight that the model casts to the compute
    dtype at use cast once now; norm parameters and the embedding table
    (gathered in the compute dtype but read in fp32 by the tied unembed)
    keep their fp32 values.  Each cast weight has the bf16 value the
    per-use cast would give, so the outputs are the same; at qwen2-0.5b's
    full width a cast at every step would move about 3 GB a step."""
    dt = cdt(cfg)

    def rec(tree, path):
        if isinstance(tree, torch.Tensor):
            parts = path.split("/")
            keep = parts[0] == "embed" or bool(_NORMS.intersection(parts))
            return tree if keep else tree.to(dt)
        return {k: rec(v, f"{path}/{k}" if path else k) for k, v in tree.items()}

    return rec(params, "")


def forward_decode(params, cache, tokens, pos, cfg: ModelConfig):
    """One decode step of every batch row at the shared position ``pos``
    (a host int).  tokens: (B,) int.  Returns (logits (B, V) f32, cache)."""
    _dense(cfg)
    return _lm_decode(params, cache, tokens, int(pos), cfg)


def forward_train(params, tokens, cfg: ModelConfig, extra=None):
    """tokens: (B, S) int → logits (B, S, V) f32.  ``extra`` (the other
    families' frames or patch embeddings) is unused by the dense family."""
    _dense(cfg)
    return _lm_forward(params, tokens, cfg)


def loss_fn(params, batch, cfg: ModelConfig):
    """Next-token cross-entropy, log-softmax in f32.  batch: {tokens (B, S)}.
    Returns (loss, {"loss", "ppl"})."""
    tokens = batch["tokens"]
    extra = {k: v for k, v in batch.items() if k != "tokens"} or None
    logits = forward_train(params, tokens, cfg, extra)
    tgt = tokens[:, 1:].long()
    logp = F.log_softmax(logits[:, :-1].float(), dim=-1)
    nll = -logp.gather(-1, tgt[..., None])[..., 0]
    loss = nll.mean()
    return loss, {"loss": loss, "ppl": torch.exp(loss)}

