"""Model assembly: the decoder-only LM family (dense, moe, vlm), training
forward and decode path (port of the ``_lm_*`` paths of
``src/repro/models/backbone.py``).

Public API (used by train/serve/launch):
    model_spec(cfg)                          → param spec tree (models/params.P)
    forward_train(params, tokens, cfg, extra=None) → logits (B, S, V) f32
    loss_fn(params, batch, cfg)              → (loss, metrics)
    cache_spec(cfg, batch, s_max)            → decode cache (TensorSpecs)
    init_cache(cfg, batch, s_max, device)    → zero-filled decode cache
    compute_params(params, cfg)              → params with each weight cast once
    forward_decode(params, cache, tokens, pos, cfg) → (logits (B, V) f32, cache)

Layer stacks keep the JAX package's stacked ``(L, …)`` params and caches,
grouped as JAX groups them: an MoE arch with ``first_k_dense`` dense layers
has a ``dense_layers`` stack before its ``layers``; a VLM projects its
precomputed patch embeddings (``extra["vis_embeds"]``) with ``vis_proj``
and prepends them.  The layer loop is explicit (JAX scans it).
``forward_decode`` writes the new cache column of each layer in place and
returns the same cache; an MLA cache holds the latent alone
(``KVCache(latent, None)``).

``remat`` checkpoints each layer with ``torch.utils.checkpoint``, as
``jax.checkpoint`` does: ``"full"`` keeps only the layer's input; ``"dots"``
keeps the outputs of the 2-D products (``aten.mm`` / ``aten.addmm``), which
is what JAX's ``checkpoint_dots_with_no_batch_dims`` keeps, and recomputes
everything else, batched products (attention scores, the expert products
over E) included.  Either backward runs the layer's forward again, the
attention kernel included.

Not ported yet, each raising ``NotImplementedError`` that names its roadmap
item: the ssm, hybrid and audio families.
"""
from __future__ import annotations

import functools
from typing import Any, Dict

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import (
    CheckpointPolicy,
    checkpoint,
    create_selective_checkpoint_contexts,
)

from repro_torch.models import attention as attn
from repro_torch.models import moe as moe_mod
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

_FAMILIES = ("dense", "moe", "vlm")


def _family_not_ported(what: str) -> NotImplementedError:
    return NotImplementedError(
        f"{what} is not ported yet (ROADMAP.md queue A, item 6: the ssm, hybrid and "
        "audio families)"
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


_SAVED_BY_DOTS = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default)


def _dots_policy(ctx, op, *args, **kwargs):
    """``remat="dots"``: keep the 2-D products' outputs, recompute the rest."""
    if op in _SAVED_BY_DOTS:
        return CheckpointPolicy.MUST_SAVE
    return CheckpointPolicy.PREFER_RECOMPUTE


_dots_context = functools.partial(create_selective_checkpoint_contexts, _dots_policy)


def _remat(body, cfg):
    """``body(params, x)`` checkpointed as ``cfg.remat`` says."""
    if cfg.remat == "full":
        return lambda lp, x: checkpoint(body, lp, x, use_reentrant=False)
    if cfg.remat == "dots":
        return lambda lp, x: checkpoint(body, lp, x, use_reentrant=False,
                                        context_fn=_dots_context)
    return body


# ---------------------------------------------------------------------------
# transformer block (dense / moe / mla / swa)
# ---------------------------------------------------------------------------


def _attn_spec(cfg):
    return attn.mla_spec(cfg) if cfg.attn == "mla" else attn.gqa_spec(cfg)


def _ffn_spec(cfg, moe: bool):
    return moe_mod.moe_spec(cfg) if moe else mlp_spec(cfg)


def block_spec(cfg, moe: bool = False):
    return {
        "ln1": norm_spec(cfg),
        "attn": _attn_spec(cfg),
        "ln2": norm_spec(cfg),
        "ffn": _ffn_spec(cfg, moe),
    }


def _ffn(p, h, cfg, moe: bool):
    return moe_mod.moe_apply(p, h, cfg) if moe else mlp_apply(p, h, cfg)


def block_apply(p, x, cfg, moe: bool = False):
    h = norm_apply(p["ln1"], x, cfg)
    if cfg.attn == "mla":
        h = attn.mla_train(p["attn"], h, cfg)
    else:
        h = attn.gqa_train(p["attn"], h, cfg)
    x = x + h
    h = norm_apply(p["ln2"], x, cfg)
    return x + _ffn(p["ffn"], h, cfg, moe)


def block_decode(p, x, cfg, cache, pos, moe: bool = False):
    h = norm_apply(p["ln1"], x, cfg)
    if cfg.attn == "mla":
        h, cache = attn.mla_decode(p["attn"], h, cfg, cache, pos)
    else:
        h, cache = attn.gqa_decode(p["attn"], h, cfg, cache, pos)
    x = x + h
    h = norm_apply(p["ln2"], x, cfg)
    return x + _ffn(p["ffn"], h, cfg, moe), cache


def _layers(tree):
    """The per-layer slices of a stacked ``(L, …)`` param tree (views; one
    ``unbind`` per leaf)."""
    if isinstance(tree, torch.Tensor):
        return tree.unbind(0)
    parts = {k: _layers(v) for k, v in tree.items()}
    n = len(next(iter(parts.values())))
    return [{k: v[i] for k, v in parts.items()} for i in range(n)]


def _scan_stack(params, x, cfg, body):
    """x through the stacked-layer params, one layer after another (JAX's
    ``lax.scan``), each layer checkpointed as ``cfg.remat`` says."""
    step = _remat(body, cfg)
    for lp in _layers(params):
        x = step(lp, x)
    return x


def _decode_stack(params, cache, x, cfg, pos, moe: bool):
    """One decode step through a stack, each layer on its cache slice."""
    ks = cache.k.unbind(0)
    vs = cache.v.unbind(0) if cache.v is not None else (None,) * len(ks)
    for lp, k, v in zip(_layers(params), ks, vs):
        x, _ = block_decode(lp, x, cfg, attn.KVCache(k, v), pos, moe)
    return x


# ---------------------------------------------------------------------------
# family: dense / moe / vlm  (decoder-only transformer LM)
# ---------------------------------------------------------------------------


def _lm_spec(cfg: ModelConfig):
    s: Dict[str, Any] = {"embed": embed_spec(cfg), "ln_f": norm_spec(cfg)}
    if cfg.n_experts:
        n_dense = cfg.first_k_dense
        if n_dense:
            s["dense_layers"] = stack_specs(block_spec(cfg, moe=False), n_dense)
        s["layers"] = stack_specs(block_spec(cfg, moe=True), cfg.n_layers - n_dense)
    else:
        s["layers"] = stack_specs(block_spec(cfg, moe=False), cfg.n_layers)
    if cfg.family == "vlm":
        # the modality frontend is a stub, as in JAX: precomputed patch
        # embeddings arrive as inputs; only a projection is learned here
        s["vis_proj"] = P((cfg.d_model, cfg.d_model), ("embed", "embed"))
    return s


def _lm_forward(params, tokens, cfg: ModelConfig, extra=None):
    x = embed_apply(params["embed"], tokens, cfg)
    if cfg.family == "vlm":
        vis = extra["vis_embeds"].to(cdt(cfg)) @ params["vis_proj"].to(cdt(cfg))
        x = torch.cat([vis, x], dim=1)
    moe = bool(cfg.n_experts)
    if moe and cfg.first_k_dense:
        x = _scan_stack(params["dense_layers"], x, cfg,
                        lambda p, h: block_apply(p, h, cfg, False))
    x = _scan_stack(params["layers"], x, cfg, lambda p, h: block_apply(p, h, cfg, moe))
    x = norm_apply(params["ln_f"], x, cfg)
    if cfg.family == "vlm":
        x = x[:, extra["vis_embeds"].shape[1]:]  # logits for the text positions
    return unembed_apply(params["embed"], x, cfg)


def _lm_cache_spec(cfg, batch, s_max):
    mk = attn.mla_cache_spec if cfg.attn == "mla" else attn.gqa_cache_spec
    c = {}
    if cfg.n_experts and cfg.first_k_dense:
        c["dense_layers"] = mk(cfg, batch, s_max, layers=cfg.first_k_dense)
        c["layers"] = mk(cfg, batch, s_max, layers=cfg.n_layers - cfg.first_k_dense)
    else:
        c["layers"] = mk(cfg, batch, s_max, layers=cfg.n_layers)
    return c


def _lm_decode(params, cache, tokens, pos, cfg):
    x = embed_apply(params["embed"], tokens[:, None], cfg)
    moe = bool(cfg.n_experts)
    if moe and cfg.first_k_dense:
        x = _decode_stack(params["dense_layers"], cache["dense_layers"], x, cfg, pos, False)
    x = _decode_stack(params["layers"], cache["layers"], x, cfg, pos, moe)
    x = norm_apply(params["ln_f"], x, cfg)
    logits = unembed_apply(params["embed"], x, cfg)
    return logits[:, 0], cache


# ---------------------------------------------------------------------------
# public dispatch
# ---------------------------------------------------------------------------


def _lm_family(cfg: ModelConfig):
    """Refuse the families still to port."""
    if cfg.family not in _FAMILIES:
        raise _family_not_ported(f"the {cfg.family} family")


def model_spec(cfg: ModelConfig):
    _lm_family(cfg)
    return _lm_spec(cfg)


def cache_spec(cfg: ModelConfig, batch: int, s_max: int):
    _lm_family(cfg)
    return _lm_cache_spec(cfg, batch, s_max)


def init_cache(cfg: ModelConfig, batch: int, s_max: int, device=None):
    """A zero-filled decode cache on ``device`` (default the CUDA card;
    raises without one)."""
    device = resolve_device(device, "init_cache")
    spec = cache_spec(cfg, batch, s_max)
    return {
        name: attn.KVCache(
            *(None if s is None else torch.zeros(s.shape, dtype=s.dtype, device=device)
              for s in kv)
        )
        for name, kv in spec.items()
    }


# kept in fp32: the norms, and the MoE router, which JAX reads from the fp32
# weight (a router cast to bf16 and back would route differently)
_FP32_LEAVES = {"ln1", "ln2", "ln_f", "router"}


def compute_params(params, cfg: ModelConfig):
    """``params`` with every weight that the model casts to the compute
    dtype at use cast once now; norm parameters, the MoE router (read in
    f32) and the embedding table (gathered in the compute dtype but read in
    fp32 by the tied unembed) keep their fp32 values.  Each cast weight has the bf16 value the
    per-use cast would give, so the outputs are the same; at qwen2-0.5b's
    full width a cast at every step would move about 3 GB a step."""
    dt = cdt(cfg)

    def rec(tree, path):
        if isinstance(tree, torch.Tensor):
            parts = path.split("/")
            keep = parts[0] == "embed" or bool(_FP32_LEAVES.intersection(parts))
            return tree if keep else tree.to(dt)
        return {k: rec(v, f"{path}/{k}" if path else k) for k, v in tree.items()}

    return rec(params, "")


def forward_decode(params, cache, tokens, pos, cfg: ModelConfig):
    """One decode step of every batch row at the shared position ``pos``
    (a host int).  tokens: (B,) int.  Returns (logits (B, V) f32, cache)."""
    _lm_family(cfg)
    return _lm_decode(params, cache, tokens, int(pos), cfg)


def forward_train(params, tokens, cfg: ModelConfig, extra=None):
    """tokens: (B, S) int → logits (B, S, V) f32.  ``extra``: a VLM's
    ``{"vis_embeds": (B, vis_tokens, d_model)}``; unused by the others."""
    _lm_family(cfg)
    return _lm_forward(params, tokens, cfg, extra)


def loss_fn(params, batch, cfg: ModelConfig):
    """Next-token cross-entropy, log-softmax in f32.  batch: {tokens (B, S),
    [vis_embeds]}.
    Returns (loss, {"loss", "ppl"})."""
    tokens = batch["tokens"]
    extra = {k: v for k, v in batch.items() if k != "tokens"} or None
    logits = forward_train(params, tokens, cfg, extra)
    tgt = tokens[:, 1:].long()
    logp = F.log_softmax(logits[:, :-1].float(), dim=-1)
    nll = -logp.gather(-1, tgt[..., None])[..., 0]
    loss = nll.mean()
    return loss, {"loss": loss, "ppl": torch.exp(loss)}

