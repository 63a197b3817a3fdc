"""Model assembly for every architecture family of the JAX package (port
of ``src/repro/models/backbone.py``): the decoder-only LMs (dense, moe,
vlm), the ssm family (xLSTM), the hybrid (zamba2: mamba2 layers and a
shared attention block) and the audio family (whisper's encoder-decoder).

Public API (used by train/serve/launch):
    model_spec(cfg)                          → param spec tree (models/params.P)
    forward_train(params, tokens, cfg, extra=None) → logits (B, S, V) f32
    loss_fn(params, batch, cfg)              → (loss, metrics)
    cache_spec(cfg, batch, s_max)            → decode cache (TensorSpecs)
    init_cache(cfg, batch, s_max, device)    → zero-filled decode cache
    compute_params(params, cfg)              → params with each weight cast once
    forward_decode(params, cache, tokens, pos, cfg) → (logits (B, V) f32, cache)

Each public function dispatches on ``cfg.family`` through a table, as JAX
does; an unknown family raises ``KeyError``.  Layer stacks keep the JAX
package's stacked ``(L, …)`` params and caches, grouped as JAX groups them:
an MoE arch with ``first_k_dense`` dense layers has a ``dense_layers``
stack before its ``layers``; a VLM projects its precomputed patch
embeddings (``extra["vis_embeds"]``) with ``vis_proj`` and prepends them;
xLSTM keeps ``mblocks`` and ``sblocks`` (every ``slstm_every``-th block an
sLSTM); zamba2 its ``mamba`` stack and one unstacked ``shared`` block,
applied after every ``shared_attn_every`` mamba layers to ``[hidden ‖
embeddings]``; whisper ``enc_layers`` and ``dec_layers``, its audio
frontend a stub (``extra["frames"]``, precomputed frame embeddings).  The
layer loop is explicit (JAX scans it).  ``forward_decode`` updates its
cache in place and returns it: the new K/V column of each attention layer,
the recurrent states of each xLSTM and mamba2 layer (their values those of
JAX's new stacked caches); an MLA cache holds the latent alone
(``KVCache(latent, None)``); whisper's ``enc_out`` is read, never written.

``remat`` checkpoints each layer of a stack with
``torch.utils.checkpoint``, as ``jax.checkpoint`` does: ``"full"`` keeps
only the layer's input; ``"dots"`` keeps the outputs of the 2-D products
(``aten.mm`` / ``aten.addmm``), which is what JAX's
``checkpoint_dots_with_no_batch_dims`` keeps, and recomputes everything
else, batched products (attention scores, the expert products over E)
included.  Either backward runs the layer's forward again, the attention
kernel included.  As in JAX, the sLSTM blocks and zamba2's shared block
are not checkpointed.
"""
from __future__ import annotations

import functools
from typing import Any, Dict

import torch
import torch.nn.functional as F
from torch.distributed.tensor import DTensor
from torch.utils.checkpoint import (
    CheckpointPolicy,
    checkpoint,
    create_selective_checkpoint_contexts,
)

from repro_torch._shardmap_compat import batch_local
from repro_torch.models import attention as attn
from repro_torch.models import moe as moe_mod
from repro_torch.models import ssm as ssm_mod
from repro_torch.models import xlstm as xlstm_mod
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import (
    cdt,
    embed_apply,
    embed_spec,
    mlp_apply,
    mlp_spec,
    norm_apply,
    norm_spec,
    position_table,
    unembed_apply,
)
from repro_torch.kernels._lib import resolve_device
from repro_torch.models.params import P, TensorSpec, map_specs
from repro_torch.parallel.ctx import current_mesh, use_mesh


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
    """``body(params, x)`` checkpointed as ``cfg.remat`` says.  The
    recompute runs in the backward, on the card on the autograd engine's
    own thread, which sees none of the caller's ``use_mesh``; so it
    re-enters the mesh the forward ran under, and the same local regions
    and constraints run again on the same placements."""
    if cfg.remat not in ("full", "dots"):
        return body
    kw = {"context_fn": _dots_context} if cfg.remat == "dots" else {}

    def run(lp, x):
        mesh = current_mesh()

        def again(lp_, x_):
            with use_mesh(mesh):
                return body(lp_, x_)

        return checkpoint(again, lp, x, use_reentrant=False, **kw)

    return run


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


def _slice_stack(params, lo: int, n: int):
    """Layers ``lo … lo+n-1`` of a stacked param tree (views)."""
    if isinstance(params, torch.Tensor):
        return params[lo:lo + n]
    return {k: _slice_stack(v, lo, n) for k, v in params.items()}


def _layer(tree, i: int):
    """Layer ``i`` of a stacked param tree (views)."""
    if isinstance(tree, torch.Tensor):
        return tree[i]
    return {k: _layer(v, i) for k, v in tree.items()}


def _cache_layer(cache, i: int):
    """Layer ``i`` of a stacked NamedTuple cache (views: writes land in it)."""
    return type(cache)(*(x[i] for x in cache))


def _store(dst, src) -> None:
    """Copy a new per-layer state into its views in the stacked cache."""
    for d, s_ in zip(dst, src):
        d.copy_(s_)


# ---------------------------------------------------------------------------
# family: ssm (xlstm)
# ---------------------------------------------------------------------------


def _xlstm_counts(cfg):
    n_s = cfg.n_layers // cfg.slstm_every if cfg.slstm_every else 0
    return cfg.n_layers - n_s, n_s


def _xlstm_spec(cfg):
    n_m, n_s = _xlstm_counts(cfg)
    s = {
        "embed": embed_spec(cfg),
        "ln_f": norm_spec(cfg),
        "mblocks": stack_specs({"ln": norm_spec(cfg), "cell": xlstm_mod.mlstm_spec(cfg)}, n_m),
    }
    if n_s:
        s["sblocks"] = stack_specs({"ln": norm_spec(cfg), "cell": xlstm_mod.slstm_spec(cfg)}, n_s)
    return s


def _xlstm_segments(cfg):
    """(count, is_slstm) runs: (k-1) mLSTM blocks then one sLSTM, repeated,
    then the mLSTM blocks left over."""
    n_m, n_s = _xlstm_counts(cfg)
    if not n_s:
        return [(n_m, False)]
    k = cfg.slstm_every
    segs = []
    for _ in range(n_s):
        segs.append((k - 1, False))
        segs.append((1, True))
    rem = cfg.n_layers - n_s * k
    if rem:
        segs.append((rem, False))
    return segs


def _xlstm_forward(params, tokens, cfg, extra=None):
    x = embed_apply(params["embed"], tokens, cfg)
    if cfg.mlstm_chunk:
        mlstm = lambda p, h: xlstm_mod.mlstm_train_chunked(p, h, cfg, chunk=cfg.mlstm_chunk)
    else:
        mlstm = lambda p, h: xlstm_mod.mlstm_train(p, h, cfg)
    cell = lambda p, h: h + batch_local(mlstm, p["cell"], norm_apply(p["ln"], h, cfg))
    slstm = lambda p, h: xlstm_mod.slstm_train(p, h, cfg)
    mi = si = 0
    for count, is_s in _xlstm_segments(cfg):
        if is_s:
            for _ in range(count):
                lp = _layer(params["sblocks"], si)
                x = x + batch_local(slstm, lp["cell"], norm_apply(lp["ln"], x, cfg))
                si += 1
        else:
            x = _scan_stack(_slice_stack(params["mblocks"], mi, count), x, cfg, cell)
            mi += count
    x = norm_apply(params["ln_f"], x, cfg)
    return unembed_apply(params["embed"], x, cfg)


def _xlstm_cache_spec(cfg, batch, s_max):
    n_m, n_s = _xlstm_counts(cfg)
    c = {"m": xlstm_mod.mlstm_cache_spec(cfg, batch, layers=n_m)}
    if n_s:
        c["s"] = xlstm_mod.slstm_cache_spec(cfg, batch, layers=n_s)
    return c


# an xLSTM block's (param stack, cache entry, decode step) by its kind
_XLSTM_DECODE = {False: ("mblocks", "m", xlstm_mod.mlstm_decode),
                 True: ("sblocks", "s", xlstm_mod.slstm_decode)}


def _xlstm_decode(params, cache, tokens, pos, cfg):
    x = embed_apply(params["embed"], tokens[:, None], cfg)
    done = {False: 0, True: 0}  # blocks of each kind already run
    for count, is_s in _xlstm_segments(cfg):
        stack, entry, step = _XLSTM_DECODE[is_s]
        for i in range(done[is_s], done[is_s] + count):
            lp = _layer(params[stack], i)
            lc = _cache_layer(cache[entry], i)
            y, nc = batch_local(lambda p, h, c: step(p, h, cfg, c), lp["cell"],
                                norm_apply(lp["ln"], x, cfg), lc)
            _store(lc, nc)
            x = x + y
        done[is_s] += count
    x = norm_apply(params["ln_f"], x, cfg)
    return unembed_apply(params["embed"], x, cfg)[:, 0], cache


# ---------------------------------------------------------------------------
# family: hybrid (zamba2: mamba2 backbone + shared attention block)
# ---------------------------------------------------------------------------


def _z_invocations(cfg):
    return cfg.n_layers // cfg.shared_attn_every if cfg.shared_attn_every else 0


def _z_segments(cfg):
    """(first mamba layer, count, shared block after it?) for each run of
    mamba layers; the shared block follows each of the first
    ``_z_invocations`` runs."""
    k, n_inv = cfg.shared_attn_every, _z_invocations(cfg)
    segs, li = [], 0
    for seg in range(n_inv + 1):
        count = min(k, cfg.n_layers - li) if k else cfg.n_layers
        segs.append((li, max(count, 0), bool(k) and seg < n_inv))
        li += max(count, 0)
    return segs


def _hybrid_spec(cfg):
    s = {
        "embed": embed_spec(cfg),
        "ln_f": norm_spec(cfg),
        "mamba": stack_specs({"ln": norm_spec(cfg), "ssm": ssm_mod.mamba2_spec(cfg)},
                             cfg.n_layers),
    }
    if cfg.shared_attn_every:
        s["shared"] = {
            "in_proj": P((2 * cfg.d_model, cfg.d_model), ("ffn", "embed")),
            "block": block_spec(cfg, moe=False),
        }
    return s


def _shared_input(sp, x, x0, cfg):
    """The shared block's input: ``[hidden ‖ embeddings]`` projected to d."""
    return torch.cat([x, x0], dim=-1) @ sp["in_proj"].to(cdt(cfg))


def _placed_like(y, x):
    """The shared block's output in the residual stream's placements.  Under
    a mesh the block's output projection leaves partial sums over
    ``model``; added as they are, they would keep the residual stream
    partial for the rest of the stack, and every later mamba layer would
    reduce it again (its norm's f32 input and its local region's input)
    where the layers before the first shared block reduce nothing.  Reduced
    here once an invocation, every mamba layer runs alike, so the dry-run's
    counts are linear in the layer and invocation counts."""
    if isinstance(y, DTensor) and isinstance(x, DTensor) and y.placements != x.placements:
        return y.redistribute(x.device_mesh, x.placements)
    return y


def _hybrid_forward(params, tokens, cfg, extra=None):
    x0 = embed_apply(params["embed"], tokens, cfg)
    x = x0
    mamba = lambda p, h: ssm_mod.mamba2_train(p, h, cfg)
    body = lambda p, h: h + batch_local(mamba, p["ssm"], norm_apply(p["ln"], h, cfg))
    for li, count, shared in _z_segments(cfg):
        if count:
            x = _scan_stack(_slice_stack(params["mamba"], li, count), x, cfg, body)
        if shared:
            sp = params["shared"]
            y = block_apply(sp["block"], _shared_input(sp, x, x0, cfg), cfg, moe=False)
            x = x + _placed_like(y, x)
    x = norm_apply(params["ln_f"], x, cfg)
    return unembed_apply(params["embed"], x, cfg)


def _hybrid_cache_spec(cfg, batch, s_max):
    c = {"mamba": ssm_mod.ssm_cache_spec(cfg, batch, layers=cfg.n_layers)}
    n_inv = _z_invocations(cfg)
    if n_inv:
        c["shared"] = attn.gqa_cache_spec(cfg, batch, s_max, layers=n_inv)
    return c


def _hybrid_decode(params, cache, tokens, pos, cfg):
    x0 = embed_apply(params["embed"], tokens[:, None], cfg)
    x = x0
    for seg, (li, count, shared) in enumerate(_z_segments(cfg)):
        for i in range(li, li + count):
            lp = _layer(params["mamba"], i)
            lc = _cache_layer(cache["mamba"], i)
            y, nc = batch_local(lambda p, h, c: ssm_mod.mamba2_decode(p, h, cfg, c), lp["ssm"],
                                norm_apply(lp["ln"], x, cfg), lc)
            _store(lc, nc)
            x = x + y
        if shared:
            sp = params["shared"]
            y, _ = block_decode(sp["block"], _shared_input(sp, x, x0, cfg), cfg,
                                _cache_layer(cache["shared"], seg), pos, moe=False)
            x = x + _placed_like(y, x)
    x = norm_apply(params["ln_f"], x, cfg)
    return unembed_apply(params["embed"], x, cfg)[:, 0], cache


# ---------------------------------------------------------------------------
# family: audio (whisper enc-dec; the conv frontend is a stub, as in JAX)
# ---------------------------------------------------------------------------

# rows of whisper's decode position table (JAX's ``_audio_decode``); a
# position past the last reads the last row
AUDIO_DECODE_POSITIONS = 8192


def _audio_spec(cfg):
    enc_block = {
        "ln1": norm_spec(cfg),
        "attn": attn.gqa_spec(cfg),
        "ln2": norm_spec(cfg),
        "mlp": mlp_spec(cfg),
    }
    dec_block = {
        "ln1": norm_spec(cfg),
        "attn": attn.gqa_spec(cfg),
        "lnx": norm_spec(cfg),
        "cross": attn.cross_spec(cfg),
        "ln2": norm_spec(cfg),
        "mlp": mlp_spec(cfg),
    }
    return {
        "embed": embed_spec(cfg),
        "enc_layers": stack_specs(enc_block, cfg.enc_layers),
        "dec_layers": stack_specs(dec_block, cfg.n_layers),
        "enc_ln": norm_spec(cfg),
        "ln_f": norm_spec(cfg),
    }


def _audio_encode(params, frames, cfg):
    """frames: (B, T_enc, d), precomputed frame embeddings (the stub)."""
    dt = cdt(cfg)
    pe = position_table(frames.shape[1], cfg.d_model, frames.device)
    x = frames.to(dt) + pe[None].to(dt)

    def body(p, h):
        h = h + attn.gqa_train(p["attn"], norm_apply(p["ln1"], h, cfg), cfg, causal=False)
        return h + mlp_apply(p["mlp"], norm_apply(p["ln2"], h, cfg), cfg)

    x = _scan_stack(params["enc_layers"], x, cfg, body)
    return norm_apply(params["enc_ln"], x, cfg)


def _audio_forward(params, tokens, cfg, extra=None):
    dt = cdt(cfg)
    enc = _audio_encode(params, extra["frames"], cfg)
    pe = position_table(tokens.shape[1], cfg.d_model, tokens.device)
    x = embed_apply(params["embed"], tokens, cfg) + pe[None].to(dt)

    def body(p, h):
        h = h + attn.gqa_train(p["attn"], norm_apply(p["ln1"], h, cfg), cfg)
        h = h + attn.cross_apply(p["cross"], norm_apply(p["lnx"], h, cfg), enc, cfg)
        return h + mlp_apply(p["mlp"], norm_apply(p["ln2"], h, cfg), cfg)

    x = _scan_stack(params["dec_layers"], x, cfg, body)
    x = norm_apply(params["ln_f"], x, cfg)
    return unembed_apply(params["embed"], x, cfg)


def _audio_cache_spec(cfg, batch, s_max):
    return {
        "self": attn.gqa_cache_spec(cfg, batch, s_max, layers=cfg.n_layers),
        "enc_out": TensorSpec((batch, cfg.enc_frames, cfg.d_model), cdt(cfg)),
    }


def _audio_decode(params, cache, tokens, pos, cfg):
    dt = cdt(cfg)
    enc = cache["enc_out"]
    pe = position_table(AUDIO_DECODE_POSITIONS, cfg.d_model, enc.device)
    pos_emb = pe[min(pos, AUDIO_DECODE_POSITIONS - 1)][None, None]
    x = embed_apply(params["embed"], tokens[:, None], cfg) + pos_emb.to(dt)
    ks, vs = cache["self"].k.unbind(0), cache["self"].v.unbind(0)
    for p, k, v in zip(_layers(params["dec_layers"]), ks, vs):
        y, _ = attn.gqa_decode(p["attn"], norm_apply(p["ln1"], x, cfg), cfg,
                               attn.KVCache(k, v), pos)
        x = x + y
        x = x + attn.cross_apply(p["cross"], norm_apply(p["lnx"], x, cfg), enc, cfg)
        x = x + mlp_apply(p["mlp"], norm_apply(p["ln2"], x, cfg), cfg)
    x = norm_apply(params["ln_f"], x, cfg)
    return unembed_apply(params["embed"], x, cfg)[:, 0], cache


# ---------------------------------------------------------------------------
# public dispatch
# ---------------------------------------------------------------------------

_SPEC = {"dense": _lm_spec, "moe": _lm_spec, "vlm": _lm_spec,
         "ssm": _xlstm_spec, "hybrid": _hybrid_spec, "audio": _audio_spec}
_FWD = {"dense": _lm_forward, "moe": _lm_forward, "vlm": _lm_forward,
        "ssm": _xlstm_forward, "hybrid": _hybrid_forward, "audio": _audio_forward}
_CACHE = {"dense": _lm_cache_spec, "moe": _lm_cache_spec, "vlm": _lm_cache_spec,
          "ssm": _xlstm_cache_spec, "hybrid": _hybrid_cache_spec, "audio": _audio_cache_spec}
_DECODE = {"dense": _lm_decode, "moe": _lm_decode, "vlm": _lm_decode,
           "ssm": _xlstm_decode, "hybrid": _hybrid_decode, "audio": _audio_decode}


def model_spec(cfg: ModelConfig):
    return _SPEC[cfg.family](cfg)


def cache_spec(cfg: ModelConfig, batch: int, s_max: int):
    return _CACHE[cfg.family](cfg, batch, s_max)


def _zeros(spec, device):
    if spec is None:
        return None
    if isinstance(spec, TensorSpec):
        return torch.zeros(spec.shape, dtype=spec.dtype, device=device)
    if isinstance(spec, dict):
        return {k: _zeros(v, device) for k, v in spec.items()}
    return type(spec)(*(_zeros(s_, device) for s_ in spec))  # a cache NamedTuple


def init_cache(cfg: ModelConfig, batch: int, s_max: int, device=None):
    """A zero-filled decode cache on ``device`` (default the CUDA card;
    raises without one): ``KVCache`` entries, the recurrent states
    (``SSMCache``, ``XLSTMCache``, ``SLSTMCache``) and whisper's bare
    ``enc_out`` tensor, as ``cache_spec`` describes them."""
    device = resolve_device(device, "init_cache")
    return _zeros(cache_spec(cfg, batch, s_max), device)


# kept in fp32, as the model reads them without a cast: the norms, wherever
# they sit, and the MoE router (a router cast to bf16 and back would route
# differently), by any part of the path ...
_FP32_BLOCKS = {"ln1", "ln2", "ln_f", "router", "ln", "lnx", "enc_ln"}
# ... and, by (stack, block), the cell leaves that the recurrences read in
# f32: mLSTM's gate weights, sLSTM's input and recurrent weights and bias,
# mamba2's decay, step bias, skip and norm weight.  Their other leaves (the
# MLP's ``wi`` among them) are cast at use like every other weight.
_FP32_CELL_LEAVES = {
    ("mblocks", "cell"): {"wi", "wf", "bi", "bf"},
    ("sblocks", "cell"): {"wx", "wr", "b"},
    ("mamba", "ssm"): {"A_log", "dt_bias", "D", "norm_w"},
}


def _keeps_fp32(parts) -> bool:
    if parts[0] == "embed" or _FP32_BLOCKS.intersection(parts):
        return True
    return parts[-1] in _FP32_CELL_LEAVES.get(tuple(parts[:2]), ())


def compute_params(params, cfg: ModelConfig):
    """``params`` with every weight that the model casts to the compute
    dtype at use cast once now; the leaves it reads in fp32 (the norms, the
    MoE router, the recurrent cells' gate and decay leaves, and the
    embedding table, gathered in the compute dtype but read in fp32 by the
    tied unembed) keep their fp32 values.  Each cast weight has the bf16
    value the per-use cast would give, so the outputs are the same; at
    qwen2-0.5b's full width a cast at every step would move about 3 GB a
    step."""
    dt = cdt(cfg)

    def rec(tree, path):
        if isinstance(tree, torch.Tensor):
            return tree if _keeps_fp32(path) else tree.to(dt)
        return {k: rec(v, path + (k,)) for k, v in tree.items()}

    return rec(params, ())


def forward_decode(params, cache, tokens, pos, cfg: ModelConfig):
    """One decode step of every batch row at the shared position ``pos``
    (a host int).  tokens: (B,) int.  Returns (logits (B, V) f32, cache)."""
    return _DECODE[cfg.family](params, cache, tokens, int(pos), cfg)


def forward_train(params, tokens, cfg: ModelConfig, extra=None):
    """tokens: (B, S) int → logits (B, S, V) f32.  ``extra``: a VLM's
    ``{"vis_embeds": (B, vis_tokens, d_model)}``, whisper's ``{"frames":
    (B, enc_frames, d_model)}``; unused by the others."""
    return _FWD[cfg.family](params, tokens, cfg, extra)


def loss_fn(params, batch, cfg: ModelConfig):
    """Next-token cross-entropy, log-softmax in f32.  batch: {tokens (B, S),
    [frames | vis_embeds]}.
    Returns (loss, {"loss", "ppl"})."""
    tokens = batch["tokens"]
    extra = {k: v for k, v in batch.items() if k != "tokens"} or None
    logits = forward_train(params, tokens, cfg, extra)
    tgt = tokens[:, 1:].long()
    logp = F.log_softmax(logits[:, :-1].float(), dim=-1)
    nll = -logp.gather(-1, tgt[..., None])[..., 0]
    loss = nll.mean()
    return loss, {"loss": loss, "ppl": torch.exp(loss)}

