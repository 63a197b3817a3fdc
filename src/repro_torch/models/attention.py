"""GQA attention, training and decoding (port of the GQA part of
``src/repro/models/attention.py``).

The training path (``gqa_train``) attends over the whole sequence through
the flash-attention wrapper (``kernels/flash_attention``): on CUDA tensors
its hand-written forward kernel, with the plain version's autograd as the
backward pass.  The JAX package reaches its Pallas kernel only under
``cfg.use_pallas``; the port follows its own dispatch rule instead (a CUDA
tensor goes to the kernel, a CPU tensor to the plain version).

The decode path updates a static-shape KV cache and masks by ``kv_len``:
the whole live cache is streamed once per token by the decode-attention
kernel (``kernels/decode_attention``; the JAX package calls its plain
reference here, the port calls the kernel on CUDA tensors).  Sliding-window
decode stays plain, as in JAX.

MLA (DeepSeek-V3's latent attention) trains through the plain attention
(``attention_ref``), as JAX's does: its head dim ``d_head + rope_head`` (192
at full width) is no instance of the flash kernel, and the JAX package
calls no Pallas kernel there.  Its decode is the absorbed form over a cache
of the compressed latent alone, ``(B, S, kv_lora + rope_head)`` per layer
(``KVCache(latent, None)``).

Cross-attention (whisper's decoder over the encoder output) trains through
the plain attention too: its queries and keys differ in length (T tokens
over ``enc_frames`` frames), which the flash kernel does not take, and the
JAX package calls no Pallas kernel there.  A one-token decode over the
encoder output is the decode-attention kernel's function at ``kv_len`` =
the frames, and goes through its wrapper.

Under a mesh (``DTensor`` params and caches) every attention runs on each
rank's local (batch, head) shard (``_shardmap_compat.local_heads``, which
the kernel wrappers call on a ``DTensor`` too), and a decode writes its new cache
column in place on the rank whose shard holds it
(``_shardmap_compat.write_index``): the cache's sequence may be split over
``model`` (``parallel/sharding.py``).
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from repro_torch._shardmap_compat import local_heads, write_index
from repro_torch.kernels.decode_attention.ops import decode_attention
from repro_torch.kernels.flash_attention.ops import flash_attention
from repro_torch.kernels.flash_attention.ref import attention_ref
from repro_torch.models.layers import apply_rope, cdt, rope_cos_sin, rotate
from repro_torch.models.params import P, TensorSpec


class KVCache(NamedTuple):
    k: torch.Tensor  # (B, KH, S, D), or (L, B, KH, S, D) stacked over layers;
    # MLA: the latent (B, S, kv_lora + rope_head), or (L, B, S, ...)
    v: Optional[torch.Tensor]  # None for MLA


def gqa_spec(cfg):
    d, h, kh, dh = cfg.d_model, cfg.n_heads, cfg.n_kv, cfg.d_head
    s = {
        "wq": P((d, h, dh), ("embed", "heads", None)),
        "wk": P((d, kh, dh), ("embed", "kv_heads", None)),
        "wv": P((d, kh, dh), ("embed", "kv_heads", None)),
        "wo": P((h, dh, d), ("heads", None, "embed")),
    }
    if cfg.qkv_bias:
        s["bq"] = P((h, dh), ("heads", None), "zeros")
        s["bk"] = P((kh, dh), ("kv_heads", None), "zeros")
        s["bv"] = P((kh, dh), ("kv_heads", None), "zeros")
    return s


def _proj(x, w, dt):
    """einsum("bsd,dhk->bhsk", x, w) as one matmul."""
    b, s, d = x.shape
    _, h, k = w.shape
    return (x @ w.to(dt).reshape(d, h * k)).reshape(b, s, h, k).transpose(1, 2)


def _qkv(p, x, cfg, positions):
    dt = cdt(cfg)
    q = _proj(x, p["wq"], dt)
    k = _proj(x, p["wk"], dt)
    v = _proj(x, p["wv"], dt)
    if cfg.qkv_bias:
        q = q + p["bq"].to(dt)[None, :, None, :]
        k = k + p["bk"].to(dt)[None, :, None, :]
        v = v + p["bv"].to(dt)[None, :, None, :]
    if cfg.use_rope:
        # q and k rotate at the same positions: one (cos, sin) for both
        cos, sin = rope_cos_sin(positions[:, None, :], cfg.d_head, cfg.rope_theta, x.device)
        q, k = rotate(q, cos, sin), rotate(k, cos, sin)
    return q, k, v


def gqa_train(p, x, cfg, *, causal=True):
    """x: (B, S, d) → (B, S, d), every row at positions 0 … S-1."""
    b, s, _ = x.shape
    positions = torch.arange(s, device=x.device).expand(b, s)
    q, k, v = _qkv(p, x, cfg, positions)
    o = flash_attention(q, k, v, causal, cfg.window)  # (B, H, S, D)
    hd = o.shape[1] * o.shape[3]
    # einsum("bhsk,hkd->bsd", o, wo) as one matmul
    return o.transpose(1, 2).reshape(b, s, hd) @ p["wo"].to(cdt(cfg)).reshape(hd, -1)


def gqa_decode(p, x, cfg, cache: KVCache, pos: int):
    """One-token decode.  x: (B, 1, d); pos: the current index, a host int
    shared by every row.  Returns (y (B, 1, d), cache).

    The new K/V column of every batch row is written at ``pos`` in place
    (JAX returns a new cache from ``dynamic_update_slice``, which clamps the
    index into range; so does this write).  Writing every row at one shared
    position is the reference's behaviour and is kept (ROADMAP.md queue C)."""
    b = x.shape[0]
    positions = torch.full((b, 1), pos, dtype=torch.int32, device=x.device)
    q, k, v = _qkv(p, x, cfg, positions)  # q (B,H,1,D); k/v (B,KH,1,D)
    s = cache.k.shape[2]
    col = min(max(int(pos), 0), s - 1)
    write_index(cache.k, 2, col, k[:, :, 0])
    write_index(cache.v, 2, col, v[:, :, 0])
    kv_len = int(pos) + 1
    if cfg.window > 0:
        o = local_heads(_decode_windowed, (q[:, :, 0], cache.k, cache.v), kv_len, cfg.window)
    else:
        # columns past S do not exist: kv_len > S reads all S, as JAX's mask does
        o = decode_attention(
            q[:, :, 0].contiguous(), cache.k.to(q.dtype), cache.v.to(q.dtype), min(kv_len, s)
        )
    hd = o.shape[1] * o.shape[2]
    y = o.reshape(b, hd) @ p["wo"].to(cdt(cfg)).reshape(hd, -1)
    return y[:, None, :], cache


def _decode_windowed(q, k, v, kv_len, window):
    b, h, d = q.shape
    kh, s = k.shape[1], k.shape[2]
    group = h // kh
    kx = torch.repeat_interleave(k.to(q.dtype), group, dim=1)
    vx = torch.repeat_interleave(v.to(q.dtype), group, dim=1)
    scores = torch.einsum("bhd,bhkd->bhk", q.float(), kx.float())
    scores = scores / (d**0.5)
    idx = torch.arange(s, device=q.device)[None, None, :]
    mask = (idx < kv_len) & (idx >= kv_len - window)
    scores = scores.masked_fill(~mask, -1e30)
    p_ = torch.softmax(scores, dim=-1)
    return torch.einsum("bhk,bhkd->bhd", p_, vx.float()).to(q.dtype)


def gqa_cache_spec(cfg, batch, s_max, layers=None):
    kh, dh = cfg.n_kv, cfg.d_head
    shape = (batch, kh, s_max, dh)
    if layers:
        shape = (layers,) + shape
    dt = cdt(cfg)
    return KVCache(k=TensorSpec(shape, dt), v=TensorSpec(shape, dt))


# ---------------------------------------------------------------------------
# MLA (DeepSeek-V3): low-rank latent KV + decoupled rope head
# ---------------------------------------------------------------------------


def mla_spec(cfg):
    d, h, dh = cfg.d_model, cfg.n_heads, cfg.d_head
    ql, kvl, dr = cfg.q_lora, cfg.kv_lora, cfg.rope_head
    return {
        "wdq": P((d, ql), ("embed", None)),  # q down
        "wuq": P((ql, h, dh), (None, "heads", None)),  # q up (nope part)
        "wqr": P((ql, h, dr), (None, "heads", None)),  # q rope part
        "wdkv": P((d, kvl), ("embed", None)),  # kv joint down (the latent)
        "wkr": P((d, dr), ("embed", None)),  # shared k rope
        "wuk": P((kvl, h, dh), (None, "heads", None)),  # k up
        "wuv": P((kvl, h, dh), (None, "heads", None)),  # v up
        "wo": P((h, dh, d), ("heads", None, "embed")),
    }


def _mla_scale(cfg) -> float:
    return 1.0 / ((cfg.d_head + cfg.rope_head) ** 0.5)


def mla_train(p, x, cfg):
    """x: (B, S, d) → (B, S, d), causal, every row at positions 0 … S-1."""
    dt = cdt(cfg)
    b, s, _ = x.shape
    positions = torch.arange(s, device=x.device).expand(b, s)
    cq = x @ p["wdq"].to(dt)
    q_nope = _proj(cq, p["wuq"], dt)  # (B, H, S, dh)
    q_rope = apply_rope(_proj(cq, p["wqr"], dt), positions[:, None, :], cfg.rope_theta)

    ckv = x @ p["wdkv"].to(dt)  # (B, S, kv_lora)
    k_rope = x @ p["wkr"].to(dt)  # (B, S, dr)
    k_rope = apply_rope(k_rope[:, None], positions[:, None, :], cfg.rope_theta)[:, 0]
    k_nope = _proj(ckv, p["wuk"], dt)
    v = _proj(ckv, p["wuv"], dt)

    q = torch.cat([q_nope, q_rope], dim=-1)
    k = torch.cat([k_nope, k_rope[:, None].expand(q_rope.shape)], dim=-1)
    # (B, H, S, dh)
    o = local_heads(attention_ref, (q, k, v), causal=True, sm_scale=_mla_scale(cfg))
    hd = o.shape[1] * o.shape[3]
    return o.transpose(1, 2).reshape(b, s, hd) @ p["wo"].to(dt).reshape(hd, -1)


def mla_decode(p, x, cfg, cache: KVCache, pos: int):
    """Absorbed MLA decode: cache = latent (B, S, kv_lora + rope_head).  The
    new latent of every batch row is written at ``pos`` in place (clamped
    into range, as JAX's ``dynamic_update_slice``).  Returns (y (B, 1, d),
    cache)."""
    dt = cdt(cfg)
    b = x.shape[0]
    positions = torch.full((b, 1), pos, dtype=torch.int32, device=x.device)
    cq = x @ p["wdq"].to(dt)
    q_nope = _proj(cq, p["wuq"], dt)[:, :, 0]  # (B, H, dh)
    q_rope = apply_rope(_proj(cq, p["wqr"], dt), positions[:, None, :], cfg.rope_theta)[:, :, 0]

    ckv = (x @ p["wdkv"].to(dt))[:, 0]  # (B, kv_lora)
    k_rope = x[:, 0] @ p["wkr"].to(dt)
    k_rope = apply_rope(k_rope[:, None], positions, cfg.rope_theta)[:, 0]
    lat = cache.k
    s = lat.shape[1]
    write_index(lat, 1, min(max(int(pos), 0), s - 1), torch.cat([ckv, k_rope], dim=-1))
    kv_len = int(pos) + 1

    # absorb W_UK into q: q_c (B, H, C) = q_nope @ W_UK^T
    q_c = torch.einsum("bhk,chk->bhc", q_nope, p["wuk"].to(dt))
    # the latent has no heads: gathered where the queries' heads are split
    o_lat = local_heads(_mla_scores, (q_c, q_rope, lat), kv_len, cfg, head_dims=(1, 1, None))
    # absorb W_UV on the way out
    o = torch.einsum("bhc,chk->bhk", o_lat, p["wuv"].to(dt))
    hd = o.shape[1] * o.shape[2]
    y = o.reshape(b, hd) @ p["wo"].to(dt).reshape(hd, -1)
    return y[:, None, :], cache


def _mla_scores(q_c, q_rope, lat, kv_len, cfg):
    """Attention of (B, H, C) absorbed queries over a (B, S, C + R) latent
    cache's first ``kv_len`` columns → (B, H, C) in the compute dtype."""
    dt = cdt(cfg)
    s = lat.shape[1]
    c_lat = lat[..., : cfg.kv_lora].to(dt)  # (B, S, C)
    r_lat = lat[..., cfg.kv_lora :].to(dt)  # (B, S, R)
    scores = torch.einsum("bhc,bsc->bhs", q_c.float(), c_lat.float())
    scores = scores + torch.einsum("bhr,bsr->bhs", q_rope.float(), r_lat.float())
    scores = scores / ((cfg.d_head + cfg.rope_head) ** 0.5)
    live = torch.arange(s, device=lat.device)[None, None, :] < kv_len
    w = torch.softmax(scores.masked_fill(~live, -1e30), dim=-1)
    return torch.einsum("bhs,bsc->bhc", w, c_lat.float()).to(dt)


def mla_cache_spec(cfg, batch, s_max, layers=None):
    shape = (batch, s_max, cfg.kv_lora + cfg.rope_head)
    if layers:
        shape = (layers,) + shape
    return KVCache(k=TensorSpec(shape, cdt(cfg)), v=None)


# ---------------------------------------------------------------------------
# Cross-attention (whisper decoder → encoder output)
# ---------------------------------------------------------------------------


def cross_spec(cfg):
    d, h, dh = cfg.d_model, cfg.n_heads, cfg.d_head
    return {
        "wq": P((d, h, dh), ("embed", "heads", None)),
        "wk": P((d, h, dh), ("embed", "heads", None)),
        "wv": P((d, h, dh), ("embed", "heads", None)),
        "wo": P((h, dh, d), ("heads", None, "embed")),
    }


def cross_apply(p, x, enc, cfg):
    """x: (B, S, d) attends over enc: (B, T_enc, d), no mask.  One query row
    (a decode step) goes to ``decode_attention`` over all T_enc columns."""
    dt = cdt(cfg)
    b, s, _ = x.shape
    q = _proj(x, p["wq"], dt)  # (B, H, S, D)
    k = _proj(enc, p["wk"], dt)  # (B, H, T_enc, D)
    v = _proj(enc, p["wv"], dt)
    if s == 1:
        o = decode_attention(q[:, :, 0].contiguous(), k.contiguous(), v.contiguous())[:, :, None]
    else:
        o = local_heads(attention_ref, (q, k, v), causal=False)
    hd = o.shape[1] * o.shape[3]
    return o.transpose(1, 2).reshape(b, s, hd) @ p["wo"].to(dt).reshape(hd, -1)
