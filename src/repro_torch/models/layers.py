"""Shared layers: norms, rotary embedding, MLPs, embeddings (port of
``src/repro/models/layers.py``).

All modules are (spec, apply) pairs over plain dict param trees (see
models/params.py).  Params are stored fp32 and cast to the compute dtype at
use (mixed-precision policy); a weight that is already in the compute dtype
is used as it is, so a caller may cast the weights once at load
(``backbone.compute_params``) and get the same values.  All of this is plain
PyTorch: the JAX package computes it outside any Pallas kernel."""
from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn.functional as F
from torch.distributed.tensor import DTensor, Shard

from repro_torch._shardmap_compat import PartitionSpec, shard_map_compat
from repro_torch.models.params import P


def cdt(cfg) -> torch.dtype:
    return getattr(torch, cfg.dtype)


# ---------------------------------------------------------------------------
# norms
# ---------------------------------------------------------------------------


def norm_spec(cfg, d=None):
    d = d or cfg.d_model
    if cfg.norm == "ln":
        return {"scale": P((d,), (None,), "ones"), "bias": P((d,), (None,), "zeros")}
    return {"scale": P((d,), (None,), "ones")}


def norm_apply(p, x, cfg):
    """RMS norm or layer norm, computed in f32 and cast back to x's dtype."""
    xf = x.float()
    if cfg.norm == "ln":
        mu = xf.mean(-1, keepdim=True)
        var = xf.var(-1, keepdim=True, unbiased=False)
        out = (xf - mu) * torch.rsqrt(var + 1e-5) * p["scale"] + p["bias"]
    else:
        var = (xf * xf).mean(-1, keepdim=True)
        out = xf * torch.rsqrt(var + 1e-6) * p["scale"]
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# rotary position embedding
# ---------------------------------------------------------------------------


def rope_frequencies(d_head: int, theta: float):
    return 1.0 / (theta ** (np.arange(0, d_head, 2, dtype=np.float32) / d_head))


@functools.lru_cache(maxsize=16)
def _rope_table(d_head: int, theta: float, device: torch.device) -> torch.Tensor:
    """``rope_frequencies`` on ``device``, made once: a copy from host memory
    at every call would wait for the device's queue on every layer."""
    return torch.as_tensor(rope_frequencies(d_head, theta), device=device)


def rope_cos_sin(positions: torch.Tensor, d_head: int, theta: float, device):
    """(cos, sin) of the rotation angles, (..., S, D/2) for positions
    (..., S): shared by every tensor rotated at the same positions."""
    freqs = _rope_table(d_head, float(theta), device)  # (D/2,)
    angles = positions[..., None].float() * freqs  # (..., S, D/2)
    return torch.cos(angles), torch.sin(angles)


def rotate(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor):
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float):
    """x: (..., S, D) with positions (..., S) or (S,)."""
    return rotate(x, *rope_cos_sin(positions, x.shape[-1], theta, x.device))


# ---------------------------------------------------------------------------
# MLP (SwiGLU / GELU)
# ---------------------------------------------------------------------------


def mlp_spec(cfg, d_in=None, d_ff=None):
    d_in = d_in or cfg.d_model
    d_ff = d_ff or cfg.d_ff
    if cfg.act == "swiglu":
        return {
            "wi": P((d_in, d_ff), ("embed", "ffn")),
            "wg": P((d_in, d_ff), ("embed", "ffn")),
            "wo": P((d_ff, d_in), ("ffn", "embed")),
        }
    return {
        "wi": P((d_in, d_ff), ("embed", "ffn")),
        "wo": P((d_ff, d_in), ("ffn", "embed")),
    }


def mlp_apply(p, x, cfg):
    dt = cdt(cfg)
    if cfg.act == "swiglu":
        h = x @ p["wi"].to(dt)
        g = x @ p["wg"].to(dt)
        h = F.silu(g) * h
    else:
        # jax.nn.gelu defaults to the tanh approximation
        h = F.gelu(x @ p["wi"].to(dt), approximate="tanh")
    return h @ p["wo"].to(dt)


# ---------------------------------------------------------------------------
# embeddings / unembedding
# ---------------------------------------------------------------------------


def embed_spec(cfg):
    s = {"tok": P((cfg.vocab, cfg.d_model), ("vocab", "embed"), "embed")}
    if not cfg.tie_embeddings:
        s["unembed"] = P((cfg.d_model, cfg.vocab), ("embed", "vocab"))
    return s


def _gather_rows(table, ids):
    return table[ids.long()]


def embed_apply(p, tokens, cfg):
    # rows are gathered, then cast: the same values as casting the table
    table = p["tok"]
    if not isinstance(table, DTensor):
        return _gather_rows(table, tokens).to(cdt(cfg))
    # under a mesh: each rank gathers its own token rows from the whole
    # table (the gather and its backward, an accumulating index_put, the
    # mesh-free ops), the table's grad summed over the token shards
    mesh = table.device_mesh
    lead = tuple(name for name, pl in zip(mesh.mesh_dim_names, tokens.placements)
                 if pl == Shard(0)) if isinstance(tokens, DTensor) else ()
    ids_spec = PartitionSpec(lead or None, *([None] * (tokens.dim() - 1)))
    out_spec = PartitionSpec(lead or None, *([None] * tokens.dim()))
    gather = shard_map_compat(_gather_rows, mesh=mesh, in_specs=(PartitionSpec(), ids_spec),
                              out_specs=out_spec, manual=lead)
    return gather(table, tokens).to(cdt(cfg))


def unembed_apply(p, x, cfg):
    w = p["tok"].T if cfg.tie_embeddings else p["unembed"]
    # logits in fp32 for a stable softmax/CE
    return x.float() @ w.float()


def sinusoidal_positions(n: int, d: int) -> np.ndarray:
    """(n, d) float32: sin of the angles in the even columns, cos in the odd
    (numpy, as the JAX package computes it, so the tables are bit-equal)."""
    pos = np.arange(n, dtype=np.float32)[:, None]
    dim = np.arange(0, d, 2, dtype=np.float32)[None, :]
    angle = pos / np.power(10000.0, dim / d)
    out = np.zeros((n, d), np.float32)
    out[:, 0::2] = np.sin(angle)
    out[:, 1::2] = np.cos(angle)
    return out


@functools.lru_cache(maxsize=16)
def position_table(n: int, d: int, device: torch.device) -> torch.Tensor:
    """``sinusoidal_positions(n, d)`` on ``device``, made once: whisper's
    decode reads one row of the 8,192-row table a step."""
    return torch.from_numpy(sinusoidal_positions(n, d)).to(device)
