"""Mamba2 (SSD) block: the chunked parallel form for training, the O(1)
state recurrence for decode (port of ``src/repro/models/ssm.py``; zamba2's
backbone).

The SSD form, per head with state N and head dim P:
    h_t = exp(dt_t·A) · h_{t-1} + dt_t · B_t ⊗ x_t        (state (N, P))
    y_t = C_t · h_t + D · x_t
computed chunkwise: the intra-chunk term is quadratic in the chunk length,
and the state is carried from chunk to chunk by a loop over the chunks
(JAX's ``lax.scan``).  The projections run in the compute dtype; the decay,
the state and the SSD products in f32, as in JAX.  The JAX package calls no
Pallas kernel here, so neither does the port.
"""
from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F

from repro_torch.models.layers import cdt
from repro_torch.models.params import P, TensorSpec


class SSMCache(NamedTuple):
    h: torch.Tensor  # (B, H, N, P) state, or (L, B, H, N, P) stacked over layers
    conv: torch.Tensor  # (B, K-1, conv_dim) conv tail


def _dims(cfg):
    d_in = cfg.ssm_expand * cfg.d_model
    return d_in, d_in // cfg.ssm_headdim


def _softplus(x):
    """``jax.nn.softplus``: log(1 + e^x) as ``logaddexp(x, 0)`` at every x
    (``F.softplus`` returns x itself above its threshold)."""
    return torch.logaddexp(x, torch.zeros((), dtype=x.dtype, device=x.device))


def mamba2_spec(cfg):
    d = cfg.d_model
    d_in, heads = _dims(cfg)
    n = cfg.ssm_state
    conv_dim = d_in + 2 * n
    return {
        "in_proj": P((d, 2 * d_in + 2 * n + heads), ("embed", "ffn")),
        "conv_w": P((cfg.ssm_conv, conv_dim), (None, "conv")),
        "conv_b": P((conv_dim,), ("conv",), "zeros"),
        "A_log": P((heads,), (None,), "zeros"),
        "dt_bias": P((heads,), (None,), "zeros"),
        "D": P((heads,), (None,), "ones"),
        "norm_w": P((d_in,), ("ffn",), "ones"),
        "out_proj": P((d_in, d), ("ffn", "embed")),
    }


def _split_proj(z, cfg):
    """gate (d_in) | conv input (d_in + 2N) | dt (heads)."""
    d_in, heads = _dims(cfg)
    n = cfg.ssm_state
    return torch.split(z, [d_in, d_in + 2 * n, heads], dim=-1)


def _causal_conv(xbc, w, b, cfg, tail=None):
    """Depthwise causal conv1d of kernel K over (B, T, C).  ``tail``: the
    (B, K-1, C) history for decode.  Returns (out, new tail)."""
    k = cfg.ssm_conv
    pad = tail if tail is not None else torch.zeros(
        (xbc.shape[0], k - 1, xbc.shape[-1]), dtype=xbc.dtype, device=xbc.device
    )
    xp = torch.cat([pad, xbc], dim=1)  # (B, K-1+T, C)
    t = xbc.shape[1]
    out = sum(xp[:, i : i + t, :] * w[i][None, None, :] for i in range(k))
    out = F.silu(out + b[None, None, :])
    return out, xp[:, -(k - 1):, :]


def _segsum(log_a):
    """(..., T) → (..., T, T): the cumulative log-decay from column to row,
    -inf above the diagonal."""
    t = log_a.shape[-1]
    cs = torch.cumsum(log_a, dim=-1)
    diff = cs[..., :, None] - cs[..., None, :]
    mask = torch.tril(torch.ones((t, t), dtype=torch.bool, device=log_a.device))
    return torch.where(mask, diff, float("-inf"))


def _gated_norm_out(p, y, gate, dt_):
    """Mamba2's gated RMS norm, then the output projection."""
    y = y * F.silu(gate)
    var = torch.mean(torch.square(y.float()), -1, keepdim=True)
    y = (y.float() * torch.rsqrt(var + 1e-6) * p["norm_w"]).to(dt_)
    return y @ p["out_proj"].to(dt_)


def mamba2_train(p, x, cfg):
    """x: (B, T, d) → (B, T, d) via chunked SSD."""
    dt_ = cdt(cfg)
    b, t, _ = x.shape
    d_in, heads = _dims(cfg)
    n, hp = cfg.ssm_state, cfg.ssm_headdim
    cs = min(cfg.ssm_chunk, t)
    assert t % cs == 0, f"seq {t} % chunk {cs} != 0"
    nc = t // cs

    z = x @ p["in_proj"].to(dt_)
    gate, xbc, dtp = _split_proj(z, cfg)
    xbc, _ = _causal_conv(xbc, p["conv_w"].to(dt_), p["conv_b"].to(dt_), cfg)
    xs, bmat, cmat = torch.split(xbc, [d_in, n, n], dim=-1)
    xh = xs.reshape(b, t, heads, hp)
    dt = _softplus(dtp.float() + p["dt_bias"][None, None])  # (B,T,H)
    a = -torch.exp(p["A_log"].float())  # (H,) negative
    da = dt * a[None, None]  # (B,T,H) log-decay
    dac = da.reshape(b, nc, cs, heads).permute(0, 3, 1, 2)  # (B,H,nc,cs)
    xc = xh.reshape(b, nc, cs, heads, hp)
    bc = bmat.reshape(b, nc, cs, n).float()
    cc = cmat.reshape(b, nc, cs, n).float()
    dtc = dt.reshape(b, nc, cs, heads)

    # intra-chunk (diagonal) term
    l = torch.exp(_segsum(dac))  # (B,H,nc,cs,cs)
    scores = torch.einsum("bcin,bcjn->bcij", cc, bc)
    att = scores[:, None] * l  # (B,H,nc,cs,cs)
    xdt = xc.float() * dtc[..., None]  # (B,nc,cs,H,P)
    y_diag = torch.einsum("bhcij,bcjhp->bcihp", att, xdt)

    # chunk states, carried from chunk to chunk
    # state_c = Σ_i exp(Σ_{j>i} da_j) · dt_i · B_i ⊗ x_i
    cum = torch.cumsum(dac, dim=-1)
    decay_rest = torch.exp(cum[..., -1:] - cum)  # (B,H,nc,cs)
    states = torch.einsum("bhci,bcin,bcihp->bchnp", decay_rest, bc, xdt)  # (B,nc,H,N,P)
    chunk_decay = torch.exp(cum[..., -1])  # (B,H,nc)
    h = torch.zeros((b, heads, n, hp), device=x.device)
    h_prev = []  # the state before each chunk
    for ci in range(nc):
        h_prev.append(h)
        h = h * chunk_decay[:, :, ci, None, None] + states[:, ci]
    h_prev = torch.stack(h_prev)  # (nc,B,H,N,P)

    # inter-chunk output: y_off_i = C_i · exp(cum_i) · h_prev
    decay_in = torch.exp(cum)  # (B,H,nc,cs)
    y_off = torch.einsum("bcin,bhci,cbhnp->bcihp", cc, decay_in, h_prev)

    y = (y_diag + y_off).reshape(b, t, heads, hp)
    y = y + xh.float() * p["D"][None, None, :, None]
    y = y.reshape(b, t, d_in).to(dt_)
    return _gated_norm_out(p, y, gate, dt_)


def mamba2_decode(p, x, cfg, cache: SSMCache):
    """One token, x: (B, 1, d).  Returns (y (B, 1, d), the new cache)."""
    dt_ = cdt(cfg)
    b = x.shape[0]
    d_in, heads = _dims(cfg)
    n, hp = cfg.ssm_state, cfg.ssm_headdim

    z = x @ p["in_proj"].to(dt_)
    gate, xbc, dtp = _split_proj(z, cfg)
    xbc, conv_tail = _causal_conv(
        xbc, p["conv_w"].to(dt_), p["conv_b"].to(dt_), cfg, tail=cache.conv
    )
    xs, bmat, cmat = torch.split(xbc[:, 0], [d_in, n, n], dim=-1)
    xh = xs.reshape(b, heads, hp).float()
    dt = _softplus(dtp[:, 0].float() + p["dt_bias"][None])  # (B,H)
    a = -torch.exp(p["A_log"].float())
    dec = torch.exp(dt * a[None])  # (B,H)
    h = cache.h * dec[..., None, None] + torch.einsum("bn,bhp,bh->bhnp", bmat.float(), xh, dt)
    y = torch.einsum("bn,bhnp->bhp", cmat.float(), h)
    y = y + xh * p["D"][None, :, None]
    y = y.reshape(b, d_in).to(dt_)
    return _gated_norm_out(p, y, gate[:, 0], dt_)[:, None, :], SSMCache(h=h, conv=conv_tail)


def ssm_cache_spec(cfg, batch, layers=None):
    d_in, heads = _dims(cfg)
    n, hp = cfg.ssm_state, cfg.ssm_headdim
    hshape = (batch, heads, n, hp)
    cshape = (batch, cfg.ssm_conv - 1, d_in + 2 * n)
    if layers:
        hshape = (layers,) + hshape
        cshape = (layers,) + cshape
    return SSMCache(h=TensorSpec(hshape, torch.float32), conv=TensorSpec(cshape, cdt(cfg)))
