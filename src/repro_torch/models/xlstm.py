"""xLSTM blocks, the mLSTM (matrix memory) and the sLSTM (scalar memory),
with the stabilized exponential gating (port of
``src/repro/models/xlstm.py``; arXiv:2405.04517).

mLSTM recurrence (per head, head dim P):
    m_t = max(f̃_t + m_{t-1}, ĩ_t)                       (stabilizer)
    i'  = exp(ĩ_t − m_t);  f' = exp(f̃_t + m_{t-1} − m_t)
    C_t = f'·C_{t-1} + i'·(v_t ⊗ k_t)                    (P×P matrix memory)
    n_t = f'·n_{t-1} + i'·k_t
    h_t = (C_t q_t) / max(|n_tᵀ q_t|, 1)

Training runs the recurrence as a loop over time (JAX's ``lax.scan``), or
chunkwise (``mlstm_train_chunked``, the same outputs); decode is one step
of it on the carried ``(C, n, m)``.  The gates, states and recurrences are
f32, as in JAX; the JAX package calls no Pallas kernel here, so neither
does the port: all of it is plain PyTorch.
"""
from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F

from repro_torch.models.layers import cdt
from repro_torch.models.params import P, TensorSpec


class XLSTMCache(NamedTuple):
    c: torch.Tensor  # (B, H, P, P), or (L, B, H, P, P) stacked over layers
    n: torch.Tensor  # (B, H, P)
    m: torch.Tensor  # (B, H)


class SLSTMCache(NamedTuple):
    c: torch.Tensor  # (B, H, P)
    n: torch.Tensor  # (B, H, P)
    h: torch.Tensor  # (B, H, P)
    m: torch.Tensor  # (B, H)


M0 = -1e30  # the stabilizer before the first step


def _dims(cfg):
    heads = cfg.n_heads
    return heads, cfg.d_model // heads


def _heads_proj(x, w, dt):
    """einsum("btd,dhp->bthp", x, w) as one matmul."""
    d, h, p_ = w.shape
    return (x @ w.to(dt).reshape(d, h * p_)).reshape(*x.shape[:-1], h, p_)


def _out_proj(h, wo, dt):
    """einsum("bthp,hpd->btd", h, wo) (or "bhp,hpd->bd") as one matmul."""
    hh, p_, d = wo.shape
    return h.reshape(*h.shape[:-2], hh * p_) @ wo.to(dt).reshape(hh * p_, d)


# ---------------------------------------------------------------------------
# mLSTM block
# ---------------------------------------------------------------------------


def mlstm_spec(cfg):
    d = cfg.d_model
    h, p_ = _dims(cfg)
    return {
        "wq": P((d, h, p_), ("embed", "heads", None)),
        "wk": P((d, h, p_), ("embed", "heads", None)),
        "wv": P((d, h, p_), ("embed", "heads", None)),
        "wi": P((d, h), ("embed", "heads")),  # input gate pre-act
        "wf": P((d, h), ("embed", "heads")),  # forget gate pre-act
        "bi": P((h,), ("heads",), "zeros"),
        "bf": P((h,), ("heads",), "ones"),  # bias toward remembering
        "wo_gate": P((d, d), ("embed", "ffn")),
        "wo": P((h, p_, d), ("heads", None, "embed")),
    }


def _mlstm_gates(p, x, cfg):
    """q, k, v (B, T, H, P) in the compute dtype; the gates (B, T, H) f32
    (their weights are read in f32)."""
    dt = cdt(cfg)
    q = _heads_proj(x, p["wq"], dt)
    k = _heads_proj(x, p["wk"], dt)
    v = _heads_proj(x, p["wv"], dt)
    xf = x.float()
    ig = xf @ p["wi"] + p["bi"]
    fg = xf @ p["wf"] + p["bf"]
    return q, k, v, ig, fg


def _mlstm_step(state, inp, d_head):
    c, n, m = state  # (B,H,P,P), (B,H,P), (B,H)
    q, k, v, ig, fg = inp  # q/k/v (B,H,P); gates (B,H)
    k = k / (d_head**0.5)  # in k's dtype, as JAX divides before its cast
    logf = F.logsigmoid(fg)
    m_new = torch.maximum(logf + m, ig)
    i_p = torch.exp(ig - m_new)
    f_p = torch.exp(logf + m - m_new)
    qf, kf, vf = q.float(), k.float(), v.float()
    c_new = f_p[..., None, None] * c + i_p[..., None, None] * (
        vf[..., :, None] * kf[..., None, :]
    )
    n_new = f_p[..., None] * n + i_p[..., None] * kf
    num = torch.einsum("bhij,bhj->bhi", c_new, qf)
    den = torch.clamp(torch.abs(torch.einsum("bhj,bhj->bh", n_new, qf)), min=1.0)
    return (c_new, n_new, m_new), num / den[..., None]


def _mlstm_zeros(b, heads, d_head, device):
    return (torch.zeros((b, heads, d_head, d_head), device=device),
            torch.zeros((b, heads, d_head), device=device),
            torch.full((b, heads), M0, device=device))


def _mlstm_out(p, x, h, dt):
    gate = F.silu(x @ p["wo_gate"].to(dt))
    return _out_proj(h, p["wo"], dt) * gate


def mlstm_train(p, x, cfg):
    """x: (B, T, d) → (B, T, d), the recurrence one step at a time."""
    dt = cdt(cfg)
    b, t, _ = x.shape
    heads, d_head = _dims(cfg)
    q, k, v, ig, fg = _mlstm_gates(p, x, cfg)
    state = _mlstm_zeros(b, heads, d_head, x.device)
    hs = []
    for i in range(t):
        state, h = _mlstm_step(state, (q[:, i], k[:, i], v[:, i], ig[:, i], fg[:, i]), d_head)
        hs.append(h)
    return _mlstm_out(p, x, torch.stack(hs, dim=1).to(dt), dt)


def mlstm_decode(p, x, cfg, cache: XLSTMCache):
    """One token, x: (B, 1, d).  Returns (y (B, 1, d), the new cache)."""
    dt = cdt(cfg)
    _, d_head = _dims(cfg)
    q, k, v, ig, fg = _mlstm_gates(p, x, cfg)
    state, h = _mlstm_step(
        (cache.c, cache.n, cache.m), (q[:, 0], k[:, 0], v[:, 0], ig[:, 0], fg[:, 0]), d_head
    )
    return _mlstm_out(p, x, h.to(dt)[:, None], dt), XLSTMCache(*state)


def mlstm_cache_spec(cfg, batch, layers=None):
    heads, d_head = _dims(cfg)
    shp = lambda *s: (layers,) + s if layers else s
    f32 = torch.float32
    return XLSTMCache(
        c=TensorSpec(shp(batch, heads, d_head, d_head), f32),
        n=TensorSpec(shp(batch, heads, d_head), f32),
        m=TensorSpec(shp(batch, heads), f32),
    )


# ---------------------------------------------------------------------------
# sLSTM block
# ---------------------------------------------------------------------------


def slstm_spec(cfg):
    d = cfg.d_model
    h, p_ = _dims(cfg)
    return {
        "wx": P((d, 4, h, p_), ("embed", None, "heads", None)),  # i,f,z,o from x
        "wr": P((4, h, p_, p_), (None, "heads", None, None)),  # recurrent (block-diag per head)
        "b": P((4, h, p_), (None, "heads", None), "zeros"),
        "wo": P((h, p_, d), ("heads", None, "embed")),
    }


def _slstm_inputs(p, x):
    """einsum("btd,dghp->btghp", x f32, wx): (B, T, 4, H, P) f32."""
    d, g, h, p_ = p["wx"].shape
    return (x.float() @ p["wx"].reshape(d, g * h * p_)).reshape(*x.shape[:-1], g, h, p_)


def _slstm_step(p, state, xt):
    c, n, h, m = state  # (B,H,P) ×3, (B,H)
    pre = xt + torch.einsum("ghpq,bhq->bghp", p["wr"], h).reshape(xt.shape)  # (B,4,H,P)
    pre = pre + p["b"][None]
    ig, fg, zg, og = pre.unbind(1)  # (B,H,P)
    # per-head stabilizer from the mean pre-activation across the head dim
    ig_s = ig.mean(-1)
    fg_s = fg.mean(-1)
    logf = F.logsigmoid(fg_s)
    m_new = torch.maximum(logf + m, ig_s)
    i_p = torch.exp(ig - m_new[..., None])
    f_p = torch.exp(logf[..., None] + (m - m_new)[..., None])
    c_new = f_p * c + i_p * torch.tanh(zg)
    n_new = f_p * n + i_p
    h_new = torch.sigmoid(og) * c_new / torch.clamp(n_new, min=1.0)
    return (c_new, n_new, h_new, m_new)


def slstm_train(p, x, cfg):
    """x: (B, T, d) → (B, T, d), the recurrence one step at a time."""
    dt = cdt(cfg)
    b, t, _ = x.shape
    heads, d_head = _dims(cfg)
    xg = _slstm_inputs(p, x)
    z = torch.zeros((b, heads, d_head), device=x.device)
    state = (z, z, z, torch.full((b, heads), M0, device=x.device))
    hs = []
    for i in range(t):
        state = _slstm_step(p, state, xg[:, i])
        hs.append(state[2])
    return _out_proj(torch.stack(hs, dim=1).to(dt), p["wo"], dt)


def slstm_decode(p, x, cfg, cache: SLSTMCache):
    """One token, x: (B, 1, d).  Returns (y (B, 1, d), the new cache)."""
    dt = cdt(cfg)
    state = _slstm_step(p, (cache.c, cache.n, cache.h, cache.m), _slstm_inputs(p, x)[:, 0])
    return _out_proj(state[2].to(dt), p["wo"], dt)[:, None, :], SLSTMCache(*state)


def slstm_cache_spec(cfg, batch, layers=None):
    heads, d_head = _dims(cfg)
    shp = lambda *s: (layers,) + s if layers else s
    z = lambda *s: TensorSpec(shp(*s), torch.float32)
    return SLSTMCache(
        c=z(batch, heads, d_head),
        n=z(batch, heads, d_head),
        h=z(batch, heads, d_head),
        m=z(batch, heads),
    )


# ---------------------------------------------------------------------------
# Chunkwise mLSTM (the same outputs as the step-by-step form)
# ---------------------------------------------------------------------------
#
# Per chunk of length L, with b the cumulative log-forget inside the chunk:
#   intra-chunk: D_ij = exp(b_i − b_j + ĩ_j − m_i) for j ≤ i
#   inter-chunk: the carried C_prev, decayed by exp(b_i + m_prev − m_i)
#   carry:       C_new = exp(b_L + m_prev − m_new)·C_prev
#                        + Σ_j exp(b_L − b_j + ĩ_j − m_new)·v_j k_jᵀ
# The state is read and written once a chunk instead of once a step, and
# the intra-chunk work is matrix products.


def _mlstm_chunk_scan(q, k, v, ig, fg, d_head: int, chunk: int):
    """q/k/v: (B, T, H, P) f32; gates (B, T, H) f32.  Returns h (B, T, H, P)."""
    b, t, h, p_ = q.shape
    nc = t // chunk
    k = k / (d_head**0.5)

    logf = F.logsigmoid(fg)  # (B,T,H)
    cq = lambda x: x.reshape(b, nc, chunk, h, p_)
    qc, kc, vc = cq(q), cq(k), cq(v)
    igc = ig.reshape(b, nc, chunk, h)
    lfc = logf.reshape(b, nc, chunk, h)
    bcum = torch.cumsum(lfc, dim=2)  # (B,nc,L,H) cumulative log-forget (self included)

    # the stabilizer's candidate from the inputs: m_in_i = max_{j≤i} (b_i − b_j + ĩ_j)
    a_j = igc - bcum  # ĩ_j − b_j
    m_in = torch.cummax(a_j, dim=2).values + bcum  # (B,nc,L,H)
    tri = torch.tril(torch.ones((chunk, chunk), dtype=torch.bool, device=q.device))

    c_prev = torch.zeros((b, h, p_, p_), device=q.device)
    n_prev = torch.zeros((b, h, p_), device=q.device)
    m_prev = torch.full((b, h), M0, device=q.device)
    out = []
    for ci in range(nc):
        qx, kx, vx = qc[:, ci], kc[:, ci], vc[:, ci]  # (B,L,H,P)
        bx, igx, m_inx = bcum[:, ci], igc[:, ci], m_in[:, ci]  # (B,L,H)
        # stabilizer: m_i = max(m_prev + b_i, m_in_i)
        m_i = torch.maximum(m_prev[:, None] + bx, m_inx)
        # inter-chunk: (C_prev q_i)·exp(b_i + m_prev − m_i)
        dec_in = torch.exp(bx + m_prev[:, None] - m_i)
        h_inter = torch.einsum("bhij,blhj->blhi", c_prev, qx) * dec_in[..., None]
        n_inter = torch.einsum("bhj,blhj->blh", n_prev, qx) * dec_in
        # intra-chunk: D_ij = exp(b_i − b_j + ĩ_j − m_i), j ≤ i
        dmat = bx[:, :, None] - bx[:, None, :] + igx[:, None, :] - m_i[:, :, None]
        dmat = torch.where(tri[None, :, :, None], torch.exp(dmat), 0.0)  # (B,L,L,H)
        scores = torch.einsum("blhp,bjhp->bljh", qx, kx) * dmat
        h_intra = torch.einsum("bljh,bjhp->blhp", scores, vx)
        n_intra = scores.sum(2)  # Σ_j score_ij
        den = torch.clamp(torch.abs(n_inter + n_intra), min=1.0)
        out.append((h_inter + h_intra) / den[..., None])
        # carry to the next chunk
        b_l = bx[:, -1]  # (B,H) the chunk's total log-forget
        m_cand = torch.amax(igx - bx, dim=1) + b_l
        m_new = torch.maximum(m_prev + b_l, m_cand)
        dec_c = torch.exp(m_prev + b_l - m_new)  # (B,H)
        w_j = torch.exp((b_l[:, None] - bx) + igx - m_new[:, None])  # (B,L,H)
        c_upd = torch.einsum("blh,blhp,blhq->bhpq", w_j, vx, kx)
        n_upd = torch.einsum("blh,blhp->bhp", w_j, kx)
        c_prev = c_prev * dec_c[..., None, None] + c_upd
        n_prev = n_prev * dec_c[..., None] + n_upd
        m_prev = m_new
    return torch.stack(out, dim=1).reshape(b, t, h, p_)


def mlstm_train_chunked(p, x, cfg, chunk: int = 64):
    """The mLSTM block chunkwise (the outputs of ``mlstm_train``); T must be
    a multiple of ``min(chunk, T)``."""
    dt = cdt(cfg)
    t = x.shape[1]
    _, d_head = _dims(cfg)
    chunk = min(chunk, t)
    q, k, v, ig, fg = _mlstm_gates(p, x, cfg)
    h = _mlstm_chunk_scan(q.float(), k.float(), v.float(), ig, fg, d_head, chunk).to(dt)
    return _mlstm_out(p, x, h, dt)
