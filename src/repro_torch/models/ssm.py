"""Recurrent sequence mixers (port of ``repro.models.ssm``): the chunked
gated linear recurrence (Mamba2's SSD and xLSTM's mLSTM are both
instances), the Mamba2 block and the xLSTM mLSTM and sLSTM blocks.

The recurrence is  S_t = a_t * S_{t-1} + k_t v_t^T,  y_t = q_t @ S_t  with
a per-(step, head) scalar decay ``a_t = exp(log_a_t)``.  Decode runs the
chunk form with ``chunk=1`` (as the JAX package does), not
``linear_rnn_step``, which rounds differently.  The chunk loop is a Python
loop where JAX scans.  Each operation rounds to its dtype where JAX's
``jnp`` code does; XLA may keep excess precision inside a fused bf16
chain, so bf16 results can stand a few ulps apart.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from ..launch.mesh import split_heads
from .common import DP, TP, ParamDef, dense, rms_norm


def _softplus(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.softplus``: logaddexp(x, 0)."""
    return torch.logaddexp(x, torch.zeros_like(x))


def _const(c: float, like: torch.Tensor) -> torch.Tensor:
    """A 0-d f32 constant on ``like``'s device.  ``torch.maximum`` and
    ``torch.minimum`` against it split a tie's gradient in half, as JAX's
    ``jnp.maximum``/``jnp.minimum`` do (``torch.clamp`` passes it whole):
    an sLSTM's normalizer is exactly 1 at its first step."""
    return torch.full((), c, dtype=torch.float32, device=like.device)


def _scale(x: torch.Tensor, c: float) -> torch.Tensor:
    """x / c with the Python float rounded to x's dtype first, as JAX does
    with a weakly typed scalar."""
    return x / torch.full((), c, dtype=x.dtype, device=x.device)


# --------------------------------------------------------------------------
# chunked gated linear recurrence
# --------------------------------------------------------------------------

def chunked_linear_rnn(q, k, v, log_a, s0=None, *, chunk: int = 128):
    """q,k: [B, S, H, dk]; v: [B, S, H, dv]; log_a: [B, S, H] (<= 0).
    Returns (y [B, S, H, dv] in v's dtype, s_final [B, H, dk, dv] f32)."""
    B, S, H, dk = q.shape
    dv = v.shape[-1]
    L = min(chunk, S)
    while S % L:
        L //= 2
    n = S // L

    qc = q.reshape(B, n, L, H, dk).permute(1, 0, 3, 2, 4)     # [n,B,H,L,dk]
    kc = k.reshape(B, n, L, H, dk).permute(1, 0, 3, 2, 4)
    vc = v.reshape(B, n, L, H, dv).permute(1, 0, 3, 2, 4)
    ac = log_a.reshape(B, n, L, H).permute(1, 0, 3, 2)        # [n,B,H,L]

    s = s0
    if s is None:
        s = torch.zeros((B, H, dk, dv), dtype=torch.float32, device=q.device)
    causal = torch.tril(torch.ones((L, L), dtype=torch.bool,
                                   device=q.device))
    ys = []
    for i in range(n):
        lai = ac[i].to(torch.float32)
        A = torch.cumsum(lai, dim=-1)                          # [B,H,L]
        # intra-chunk: y_i += sum_{j<=i} exp(A_i - A_j) (q_i.k_j) v_j
        qf = qc[i].to(torch.float32)
        kf = kc[i].to(torch.float32)
        vf = vc[i].to(torch.float32)
        scores = torch.einsum("bhid,bhjd->bhij", qf, kf)
        decay = A[..., :, None] - A[..., None, :]              # [B,H,L,L]
        w = torch.where(causal, torch.exp(decay), 0.0)
        y = torch.einsum("bhij,bhjd->bhid", scores * w, vf)
        # inter-chunk: y_i += exp(A_i) q_i @ s_in
        y = y + torch.exp(A)[..., None] * torch.einsum("bhid,bhdv->bhiv",
                                                       qf, s)
        # state update: s_out = exp(A_L) s + sum_j exp(A_L - A_j) k_j v_j^T
        tail = torch.exp(A[..., -1:] - A)                      # [B,H,L]
        s = torch.exp(A[..., -1])[..., None, None] * s + torch.einsum(
            "bhjd,bhjv->bhdv", kf * tail[..., None], vf)
        ys.append(y)
    y = torch.stack(ys).permute(1, 0, 3, 2, 4).reshape(B, S, H, dv)
    return y.to(v.dtype), s


def linear_rnn_step(q, k, v, log_a, s):
    """Single-token recurrence.  q,k: [B, H, dk]; v: [B, H, dv];
    log_a: [B, H]; s: [B, H, dk, dv] -> (y [B, H, dv], s')."""
    a = torch.exp(log_a.to(torch.float32))[..., None, None]
    s = a * s + torch.einsum("bhd,bhv->bhdv", k.to(torch.float32),
                             v.to(torch.float32))
    y = torch.einsum("bhd,bhdv->bhv", q.to(torch.float32), s)
    return y.to(v.dtype), s


# --------------------------------------------------------------------------
# Mamba2 block (SSD)
# --------------------------------------------------------------------------

def mamba2_defs(d_model: int, ssm_state: int, dtype, *, expand: int = 2,
                head_dim: int = 64, conv_width: int = 4) -> dict:
    d_inner = expand * d_model
    H = d_inner // head_dim
    return {
        "norm": ParamDef((d_model,), (None,), "ones", dtype=dtype),
        "in_proj": ParamDef((d_model, 2 * d_inner + 2 * ssm_state + H),
                            (DP, TP), dtype=dtype),
        "conv": ParamDef((conv_width, d_inner + 2 * ssm_state), (None, TP),
                         "normal", dtype=dtype),
        "A_log": ParamDef((H,), (None,), "zeros", dtype=torch.float32),
        "D": ParamDef((H,), (None,), "ones", dtype=torch.float32),
        "dt_bias": ParamDef((H,), (None,), "zeros", dtype=torch.float32),
        "out_norm": ParamDef((d_inner,), (None,), "ones", dtype=dtype),
        "out_proj": ParamDef((d_inner, d_model), (TP, DP), dtype=dtype),
    }


def _causal_conv(x, w, state=None):
    """Depthwise causal conv.  x: [B, S, C]; w: [W, C].
    state: [B, W-1, C] carried inputs for decode; returns (y, new_state).
    The taps are summed left to right, each product in x's dtype."""
    W = w.shape[0]
    if state is None:
        state = torch.zeros((x.shape[0], W - 1, x.shape[2]), dtype=x.dtype,
                            device=x.device)
    xp = torch.cat([state, x], dim=1)
    S = x.shape[1]
    y = xp[:, 0:S] * w[0]
    for i in range(1, W):
        y = y + xp[:, i:i + S] * w[i]
    return y.to(x.dtype), xp[:, -(W - 1):]


def mamba2_block(params, x, cfg, state=None, *, chunk: int = 128):
    """x: [B, S, d_model].  state: optional (conv_state, ssm_state) for
    decode continuation.  Returns (y, new_state)."""
    B, S, d = x.shape
    N = cfg.ssm_state
    d_inner = 2 * d
    head_dim = 64
    H = d_inner // head_dim

    h = rms_norm(x, params["norm"])
    proj = dense(h, params["in_proj"])
    z, xbc, dt = torch.split(proj, [d_inner, d_inner + 2 * N, H], dim=-1)
    conv_state = None if state is None else state[0]
    xbc, new_conv = _causal_conv(xbc, params["conv"], conv_state)
    xbc = F.silu(xbc.to(torch.float32)).to(x.dtype)
    xs, Bc, Cc = torch.split(xbc, [d_inner, N, N], dim=-1)

    dt = _softplus(dt.to(torch.float32) + params["dt_bias"])     # [B,S,H]
    A = -torch.exp(params["A_log"])                              # [H] < 0
    log_a = dt * A                                               # [B,S,H]

    xh = xs.reshape(B, S, H, head_dim)
    v = xh * dt[..., None].to(x.dtype)
    k = Bc[:, :, None, :].expand(B, S, H, N)
    q = Cc[:, :, None, :].expand(B, S, H, N)

    s0 = None if state is None else state[1]
    y, s_final = chunked_linear_rnn(q, k, v, log_a, s0, chunk=chunk)
    y = y + params["D"][None, None, :, None] * xh.to(torch.float32)
    y = y.reshape(B, S, d_inner).to(x.dtype)
    y = rms_norm(y * F.silu(z.to(torch.float32)).to(x.dtype),
                 params["out_norm"])
    return x + dense(y, params["out_proj"]), (new_conv, s_final)


# --------------------------------------------------------------------------
# xLSTM blocks
# --------------------------------------------------------------------------

def mlstm_defs(d_model: int, n_heads: int, dtype, *, expand: int = 2) -> dict:
    d_inner = expand * d_model
    return {
        "norm": ParamDef((d_model,), (None,), "ones", dtype=dtype),
        "up_proj": ParamDef((d_model, 2 * d_inner), (DP, TP), dtype=dtype),
        "wq": ParamDef((d_inner, d_inner), (DP, TP), dtype=dtype),
        "wk": ParamDef((d_inner, d_inner), (DP, TP), dtype=dtype),
        "wv": ParamDef((d_inner, d_inner), (DP, TP), dtype=dtype),
        "wif": ParamDef((d_inner, 2 * n_heads), (DP, None), dtype=dtype),
        "out_norm": ParamDef((d_inner,), (None,), "ones", dtype=dtype),
        "down_proj": ParamDef((d_inner, d_model), (TP, DP), dtype=dtype),
    }


def mlstm_block(params, x, cfg, state=None, *, chunk: int = 128):
    """xLSTM mLSTM block (matrix memory, capped exponential input gate and
    a normalizer carried as a second recurrence over a ones ``v``).
    state: optional (s [B, H, dh, dh], n [B, H, dh, 1])."""
    B, S, d = x.shape
    H = cfg.n_heads
    d_inner = 2 * d
    dh = d_inner // H

    h = rms_norm(x, params["norm"])
    up = dense(h, params["up_proj"])
    xm, z = torch.chunk(up, 2, dim=-1)

    q = _scale(split_heads(dense(xm, params["wq"]), H), math.sqrt(dh))
    k = _scale(split_heads(dense(xm, params["wk"]), H), math.sqrt(dh))
    v = split_heads(dense(xm, params["wv"]), H)
    gates = dense(xm, params["wif"]).to(torch.float32)
    i_gate = torch.exp(torch.minimum(gates[..., :H], _const(4.0, gates)))
    log_f = F.logsigmoid(gates[..., H:])                       # [B,S,H]

    ki = k * i_gate[..., None].to(k.dtype)
    s0 = None if state is None else state[0]
    n0 = None if state is None else state[1]
    y, s_final = chunked_linear_rnn(q, ki, v, log_f, s0, chunk=chunk)
    ones = torch.ones(v.shape[:-1] + (1,), dtype=v.dtype, device=v.device)
    nrm, n_final = chunked_linear_rnn(q, ki, ones, log_f, n0, chunk=chunk)
    y = y.to(torch.float32) / torch.maximum(
        torch.abs(nrm.to(torch.float32)), _const(1.0, y))

    y = y.reshape(B, S, d_inner).to(x.dtype)
    y = rms_norm(y * F.silu(z.to(torch.float32)).to(x.dtype),
                 params["out_norm"])
    return x + dense(y, params["down_proj"]), (s_final, n_final)


def slstm_defs(d_model: int, n_heads: int, dtype, *, pf: float = 4 / 3) -> dict:
    dh = d_model // n_heads
    # the GeGLU hidden rounded up to a multiple of 64
    d_ff = -(-int(pf * d_model) // 64) * 64
    return {
        "norm": ParamDef((d_model,), (None,), "ones", dtype=dtype),
        "wx": ParamDef((d_model, 4 * d_model), (DP, None), dtype=dtype),
        "r": ParamDef((n_heads, dh, 4 * dh), (None, None, None), dtype=dtype,
                      scale=0.5),
        "ff_norm": ParamDef((d_model,), (None,), "ones", dtype=dtype),
        "ff_in": ParamDef((d_model, 2 * d_ff), (DP, TP), dtype=dtype),
        "ff_out": ParamDef((d_ff, d_model), (TP, DP), dtype=dtype),
    }


def slstm_init_state(B: int, H: int, dh: int, device) -> tuple:
    """(c, n, m, h) = (0, 0, -10, 0), each [B, H, dh] f32."""
    z = torch.zeros((B, H, dh), dtype=torch.float32, device=device)
    return (z, z.clone(), z - 10.0, z.clone())


def slstm_block(params, x, cfg, state=None):
    """xLSTM sLSTM block: the sequential scalar-memory recurrence (its
    recurrent product in f32) and a GeGLU feed-forward.
    state: optional (c, n, m, h), each [B, H, dh] f32."""
    B, S, d = x.shape
    H = cfg.n_heads
    dh = d // H

    h = rms_norm(x, params["norm"])
    wx = dense(h, params["wx"])                 # [B, S, 4d]

    if state is None:
        state = slstm_init_state(B, H, dh, x.device)
    c, n, m, hprev = state

    r = params["r"].to(torch.float32)
    one = _const(1.0, c)
    ys = []
    for t in range(S):
        rec = torch.einsum("bhd,hdk->bhk", hprev, r)           # [B, H, 4dh]
        gx = wx[:, t].to(torch.float32).reshape(B, H, 4 * dh) + rec
        zt, it, ft, ot = torch.split(gx, dh, dim=-1)
        zt = torch.tanh(zt)
        ot = torch.sigmoid(ot)
        log_f = F.logsigmoid(ft)
        m_new = torch.maximum(log_f + m, it)
        i_p = torch.exp(it - m_new)
        f_p = torch.exp(log_f + m - m_new)
        c = f_p * c + i_p * zt
        n = f_p * n + i_p
        hprev = ot * c / torch.maximum(n, one)
        m = m_new
        ys.append(hprev)
    y = torch.stack(ys, dim=1).reshape(B, S, d).to(x.dtype)
    x = x + y
    # GeGLU feed-forward
    hf = rms_norm(x, params["ff_norm"])
    a, b = torch.chunk(dense(hf, params["ff_in"]), 2, dim=-1)
    ff = F.gelu(a.to(torch.float32), approximate="tanh").to(x.dtype) * b
    return x + dense(ff, params["ff_out"]), (c, n, m, hprev)
