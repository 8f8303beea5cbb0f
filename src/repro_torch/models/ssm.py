"""State-space sequence mixers: Mamba2 (SSD) and RWKV-6 (Finch) (port of
``repro/models/ssm.py``).

Prefill uses the reference's chunked formulation: within a chunk the
recurrence is a masked quadratic form, across chunks a small state is
carried (the reference's ``lax.scan``, a Python loop here). Decode is one
recurrence step on an O(1) state. The SSM and RWKV states are fp32; the
conv window and the token-shift ``x_last`` take the cache dtype.

Numerical notes (the reference's): Mamba2 decay exponents are <= 0 inside
the chunk quadratic; RWKV6 per-channel decays are clamped to log w in
[-2, -1e-6] and the intra-chunk factors are stabilised around the chunk's
midpoint cumulative decay (chunk = 32).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from .config import MambaConfig, ModelConfig, RWKVConfig
from .layers import F32, rmsnorm, rmsnorm_spec
from .params import Leaf, dense, full, mm, weight

# ===========================================================================
# Mamba2 (SSD)
# ===========================================================================


def mamba_spec(cfg: ModelConfig):
    m: MambaConfig = cfg.mamba
    d_inner = m.expand * cfg.d_model
    nheads = d_inner // m.head_dim
    conv_dim = d_inner + 2 * m.state_dim
    return {
        # order: [z | x | B | C | dt]
        "in_proj": dense(cfg.d_model, 2 * d_inner + 2 * m.state_dim + nheads),
        "conv_w": Leaf((m.conv_width, conv_dim), "normal", 0.1),
        "conv_b": full((conv_dim,), 0.0),
        "A_log": full((nheads,), 0.0),  # A = -exp(A_log) = -1
        "D": full((nheads,), 1.0),
        "dt_bias": full((nheads,), 0.0),
        "out_norm": rmsnorm_spec(d_inner),
        "out_proj": dense(d_inner, cfg.d_model),
    }


def _causal_conv(xBC, params):
    """Depthwise causal conv along the sequence, in the activations' dtype
    with a rounding per product and per add (the reference's Python sum).
    xBC: [B, S, C]; conv_w: [W, C]."""
    w = weight(params, "conv_w", xBC.dtype)
    W = w.shape[0]
    S = xBC.shape[1]
    pads = F.pad(xBC, (0, 0, W - 1, 0))
    out = sum(pads[:, i:i + S, :] * w[i] for i in range(W))
    return out + weight(params, "conv_b", xBC.dtype)


def _mamba_project(cfg, params, x):
    m = cfg.mamba
    d_inner = m.expand * cfg.d_model
    nheads = d_inner // m.head_dim
    zxbcdt = mm(x, weight(params, "in_proj", x.dtype))
    z = zxbcdt[..., :d_inner]
    xBC = zxbcdt[..., d_inner:2 * d_inner + 2 * m.state_dim]
    dt_raw = zxbcdt[..., 2 * d_inner + 2 * m.state_dim:]
    return z, xBC, dt_raw, d_inner, nheads


def _mamba_post(cfg, params, xin, y, z):
    """y + D skip, gated norm, out projection."""
    B_, S, H, hd = y.shape
    xh = xin.reshape(B_, S, H, hd)
    y = y + weight(params, "D", y.dtype)[None, None, :, None] * xh
    y = y.reshape(B_, S, H * hd)
    y = rmsnorm(params["out_norm"], y, cfg.rms_eps)
    y = y * F.silu(z.to(F32)).to(y.dtype)
    return mm(y, weight(params, "out_proj", y.dtype))


def mamba_apply(cfg: ModelConfig, params, x):
    """Prefill SSD (``ssm.py:88``). x: [B, S, D] -> [B, S, D]; S must be a
    multiple of the chunk."""
    m = cfg.mamba
    B_, S, _ = x.shape
    z, xBC, dt_raw, d_inner, H = _mamba_project(cfg, params, x)
    xBC = F.silu(_causal_conv(xBC, params).to(F32)).to(x.dtype)
    xs = xBC[..., :d_inner]
    Bm = xBC[..., d_inner:d_inner + m.state_dim].to(F32)  # [B,S,N]
    Cm = xBC[..., d_inner + m.state_dim:].to(F32)  # [B,S,N]
    dt = F.softplus(dt_raw.to(F32) + params["dt_bias"])  # [B,S,H]
    A = -torch.exp(params["A_log"])  # [H]
    loga = dt * A[None, None, :]  # log decay, <= 0
    xh = xs.reshape(B_, S, H, m.head_dim).to(F32)
    xdt = xh * dt[..., None]

    Q = m.chunk
    if S % Q:
        raise ValueError(f"mamba_apply: sequence length {S} is not a multiple of the chunk {Q}")
    nc = S // Q

    def r(t):
        return t.reshape((B_, nc, Q) + t.shape[2:])

    loga_c, x_c, B_c, C_c = r(loga), r(xdt), r(Bm), r(Cm)
    L = torch.cumsum(loga_c, dim=2)  # [B,nc,Q,H] inclusive

    # intra-chunk quadratic: scores[t,s] = (C_t . B_s) e^{L_t - L_s} (s <= t)
    CB = torch.einsum("bctn,bcsn->bcts", C_c, B_c)
    dec = torch.exp(L[:, :, :, None, :] - L[:, :, None, :, :])  # [B,nc,Q,Q,H]
    mask = torch.tril(torch.ones((Q, Q), dtype=torch.bool, device=x.device))
    scores = CB[..., None] * torch.where(mask[None, None, :, :, None], dec, 0.0)
    y_intra = torch.einsum("bctsh,bcshd->bcthd", scores, x_c)

    # inter-chunk recurrence over the carried state [B,H,N,hd]
    w_state = torch.exp(L[:, :, -1, None, :] - L)  # decay from s to the chunk end
    state_add = torch.einsum("bcsh,bcsn,bcshd->bchnd", w_state, B_c, x_c)
    chunk_decay = torch.exp(L[:, :, -1, :])  # [B,nc,H]
    S_prev = torch.zeros((B_, H, m.state_dim, m.head_dim), dtype=F32, device=x.device)
    y_inter = []
    for c in range(nc):
        y_inter.append(torch.einsum("bqn,bhnd,bqh->bqhd", C_c[:, c], S_prev, torch.exp(L[:, c])))
        S_prev = chunk_decay[:, c][:, :, None, None] * S_prev + state_add[:, c]
    y_inter = torch.stack(y_inter, 1)  # [B,nc,Q,H,hd]

    y = (y_intra + y_inter).reshape(B_, S, H, m.head_dim).to(x.dtype)
    return _mamba_post(cfg, params, xs, y, z)


def mamba_cache_init(cfg: ModelConfig, batch: int, dtype=F32, device=None):
    m = cfg.mamba
    d_inner = m.expand * cfg.d_model
    H = d_inner // m.head_dim
    conv_dim = d_inner + 2 * m.state_dim
    return {
        "ssm": torch.zeros((batch, H, m.state_dim, m.head_dim), dtype=F32, device=device),
        "conv": torch.zeros((batch, m.conv_width - 1, conv_dim), dtype=dtype, device=device),
    }


def mamba_decode(cfg: ModelConfig, params, x, cache, pos):
    """One-token recurrence (``ssm.py:158``). x: [B, 1, D]."""
    m = cfg.mamba
    B_ = x.shape[0]
    z, xBC, dt_raw, d_inner, H = _mamba_project(cfg, params, x)
    hist = torch.cat([cache["conv"], xBC.to(cache["conv"].dtype)], dim=1)
    # a dot over the conv window in the cache dtype: fp32 products and sum,
    # one rounding (XLA computes a bf16 dot in fp32)
    w = weight(params, "conv_w", hist.dtype)
    conv_out = torch.einsum("bwc,wc->bc", hist.to(F32), w.to(F32)).to(hist.dtype)
    conv_out = conv_out + weight(params, "conv_b", hist.dtype)
    xBC1 = F.silu(conv_out.to(F32))[:, None, :].to(x.dtype)
    new_conv = hist[:, 1:, :]
    xs = xBC1[..., :d_inner]
    Bm = xBC1[..., d_inner:d_inner + m.state_dim].to(F32)[:, 0]
    Cm = xBC1[..., d_inner + m.state_dim:].to(F32)[:, 0]
    dt = F.softplus(dt_raw.to(F32) + params["dt_bias"])[:, 0]  # [B,H]
    a = torch.exp(dt * (-torch.exp(params["A_log"]))[None, :])  # [B,H]
    xh = xs.reshape(B_, 1, H, m.head_dim).to(F32)[:, 0]  # [B,H,hd]
    S_new = a[:, :, None, None] * cache["ssm"] + torch.einsum("bn,bhd,bh->bhnd", Bm, xh, dt)
    y = torch.einsum("bn,bhnd->bhd", Cm, S_new)[:, None]  # [B,1,H,hd]
    out = _mamba_post(cfg, params, xs, y.to(x.dtype), z)
    return out, {"ssm": S_new, "conv": new_conv}


# ===========================================================================
# RWKV-6 (Finch)
# ===========================================================================

RWKV_LOGW_MIN, RWKV_LOGW_MAX = -2.0, -1e-6
RWKV_CHUNK = 32


def rwkv_spec(cfg: ModelConfig):
    r: RWKVConfig = cfg.rwkv
    D = cfg.d_model
    return {
        "mu": Leaf((5, D), "uniform"),  # r, k, v, w, g lerps
        "w_r": dense(D, D),
        "w_k": dense(D, D),
        "w_v": dense(D, D),
        "w_g": dense(D, D),
        "w0": full((D,), -0.6),  # base log-log decay
        "w_lora_a": dense(D, r.decay_lora),
        "w_lora_b": full((r.decay_lora, D), 0.0),
        "u": Leaf((D,), "normal", 0.1),  # bonus
        "out_norm": rmsnorm_spec(r.head_dim),  # per-head norm
        "w_out": dense(D, D),
        # channel mix
        "cm_mu": Leaf((2, D), "uniform"),
        "cm_k": dense(D, cfg.d_ff),
        "cm_v": dense(cfg.d_ff, D),
        "cm_r": dense(D, D),
    }


def _shift(x, last=None):
    """Token shift: x_{t-1} (zeros, or the given state, at t = 0)."""
    pad = torch.zeros_like(x[:, :1]) if last is None else last[:, None, :]
    return torch.cat([pad, x[:, :-1]], dim=1)


def _rwkv_proj(cfg, params, x, x_prev):
    r = cfg.rwkv
    H = cfg.d_model // r.head_dim
    B_, S, _ = x.shape
    dt = x.dtype
    mu = weight(params, "mu", dt)

    def mix(i):
        return x + mu[i] * (x_prev - x)

    rv = mm(mix(0), weight(params, "w_r", dt)).reshape(B_, S, H, r.head_dim)
    kv = mm(mix(1), weight(params, "w_k", dt)).reshape(B_, S, H, r.head_dim)
    vv = mm(mix(2), weight(params, "w_v", dt)).reshape(B_, S, H, r.head_dim)
    logw = params["w0"] + torch.tanh(mm(mix(3), weight(params, "w_lora_a", dt)).to(F32)) @ params["w_lora_b"]
    logw = -torch.exp(logw)  # < 0
    logw = torch.clamp(logw, RWKV_LOGW_MIN, RWKV_LOGW_MAX).reshape(B_, S, H, r.head_dim)
    gv = F.silu(mm(mix(4), weight(params, "w_g", dt)).to(F32)).to(dt)
    return rv, kv, vv, logw, gv


def _rwkv_out(cfg, params, wkv, g, x_dtype):
    B_, S, H, hd = wkv.shape
    y = rmsnorm(params["out_norm"], wkv.to(F32)).to(x_dtype)
    y = y.reshape(B_, S, H * hd) * g.reshape(B_, S, H * hd)
    return mm(y, weight(params, "w_out", x_dtype))


def rwkv_timemix_apply(cfg: ModelConfig, params, x, x_last=None):
    """Chunked RWKV6 time mix (``ssm.py:251``). x: [B, S, D], S a multiple
    of 32."""
    r = cfg.rwkv
    B_, S, D = x.shape
    H = D // r.head_dim
    rv, kv, vv, logw, g = _rwkv_proj(cfg, params, x, _shift(x, x_last))
    rv, kv, vv = (t.to(F32) for t in (rv, kv, vv))
    u = params["u"].reshape(H, r.head_dim)

    Q = RWKV_CHUNK
    if S % Q:
        raise ValueError(f"rwkv_timemix_apply: sequence length {S} is not a multiple of {Q}")
    nc = S // Q

    def ch(t):
        return t.reshape((B_, nc, Q) + t.shape[2:])

    rc, kc, vc, lw = ch(rv), ch(kv), ch(vv), ch(logw)
    Wc = torch.cumsum(lw, dim=2)  # [B,nc,Q,H,hd] inclusive cumulative log decay
    Wprev = Wc - lw  # exclusive
    Wref = Wc[:, :, Q // 2:Q // 2 + 1]  # midpoint stabiliser
    r_t = rc * torch.exp(Wprev - Wref)
    k_s = kc * torch.exp(Wref - Wc)
    scores = torch.einsum("bcthd,bcshd->bchts", r_t, k_s)
    mask = torch.tril(torch.ones((Q, Q), dtype=torch.bool, device=x.device), diagonal=-1)
    scores = torch.where(mask[None, None, None], scores, 0.0)
    bonus = torch.einsum("bcthd,hd,bcthd->bcth", rc, u, kc)  # the s == t term
    y_intra = torch.einsum("bchts,bcshd->bcthd", scores, vc)
    y_intra = y_intra + bonus[..., None] * vc

    # inter-chunk state S [B,H,hd_k,hd_v]
    w_end = torch.exp(Wc[:, :, -1:, :, :] - Wc)  # decay s -> chunk end
    add = torch.einsum("bcshk,bcshv->bchkv", kc * w_end, vc)
    cdec = torch.exp(Wc[:, :, -1])  # [B,nc,H,hd]
    r_in = rc * torch.exp(Wprev)  # decay from the chunk start
    S_prev = torch.zeros((B_, H, r.head_dim, r.head_dim), dtype=F32, device=x.device)
    y_inter = []
    for c in range(nc):
        y_inter.append(torch.einsum("bqhk,bhkv->bqhv", r_in[:, c], S_prev))
        S_prev = cdec[:, c][:, :, :, None] * S_prev + add[:, c]
    y = (y_intra + torch.stack(y_inter, 1)).reshape(B_, S, H, r.head_dim)
    return _rwkv_out(cfg, params, y, g, x.dtype)


def rwkv_timemix_decode(cfg: ModelConfig, params, x, cache, pos):
    """One-token RWKV6 step (``ssm.py:300``). cache: {state: [B,H,k,v],
    x_last: [B,D]}."""
    r = cfg.rwkv
    H = cfg.d_model // r.head_dim
    rv, kv, vv, logw, g = _rwkv_proj(cfg, params, x, cache["x_last"][:, None, :].to(x.dtype))
    rv, kv, vv = (t.to(F32)[:, 0] for t in (rv, kv, vv))  # [B,H,hd]
    w = torch.exp(logw.to(F32))[:, 0]
    u = params["u"].reshape(H, r.head_dim)
    S_prev = cache["state"]
    y = (torch.einsum("bhk,bhkv->bhv", rv, S_prev)
         + torch.einsum("bhk,hk,bhk,bhv->bhv", rv, u, kv, vv))
    S_new = w[..., None] * S_prev + torch.einsum("bhk,bhv->bhkv", kv, vv)
    out = _rwkv_out(cfg, params, y[:, None], g, x.dtype)
    return out, {"state": S_new, "x_last": x[:, 0].to(cache["x_last"].dtype)}


def rwkv_chanmix_apply(cfg: ModelConfig, params, x, x_last=None):
    """RWKV channel mix (``ssm.py:319``)."""
    dt = x.dtype
    xs = _shift(x, x_last)
    mu = weight(params, "cm_mu", dt)
    xk = x + mu[0] * (xs - x)
    xr = x + mu[1] * (xs - x)
    h = torch.square(torch.relu(mm(xk, weight(params, "cm_k", dt)).to(F32))).to(dt)
    rgate = torch.sigmoid(mm(xr, weight(params, "cm_r", dt)).to(F32)).to(dt)
    return rgate * mm(h, weight(params, "cm_v", dt))


def rwkv_cache_init(cfg: ModelConfig, batch: int, dtype=F32, device=None):
    r = cfg.rwkv
    D = cfg.d_model
    H = D // r.head_dim
    return {
        "state": torch.zeros((batch, H, r.head_dim, r.head_dim), dtype=F32, device=device),
        "x_last": torch.zeros((batch, D), dtype=dtype, device=device),
        "cm_x_last": torch.zeros((batch, D), dtype=dtype, device=device),
    }
