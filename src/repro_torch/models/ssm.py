"""State-space sequence mixers: Mamba2 (SSD) and RWKV-6 (Finch) (port of
``repro/models/ssm.py``).

Prefill uses the reference's chunked formulation: within a chunk the
recurrence is a masked quadratic form, across chunks a small state is
carried (the reference's ``lax.scan``, a Python loop here). Decode is one
recurrence step on an O(1) state. The SSM and RWKV states are fp32; the
conv window and the token-shift ``x_last`` take the cache dtype.

Numerical notes (the reference's): Mamba2 decay exponents are <= 0 inside
the chunk quadratic (the port masks them before the exp, the reference after
it, whose gradient is NaN at a full-width chunk of 256); RWKV6 per-channel decays are clamped to log w in
[-2, -1e-6] and the intra-chunk factors are stabilised around the chunk's
midpoint cumulative decay (chunk = 32).

``tp``: the shard context of a rank of a sharded model (:mod:`.layers`),
which runs the recurrence on its heads (:class:`Heads`, ``tp.ssm_heads``;
no head reads another). With ``tp=None`` nothing changes. With a context
every weight is read through ``tp.weight`` (gathered over "data" where the
layout splits it there), and:

* RWKV-6: ``w_r`` / ``w_k`` / ``w_v`` / ``w_g`` column-parallel on the
  rank's heads; ``w_lora_a`` column-parallel over its lora columns, whose
  ``tanh`` is gathered over "model" (exact: elementwise) before the product
  with the rank's column block of ``w_lora_b``; ``w0`` and ``u`` narrowed to
  the rank's heads; the per-head ``out_norm`` local; ``w_out`` row-parallel
  (fp32 partials summed over "model", rounded once). Channel mix: ``cm_k``
  column-parallel, ``cm_v`` row-parallel, the sigmoid gate of the ``cm_r``
  column block gathered over "model" (exact) before the product. The state
  cache holds the rank's heads; ``x_last`` / ``cm_x_last`` are whole.
* Mamba2: the spec cuts ``in_proj``'s columns ``[z | x | B | C | dt]``
  across the segments, so its column-parallel product is gathered over
  "model" (one all-gather of [B, S, 2 d_inner + 2N + H]) and the rank takes
  its heads' ``z``, ``x`` and ``dt`` columns and ``B``, ``C`` whole; the
  depthwise conv runs on those channels, ``conv_w`` read whole; the SSD on
  the rank's heads; the gated RMSNorm over all of d_inner takes the row's
  sum of squares summed over "model" (one fp32 all-reduce of [B, S, 1]);
  ``out_proj`` row-parallel. The ssm cache holds the rank's heads; the conv
  window is whole (every rank has the whole product).

Under autograd (the sharded train step) each use has its backward
(``serve/sharded.ServeShard``): the replicated leaves a rank reads only for
its heads (RWKV-6's ``w0``, ``u`` and ``out_norm`` scale; Mamba2's
``A_log``, ``dt_bias``, ``D``, ``conv_b`` and gated norm scale) have their
gradients summed over "model" (``part``); the gathered lora tanh, ``in_proj``
product and ``conv_w`` feed the rank's heads only, so their reduce-scatter
sums the ranks' partial gradients; RWKV-6's channel-mix gate multiplies the
replicated row-parallel sum, so every rank holds its whole gradient and
keeps its own block (``gather_replicated``); the gated norm's sum of squares
scales the rank's heads only, so its gradient is summed too (``part``). A
product's weight that "model" leaves whole where only the rank's heads read
its output (Mamba2's ``in_proj`` and ``conv_w``, RWKV-6's ``w_lora_a``) has
its gradient summed the same way (``ServeShard.weight``); a mixer whose
output product "model" does not split (``w_out``, ``out_proj``, ``cm_v``)
runs alike on every rank (``ServeShard.core``).
"""
from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F

from .config import MambaConfig, ModelConfig, RWKVConfig
from .layers import F32, _col_mm, _core, _row_mm, _weight, rmsnorm, rmsnorm_spec
from .params import Leaf, dense, full


@dataclasses.dataclass(frozen=True)
class Heads:
    """The recurrent heads (RWKV-6's D / head_dim, Mamba2's d_inner /
    head_dim) a rank computes: ``h0 ... h0 + n - 1``; ``whole``: its "model"
    block of the head-split weights cuts through a head, so it computes all
    of them with those weights gathered over "model" first."""

    h0: int
    n: int
    whole: bool = False


def _heads(tp, H: int) -> Heads:
    return Heads(0, H) if tp is None else tp.ssm_heads


def _head_cols(t: torch.Tensor, hs: Heads, width: int, H: int) -> torch.Tensor:
    """The columns (last dim) of heads ``hs`` of a tensor laid out as H
    blocks of ``width``; ``t`` itself where they are all of them."""
    return t if hs.n == H else t.narrow(-1, hs.h0 * width, hs.n * width)


def _raw(params, name: str, tp, whole: bool = False, part: bool = False) -> torch.Tensor:
    """``params[name]`` as the single process reads it, in its own dtype (no
    cast: the reference adds or multiplies the leaf as it is); on a rank,
    gathered over "data" where the layout splits it there (and over "model"
    too if ``whole``; ``part``: read only for the rank's heads)."""
    return params[name] if tp is None else tp.weight(params, name, params[name].dtype, whole, part)


def _gathered(t: torch.Tensor, params, name: str, tp, replicated: bool = False) -> torch.Tensor:
    """``t`` [..., cols], the rank's column block of a product with
    ``params[name]``, gathered over "model" where that weight's columns are
    split there (the whole product); ``t`` itself elsewhere. ``replicated``:
    every rank uses the whole product alike (its gradient's own block kept,
    not summed)."""
    if tp is None or tp.model_block(params, name, -1) is None:
        return t
    return (tp.gather_replicated if replicated else tp.gather)(t, t.dim() - 1, "model")


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


def _conv_channels(t: torch.Tensor, cfg: ModelConfig, hs: Heads) -> torch.Tensor:
    """The channels of heads ``hs`` of a tensor over ``[x | B | C]`` (last
    dim): their x channels, then B and C whole; ``t`` itself for all heads."""
    m = cfg.mamba
    d_inner = m.expand * cfg.d_model
    if hs.n * m.head_dim == d_inner:
        return t
    return torch.cat([t[..., hs.h0 * m.head_dim:(hs.h0 + hs.n) * m.head_dim], t[..., d_inner:]], -1)


def _conv_weights(cfg, params, dtype, tp, hs: Heads):
    """(conv_w [W, C'], conv_b [C']) of the channels of heads ``hs``
    (:func:`_conv_channels`); conv_w read whole."""
    w = _weight(params, "conv_w", dtype, tp, True)
    return _conv_channels(w, cfg, hs), _conv_channels(_weight(params, "conv_b", dtype, tp, part=True), cfg, hs)


def _causal_conv(xBC, w, b):
    """Depthwise causal conv along the sequence, in the activations' dtype
    with a rounding per product and per add (the reference's Python sum).
    xBC: [B, S, C]; w: [W, C]; b: [C]."""
    W = w.shape[0]
    S = xBC.shape[1]
    pads = F.pad(xBC, (0, 0, W - 1, 0))
    out = sum(pads[:, i:i + S, :] * w[i] for i in range(W))
    return out + b


def _mamba_project(cfg, params, x, tp=None):
    """(z, xBC, dt_raw) of the rank's heads ([B, S, n hd], [B, S, n hd +
    2N], [B, S, n]), the whole ``[x | B | C]`` [B, S, d_inner + 2N], and the
    heads."""
    m = cfg.mamba
    d_inner = m.expand * cfg.d_model
    H = d_inner // m.head_dim
    hs = _heads(tp, H)
    zxbcdt = _gathered(_col_mm(x, [_weight(params, "in_proj", x.dtype, tp)], tp)[0], params, "in_proj", tp)
    z = _head_cols(zxbcdt[..., :d_inner], hs, m.head_dim, H)
    xBC = zxbcdt[..., d_inner:2 * d_inner + 2 * m.state_dim]
    dt_raw = _head_cols(zxbcdt[..., 2 * d_inner + 2 * m.state_dim:], hs, 1, H)
    return z, _conv_channels(xBC, cfg, hs), dt_raw, xBC, hs


def _mamba_decay(cfg, params, tp, hs: Heads):
    """(dt_bias, A = -exp(A_log)) of heads ``hs``."""
    H = cfg.mamba.expand * cfg.d_model // cfg.mamba.head_dim
    dt_bias = _head_cols(_raw(params, "dt_bias", tp, part=True), hs, 1, H)
    return dt_bias, -torch.exp(_head_cols(_raw(params, "A_log", tp, part=True), hs, 1, H))


def _gated_norm(cfg, params, y, tp):
    """The RMSNorm of ``y`` [B, S, n hd] over all of d_inner; on a rank of
    some of the heads, the row's sum of squares summed over "model" in fp32
    and the scale's columns of its heads (``out_proj``'s row block reads only
    the rank's part of the norm: both are ``part`` uses)."""
    m = cfg.mamba
    d_inner = m.expand * cfg.d_model
    if tp is None or y.shape[-1] == d_inner:
        return rmsnorm(params["out_norm"], y, cfg.rms_eps, tp, part=True)
    xf = y.to(F32)
    var = tp.all_reduce((xf * xf).sum(-1, keepdim=True), "model", part=True) / d_inner
    scale = tp.weight(params["out_norm"], "scale", F32, part=True)
    scale = scale.narrow(-1, tp.ssm_heads.h0 * m.head_dim, y.shape[-1])
    return (xf * torch.rsqrt(var + cfg.rms_eps) * scale).to(y.dtype)


def _mamba_post(cfg, params, xin, y, z, hs: Heads, tp=None):
    """y + D skip, gated norm, out projection (row-parallel on a rank)."""
    B_, S, H, hd = y.shape
    xh = xin.reshape(B_, S, H, hd)
    D = _head_cols(_weight(params, "D", y.dtype, tp, part=True), hs, 1, cfg.mamba.expand * cfg.d_model // hd)
    y = y + D[None, None, :, None] * xh
    y = y.reshape(B_, S, H * hd)
    y = _gated_norm(cfg, params, y, tp)
    y = y * F.silu(z.to(F32)).to(y.dtype)
    return _row_mm(y, params, "out_proj", tp)


def mamba_apply(cfg: ModelConfig, params, x, tp=None):
    """Prefill SSD (``ssm.py:88``). x: [B, S, D] -> [B, S, D]; S must be a
    multiple of the chunk. On a rank (``tp``): its heads."""
    m = cfg.mamba
    tp = _core(tp, params, "out_proj")
    B_, S, _ = x.shape
    z, xBC, dt_raw, _, hs = _mamba_project(cfg, params, x, tp)
    H, nd = hs.n, hs.n * m.head_dim
    xBC = F.silu(_causal_conv(xBC, *_conv_weights(cfg, params, x.dtype, tp, hs)).to(F32)).to(x.dtype)
    xs = xBC[..., :nd]
    Bm = xBC[..., nd:nd + m.state_dim].to(F32)  # [B,S,N]
    Cm = xBC[..., nd + m.state_dim:].to(F32)  # [B,S,N]
    dt_bias, A = _mamba_decay(cfg, params, tp, hs)
    dt = F.softplus(dt_raw.to(F32) + dt_bias)  # [B,S,H]
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

    # intra-chunk quadratic: scores[t,s] = (C_t . B_s) e^{L_t - L_s} (s <= t). The exponent is masked before
    # the exp, where the reference masks after it: the same values, but past the diagonal L_t - L_s > 0 grows
    # with the chunk (a full-width chunk of 256 passes 88, exp's fp32 range), and exp's backward there,
    # 0 * inf, made the whole gradient NaN
    CB = torch.einsum("bctn,bcsn->bcts", C_c, B_c)
    mask = torch.tril(torch.ones((Q, Q), dtype=torch.bool, device=x.device))
    dec = torch.exp(torch.where(mask[None, None, :, :, None], L[:, :, :, None, :] - L[:, :, None, :, :],
                                float("-inf")))  # [B,nc,Q,Q,H]
    scores = CB[..., None] * dec
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
    return _mamba_post(cfg, params, xs, y, z, hs, tp)


def mamba_cache_init(cfg: ModelConfig, batch: int, dtype=F32, device=None):
    m = cfg.mamba
    d_inner = m.expand * cfg.d_model
    H = d_inner // m.head_dim
    conv_dim = d_inner + 2 * m.state_dim
    return {
        "ssm": torch.zeros((batch, H, m.state_dim, m.head_dim), dtype=F32, device=device),
        "conv": torch.zeros((batch, m.conv_width - 1, conv_dim), dtype=dtype, device=device),
    }


def mamba_decode(cfg: ModelConfig, params, x, cache, pos, tp=None):
    """One-token recurrence (``ssm.py:158``). x: [B, 1, D]. On a rank
    (``tp``): its heads and their ssm cache, the whole conv window."""
    m = cfg.mamba
    tp = _core(tp, params, "out_proj")
    B_ = x.shape[0]
    z, _, dt_raw, xBC, hs = _mamba_project(cfg, params, x, tp)
    H, nd = hs.n, hs.n * m.head_dim
    hist = torch.cat([cache["conv"], xBC.to(cache["conv"].dtype)], dim=1)
    # a dot over the conv window in the cache dtype: fp32 products and sum,
    # one rounding (XLA computes a bf16 dot in fp32)
    w, b = _conv_weights(cfg, params, hist.dtype, tp, hs)
    conv_out = torch.einsum("bwc,wc->bc", _conv_channels(hist, cfg, hs).to(F32), w.to(F32)).to(hist.dtype)
    conv_out = conv_out + b
    xBC1 = F.silu(conv_out.to(F32))[:, None, :].to(x.dtype)
    new_conv = hist[:, 1:, :]
    xs = xBC1[..., :nd]
    Bm = xBC1[..., nd:nd + m.state_dim].to(F32)[:, 0]
    Cm = xBC1[..., nd + m.state_dim:].to(F32)[:, 0]
    dt_bias, A = _mamba_decay(cfg, params, tp, hs)
    dt = F.softplus(dt_raw.to(F32) + dt_bias)[:, 0]  # [B,H]
    a = torch.exp(dt * A[None, :])  # [B,H]
    xh = xs.reshape(B_, 1, H, m.head_dim).to(F32)[:, 0]  # [B,H,hd]
    S_new = a[:, :, None, None] * cache["ssm"] + torch.einsum("bn,bhd,bh->bhnd", Bm, xh, dt)
    y = torch.einsum("bn,bhnd->bhd", Cm, S_new)[:, None]  # [B,1,H,hd]
    out = _mamba_post(cfg, params, xs, y.to(x.dtype), z, hs, tp)
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


def _rwkv_proj(cfg, params, x, x_prev, tp=None):
    """(r, k, v, log w [B, S, n, hd], g [B, S, n hd]) of the rank's heads."""
    r = cfg.rwkv
    hs = _heads(tp, cfg.d_model // r.head_dim)
    H = hs.n
    B_, S, _ = x.shape
    dt = x.dtype
    mu = _weight(params, "mu", dt, tp)

    def mix(i):
        return x + mu[i] * (x_prev - x)

    def proj(i, name, whole=hs.whole):
        return _col_mm(mix(i), [_weight(params, name, dt, tp, whole)], tp)[0]

    rv = proj(0, "w_r").reshape(B_, S, H, r.head_dim)
    kv = proj(1, "w_k").reshape(B_, S, H, r.head_dim)
    vv = proj(2, "w_v").reshape(B_, S, H, r.head_dim)
    lora = _gathered(torch.tanh(proj(3, "w_lora_a", False).to(F32)), params, "w_lora_a", tp)
    w0 = _head_cols(_raw(params, "w0", tp, part=True), hs, r.head_dim, cfg.d_model // r.head_dim)
    # fp32 @ the leaf as it is (bf16 under bf16 replicas): jnp promotes it to fp32, torch's matmul must be told
    logw = w0 + lora @ _raw(params, "w_lora_b", tp, hs.whole).to(lora.dtype)
    logw = -torch.exp(logw)  # < 0
    logw = torch.clamp(logw, RWKV_LOGW_MIN, RWKV_LOGW_MAX).reshape(B_, S, H, r.head_dim)
    gv = F.silu(proj(4, "w_g").to(F32)).to(dt)
    return rv, kv, vv, logw, gv


def _rwkv_u(cfg, params, tp) -> torch.Tensor:
    """The bonus ``u`` of the rank's heads, [n, hd] fp32."""
    r = cfg.rwkv
    H = cfg.d_model // r.head_dim
    hs = _heads(tp, H)
    return _head_cols(_raw(params, "u", tp, part=True), hs, r.head_dim, H).reshape(hs.n, r.head_dim)


def _rwkv_out(cfg, params, wkv, g, x_dtype, tp=None):
    B_, S, H, hd = wkv.shape
    y = rmsnorm(params["out_norm"], wkv.to(F32), tp=tp, part=True).to(x_dtype)  # the rank's heads
    y = y.reshape(B_, S, H * hd) * g.reshape(B_, S, H * hd)
    return _row_mm(y, params, "w_out", tp)


def rwkv_timemix_apply(cfg: ModelConfig, params, x, x_last=None, tp=None):
    """Chunked RWKV6 time mix (``ssm.py:251``). x: [B, S, D], S a multiple
    of 32. On a rank (``tp``): its heads."""
    r = cfg.rwkv
    tp = _core(tp, params, "w_out")
    B_, S, D = x.shape
    rv, kv, vv, logw, g = _rwkv_proj(cfg, params, x, _shift(x, x_last), tp)
    H = rv.shape[2]
    rv, kv, vv = (t.to(F32) for t in (rv, kv, vv))
    u = _rwkv_u(cfg, params, tp)

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
    return _rwkv_out(cfg, params, y, g, x.dtype, tp)


def rwkv_timemix_decode(cfg: ModelConfig, params, x, cache, pos, tp=None):
    """One-token RWKV6 step (``ssm.py:300``). cache: {state: [B,H,k,v],
    x_last: [B,D]}; on a rank (``tp``) the state of its heads."""
    tp = _core(tp, params, "w_out")
    rv, kv, vv, logw, g = _rwkv_proj(cfg, params, x, cache["x_last"][:, None, :].to(x.dtype), tp)
    rv, kv, vv = (t.to(F32)[:, 0] for t in (rv, kv, vv))  # [B,H,hd]
    w = torch.exp(logw.to(F32))[:, 0]
    u = _rwkv_u(cfg, params, tp)
    S_prev = cache["state"]
    y = (torch.einsum("bhk,bhkv->bhv", rv, S_prev)
         + torch.einsum("bhk,hk,bhk,bhv->bhv", rv, u, kv, vv))
    S_new = w[..., None] * S_prev + torch.einsum("bhk,bhv->bhkv", kv, vv)
    out = _rwkv_out(cfg, params, y[:, None], g, x.dtype, tp)
    return out, {"state": S_new, "x_last": x[:, 0].to(cache["x_last"].dtype)}


def rwkv_chanmix_apply(cfg: ModelConfig, params, x, x_last=None, tp=None):
    """RWKV channel mix (``ssm.py:319``). On a rank (``tp``): ``cm_k``
    column-parallel, ``cm_v`` row-parallel, the gate gathered over "model"
    and used whole (its gradient's block kept; where "model" does not split
    ``cm_r``, computed alike on every rank)."""
    dt = x.dtype
    tg, tp = _core(tp, params, "cm_r", -1), _core(tp, params, "cm_v")
    xs = _shift(x, x_last)
    mu = _weight(params, "cm_mu", dt, tp)
    xk = x + mu[0] * (xs - x)
    xr = x + mu[1] * (xs - x)
    h = torch.square(torch.relu(_col_mm(xk, [_weight(params, "cm_k", dt, tp)], tp)[0].to(F32))).to(dt)
    rgate = torch.sigmoid(_col_mm(xr, [_weight(params, "cm_r", dt, tg)], tg)[0].to(F32)).to(dt)
    return _gathered(rgate, params, "cm_r", tg, replicated=True) * _row_mm(h, params, "cm_v", tp)


def rwkv_cache_init(cfg: ModelConfig, batch: int, dtype=F32, device=None):
    r = cfg.rwkv
    D = cfg.d_model
    H = D // r.head_dim
    return {
        "state": torch.zeros((batch, H, r.head_dim, r.head_dim), dtype=F32, device=device),
        "x_last": torch.zeros((batch, D), dtype=dtype, device=device),
        "cm_x_last": torch.zeros((batch, D), dtype=dtype, device=device),
    }
