"""Core NN layers: RMSNorm, RoPE, MLPs, GQA/MQA attention, MLA (port of
``repro/models/layers.py``).

Conventions, as in the reference:

* parameters are dict trees (:mod:`.params`); every layer has a ``*_spec(cfg)``
  giving its leaves' shapes and initialisers, an ``*_apply`` and, for
  attention, a ``*_decode`` path;
* activations are bf16 (``COMPUTE_DTYPE``); every matmul reads the bf16 copy
  of its fp32 master weight (:func:`.params.weight`), softmax statistics and
  norms run in fp32, and the attention scores and ``p @ v`` contract in fp32
  (the reference's ``preferred_element_type``);
* projection weights are 2-D ``[d_in, d_out]`` with flattened head dims;
* prefill attention is the reference's online-softmax scan over KV chunks
  (in-window chunks only for a window shorter than the sequence), a Python
  loop here.

Decode takes ``pos`` as an int or a 0-d integer tensor on the activations'
device; with a tensor the step has no host synchronisation, so the serving
engine can capture it in a CUDA graph.

Tensor parallelism: the dense layers take an optional shard context ``tp``
(``serve/sharded.py``'s :class:`~repro_torch.serve.sharded.ServeShard`: one
rank of a ("data", "model") mesh holding its blocks of the weights and
caches). With ``tp=None`` (the default) nothing changes. With a context, each
weight is read through ``tp.weight`` (gathered over "data" where the layout
splits it there: ZeRO-3), column-parallel products give the rank's columns,
row-parallel ones (``wo``, ``w_out``) a partial that ``tp.row_mm`` sums over
"model" in fp32 and rounds once, attention runs on the rank's q heads
(:class:`Heads`; all of them where the "model" split cuts through a head),
and a decode over a cache whose sequence is split over "data" combines the
ranks' partial softmaxes (:func:`split_decode_attention`). MLA runs on the
rank's q heads too, with its latent (``w_dkv``, ``w_krope``) read whole and
its cache, the latent, whole on every "model" rank. Under autograd
(the sharded train step) the context's collectives carry the gradients:
``x`` enters "model" before the column-parallel products, whose partial
gradients of ``x`` sum there in fp32; ``kv_norm``'s scale enters it too,
since only the rank's heads read the latent it scales, and so does a
product's weight that "model" leaves whole where only the rank's heads read
its output (MQA's ``wk`` / ``wv``, MLA's ``w_dkv`` / ``w_krope``). A layer
whose output product "model" does not split (``wo``, ``w_out``) runs alike
on every rank, in the context's alike view (``tp.core``).
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch
import torch.nn.functional as F

from .config import MLAConfig, ModelConfig
from .params import dense, einsum_low, full, mm, weight

COMPUTE_DTYPE = torch.bfloat16
F32 = torch.float32
NEG_INF = float("-inf")


def set_reference_precision() -> None:
    """Matmuls at the reference's precision: fp32 products in full fp32 (no
    TF32; the reference runs at "highest"), bf16 products with fp32
    accumulation throughout (no reduced-precision split-K reductions)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    torch.set_float32_matmul_precision("highest")


def _pos_tensor(pos, device) -> torch.Tensor:
    """``pos`` as a 0-d int64 tensor on ``device`` (a tensor passes through)."""
    if isinstance(pos, torch.Tensor):
        return pos.to(device=device, dtype=torch.int64)
    return torch.tensor(int(pos), dtype=torch.int64, device=device)


# ---------------------------------------------------------------------------
# RMSNorm
# ---------------------------------------------------------------------------


def rmsnorm_spec(d):
    return {"scale": full((d,), 1.0)}


def rmsnorm(params, x, eps=1e-5, tp=None, part=False):
    """RMSNorm of ``x`` over its last dim; ``part``: on a rank of a sharded
    model, a scale the rank uses only in part (``tp.weight``'s ``part``)."""
    xf = x.to(F32)
    var = (xf * xf).mean(-1, keepdim=True)
    scale = params["scale"] if tp is None else tp.weight(params, "scale", F32, part=part)
    out = xf * torch.rsqrt(var + eps) * scale
    return out.to(x.dtype)


def _weight(p, name: str, dtype, tp, whole: bool = False, part: bool = False) -> torch.Tensor:
    """:func:`.params.weight`, or on a rank of a sharded model the rank's
    block gathered over "data" (and over "model" too if ``whole``; ``part``:
    read only in part by the rank, its gradient summed over "model")."""
    return weight(p, name, dtype) if tp is None else tp.weight(p, name, dtype, whole, part)


def _core(tp, p, name: str, dim: int = -2):
    """``tp``, or its alike view where "model" does not split ``p[name]``
    on ``dim`` (``tp.core``: a layer whose output product runs whole on
    every rank runs alike there)."""
    return tp if tp is None else tp.core(p, name, dim)


def _col_mm(x, ws, tp) -> list:
    """``[x @ w for w in ws]``; on a rank of a sharded model its
    column-parallel products (``tp.col_mm``: under autograd, ``x``'s
    gradient summed over "model")."""
    return [mm(x, w) for w in ws] if tp is None else tp.col_mm(x, ws)


def _row_mm(x, p, name: str, tp) -> torch.Tensor:
    """``x @ p[name]``; on a rank whose ``p[name]`` rows are split over
    "model", the partial product summed over "model" (``tp.row_mm``)."""
    return mm(x, weight(p, name, x.dtype)) if tp is None else tp.row_mm(x, p, name)


# ---------------------------------------------------------------------------
# RoPE
# ---------------------------------------------------------------------------


def rope_freqs(head_dim: int, theta: float, device=None):
    exps = -(torch.arange(0, head_dim, 2, dtype=F32, device=device) / head_dim)
    return torch.pow(theta, exps)  # a scalar base: no host-to-device copy (graph capture)


def rope_angles(positions, head_dim: int, theta: float):
    """(cos, sin) [..., S, 1, hd/2] of the rotation at integer ``positions``
    [..., S]; one pair serves every tensor rotated at those positions."""
    angles = positions.to(F32)[..., None, None] * rope_freqs(head_dim, theta, positions.device)
    return torch.cos(angles), torch.sin(angles)


def apply_rope(x, positions, theta: float, angles=None):
    """x: [..., S, H, hd]; positions: [..., S] integer. Rotates the two
    halves of the head dim (not interleaved pairs). ``angles``: the
    :func:`rope_angles` of ``positions``, where already computed."""
    cos, sin = angles if angles is not None else rope_angles(positions, x.shape[-1], theta)
    x1, x2 = x.to(F32).chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# MLPs
# ---------------------------------------------------------------------------


def mlp_spec(d_model: int, d_ff: int, kind: str):
    p = {"w_out": dense(d_ff, d_model), "w_in": dense(d_model, d_ff)}
    if kind in ("swiglu", "geglu"):
        p["w_gate"] = dense(d_model, d_ff)
    return p


def mlp_apply(params, x, kind: str, tp=None):
    tp = _core(tp, params, "w_out")
    dt = x.dtype
    names = ("w_in", "w_gate") if kind in ("swiglu", "geglu") else ("w_in",)
    h, *g = _col_mm(x, [_weight(params, n, dt, tp) for n in names], tp)
    if kind == "swiglu":
        h = F.silu(g[0].to(F32)).to(dt) * h
    elif kind == "geglu":
        h = F.gelu(g[0].to(F32), approximate="tanh").to(dt) * h
    elif kind == "relu2":
        h = torch.square(torch.relu(h.to(F32))).to(dt)
    elif kind == "gelu":
        h = F.gelu(h.to(F32), approximate="tanh").to(dt)
    else:
        raise ValueError(kind)
    return _row_mm(h, params, "w_out", tp)


# ---------------------------------------------------------------------------
# Online-softmax chunked attention (prefill)
# ---------------------------------------------------------------------------


def windowed_attention(q, k, v, *, window: int, chunk: int = 512):
    """Sliding-window self-attention over the in-window KV chunks only
    (``layers.py:108``): each query chunk attends to the
    ceil((window-1)/chunk)+1 KV chunks that can intersect its window."""
    B, S, H, hd = q.shape
    KV = k.shape[2]
    hd_v = v.shape[-1]
    G = H // KV
    scale = hd**-0.5
    nq = -(-S // chunk)
    pad = nq * chunk - S
    if pad:
        q, k, v = (F.pad(t, (0, 0, 0, 0, 0, pad)) for t in (q, k, v))
    w_chunks = -(-(window - 1) // chunk) + 1
    L = w_chunks * chunk
    zpad = (w_chunks - 1) * chunk
    k_ext = F.pad(k, (0, 0, 0, 0, zpad, 0)).to(F32)
    v_ext = F.pad(v, (0, 0, 0, 0, zpad, 0)).to(F32)
    qg = q.reshape(B, nq, chunk, KV, G, hd).to(F32)
    ar_q = torch.arange(chunk, device=q.device)
    ar_k = torch.arange(L, device=q.device)
    blocks = []
    for i in range(nq):
        kb = k_ext[:, i * chunk:i * chunk + L]
        vb = v_ext[:, i * chunk:i * chunk + L]
        q_pos = i * chunk + ar_q
        k_pos = (i - w_chunks + 1) * chunk + ar_k
        s = torch.einsum("bqkgh,bckh->bqkgc", qg[:, i], kb) * scale
        mask = (q_pos[:, None] >= k_pos[None, :]) & (k_pos[None, :] >= 0)
        mask &= q_pos[:, None] - k_pos[None, :] < window
        mask &= k_pos[None, :] < S
        mask &= q_pos[:, None] < S
        mask5 = mask[None, :, None, None, :]
        s = torch.where(mask5, s, NEG_INF)
        m = s.amax(-1, keepdim=True)
        m = torch.where(torch.isfinite(m), m, 0.0)
        p = torch.where(mask5, torch.exp(s - m), 0.0)
        out = torch.einsum("bqkgc,bckh->bqkgh", p, vb)
        out = out / torch.clamp(p.sum(-1)[..., None], min=1e-30)
        blocks.append(out.to(q.dtype))
    out = torch.stack(blocks, 1).reshape(B, nq * chunk, H, hd_v)
    return out[:, :S]


def chunked_attention(q, k, v, *, q_offset: int = 0, window: Optional[int] = None,
                      chunk: int = 512):
    """Causal (optionally sliding-window) attention by an online-softmax scan
    over KV chunks (``layers.py:160``). q: [B, Sq, H, hd]; k, v: [B, Sk, KV,
    hd(_v)]. Self-attention with a window shorter than the sequence goes to
    :func:`windowed_attention`."""
    if window is not None and q.shape[1] == k.shape[1] and q_offset == 0 and window < k.shape[1]:
        return windowed_attention(q, k, v, window=window, chunk=min(chunk, max(window, 128)))
    B, Sq, H, hd = q.shape
    Sk, KV = k.shape[1], k.shape[2]
    hd_v = v.shape[-1]
    G = H // KV
    scale = hd**-0.5
    qg = q.reshape(B, Sq, KV, G, hd).to(F32)
    nchunks = -(-Sk // chunk)
    pad = nchunks * chunk - Sk
    if pad:
        k, v = (F.pad(t, (0, 0, 0, 0, 0, pad)) for t in (k, v))
    q_pos = q_offset + torch.arange(Sq, device=q.device)
    ar = torch.arange(chunk, device=q.device)
    m = torch.full((B, Sq, KV, G), NEG_INF, dtype=F32, device=q.device)
    l = torch.zeros((B, Sq, KV, G), dtype=F32, device=q.device)
    acc = torch.zeros((B, Sq, KV, G, hd_v), dtype=F32, device=q.device)
    for ci in range(nchunks):
        kci = k[:, ci * chunk:(ci + 1) * chunk].to(F32)
        vci = v[:, ci * chunk:(ci + 1) * chunk].to(F32)
        k_pos = ci * chunk + ar
        s = torch.einsum("bqkgh,bckh->bqkgc", qg, kci) * scale
        mask = q_pos[:, None] >= k_pos[None, :]
        mask &= k_pos[None, :] < Sk
        if window is not None:
            mask &= q_pos[:, None] - k_pos[None, :] < window
        mask5 = mask[None, :, None, None, :]
        s = torch.where(mask5, s, NEG_INF)
        m_new = torch.maximum(m, s.amax(-1))
        m_safe = torch.where(torch.isfinite(m_new), m_new, 0.0)
        p = torch.where(mask5, torch.exp(s - m_safe[..., None]), 0.0)
        corr = torch.where(torch.isfinite(m), torch.exp(m - m_safe), 0.0)
        l = l * corr + p.sum(-1)
        acc = acc * corr[..., None] + torch.einsum("bqkgc,bckh->bqkgh", p, vci)
        m = m_new
    out = acc / torch.clamp(l[..., None], min=1e-30)
    return out.reshape(B, Sq, H, hd_v).to(q.dtype)


def decode_attention(q, k_cache, v_cache, valid_mask):
    """q: [B, 1, H, hd]; caches [B, S, KV, hd]; valid_mask [B, S] or [S]."""
    B, _, H, hd = q.shape
    KV = k_cache.shape[2]
    G = H // KV
    qg = q.reshape(B, KV, G, hd).to(F32)
    s = torch.einsum("bkgh,bskh->bkgs", qg, k_cache.to(F32)) * hd**-0.5
    vm = valid_mask if valid_mask.dim() == 2 else valid_mask[None, :]
    s = torch.where(vm[:, None, None, :], s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bkgs,bskh->bkgh", p, v_cache.to(F32))
    return out.reshape(B, 1, H, hd).to(q.dtype)


def _split_softmax(s, mix, tp):
    """``mix(softmax(s))`` where each rank of "data" holds a slice of the
    last axis of ``s`` (its slots; ``mix(p)``: the weighted values of its
    slots): the max all-reduced, then the sum and ``mix(p)``."""
    m = tp.all_reduce(s.amax(-1), "data", "max")
    p = torch.exp(s - torch.where(torch.isfinite(m), m, 0.0)[..., None])
    part = tp.all_reduce(torch.cat([p.sum(-1)[..., None], mix(p)], -1), "data")
    return part[..., 1:] / part[..., :1]


def split_decode_attention(q, k_cache, v_cache, valid_mask, tp):
    """:func:`decode_attention` over a cache whose slots are split over the
    mesh's "data" axis: every rank scores its own slots (``valid_mask``
    [S_local], its slice of the global mask), and the softmax is combined
    from the all-reduced max, then the all-reduced sum and weighted values."""
    B, _, H, hd = q.shape
    KV = k_cache.shape[2]
    qg = q.reshape(B, KV, H // KV, hd).to(F32)
    s = torch.einsum("bkgh,bskh->bkgs", qg, k_cache.to(F32)) * hd**-0.5
    s = torch.where(valid_mask[None, None, None, :], s, NEG_INF)
    out = _split_softmax(s, lambda p: torch.einsum("bkgs,bskh->bkgh", p, v_cache.to(F32)), tp)
    return out.reshape(B, 1, H, hd).to(q.dtype)


def ring_valid(pos, slot, L: int, window: Optional[int]):
    """Validity of the L slots of a ring buffer after writing position
    ``pos`` at ``slot = pos % L``: slot j holds absolute position
    pos - slot + j (j <= slot) or that minus L (an earlier wrap)."""
    idx = torch.arange(L, device=pos.device)
    abs_pos = torch.where(idx <= slot, pos - slot + idx, pos - slot + idx - L)
    valid = (abs_pos >= 0) & (abs_pos <= pos)
    if window is not None:
        valid &= pos - abs_pos < window
    return valid


# ---------------------------------------------------------------------------
# GQA / MQA attention block
# ---------------------------------------------------------------------------


def attention_spec(cfg: ModelConfig):
    return {
        "wq": dense(cfg.d_model, cfg.q_dim),
        "wk": dense(cfg.d_model, cfg.kv_dim),
        "wv": dense(cfg.d_model, cfg.kv_dim),
        "wo": dense(cfg.q_dim, cfg.d_model, scale=cfg.q_dim**-0.5),
    }


@dataclasses.dataclass(frozen=True)
class Heads:
    """The attention heads a rank computes: q heads ``q0 ... q0 + nq - 1``
    and kv heads ``kv0 ... kv0 + nkv - 1`` (global indices); ``q_whole`` /
    ``kv_whole``: wq / (wk, wv) are gathered over "model" first, because
    their "model" split cuts through a head."""

    q0: int
    nq: int
    kv0: int
    nkv: int
    q_whole: bool = False
    kv_whole: bool = False


def _heads(cfg: ModelConfig, tp) -> Heads:
    return Heads(0, cfg.num_heads, 0, cfg.num_kv_heads) if tp is None else tp.heads


def _kv_for(cfg: ModelConfig, hs: Heads, k, v):
    """The kv heads that q heads ``hs.q0 ...`` attend with, out of the
    rank's ``hs.kv0 ...``, laid out for :func:`chunked_attention` /
    :func:`decode_attention`'s grouping (global group index h // G): whole
    groups or one group as a slice, else one kv head a q head."""
    G = cfg.num_heads // cfg.num_kv_heads
    first, last = hs.q0 // G, (hs.q0 + hs.nq - 1) // G
    if first == last or (hs.nq % G == 0 and hs.q0 % G == 0):
        lo, n = first - hs.kv0, last - first + 1
        if lo == 0 and n == k.shape[2]:
            return k, v
        return k[:, :, lo:lo + n], v[:, :, lo:lo + n]
    idx = torch.arange(hs.q0, hs.q0 + hs.nq, device=k.device) // G - hs.kv0
    return k.index_select(2, idx), v.index_select(2, idx)


def _qkv(cfg: ModelConfig, params, x, positions, tp=None):
    B, S, _ = x.shape
    dt = x.dtype
    hs = _heads(cfg, tp)
    q, k, v = _col_mm(x, [_weight(params, "wq", dt, tp, hs.q_whole), _weight(params, "wk", dt, tp, hs.kv_whole),
                          _weight(params, "wv", dt, tp, hs.kv_whole)], tp)
    q = q.reshape(B, S, hs.nq, cfg.head_dim)
    k, v = (t.reshape(B, S, hs.nkv, cfg.head_dim) for t in (k, v))
    if cfg.use_rope:
        angles = rope_angles(positions, cfg.head_dim, cfg.rope_theta)
        q = apply_rope(q, positions, cfg.rope_theta, angles)
        k = apply_rope(k, positions, cfg.rope_theta, angles)
    return q, k, v


def attention_apply(cfg: ModelConfig, params, x, *, window=None, chunk=512, tp=None):
    """Prefill self-attention. x: [B, S, D]."""
    tp = _core(tp, params, "wo")
    B, S, _ = x.shape
    positions = torch.arange(S, device=x.device).expand(B, S)
    q, k, v = _qkv(cfg, params, x, positions, tp)
    hs = _heads(cfg, tp)
    out = chunked_attention(q, *_kv_for(cfg, hs, k, v), window=window, chunk=chunk)
    return _row_mm(out.reshape(B, S, hs.nq * cfg.head_dim), params, "wo", tp)


def attention_decode(cfg: ModelConfig, params, x, cache, pos, *, window=None, tp=None):
    """One-token decode (``layers.py:286``). x: [B, 1, D]; cache {k, v: [B, L,
    KV, hd]}, a ring buffer of length L (the window for local layers, the
    whole sequence for global ones). Returns (y, new cache). On a rank
    whose cache holds a slice of the ring (``tp.ring_split``: its L slots
    of ``data_size`` x L), the rank that owns slot ``pos % (data_size x
    L)`` writes the new k/v, and the attention is
    :func:`split_decode_attention`."""
    tp = _core(tp, params, "wo")
    B = x.shape[0]
    L = cache["k"].shape[1]
    pos = _pos_tensor(pos, x.device)
    q, k, v = _qkv(cfg, params, x, pos.expand(B, 1), tp)
    hs = _heads(cfg, tp)
    if tp is not None and tp.ring_split(L, window):
        lo = tp.data_index * L
        slot = torch.remainder(pos, tp.data_size * L).reshape(1)
        mine = (slot >= lo) & (slot < lo + L)
        at = torch.clamp(slot - lo, 0, L - 1)
        k_cache, v_cache = (c.index_copy(1, at, torch.where(mine, new.to(c.dtype), c.index_select(1, at)))
                            for c, new in ((cache["k"], k), (cache["v"], v)))
        valid = ring_valid(pos, slot, tp.data_size * L, window)[lo:lo + L]
        out = split_decode_attention(q, *_kv_for(cfg, hs, k_cache, v_cache), valid, tp)
    else:
        slot = torch.remainder(pos, L).reshape(1)
        k_cache = cache["k"].index_copy(1, slot, k.to(cache["k"].dtype))
        v_cache = cache["v"].index_copy(1, slot, v.to(cache["v"].dtype))
        valid = ring_valid(pos, slot, L, window)
        out = decode_attention(q, *_kv_for(cfg, hs, k_cache, v_cache), valid)
    y = _row_mm(out.reshape(B, 1, hs.nq * cfg.head_dim), params, "wo", tp)
    return y, {"k": k_cache, "v": v_cache}


def attention_cache_init(cfg: ModelConfig, batch: int, length: int, dtype=COMPUTE_DTYPE,
                         device=None):
    shape = (batch, length, cfg.num_kv_heads, cfg.head_dim)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}


# ---------------------------------------------------------------------------
# MLA (DeepSeek-V2 Multi-head Latent Attention)
# ---------------------------------------------------------------------------


def mla_spec(cfg: ModelConfig):
    m: MLAConfig = cfg.mla
    H = cfg.num_heads
    qd = H * (m.nope_head_dim + m.rope_head_dim)
    return {
        "wq": dense(cfg.d_model, qd),
        "w_dkv": dense(cfg.d_model, m.kv_lora_rank),
        "w_krope": dense(cfg.d_model, m.rope_head_dim),
        "kv_norm": rmsnorm_spec(m.kv_lora_rank),
        "w_uk": dense(m.kv_lora_rank, H * m.nope_head_dim),
        "w_uv": dense(m.kv_lora_rank, H * m.v_head_dim),
        "wo": dense(H * m.v_head_dim, cfg.d_model),
    }


def _mla_whole(cfg: ModelConfig, hs: Heads) -> bool:
    """Whether a rank computes every MLA head, reading ``wq`` / ``w_uk`` /
    ``w_uv`` whole (gathered over "model" where split there)."""
    return hs.nq == cfg.num_heads


def _mla_proj(cfg, params, x, positions, tp=None):
    """(q_nope, q_rope) of the rank's q heads [B, S, nq, *], and the latent
    (c, k_rope) [B, S, r], [B, S, rd] of every position: ``w_dkv`` and
    ``w_krope`` are read whole, since ``kv_norm`` runs over all of r and
    every head reads c and k_rope (the single process's own products)."""
    m = cfg.mla
    B, S, _ = x.shape
    dt = x.dtype
    hs = _heads(cfg, tp)
    q, c, k_rope = _col_mm(x, [_weight(params, "wq", dt, tp, _mla_whole(cfg, hs)),
                               _weight(params, "w_dkv", dt, tp, True), _weight(params, "w_krope", dt, tp, True)], tp)
    q = q.reshape(B, S, hs.nq, m.nope_head_dim + m.rope_head_dim)
    q_nope, q_rope = q[..., :m.nope_head_dim], q[..., m.nope_head_dim:]
    q_rope = apply_rope(q_rope, positions, cfg.rope_theta)
    c = rmsnorm(params["kv_norm"], c, cfg.rms_eps, tp, part=True)  # the rank's heads read the latent
    return q_nope, q_rope, c, apply_rope(k_rope[:, :, None, :], positions, cfg.rope_theta)[:, :, 0, :]


def mla_apply(cfg: ModelConfig, params, x, *, window=None, chunk=512, tp=None):
    """Prefill MLA: per-head K/V rebuilt from the latent, then the chunked
    attention with a concatenated [nope | rope] key; on the rank's q heads
    (:class:`Heads`), ``wo`` row-parallel."""
    m = cfg.mla
    tp = _core(tp, params, "wo")
    B, S, _ = x.shape
    dt = x.dtype
    hs = _heads(cfg, tp)
    positions = torch.arange(S, device=x.device).expand(B, S)
    q_nope, q_rope, c, k_rope = _mla_proj(cfg, params, x, positions, tp)
    H, whole = hs.nq, _mla_whole(cfg, hs)
    k_nope = mm(c, _weight(params, "w_uk", dt, tp, whole)).reshape(B, S, H, m.nope_head_dim)
    v = mm(c, _weight(params, "w_uv", dt, tp, whole)).reshape(B, S, H, m.v_head_dim)
    q = torch.cat([q_nope, q_rope], dim=-1)
    k = torch.cat([k_nope, k_rope[:, :, None, :].expand(B, S, H, m.rope_head_dim)], dim=-1)
    out = chunked_attention(q, k, v, window=window, chunk=chunk)
    return _row_mm(out.reshape(B, S, H * m.v_head_dim), params, "wo", tp)


def mla_decode(cfg: ModelConfig, params, x, cache, pos, *, window=None, tp=None):
    """Absorbed-matmul decode (``layers.py:371``): attention runs in the
    kv_lora latent space; the cache holds [c | k_rope] per token and
    W_uk / W_uv are absorbed into the query / output projections. On a rank:
    its q heads, the whole latent cache (or, under ``tp.ring_split``, its
    slice of the ring's slots, written by the rank that owns ``pos``'s slot,
    with the partial softmaxes combined over "data" as in
    :func:`split_decode_attention`), ``wo`` row-parallel."""
    m = cfg.mla
    tp = _core(tp, params, "wo")
    B = x.shape[0]
    L = cache["c"].shape[1]
    dt = x.dtype
    hs = _heads(cfg, tp)
    pos = _pos_tensor(pos, x.device)
    positions = pos.expand(B, 1)
    q_nope, q_rope, c, k_rope = _mla_proj(cfg, params, x, positions, tp)  # [B,1,nq,*], [B,1,r], [B,1,rd]
    split = tp is not None and tp.ring_split(L, window)
    if split:
        lo = tp.data_index * L
        slot = torch.remainder(pos, tp.data_size * L).reshape(1)
        mine = (slot >= lo) & (slot < lo + L)
        at = torch.clamp(slot - lo, 0, L - 1)
        c_cache, kr_cache = (cc.index_copy(1, at, torch.where(mine, new.to(cc.dtype), cc.index_select(1, at)))
                             for cc, new in ((cache["c"], c), (cache["k_rope"], k_rope)))
        valid = ring_valid(pos, slot, tp.data_size * L, window)[lo:lo + L]
    else:
        slot = torch.remainder(pos, L).reshape(1)
        c_cache = cache["c"].index_copy(1, slot, c.to(cache["c"].dtype))
        kr_cache = cache["k_rope"].index_copy(1, slot, k_rope.to(cache["k_rope"].dtype))
        valid = ring_valid(pos, slot, L, window)
    whole = _mla_whole(cfg, hs)
    w_uk = _weight(params, "w_uk", dt, tp, whole).reshape(m.kv_lora_rank, hs.nq, m.nope_head_dim)
    q_eff = einsum_low("bhd,rhd->bhr", q_nope[:, 0], w_uk)  # [B,nq,r]
    s = torch.einsum("bhr,bsr->bhs", q_eff.to(F32), c_cache.to(F32))
    s = s + torch.einsum("bhd,bsd->bhs", q_rope[:, 0].to(F32), kr_cache.to(F32))
    s = s * (m.nope_head_dim + m.rope_head_dim) ** -0.5
    s = torch.where(valid[None, None, :], s, NEG_INF)
    mix = lambda p: torch.einsum("bhs,bsr->bhr", p, c_cache.to(F32))  # noqa: E731  [B,nq,r]
    lat = _split_softmax(s, mix, tp) if split else mix(torch.softmax(s, dim=-1))
    w_uv = _weight(params, "w_uv", dt, tp, whole).reshape(m.kv_lora_rank, hs.nq, m.v_head_dim)
    out = einsum_low("bhr,rhd->bhd", lat.to(dt), w_uv)
    y = _row_mm(out.reshape(B, 1, hs.nq * m.v_head_dim), params, "wo", tp)
    return y, {"c": c_cache, "k_rope": kr_cache}


def mla_cache_init(cfg: ModelConfig, batch: int, length: int, dtype=COMPUTE_DTYPE, device=None):
    m = cfg.mla
    return {"c": torch.zeros((batch, length, m.kv_lora_rank), dtype=dtype, device=device),
            "k_rope": torch.zeros((batch, length, m.rope_head_dim), dtype=dtype, device=device)}
