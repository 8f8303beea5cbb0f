"""Top-level language model: embeddings, stack, heads, decode (port of
``repro/models/lm.py``).

The three input modalities of the reference:

* text              tokens [B, S]
* audio (musicgen)  EnCodec codebook tokens [B, K, S]; K embeddings summed,
                    K output heads
* vlm (pixtral)     patch embeddings [B, P, D] prepended to the text tokens'
                    embeddings; logits over the text positions only

``params`` is a :class:`~.params.FlatParams` (what :func:`lm_init` and
``convert.lm_params_from_numpy`` return) or a plain tree of tensors.
``cross_entropy``/``loss_fn`` and ``forward``'s training and sharding
arguments (``remat``, ``remat_policy``, ``act_spec``) wait for the training
slice; ``forward`` accepts ``remat`` and ignores it.
"""
from __future__ import annotations

from typing import Dict, Optional

import torch

from ..kernels.runtime import resolve_device
from . import layers as L
from . import transformer as T
from .config import ModelConfig
from .params import FlatParams, Leaf, einsum_low, leaves_with_path, materialize, mm, tree_of, weight

# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------


def lm_spec(cfg: ModelConfig) -> dict:
    """Shapes and initialisers of every parameter (the reference's
    ``jax.eval_shape(lm_init)``), allocating nothing."""
    V, D = cfg.vocab_size, cfg.d_model
    K = (cfg.num_codebooks,) if cfg.num_codebooks else ()
    params: dict = {"embed": Leaf(K + (V, D), "normal", 0.02)}
    if not cfg.tie_embeddings:
        params["unembed"] = Leaf(K + (D, V), "normal", D**-0.5)
    params["stack"] = T.stack_spec(cfg)
    params["ln_f"] = L.rmsnorm_spec(D)
    return params


def lm_init(cfg: ModelConfig, generator: Optional[torch.Generator] = None, *, device="cuda",
            seed: int = 0) -> FlatParams:
    """Random parameters from ``generator`` (a ``torch.Generator`` on
    ``device``; by default one seeded with ``seed``). The draws are the
    port's own, not the reference's: to hold the two packages against each
    other, convert the reference's tree (``convert.lm_params_from_numpy``)."""
    dev = resolve_device(device)
    if generator is None:
        generator = torch.Generator(dev).manual_seed(seed)
    return materialize(lm_spec(cfg), generator, dev)


def count_params(cfg: ModelConfig, active_only: bool = False) -> int:
    """Parameter count from shapes (``lm.py:167``): with ``active_only``, the
    routed experts' weights count top_k / num_experts of their size."""
    total = 0
    for path, leaf in leaves_with_path(lm_spec(cfg)):
        n = leaf.size
        if active_only and cfg.moe is not None:
            keys = "/".join(str(p) for p in path)
            if any(w in keys for w in ("w_in", "w_gate", "w_out")) and "moe" in keys and "shared" not in keys:
                n = int(n * cfg.moe.top_k / cfg.moe.num_experts)
        total += n
    return total


# ---------------------------------------------------------------------------
# embedding / head helpers
# ---------------------------------------------------------------------------


def embed_tokens(cfg: ModelConfig, params, tokens: torch.Tensor) -> torch.Tensor:
    emb = weight(tree_of(params), "embed", L.COMPUTE_DTYPE)
    if cfg.num_codebooks:
        # tokens [B, K, S] -> sum_k E_k[tok_k], one bf16 rounding per add
        return sum(emb[k][tokens[:, k]] for k in range(cfg.num_codebooks))
    return emb[tokens]


def logits_from_hidden(cfg: ModelConfig, params, h: torch.Tensor) -> torch.Tensor:
    p = tree_of(params)
    if cfg.tie_embeddings:
        w = weight(p, "embed", h.dtype)
        if cfg.num_codebooks:
            return einsum_low("bsd,kvd->bksv", h, w)
        return mm(h, w.T)
    w = weight(p, "unembed", h.dtype)
    if cfg.num_codebooks:
        return einsum_low("bsd,kdv->bksv", h, w)
    return mm(h, w)


# ---------------------------------------------------------------------------
# forward
# ---------------------------------------------------------------------------


def forward(cfg: ModelConfig, params, batch: Dict[str, torch.Tensor], *,
            window_override: Optional[int] = None, chunk: int = 512, remat: bool = True):
    """Logits [B, S, V] (text / vlm over the text positions) or [B, K, S, V].
    ``remat`` (activation checkpointing for training) is accepted and has no
    effect here."""
    p = tree_of(params)
    x = embed_tokens(cfg, p, batch["tokens"])
    if cfg.num_patches:
        x = torch.cat([batch["patches"].to(x.dtype), x], dim=1)  # [B, P + S, D]
    x = T.stack_apply(cfg, p["stack"], x, window_override=window_override, chunk=chunk)
    x = L.rmsnorm(p["ln_f"], x, cfg.rms_eps)
    if cfg.num_patches:
        x = x[:, cfg.num_patches:]
    return logits_from_hidden(cfg, p, x)


# ---------------------------------------------------------------------------
# decode
# ---------------------------------------------------------------------------


def cache_init(cfg: ModelConfig, batch: int, cache_len: int, *, window_override=None,
               dtype=L.COMPUTE_DTYPE, device="cuda"):
    return T.stack_cache_init(cfg, batch, cache_len, window_override=window_override,
                              dtype=dtype, device=resolve_device(device))


def decode_step(cfg: ModelConfig, params, caches, token: torch.Tensor, pos, *,
                window_override: Optional[int] = None):
    """One-token decode: (logits [B, V] or [B, K, V], new caches).
    token: [B, 1] or [B, K, 1]; pos: an int or a 0-d integer tensor on the
    token's device (no host sync: the step can be captured in a CUDA graph)."""
    p = tree_of(params)
    x = embed_tokens(cfg, p, token)  # [B, 1, D]
    x, new_caches = T.stack_decode(cfg, p["stack"], caches, x, pos, window_override=window_override)
    x = L.rmsnorm(p["ln_f"], x, cfg.rms_eps)
    logits = logits_from_hidden(cfg, p, x)
    if cfg.num_codebooks:
        return logits[:, :, 0, :], new_caches
    return logits[:, 0, :], new_caches
