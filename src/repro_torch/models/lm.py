"""Top-level language model: embeddings, stack, heads, decode (port of
``repro/models/lm.py``).

The three input modalities of the reference:

* text              tokens [B, S]
* audio (musicgen)  EnCodec codebook tokens [B, K, S]; K embeddings summed,
                    K output heads
* vlm (pixtral)     patch embeddings [B, P, D] prepended to the text tokens'
                    embeddings; logits over the text positions only

``params`` is a :class:`~.params.FlatParams` (what :func:`lm_init` and
``convert.lm_params_from_numpy`` return) or a plain tree of tensors, such as
the training view ``params.grad_tree`` that autograd differentiates.
``forward``'s ``remat`` / ``remat_policy`` checkpoint activations (see
:mod:`.transformer`); ``act_spec``, a sharding constraint of the reference's
mesh, is refused here: ``train/sharded.py`` realizes it by splitting each
worker's rows over the mesh's "model" axis, and ``serve/sharded.py``'s
prefill (the reference's ``act_spec = P(dp, None, None)``) by taking the
rank's rows of the batch over "data".

``tp``: the shard context of a rank of a sharded model (:mod:`.layers`).
The embedding table's rows are split over "model": the rank looks up the
tokens of its rows, writes zeros for the others, and the ranks' lookups are
summed over "model" (exact: every other rank adds zero). The logits stay
split over the vocabulary: the rank gets its block ``[..., V / M]``.
"""
from __future__ import annotations

from typing import Dict, Optional

import torch

from ..kernels.runtime import resolve_device
from . import layers as L
from . import transformer as T
from .config import ModelConfig
from .params import FlatParams, Leaf, einsum_low, leaves_with_path, materialize, mm, tree_of

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
    other, convert the reference's tree (``convert.lm_params_from_numpy``).
    ``device="meta"`` (asked for explicitly) gives the shapes and dtypes
    alone, with nothing drawn: the dry-run's abstract parameters."""
    dev = resolve_device(device, meta_ok=True)
    if dev.type == "meta":
        return FlatParams(lm_spec(cfg), dev)
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


def embed_tokens(cfg: ModelConfig, params, tokens: torch.Tensor, tp=None) -> torch.Tensor:
    p = tree_of(params)
    emb = L._weight(p, "embed", L.COMPUTE_DTYPE, tp)
    rows = None if tp is None else tp.model_block(p, "embed", -2)
    if rows is not None:  # the rank's rows of the table
        inside = (tokens >= rows[0]) & (tokens < rows[0] + rows[1])
        tokens = torch.where(inside, tokens - rows[0], 0)
    if cfg.num_codebooks:
        # tokens [B, K, S] -> sum_k E_k[tok_k], one bf16 rounding per add
        parts = [emb[k][tokens[:, k]] for k in range(cfg.num_codebooks)]
    else:
        parts = [emb[tokens]]
    if rows is not None:
        ins = inside.unbind(1) if cfg.num_codebooks else [inside]
        parts = tp.all_reduce(torch.stack([torch.where(i[..., None], e, 0) for i, e in zip(ins, parts)]),
                              "model").unbind(0)
    return sum(parts) if cfg.num_codebooks else parts[0]


def logits_from_hidden(cfg: ModelConfig, params, h: torch.Tensor, tp=None) -> torch.Tensor:
    p = tree_of(params)
    if cfg.tie_embeddings:
        w = L._weight(p, "embed", h.dtype, tp)
        if cfg.num_codebooks:
            return einsum_low("bsd,kvd->bksv", h, w)
        return mm(h, w.T)
    w = L._weight(p, "unembed", h.dtype, tp)
    if cfg.num_codebooks:
        return einsum_low("bsd,kdv->bksv", h, w)
    return mm(h, w)


# ---------------------------------------------------------------------------
# forward / loss
# ---------------------------------------------------------------------------


def forward(cfg: ModelConfig, params, batch: Dict[str, torch.Tensor], *,
            window_override: Optional[int] = None, chunk: int = 512, remat: bool = True,
            act_spec=None, remat_policy: Optional[str] = None, tp=None):
    """Logits [B, S, V] (text / vlm over the text positions) or [B, K, S, V].
    ``remat``: recompute each block's activations in the backward pass
    (``remat_policy`` None / "full": all of them; "dots": all but the
    matmuls without batch dimensions); no effect outside autograd."""
    if act_spec is not None:
        raise ValueError("act_spec pins activations onto a device mesh; lm.forward runs one device's "
                         "rows: the sharded train step (train/sharded.make_sharded_train_step) realizes "
                         "it by splitting each worker's rows over the mesh's 'model' axis, the sharded "
                         "serving step (serve/sharded.make_prefill_step) by taking each rank's rows of "
                         "the batch over 'data'")
    p = tree_of(params)
    x = embed_tokens(cfg, p, batch["tokens"], tp)
    if cfg.num_patches:
        x = torch.cat([batch["patches"].to(x.dtype), x], dim=1)  # [B, P + S, D]
    x = T.stack_apply(cfg, p["stack"], x, window_override=window_override, chunk=chunk,
                      remat=remat, remat_policy=remat_policy, tp=tp)
    x = L.rmsnorm(p["ln_f"], x, cfg.rms_eps, tp)
    if cfg.num_patches:
        x = x[:, cfg.num_patches:]
    return logits_from_hidden(cfg, p, x, tp)


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Mean next-token CE. logits [..., S, V] (fp32 statistics), labels [..., S]."""
    lf = logits.float()
    lse = torch.logsumexp(lf, dim=-1)
    ll = torch.gather(lf, -1, labels.long().unsqueeze(-1)).squeeze(-1)
    return torch.mean(lse - ll)


def loss_fn(cfg: ModelConfig, params, batch, **fwd_kw) -> torch.Tensor:
    logits = forward(cfg, params, batch, **fwd_kw)
    tokens = batch["tokens"]
    if cfg.num_codebooks:
        return cross_entropy(logits[..., :-1, :], tokens[..., 1:])
    return cross_entropy(logits[:, :-1], tokens[:, 1:])


# ---------------------------------------------------------------------------
# decode
# ---------------------------------------------------------------------------


def cache_init(cfg: ModelConfig, batch: int, cache_len: int, *, window_override=None,
               dtype=L.COMPUTE_DTYPE, device="cuda"):
    """Zero caches for ``batch`` sequences of ``cache_len`` positions
    (``device="meta"``: shapes only)."""
    return T.stack_cache_init(cfg, batch, cache_len, window_override=window_override,
                              dtype=dtype, device=resolve_device(device, meta_ok=True))


def decode_step(cfg: ModelConfig, params, caches, token: torch.Tensor, pos, *,
                window_override: Optional[int] = None, tp=None):
    """One-token decode: (logits [B, V] or [B, K, V], new caches).
    token: [B, 1] or [B, K, 1]; pos: an int or a 0-d integer tensor on the
    token's device (no host sync: the step can be captured in a CUDA graph)."""
    p = tree_of(params)
    x = embed_tokens(cfg, p, token, tp)  # [B, 1, D]
    x, new_caches = T.stack_decode(cfg, p["stack"], caches, x, pos, window_override=window_override,
                                   tp=tp)
    x = L.rmsnorm(p["ln_f"], x, cfg.rms_eps, tp)
    logits = logits_from_hidden(cfg, p, x, tp)
    if cfg.num_codebooks:
        return logits[:, :, 0, :], new_caches
    return logits[:, 0, :], new_caches
