"""Deterministic synthetic token pipeline with sharded global batches (port
of ``repro/data/pipeline.py``).

Tokens are drawn per step from ``fold_in(PRNGKey(seed), step)`` exactly as
the reference draws them (``core/jax_random.uniform`` on the host: 4,096
values for 4 workers x batch 2 x seq 512), so both packages train on the
same batches. A Zipf-ish skew (``u**4``, two float32 squarings, as XLA's
``integer_pow``) makes the distribution non-uniform, so losses move under
training.

The vlm patch stub (the reference's ``jax.random.normal`` in bf16) comes from
a ``torch.Generator`` on the device, seeded from the step's key: the port's
own draws, which tests replace with the reference's.

``batch_specs`` gives each batch leaf's shape and dtype.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, NamedTuple, Tuple

import numpy as np
import torch

from ..core import jax_random
from ..kernels.runtime import resolve_device
from ..models.config import ModelConfig


class TensorSpec(NamedTuple):
    shape: Tuple[int, ...]
    dtype: torch.dtype


def _skewed_tokens(key: np.ndarray, shape, vocab: int) -> np.ndarray:
    """Zipf-flavoured token draw: u^4 concentrates mass on small ids."""
    u = jax_random.uniform(key, shape)
    u2 = u * u
    return np.minimum((u2 * u2 * np.float32(vocab)).astype(np.int32), vocab - 1)


@dataclasses.dataclass(frozen=True)
class SyntheticLMData:
    cfg: ModelConfig
    n_workers: int
    batch_per_worker: int
    seq_len: int
    seed: int = 0
    device: str = "cuda"

    def batch(self, step: int) -> Dict[str, torch.Tensor]:
        """The step's batch on ``device``: ``tokens`` int32 [W, B, S] (or
        [W, B, K, S] with codebooks), plus ``patches`` bf16 [W, B, P, D] and
        S - P text tokens for a vlm."""
        dev = resolve_device(self.device)
        key = jax_random.fold_in(jax_random.PRNGKey(self.seed), step)
        W, B, S = self.n_workers, self.batch_per_worker, self.seq_len
        cfg = self.cfg
        if cfg.num_codebooks:
            return {"tokens": _to(_skewed_tokens(key, (W, B, cfg.num_codebooks, S), cfg.vocab_size), dev)}
        if cfg.num_patches:
            S_text = S - cfg.num_patches
            if S_text <= 1:
                raise ValueError(f"seq_len {S} too short for {cfg.num_patches} patches")
            k1, k2 = jax_random.split(key)
            gen = torch.Generator(dev).manual_seed(int(k2[0]) << 32 | int(k2[1]))
            patches = torch.randn((W, B, cfg.num_patches, cfg.d_model), generator=gen, device=dev)
            return {"tokens": _to(_skewed_tokens(k1, (W, B, S_text), cfg.vocab_size), dev),
                    "patches": patches.to(torch.bfloat16)}
        return {"tokens": _to(_skewed_tokens(key, (W, B, S), cfg.vocab_size), dev)}


def _to(a: np.ndarray, dev: torch.device) -> torch.Tensor:
    t = torch.from_numpy(a)
    if dev.type == "cuda":  # a pinned copy goes over without waiting for the card's queue
        return t.pin_memory().to(dev, non_blocking=True)
    return t


def batch_specs(cfg: ModelConfig, n_workers: int, batch_per_worker: int, seq_len: int):
    """Shape and dtype of each leaf of one training batch."""
    W, B, S = n_workers, batch_per_worker, seq_len
    if cfg.num_codebooks:
        return {"tokens": TensorSpec((W, B, cfg.num_codebooks, S), torch.int32)}
    if cfg.num_patches:
        return {"tokens": TensorSpec((W, B, S - cfg.num_patches), torch.int32),
                "patches": TensorSpec((W, B, cfg.num_patches, cfg.d_model), torch.bfloat16)}
    return {"tokens": TensorSpec((W, B, S), torch.int32)}
