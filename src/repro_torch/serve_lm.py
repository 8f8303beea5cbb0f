"""Batched serving demo of the port (counterpart of ``examples/serve_lm.py``):
prefill + generate over the decode engine.

    PYTHONPATH=src python -m repro_torch.serve_lm [--batch 4] [--new-tokens 32] [--device cpu]

Loads a checkpoint if one is there (the reference's ``examples/train_lm.py``
writes ``runs/train_lm_ckpt.npz``; the file format is shared), else serves
random weights from a seed, then serves one batch of prompts, greedy or
sampled. Runs on the card unless ``--device cpu``.
"""
from __future__ import annotations

import argparse
import os
import time

import numpy as np

from .checkpoint import load_checkpoint
from .models import lm
from .models.config import ModelConfig, uniform_pattern
from .serve import DecodeEngine, greedy_sample, temperature_sample


def model_100m(layers=8, d_model=768):
    """~100M params, gemma-flavoured (GeGLU, MQA): a copy of
    ``examples/train_lm.py::model_100m``."""
    return ModelConfig(
        arch_id="demo-100m", family="dense", num_layers=layers, d_model=d_model,
        num_heads=12, num_kv_heads=4, head_dim=64, d_ff=3072, vocab_size=32768,
        block_pattern=uniform_pattern("attn", layers), mlp_kind="geglu",
    )


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--ckpt", default="runs/train_lm_ckpt.npz")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--new-tokens", type=int, default=32)
    ap.add_argument("--layers", type=int, default=8)
    ap.add_argument("--d-model", type=int, default=768)
    ap.add_argument("--temp", type=float, default=0.0, help="0 = greedy")
    ap.add_argument("--device", default="cuda",
                    help="where the model is served (default the card)")
    args = ap.parse_args(argv)

    cfg = model_100m(args.layers, args.d_model)
    params = lm.lm_init(cfg, device=args.device, seed=0)
    if os.path.exists(args.ckpt):
        params, meta = load_checkpoint(args.ckpt, params)
        print(f"loaded {args.ckpt} (step {meta['step']})")
    else:
        print("no checkpoint found: serving random weights")

    engine = DecodeEngine(
        cfg, params, cache_len=args.prompt_len + args.new_tokens, batch_size=args.batch,
        sample_fn=temperature_sample(args.temp) if args.temp > 0 else greedy_sample,
        device=args.device,
    )
    prompts = np.random.default_rng(1).integers(0, cfg.vocab_size, (args.batch, args.prompt_len))
    t0 = time.time()
    toks = engine.run(prompts, n_new_tokens=args.new_tokens)
    dt = time.time() - t0
    total = args.batch * args.new_tokens
    print(f"generated {total} tokens in {dt:.2f}s ({total / dt:.1f} tok/s, batch={args.batch}, "
          f"{engine.device}; the first request includes the card's graph capture)")
    for b in range(min(args.batch, 2)):
        print(f"  req{b}: {toks[b][:16].tolist()} ...")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
