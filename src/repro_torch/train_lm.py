"""End-to-end LM training with MARINA-P downlink compression (counterpart of
``examples/train_lm.py``).

    PYTHONPATH=src python -m repro_torch.train_lm [--steps 300] [--downlink marina:perm] [--device cpu]

Trains a ~100M-parameter gemma-family model on the synthetic token pipeline,
with the paper's compressed server->worker model broadcast, and checkpoints
the server's parameters at the end (the reference's file format, which
``serve_lm`` loads). Runs on the card unless ``--device cpu``; on the CPU,
shrink it (``--layers 1 --d-model 64 --seq 32 --steps 3``).
"""
from __future__ import annotations

import argparse
import time

import torch

from .checkpoint import save_checkpoint
from .data import SyntheticLMData
from .kernels.runtime import resolve_device
from .models import lm
from .models import params as P
from .models.config import ModelConfig, uniform_pattern
from .optim import make_optimizer
from .optim.schedules import cosine_warmup
from .train import TrainerConfig, init_state, make_downlink, make_train_step
from .train import downlink as D


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
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--workers", type=int, default=4)
    ap.add_argument("--batch-per-worker", type=int, default=2)
    ap.add_argument("--seq", type=int, default=512)
    ap.add_argument("--downlink", default="marina:perm",
                    help="marina:perm|marina:ind|marina:same|ef21p:128:1024|none")
    ap.add_argument("--layers", type=int, default=8)
    ap.add_argument("--d-model", type=int, default=768)
    ap.add_argument("--ckpt", default="runs/train_lm_ckpt.npz")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    cfg = model_100m(args.layers, args.d_model)
    print(f"model: {lm.count_params(cfg)/1e6:.1f}M params, downlink={args.downlink}, device={dev}")

    tcfg = TrainerConfig(n_workers=args.workers, attn_chunk=128)
    downlink = make_downlink(args.downlink, args.workers)
    optimizer = make_optimizer("adamw", weight_decay=0.01)
    lr = cosine_warmup(3e-4, warmup=min(50, args.steps // 4), total=args.steps)
    state = init_state(cfg, tcfg, downlink, optimizer, seed=0, device=dev)
    step = make_train_step(cfg, tcfg, downlink, optimizer, lr)
    data = SyntheticLMData(cfg, args.workers, args.batch_per_worker, args.seq, device=str(dev))
    sizes = P.leaf_sizes(lm.lm_spec(cfg))
    gen, dev_gen = torch.Generator().manual_seed(7), torch.Generator(dev).manual_seed(7)

    t0 = time.time()
    for i in range(args.steps):
        state, m = step(state, data.batch(i), D.draw_round(downlink, sizes, gen, dev_gen))
        if i % 10 == 0 or i == args.steps - 1:
            dt = time.time() - t0
            print(f"step {i:4d} loss={float(m['loss']):.4f} lr={float(m['lr']):.2e} "
                  f"gnorm={float(m['grad_norm']):.2f} drift={float(m.get('drift', 0)):.3e} "
                  f"bits/w={float(m['bits_per_worker']):.2e} ({dt:.0f}s)")
    save_checkpoint(args.ckpt, P.grad_tree(lm.lm_spec(cfg), state["server"]), step=args.steps,
                    extra={"arch": cfg.arch_id, "downlink": args.downlink})
    print(f"saved {args.ckpt}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
