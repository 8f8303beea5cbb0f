"""minitron-4b [dense] — pruned nemotron (squared-ReLU MLP).

Assigned: 32L d_model=3072 24H (GQA kv=8) d_ff=9216 vocab=256000
[arXiv:2407.14679]. head_dim=128.
"""
from repro_torch.models.config import ModelConfig, uniform_pattern

CONFIG = ModelConfig(
    arch_id="minitron-4b",
    family="dense",
    num_layers=32,
    d_model=3072,
    num_heads=24,
    num_kv_heads=8,
    head_dim=128,
    d_ff=9216,
    vocab_size=256000,
    block_pattern=uniform_pattern("attn", 32),
    mlp_kind="relu2",
    long_context_window=8192,
    notes="pruned nemotron, squared-ReLU [arXiv:2407.14679]",
)


def smoke_config():
    return ModelConfig(
        arch_id="minitron-smoke",
        family="dense",
        num_layers=2,
        d_model=128,
        num_heads=4,
        num_kv_heads=2,
        head_dim=32,
        d_ff=256,
        vocab_size=512,
        block_pattern=uniform_pattern("attn", 2),
        mlp_kind="relu2",
    )
