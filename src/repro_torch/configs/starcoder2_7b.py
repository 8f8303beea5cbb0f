"""starcoder2-7b [dense] — GQA + RoPE code model.

Assigned: 32L d_model=4608 36H (GQA kv=4) d_ff=18432 vocab=49152
[arXiv:2402.19173]. head_dim = 4608/36 = 128. Full attention; long_500k
runs under the sliding-window variant (long_context_window).
"""
from repro_torch.models.config import ModelConfig, uniform_pattern

CONFIG = ModelConfig(
    arch_id="starcoder2-7b",
    family="dense",
    num_layers=32,
    d_model=4608,
    num_heads=36,
    num_kv_heads=4,
    head_dim=128,
    d_ff=18432,
    vocab_size=49152,
    block_pattern=uniform_pattern("attn", 32),
    mlp_kind="gelu",
    rope_theta=1e5,
    long_context_window=8192,
    notes="GQA, RoPE [arXiv:2402.19173]",
)


def smoke_config():
    return ModelConfig(
        arch_id="starcoder2-smoke",
        family="dense",
        num_layers=2,
        d_model=144,
        num_heads=6,
        num_kv_heads=2,
        head_dim=24,
        d_ff=288,
        vocab_size=512,
        block_pattern=uniform_pattern("attn", 2),
        mlp_kind="gelu",
    )
