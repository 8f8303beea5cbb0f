"""zamba2-1.2b [hybrid] — Mamba2 backbone + weight-shared attention blocks.

Assigned: 38L d_model=2048 32H (GQA kv=32) d_ff=8192 vocab=32000 ssm_state=64
[arXiv:2411.15242]. Pattern: every 6th slot is the single weight-tied
attention+MLP block (zamba2's shared transformer block); the rest are Mamba2.
Subquadratic at 500k: Mamba2 state is O(1); the shared attention slots use
the sliding-window override at long context (DESIGN.md §4).
"""
from repro_torch.models.config import MambaConfig, ModelConfig


def _pattern(n):
    return tuple("shared" if (i % 6) == 5 else "mamba" for i in range(n))


CONFIG = ModelConfig(
    arch_id="zamba2-1.2b",
    family="hybrid",
    num_layers=38,
    d_model=2048,
    num_heads=32,
    num_kv_heads=32,
    head_dim=64,
    d_ff=8192,
    vocab_size=32000,
    block_pattern=_pattern(38),
    mlp_kind="swiglu",
    mamba=MambaConfig(state_dim=64, head_dim=64, expand=2, chunk=256, conv_width=4),
    sliding_window=4096,
    long_context_window=4096,
    subquadratic=True,
    notes="Mamba2 + shared attn blocks [arXiv:2411.15242]",
)


def smoke_config():
    return ModelConfig(
        arch_id="zamba2-smoke",
        family="hybrid",
        num_layers=2,
        d_model=128,
        num_heads=4,
        num_kv_heads=4,
        head_dim=32,
        d_ff=256,
        vocab_size=512,
        block_pattern=("mamba", "shared"),
        mlp_kind="swiglu",
        mamba=MambaConfig(state_dim=16, head_dim=32, expand=2, chunk=32, conv_width=4),
        subquadratic=True,
    )
