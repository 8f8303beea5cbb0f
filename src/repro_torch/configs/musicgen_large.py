"""musicgen-large [audio] — decoder-only over EnCodec tokens.

Assigned: 48L d_model=2048 32H (kv=32) d_ff=8192 vocab=2048
[arXiv:2306.05284]. 4 EnCodec codebooks (delay pattern not modelled);
codebook embeddings are summed, 4 output heads. The mel/EnCodec frontend is
a stub — input_specs() provides token streams directly (DESIGN.md §4).
"""
from repro_torch.models.config import ModelConfig, uniform_pattern

CONFIG = ModelConfig(
    arch_id="musicgen-large",
    family="audio",
    num_layers=48,
    d_model=2048,
    num_heads=32,
    num_kv_heads=32,
    head_dim=64,
    d_ff=8192,
    vocab_size=2048,
    block_pattern=uniform_pattern("attn", 48),
    mlp_kind="gelu",
    num_codebooks=4,
    long_context_window=8192,
    notes="decoder-only over EnCodec tokens [arXiv:2306.05284]",
)


def smoke_config():
    return ModelConfig(
        arch_id="musicgen-smoke",
        family="audio",
        num_layers=2,
        d_model=128,
        num_heads=4,
        num_kv_heads=4,
        head_dim=32,
        d_ff=256,
        vocab_size=256,
        block_pattern=uniform_pattern("attn", 2),
        mlp_kind="gelu",
        num_codebooks=4,
    )
