"""gemma-2b [dense] — GeGLU, MQA (kv=1), head_dim=256.

Assigned: 18L d_model=2048 8H (GQA kv=1) d_ff=16384 vocab=256000
[arXiv:2403.08295].
"""
from repro_torch.models.config import ModelConfig, uniform_pattern

CONFIG = ModelConfig(
    arch_id="gemma-2b",
    family="dense",
    num_layers=18,
    d_model=2048,
    num_heads=8,
    num_kv_heads=1,
    head_dim=256,
    d_ff=16384,
    vocab_size=256000,
    block_pattern=uniform_pattern("attn", 18),
    mlp_kind="geglu",
    tie_embeddings=True,
    long_context_window=8192,
    notes="GeGLU, head_dim=256, MQA [arXiv:2403.08295]",
)


def smoke_config():
    return ModelConfig(
        arch_id="gemma-smoke",
        family="dense",
        num_layers=2,
        d_model=128,
        num_heads=4,
        num_kv_heads=1,
        head_dim=32,
        d_ff=256,
        vocab_size=512,
        block_pattern=uniform_pattern("attn", 2),
        mlp_kind="geglu",
        tie_embeddings=True,
    )
