"""pixtral-12b [vlm] — mistral-nemo decoder consuming pixtral-ViT patches.

Assigned: 40L d_model=5120 32H (GQA kv=8) d_ff=14336 vocab=131072
[hf:mistralai/Pixtral-12B-2409]. The ViT tower + projector is a stub:
input_specs() supplies 1024 precomputed patch embeddings [B, 1024, D]
prepended to the text tokens (DESIGN.md §4).
"""
from repro_torch.models.config import ModelConfig, uniform_pattern

CONFIG = ModelConfig(
    arch_id="pixtral-12b",
    family="vlm",
    num_layers=40,
    d_model=5120,
    num_heads=32,
    num_kv_heads=8,
    head_dim=160,
    d_ff=14336,
    vocab_size=131072,
    block_pattern=uniform_pattern("attn", 40),
    mlp_kind="swiglu",
    rope_theta=1e6,
    num_patches=1024,
    long_context_window=8192,
    notes="pixtral-ViT (stub) + mistral-nemo decoder [hf:mistralai/Pixtral-12B-2409]",
)


def smoke_config():
    return ModelConfig(
        arch_id="pixtral-smoke",
        family="vlm",
        num_layers=2,
        d_model=128,
        num_heads=4,
        num_kv_heads=2,
        head_dim=32,
        d_ff=256,
        vocab_size=512,
        block_pattern=uniform_pattern("attn", 2),
        mlp_kind="swiglu",
        num_patches=16,
    )
