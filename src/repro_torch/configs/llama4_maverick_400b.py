"""llama4-maverick-400b-a17b [moe] — 128e top-1 MoE, alternating dense/MoE.

Assigned: 48L d_model=5120 40H (GQA kv=8) d_ff=8192 vocab=202048, MoE 128e
top-1 [hf:meta-llama/Llama-4-Scout-17B-16E family]. Alternating
dense/MoE layers with a shared expert (llama4 interleave); early-fusion
multimodality is stubbed (text tokens only in input_specs — DESIGN.md §4).
Uses iRoPE-style chunked-local attention for the long_500k variant.
"""
from repro_torch.models.config import ModelConfig, MoEConfig, periodic_pattern

CONFIG = ModelConfig(
    arch_id="llama4-maverick-400b-a17b",
    family="moe",
    num_layers=48,
    d_model=5120,
    num_heads=40,
    num_kv_heads=8,
    head_dim=128,
    d_ff=8192,
    vocab_size=202048,
    block_pattern=periodic_pattern(("attn", "moe"), 48),
    mlp_kind="swiglu",
    rope_theta=5e5,
    moe=MoEConfig(
        num_experts=128, top_k=1, d_ff_expert=8192, num_shared=1, d_ff_shared=8192,
        capacity_factor=1.25,
    ),
    long_context_window=8192,
    notes="MoE 128e top-1, early fusion (stub) [hf:meta-llama/Llama-4]",
)


def smoke_config():
    return ModelConfig(
        arch_id="llama4-smoke",
        family="moe",
        num_layers=2,
        d_model=128,
        num_heads=4,
        num_kv_heads=2,
        head_dim=32,
        d_ff=256,
        vocab_size=512,
        block_pattern=("attn", "moe"),
        mlp_kind="swiglu",
        # ample capacity: smoke tests check decode==prefill exactly (no drops)
        moe=MoEConfig(num_experts=4, top_k=1, d_ff_expert=128, num_shared=1, d_ff_shared=128,
                      capacity_factor=8.0),
    )
