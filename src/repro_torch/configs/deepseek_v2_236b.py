"""deepseek-v2-236b [moe] — MLA (kv_lora=512) + 2 shared / 160 routed top-6.

Assigned: 60L d_model=5120 128H (kv=128) d_ff=1536 vocab=102400, MoE 160e
top-6 [arXiv:2405.04434]. Layer 0 uses a dense FFN (d_ff_dense = 12288,
the DeepSeek-V2 first-layer width); layers 1..59 are MoE with per-expert
d_ff = 1536 and 2 shared experts. MLA: kv_lora_rank=512, rope_head_dim=64,
nope/v head dims 128.
"""
from repro_torch.models.config import MLAConfig, ModelConfig, MoEConfig

CONFIG = ModelConfig(
    arch_id="deepseek-v2-236b",
    family="moe",
    num_layers=60,
    d_model=5120,
    num_heads=128,
    num_kv_heads=128,
    head_dim=128,
    d_ff=12288,  # dense first layer
    vocab_size=102400,
    block_pattern=("attn",) + tuple(["moe"] * 59),
    mlp_kind="swiglu",
    mla=MLAConfig(kv_lora_rank=512, rope_head_dim=64, nope_head_dim=128, v_head_dim=128),
    moe=MoEConfig(
        num_experts=160, top_k=6, d_ff_expert=1536, num_shared=2, d_ff_shared=1536,
        capacity_factor=1.25,
    ),
    long_context_window=8192,
    notes="MLA kv_lora=512, 2 shared + 160 routed top-6 [arXiv:2405.04434]",
)


def smoke_config():
    return ModelConfig(
        arch_id="deepseek-v2-smoke",
        family="moe",
        num_layers=2,
        d_model=128,
        num_heads=4,
        num_kv_heads=4,
        head_dim=32,
        d_ff=256,
        vocab_size=512,
        block_pattern=("attn", "moe"),
        mlp_kind="swiglu",
        mla=MLAConfig(kv_lora_rank=32, rope_head_dim=16, nope_head_dim=32, v_head_dim=32),
        # ample capacity: smoke tests check decode==prefill exactly (no drops)
        moe=MoEConfig(num_experts=4, top_k=2, d_ff_expert=64, num_shared=1, d_ff_shared=64,
                      capacity_factor=8.0),
    )
