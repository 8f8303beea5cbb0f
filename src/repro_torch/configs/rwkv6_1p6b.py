"""rwkv6-1.6b [ssm] — Finch: attention-free, data-dependent decay.

Assigned: 24L d_model=2048 (attn-free) d_ff=7168 vocab=65536
[arXiv:2404.05892]. head_dim=64 (32 heads), decay LoRA rank 64.
Natively O(1)-state at any context length.
"""
from repro_torch.models.config import ModelConfig, RWKVConfig, uniform_pattern

CONFIG = ModelConfig(
    arch_id="rwkv6-1.6b",
    family="ssm",
    num_layers=24,
    d_model=2048,
    num_heads=32,  # derived: d_model / head_dim (attn-free; used for state layout)
    num_kv_heads=32,
    head_dim=64,
    d_ff=7168,
    vocab_size=65536,
    block_pattern=uniform_pattern("rwkv", 24),
    mlp_kind="relu2",
    use_rope=False,
    rwkv=RWKVConfig(head_dim=64, decay_lora=64),
    subquadratic=True,
    notes="Finch — data-dependent decay [arXiv:2404.05892]",
)


def smoke_config():
    return ModelConfig(
        arch_id="rwkv6-smoke",
        family="ssm",
        num_layers=2,
        d_model=128,
        num_heads=4,
        num_kv_heads=4,
        head_dim=32,
        d_ff=256,
        vocab_size=512,
        block_pattern=uniform_pattern("rwkv", 2),
        mlp_kind="relu2",
        use_rope=False,
        rwkv=RWKVConfig(head_dim=32, decay_lora=16),
        subquadratic=True,
    )
