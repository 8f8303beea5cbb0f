"""gemma3-1b [dense] — 5:1 local:global sliding-window attention, 128k ctx.

Assigned: 26L d_model=1152 4H (GQA kv=1) d_ff=6912 vocab=262144
[hf:google/gemma-3-1b-pt]. Local layers use window=512 (gemma3-1b card);
every 6th layer is global. Natively long-context capable: only the 1-in-6
global layers hold a full-length cache at 500k.
"""
from repro_torch.models.config import ModelConfig

_PATTERN = tuple("attn" if (i % 6) == 5 else "attn_local" for i in range(26))

CONFIG = ModelConfig(
    arch_id="gemma3-1b",
    family="dense",
    num_layers=26,
    d_model=1152,
    num_heads=4,
    num_kv_heads=1,
    head_dim=256,
    d_ff=6912,
    vocab_size=262144,
    block_pattern=_PATTERN,
    mlp_kind="geglu",
    tie_embeddings=True,
    rope_theta=1e6,
    sliding_window=512,
    subquadratic=True,  # 5:1 local + O(1)-per-step global decode
    notes="5:1 local:global, 128k [hf:google/gemma-3-1b-pt]",
)


def smoke_config():
    return ModelConfig(
        arch_id="gemma3-smoke",
        family="dense",
        num_layers=2,
        d_model=128,
        num_heads=4,
        num_kv_heads=1,
        head_dim=32,
        d_ff=256,
        vocab_size=512,
        block_pattern=("attn_local", "attn"),
        mlp_kind="geglu",
        tie_embeddings=True,
        sliding_window=16,
        subquadratic=True,
    )
