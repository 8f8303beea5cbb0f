"""Model configuration schema covering all ten assigned architectures (a
copy of ``repro/models/config.py``, which imports no JAX, kept so that the
port imports nothing of ``repro``).

A :class:`ModelConfig` fully determines parameter shapes, the per-layer block
pattern, and the decode-cache layout. Configs for the assigned architectures
live in ``repro_torch.configs.<id>`` and are registered in
``repro_torch.configs``. ``param_count`` counts from shapes alone, as the
reference's ``count_params`` does, and allocates nothing.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    num_experts: int
    top_k: int
    d_ff_expert: int
    num_shared: int = 0           # shared (always-on) experts, deepseek-style
    d_ff_shared: int = 0          # hidden size of the shared expert(s)
    capacity_factor: float = 1.25
    router_noise: float = 0.0
    every_k: int = 1              # MoE every k-th layer (1 = all marked layers)


@dataclasses.dataclass(frozen=True)
class MLAConfig:
    """DeepSeek-V2 Multi-head Latent Attention."""

    kv_lora_rank: int = 512
    q_lora_rank: int = 0          # 0 => full-rank queries
    rope_head_dim: int = 64
    nope_head_dim: int = 128
    v_head_dim: int = 128


@dataclasses.dataclass(frozen=True)
class MambaConfig:
    """Mamba2 (SSD) block."""

    state_dim: int = 64
    head_dim: int = 64
    expand: int = 2
    chunk: int = 256
    conv_width: int = 4


@dataclasses.dataclass(frozen=True)
class RWKVConfig:
    """RWKV-6 'Finch' time-mix block."""

    head_dim: int = 64
    decay_lora: int = 64


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    arch_id: str
    family: str                         # dense | moe | ssm | hybrid | vlm | audio
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    head_dim: int
    d_ff: int
    vocab_size: int
    # block pattern: tuple of block kinds, len == num_layers. Kinds:
    #   attn        full-attention transformer block
    #   attn_local  sliding-window attention block
    #   moe         attention + MoE ffn block
    #   mamba       Mamba2 block
    #   rwkv        RWKV6 block
    #   shared      weight-shared attention block (zamba2)
    block_pattern: Tuple[str, ...] = ()
    mlp_kind: str = "swiglu"            # swiglu | geglu | relu2 | gelu
    rope_theta: float = 10000.0
    use_rope: bool = True
    rms_eps: float = 1e-5
    tie_embeddings: bool = False
    sliding_window: int = 4096          # window for attn_local blocks
    long_context_window: int = 8192     # swa window used at long_500k for dense archs
    moe: Optional[MoEConfig] = None
    mla: Optional[MLAConfig] = None
    mamba: Optional[MambaConfig] = None
    rwkv: Optional[RWKVConfig] = None
    # modality frontends (stubs — DESIGN.md §4):
    num_codebooks: int = 0              # musicgen: EnCodec codebooks (0 = text)
    num_patches: int = 0                # pixtral: ViT patch embeddings per image
    # decode behaviour
    subquadratic: bool = False          # native O(1)/windowed state at 500k?
    notes: str = ""

    def __post_init__(self):
        if self.block_pattern:
            assert len(self.block_pattern) == self.num_layers, self.arch_id

    @property
    def q_dim(self) -> int:
        return self.num_heads * self.head_dim

    @property
    def kv_dim(self) -> int:
        return self.num_kv_heads * self.head_dim

    def param_count(self) -> int:
        """Total parameters N (from init shapes, no allocation)."""
        from . import lm as _lm

        return _lm.count_params(self)

    def active_param_count(self) -> int:
        """Active parameters per token (MoE counts top_k + shared only)."""
        from . import lm as _lm

        return _lm.count_params(self, active_only=True)


def uniform_pattern(kind: str, n: int) -> Tuple[str, ...]:
    return tuple([kind] * n)


def periodic_pattern(period: Tuple[str, ...], n: int) -> Tuple[str, ...]:
    out = []
    while len(out) < n:
        out.extend(period)
    return tuple(out[:n])
