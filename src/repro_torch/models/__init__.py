"""Model substrate: configs, layers, SSM/MoE blocks, transformer stack, LM
(port of ``repro.models``)."""
from .config import MambaConfig, MLAConfig, ModelConfig, MoEConfig, RWKVConfig  # noqa: F401
