"""Architecture registry: ``get(arch_id)`` / ``get_smoke(arch_id)`` / ``ARCHS``
(a copy of ``repro/configs``, built on ``repro_torch.models.config``).

Each ``<id>.py`` exports ``CONFIG`` (the exact assigned configuration, source
cited in its docstring) and ``smoke_config()`` (a reduced same-family variant:
<= 2 layers, d_model <= 512, <= 4 experts) for CPU smoke tests.
"""
from __future__ import annotations

import importlib

ARCHS = [
    "zamba2_1p2b",
    "starcoder2_7b",
    "gemma_2b",
    "deepseek_v2_236b",
    "musicgen_large",
    "llama4_maverick_400b",
    "gemma3_1b",
    "pixtral_12b",
    "rwkv6_1p6b",
    "minitron_4b",
]

# CLI ids (as assigned) -> module names
ALIASES = {
    "zamba2-1.2b": "zamba2_1p2b",
    "starcoder2-7b": "starcoder2_7b",
    "gemma-2b": "gemma_2b",
    "deepseek-v2-236b": "deepseek_v2_236b",
    "musicgen-large": "musicgen_large",
    "llama4-maverick-400b-a17b": "llama4_maverick_400b",
    "gemma3-1b": "gemma3_1b",
    "pixtral-12b": "pixtral_12b",
    "rwkv6-1.6b": "rwkv6_1p6b",
    "minitron-4b": "minitron_4b",
}


def _module(arch_id: str):
    name = ALIASES.get(arch_id, arch_id.replace("-", "_").replace(".", "p"))
    return importlib.import_module(f"repro_torch.configs.{name}")


def get(arch_id: str):
    return _module(arch_id).CONFIG


def get_smoke(arch_id: str):
    return _module(arch_id).smoke_config()
