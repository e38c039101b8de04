"""Assigned-architecture registry: ``get_config(arch_id)``.

Each module defines ``CONFIG`` (exact published numbers, see the per-file
source tags) and the registry maps the assignment ids to them.  The port's
own copy of the JAX package's ``repro.configs``, value for value.  Reduced
smoke variants come from ``CONFIG.reduced()``.
"""

from __future__ import annotations

from typing import Dict, List

from ..models.config import ArchConfig


def _load(mod_name: str) -> ArchConfig:
    import importlib
    # relative to this package: a dotted "repro.configs" string would load
    # the JAX package's registry
    mod = importlib.import_module(f".{mod_name}", __name__)
    return mod.CONFIG


_REGISTRY: Dict[str, str] = {
    "llama-3.2-vision-90b": "llama_3_2_vision_90b",
    "hymba-1.5b": "hymba_1_5b",
    "qwen2-moe-a2.7b": "qwen2_moe_a2_7b",
    "qwen3-moe-235b-a22b": "qwen3_moe_235b_a22b",
    "musicgen-large": "musicgen_large",
    "falcon-mamba-7b": "falcon_mamba_7b",
    "gemma3-27b": "gemma3_27b",
    "deepseek-coder-33b": "deepseek_coder_33b",
    "gemma2-27b": "gemma2_27b",
    "llama3.2-1b": "llama3_2_1b",
}


def list_archs() -> List[str]:
    return sorted(_REGISTRY)


def get_config(arch_id: str) -> ArchConfig:
    if arch_id not in _REGISTRY:
        raise KeyError(f"unknown arch {arch_id!r}; known: {list_archs()}")
    return _load(_REGISTRY[arch_id])
