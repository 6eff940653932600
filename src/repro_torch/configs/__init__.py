"""Architecture registry of the port: the dense decoders, the modality
stubs (phi-3-vision, musicgen), the recurrent families (rwkv6, zamba2)
and the mixtures of experts (deepseek-v3, kimi-k2)."""
from __future__ import annotations

import importlib
from typing import Dict

from repro_torch.models.common import ArchConfig

__all__ = ["ARCHS", "get_config", "get_smoke_config", "get_rules"]

ARCHS: Dict[str, str] = {
    "gemma3-12b": "gemma3_12b",
    "qwen2.5-32b": "qwen2_5_32b",
    "granite-8b": "granite_8b",
    "smollm-135m": "smollm_135m",
    "phi-3-vision-4.2b": "phi3_vision_4_2b",
    "musicgen-medium": "musicgen_medium",
    "rwkv6-1.6b": "rwkv6_1_6b",
    "zamba2-7b": "zamba2_7b",
    "deepseek-v3-671b": "deepseek_v3_671b",
    "kimi-k2-1t-a32b": "kimi_k2_1t",
}


def _module(arch: str):
    if arch not in ARCHS:
        raise KeyError(f"arch {arch!r} is not ported; one of {sorted(ARCHS)}")
    return importlib.import_module(f"repro_torch.configs.{ARCHS[arch]}")


def get_config(arch: str) -> ArchConfig:
    return _module(arch).CONFIG


def get_smoke_config(arch: str) -> ArchConfig:
    return _module(arch).SMOKE


def get_rules(arch: str) -> Dict:
    """The config's logical-rule overrides (``distributed.sharding``), the
    JAX package's ``get_rules``; the serving engine applies
    ``serving_rules`` on top of the defaults instead."""
    return dict(getattr(_module(arch), "RULES", {}))
