"""Architecture registry of the port (smollm-135m only in this slice)."""
from __future__ import annotations

import importlib
from typing import Dict

from repro_torch.models.common import ArchConfig

__all__ = ["ARCHS", "get_config", "get_smoke_config"]

ARCHS: Dict[str, str] = {"smollm-135m": "smollm_135m"}


def _module(arch: str):
    if arch not in ARCHS:
        raise KeyError(f"arch {arch!r} is not ported; one of {sorted(ARCHS)}")
    return importlib.import_module(f"repro_torch.configs.{ARCHS[arch]}")


def get_config(arch: str) -> ArchConfig:
    return _module(arch).CONFIG


def get_smoke_config(arch: str) -> ArchConfig:
    return _module(arch).SMOKE
