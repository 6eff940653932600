"""Architecture registry of the port: the dense decoders, the modality
stubs (phi-3-vision, musicgen), the recurrent families (rwkv6, zamba2)
and the mixtures of experts (deepseek-v3, kimi-k2); the four input-shape
sets of the dry run (``SHAPES``), its cells and the ``meta`` stand-ins of
a step's batch (``input_specs``)."""
from __future__ import annotations

import dataclasses
import importlib
from typing import Dict, Union

import torch

from repro_torch.models.common import ArchConfig

__all__ = ["ARCHS", "SHAPES", "ShapeSpec", "get_config", "get_smoke_config",
           "get_rules", "runs_shape", "cells", "input_specs"]

# in the JAX package's order, which ``cells`` walks
ARCHS: Dict[str, str] = {
    "rwkv6-1.6b": "rwkv6_1_6b",
    "gemma3-12b": "gemma3_12b",
    "qwen2.5-32b": "qwen2_5_32b",
    "granite-8b": "granite_8b",
    "smollm-135m": "smollm_135m",
    "kimi-k2-1t-a32b": "kimi_k2_1t",
    "deepseek-v3-671b": "deepseek_v3_671b",
    "zamba2-7b": "zamba2_7b",
    "phi-3-vision-4.2b": "phi3_vision_4_2b",
    "musicgen-medium": "musicgen_medium",
}


@dataclasses.dataclass(frozen=True)
class ShapeSpec:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # "train" | "prefill" | "decode"


SHAPES: Dict[str, ShapeSpec] = {
    "train_4k": ShapeSpec("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeSpec("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeSpec("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeSpec("long_500k", 524288, 1, "decode"),
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


def runs_shape(cfg: ArchConfig, shape: str) -> bool:
    """long_500k needs sub-quadratic attention (the JAX package's rule)."""
    if shape == "long_500k":
        return cfg.is_subquadratic
    return True


def cells(include_skipped: bool = False):
    """Every ``(arch, shape)`` dry-run cell; the skipped long_500k cells
    too with ``include_skipped``."""
    out = []
    for arch in ARCHS:
        cfg = get_config(arch)
        for shape in SHAPES:
            if runs_shape(cfg, shape) or include_skipped:
                out.append((arch, shape))
    return out


def input_specs(cfg: ArchConfig, shape: Union[str, ShapeSpec]
                ) -> Dict[str, torch.Tensor]:
    """``meta`` stand-ins of a step's batch, JAX's shapes and dtypes:
    train ``tokens`` and ``labels`` over the whole sequence, prefill
    ``tokens``, decode one new token a row (the cache of ``seq_len`` is
    built apart). musicgen's tokens carry a codebook axis; phi-3-vision's
    ``patches`` (compute dtype) take ``num_patches`` of the sequence and
    the text the rest."""
    spec = SHAPES[shape] if isinstance(shape, str) else shape
    B, S = spec.global_batch, spec.seq_len
    i32 = torch.int32

    def meta(shape, dtype=i32):
        return torch.empty(shape, dtype=dtype, device="meta")

    tok_shape = (B, S, cfg.num_codebooks) if cfg.num_codebooks else (B, S)
    out: Dict[str, torch.Tensor] = {}
    if spec.kind == "decode":
        out["tokens"] = meta((B, 1, cfg.num_codebooks) if cfg.num_codebooks
                             else (B, 1))
        return out
    if cfg.num_patches:
        s_text = S - cfg.num_patches
        out["patches"] = meta((B, cfg.num_patches, cfg.d_model),
                              cfg.compute_dtype)
        out["tokens"] = meta((B, s_text))
        if spec.kind == "train":
            out["labels"] = meta((B, s_text))
        return out
    out["tokens"] = meta(tok_shape)
    if spec.kind == "train":
        out["labels"] = meta(tok_shape)
    return out
