"""Architecture registry of the port: --arch <id> -> ModelConfig."""
from __future__ import annotations

import importlib

from .base import ModelConfig, SHAPES, ShapeConfig

_ARCH_MODULES = {
    "whisper-medium": "whisper_medium",
    "recurrentgemma-2b": "recurrentgemma_2b",
    "qwen3-4b": "qwen3_4b",
    "yi-34b": "yi_34b",
    "starcoder2-7b": "starcoder2_7b",
    "gemma3-27b": "gemma3_27b",
    "granite-moe-1b-a400m": "granite_moe_1b_a400m",
    "arctic-480b": "arctic_480b",
    "qwen2-vl-72b": "qwen2_vl_72b",
    "xlstm-1.3b": "xlstm_1_3b",
    "paper-tiny-lm": "paper_msr",
}

ARCH_IDS = tuple(k for k in _ARCH_MODULES if k != "paper-tiny-lm")


def get_config(arch: str) -> ModelConfig:
    if arch not in _ARCH_MODULES:
        raise KeyError(f"unknown arch {arch!r}; known: {sorted(_ARCH_MODULES)}")
    mod = importlib.import_module(f"repro_torch.configs.{_ARCH_MODULES[arch]}")
    return mod.CONFIG


def get_shape(name: str) -> ShapeConfig:
    return SHAPES[name]


def cells() -> list[tuple[str, str]]:
    """All assigned (arch x shape) dry-run cells, with skip rules applied.

    Skips (recorded in DESIGN.md §5): long_500k for pure-full-attention archs.
    Whisper has a decoder, so decode shapes run (backbone exercise).
    """
    out = []
    for arch in ARCH_IDS:
        cfg = get_config(arch)
        for shape in SHAPES.values():
            if shape.name == "long_500k" and not cfg.is_subquadratic():
                continue
            out.append((arch, shape.name))
    return out


def skipped_cells() -> list[tuple[str, str, str]]:
    out = []
    for arch in ARCH_IDS:
        cfg = get_config(arch)
        if not cfg.is_subquadratic():
            out.append((arch, "long_500k",
                        "pure full attention — sub-quadratic required (DESIGN.md §5)"))
    return out
