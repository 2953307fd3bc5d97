"""Registry of assigned architectures: ``--arch <id>`` resolution."""
from __future__ import annotations

from repro_torch.configs.base import INPUT_SHAPES, ArchConfig, InputShape
from repro_torch.configs.phi_3_vision_4_2b import CONFIG as PHI3V
from repro_torch.configs.llama4_maverick_400b_a17b import CONFIG as LLAMA4
from repro_torch.configs.gemma3_1b import CONFIG as GEMMA3
from repro_torch.configs.nemotron_4_15b import CONFIG as NEMOTRON
from repro_torch.configs.musicgen_large import CONFIG as MUSICGEN
from repro_torch.configs.qwen1_5_0_5b import CONFIG as QWEN
from repro_torch.configs.hymba_1_5b import CONFIG as HYMBA
from repro_torch.configs.grok_1_314b import CONFIG as GROK
from repro_torch.configs.rwkv6_7b import CONFIG as RWKV6
from repro_torch.configs.minicpm_2b import CONFIG as MINICPM

ARCHS: dict[str, ArchConfig] = {
    c.name: c
    for c in [
        PHI3V,
        LLAMA4,
        GEMMA3,
        NEMOTRON,
        MUSICGEN,
        QWEN,
        HYMBA,
        GROK,
        RWKV6,
        MINICPM,
    ]
}


def get_arch(name: str) -> ArchConfig:
    if name not in ARCHS:
        raise KeyError(f"unknown arch {name!r}; known: {sorted(ARCHS)}")
    return ARCHS[name]


def get_shape(name: str) -> InputShape:
    if name not in INPUT_SHAPES:
        raise KeyError(f"unknown shape {name!r}; known: {sorted(INPUT_SHAPES)}")
    return INPUT_SHAPES[name]


def all_pairs() -> list[tuple[ArchConfig, InputShape]]:
    """All 40 (arch x shape) pairs; unsupported pairs are flagged by
    cfg.supports_shape and skipped by the dry-run with a documented reason."""
    return [
        (a, s) for a in ARCHS.values() for s in INPUT_SHAPES.values()
    ]
