"""The paper's nine evaluation models (Table II) as synthetic profile specs.

Size / FLOPs / partition-point counts are taken verbatim from Table II.
``speedup_front`` / ``speedup_back`` encode each model's Fig.-3-style
TPU-vs-CPU per-segment speedup curve, calibrated so that derived
intra-model swap-overhead fractions reproduce the ranges in Figs. 1-2
(20.2% for DenseNet201 up to 62.4% for InceptionV4).
"""
from __future__ import annotations

from repro_torch.core.planner import ModelProfile
from repro_torch.hw.specs import EDGE_TPU_PLATFORM, Platform
from repro_torch.profiler.synthetic import SyntheticModelSpec, build_profile

# name, size(MB), GFLOPs, partition points  -- Table II
PAPER_MODEL_SPECS: dict[str, SyntheticModelSpec] = {
    s.name: s
    for s in [
        SyntheticModelSpec("squeezenet", 1.4, 0.81, 2, speedup_front=30, speedup_back=1.6),
        SyntheticModelSpec("mobilenetv2", 4.1, 0.30, 5, speedup_front=25, speedup_back=1.05),
        SyntheticModelSpec("efficientnet", 6.7, 0.39, 6, speedup_front=25, speedup_back=1.05),
        SyntheticModelSpec("mnasnet", 7.1, 0.31, 7, speedup_front=25, speedup_back=1.05),
        SyntheticModelSpec("gpunet", 12.2, 0.62, 5, speedup_front=40, speedup_back=1.2),
        SyntheticModelSpec("densenet201", 19.7, 4.32, 7, speedup_front=50, speedup_back=1.4),
        SyntheticModelSpec("resnet50v2", 25.3, 4.49, 8, speedup_front=66, speedup_back=1.2),
        SyntheticModelSpec("xception", 26.1, 8.38, 11, speedup_front=160, speedup_back=1.35, flops_decay=0.62),
        SyntheticModelSpec("inceptionv4", 43.2, 12.27, 11, speedup_front=210, speedup_back=1.45, flops_decay=0.58),
    ]
}

PAPER_MODEL_NAMES = tuple(PAPER_MODEL_SPECS)


def paper_profile(name: str, platform: Platform = EDGE_TPU_PLATFORM) -> ModelProfile:
    return build_profile(PAPER_MODEL_SPECS[name], platform)


def all_paper_profiles(platform: Platform = EDGE_TPU_PLATFORM) -> dict[str, ModelProfile]:
    return {n: paper_profile(n, platform) for n in PAPER_MODEL_SPECS}
