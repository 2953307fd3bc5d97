"""Architecture configs of the model zoo (``registry``) and the paper's model
profiles (``paper_models``)."""
from repro_torch.configs.base import INPUT_SHAPES, ArchConfig, InputShape
from repro_torch.configs.registry import ARCHS, all_pairs, get_arch, get_shape

__all__ = [
    "ARCHS",
    "ArchConfig",
    "INPUT_SHAPES",
    "InputShape",
    "all_pairs",
    "get_arch",
    "get_shape",
]
