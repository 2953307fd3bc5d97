"""Synthetic per-segment model profiles."""
from repro_torch.profiler.synthetic import SyntheticModelSpec, build_profile

__all__ = ["SyntheticModelSpec", "build_profile"]
