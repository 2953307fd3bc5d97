"""Hardware model of the paper's testbed (planner input).

Re-exports the reference's public names that the port holds; the TPU v5e
specs (``TPU_V5E``, ``TPU_V5E_SERVING_PLATFORM``, ``TPUChipSpec``) are not
ported yet.
"""
from repro_torch.hw.specs import (
    AcceleratorSpec,
    CORAL_EDGE_TPU,
    CORTEX_A76_QUAD,
    EDGE_TPU_PLATFORM,
    HostCPUSpec,
    Platform,
)

__all__ = [
    "AcceleratorSpec",
    "CORAL_EDGE_TPU",
    "CORTEX_A76_QUAD",
    "EDGE_TPU_PLATFORM",
    "HostCPUSpec",
    "Platform",
]
