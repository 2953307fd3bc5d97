"""Hardware models: the paper's testbed (planner input) and the reference's
TPU v5e constants, under the reference package's names.  The port's own
GPU, ``H100_SXM``, is in ``repro_torch.hw.specs``."""
from repro_torch.hw.specs import (
    AcceleratorSpec,
    CORAL_EDGE_TPU,
    CORTEX_A76_QUAD,
    EDGE_TPU_PLATFORM,
    HostCPUSpec,
    Platform,
    TPU_V5E,
    TPU_V5E_SERVING_PLATFORM,
    TPUChipSpec,
)

__all__ = [
    "AcceleratorSpec",
    "CORAL_EDGE_TPU",
    "CORTEX_A76_QUAD",
    "EDGE_TPU_PLATFORM",
    "HostCPUSpec",
    "Platform",
    "TPU_V5E",
    "TPU_V5E_SERVING_PLATFORM",
    "TPUChipSpec",
]
