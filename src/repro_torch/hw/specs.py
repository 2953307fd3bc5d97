"""Hardware model of the paper's testbed, as input to the SwapLess planner.

``EDGE_TPU_PLATFORM`` is the modeled testbed of the paper: a Google Coral
USB Edge TPU (4 TOPS int8, 8 MB on-chip SRAM) attached over USB 3.0 to a
Raspberry Pi 5 (quad-core Cortex-A76 @ 2.4 GHz).  Its constants feed the
analytic model, Algorithm 1 and the stepper simulation, so the predicted
and simulated latencies describe that modeled testbed.  None of them is a
property of the GPU this package executes on.
"""
from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class AcceleratorSpec:
    """A bounded-fast-memory accelerator attached to a host."""

    name: str
    peak_ops: float          # ops/s at native precision (int8 for EdgeTPU)
    sram_bytes: int          # bounded fast-memory tier (SRAM / HBM)
    host_bw: float           # host <-> accelerator bandwidth, bytes/s (swap channel)
    # Effective-utilization envelope across a model's depth.  Early (wide,
    # highly parallel) segments run near ``eff_front``; trailing (narrow,
    # pointwise) segments degrade toward ``eff_back`` -- this reproduces the
    # paper's Fig. 3 observation that CPU and TPU converge in later stages.
    eff_front: float = 0.10
    eff_back: float = 0.004


@dataclasses.dataclass(frozen=True)
class HostCPUSpec:
    name: str
    n_cores: int
    ops_per_core: float      # effective ops/s per core (NEON int8 ~ 4 GOPS)
    parallel_frac: float     # Amdahl parallelizable fraction for suffix blocks


@dataclasses.dataclass(frozen=True)
class Platform:
    accelerator: AcceleratorSpec
    cpu: HostCPUSpec

    @property
    def sram_bytes(self) -> int:
        return self.accelerator.sram_bytes

    @property
    def swap_bw(self) -> float:
        return self.accelerator.host_bw


# --- Paper testbed -----------------------------------------------------------
CORAL_EDGE_TPU = AcceleratorSpec(
    name="coral-usb-edgetpu",
    peak_ops=4.0e12,               # 4 TOPS int8
    sram_bytes=8 * 1024 * 1024,    # 8 MB on-chip SRAM
    host_bw=400e6,                 # effective USB 3.0 weight-streaming bandwidth
)

CORTEX_A76_QUAD = HostCPUSpec(
    name="rpi5-cortex-a76",
    n_cores=4,
    ops_per_core=4.0e9,            # effective int8 GOPS/core via NEON
    parallel_frac=0.90,
)

EDGE_TPU_PLATFORM = Platform(accelerator=CORAL_EDGE_TPU, cpu=CORTEX_A76_QUAD)
