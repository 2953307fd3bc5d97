"""Hardware models: the paper's testbed (planner input), the reference's
datacenter TPU constants, and the GPU this package runs on.

``EDGE_TPU_PLATFORM`` is the modeled testbed of the paper: a Google Coral
USB Edge TPU (4 TOPS int8, 8 MB on-chip SRAM) attached over USB 3.0 to a
Raspberry Pi 5 (quad-core Cortex-A76 @ 2.4 GHz).  Its constants feed the
analytic model, Algorithm 1 and the stepper simulation, so the predicted
and simulated latencies describe that modeled testbed.  None of them is a
property of the GPU this package executes on.

``TPU_V5E`` and ``TPU_V5E_SERVING_PLATFORM`` are the reference's modeled
TPU v5e constants, copied for parity with its roofline and planner tests;
they describe no hardware of this port.  ``H100_SXM`` holds NVIDIA's data
sheet figures for the H100 SXM (dense rates at the 700 W limit), the
default chip of the port's roofline analysis.
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


# --- Datacenter target (roofline constants for the dry-run) ------------------
@dataclasses.dataclass(frozen=True)
class TPUChipSpec:
    name: str
    peak_flops_bf16: float
    hbm_bytes: int
    hbm_bw: float
    ici_link_bw: float


TPU_V5E = TPUChipSpec(
    name="tpu-v5e",
    peak_flops_bf16=197e12,
    hbm_bytes=16 * 1024**3,
    hbm_bw=819e9,
    ici_link_bw=50e9,
)

# A v5e-like serving platform viewed through the SwapLess abstraction:
# HBM is the bounded tier, host DRAM the backing store, PCIe the swap channel.
TPU_V5E_SERVING_PLATFORM = Platform(
    accelerator=AcceleratorSpec(
        name="tpu-v5e-serving",
        peak_ops=197e12,
        sram_bytes=16 * 1024**3,
        host_bw=32e9,              # PCIe gen4 x16-ish host link
        eff_front=0.55,
        eff_back=0.08,
    ),
    cpu=HostCPUSpec(name="dc-host", n_cores=112, ops_per_core=50e9, parallel_frac=0.95),
)


# --- The port's GPU (NVIDIA H100 SXM data sheet, dense, 700 W) ---------------
@dataclasses.dataclass(frozen=True)
class GPUChipSpec:
    name: str
    peak_flops_bf16: float   # tensor cores
    peak_flops_tf32: float   # tensor cores
    peak_flops_f32: float    # CUDA cores
    hbm_bytes: int
    hbm_bw: float
    nvlink_bw: float         # per direction


H100_SXM = GPUChipSpec(
    name="nvidia-h100-sxm",
    peak_flops_bf16=989.4e12,
    peak_flops_tf32=494.7e12,
    peak_flops_f32=66.9e12,
    hbm_bytes=80 * 1024**3,
    hbm_bw=3.35e12,
    nvlink_bw=450e9,               # NVLink 4: 900 GB/s both directions
)
