"""Three-term roofline analysis of a step bundle's counted costs.

Port of the JAX package's ``roofline/analysis.py``:

    compute term    = FLOPs_per_device / peak_FLOP/s
    memory term     = bytes_per_device / HBM_bw
    collective term = collective_bytes_per_device / link_bw

The reference reads a compiled XLA executable (``cost_analysis`` and its
HLO text through ``hlo_parse``); torch produces neither, so
``analyze_compiled`` takes the record of ``roofline.counter.count_step``
(the parser's ``HloCosts``) in its place.  The count runs every op once,
so there is no loop-blind static figure: the ``static_*`` keys repeat the
counted ones.  The default chip is the port's H100 (``hw.specs.H100_SXM``:
its bf16 tensor-core peak, HBM rate and NVLink rate per direction); the
reference's ``TPU_V5E`` is accepted too.

MODEL_FLOPS uses 6*N*D (train) / 2*N*D (inference) with N the *active*
parameter count for MoE; the ratio MODEL_FLOPS / (counted FLOPs * chips)
shows how much counted compute is "useful" (catches remat recompute,
capacity overhead, dispatch waste).
"""
from __future__ import annotations

import math
from typing import Any

from repro_torch.configs.base import ArchConfig, InputShape
from repro_torch.hw.specs import H100_SXM, TPUChipSpec
from repro_torch.launch.mesh import mesh_view
from repro_torch.roofline.hlo_parse import HloCosts


def model_flops(cfg: ArchConfig, shape: InputShape) -> float:
    n_active = cfg.active_param_count()
    if shape.kind == "train":
        tokens = shape.global_batch * shape.seq_len
        return 6.0 * n_active * tokens
    if shape.kind == "prefill":
        tokens = shape.global_batch * shape.seq_len
        return 2.0 * n_active * tokens
    # decode: one token per sequence
    return 2.0 * n_active * shape.global_batch


def analyze_compiled(
    cfg: ArchConfig,
    shape: InputShape,
    mesh,
    compiled: HloCosts,
    *,
    chip=H100_SXM,
) -> dict[str, Any]:
    """The reference's roofline record for the counted costs ``compiled``
    of one step on ``mesh`` (a ``DeviceMesh`` or any mesh with ``.shape``)."""
    n_chips = math.prod(mesh_view(mesh).shape.values())
    flops_dev = compiled.flops
    bytes_dev = compiled.bytes_accessed
    link_bw = chip.ici_link_bw if isinstance(chip, TPUChipSpec) else chip.nvlink_bw

    compute_s = flops_dev / chip.peak_flops_bf16
    memory_s = bytes_dev / chip.hbm_bw
    collective_s = compiled.collective_bytes["total"] / link_bw

    terms = {
        "compute_s": compute_s,
        "memory_s": memory_s,
        "collective_s": collective_s,
    }
    bottleneck = max(terms, key=terms.get).replace("_s", "")

    mf = model_flops(cfg, shape)
    hlo_total_flops = flops_dev * n_chips
    useful = mf / hlo_total_flops if hlo_total_flops > 0 else 0.0

    return {
        "roofline": {
            **{k: float(v) for k, v in terms.items()},
            "bottleneck": bottleneck,
            "flops_per_device": flops_dev,
            "bytes_per_device": bytes_dev,
            "static_flops_per_device": flops_dev,
            "static_bytes_per_device": bytes_dev,
            "collective_bytes_per_device": compiled.collective_bytes["total"],
            "collective_breakdown": {
                k: v for k, v in compiled.collective_bytes.items() if k != "total"
            },
            "collective_op_counts": compiled.collective_ops,
            "model_flops": mf,
            "useful_flops_ratio": useful,
            "n_chips": int(n_chips),
        }
    }
