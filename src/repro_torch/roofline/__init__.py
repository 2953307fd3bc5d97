"""Roofline accounting: MODEL_FLOPS, the three-term analysis of a step's
counted costs (``counter``), the reference's HLO parser and its report."""
from repro_torch.roofline.analysis import analyze_compiled, model_flops
from repro_torch.roofline.hlo_parse import count_collective_ops, parse_collective_bytes

__all__ = [
    "analyze_compiled",
    "count_collective_ops",
    "model_flops",
    "parse_collective_bytes",
]
