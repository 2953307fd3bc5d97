"""Models: the paper's partitionable CNNs (``cnn``) for the SwapLess serving
path, and the model zoo (``transformer`` over ``attention``, ``rwkv`` and
``layers``) for prefill and decode."""
from repro_torch.models.transformer import (
    backbone,
    count_params,
    decode_step,
    init_decode_caches,
    init_params,
    prefill_step,
)

__all__ = [
    "backbone",
    "count_params",
    "decode_step",
    "init_decode_caches",
    "init_params",
    "prefill_step",
]
