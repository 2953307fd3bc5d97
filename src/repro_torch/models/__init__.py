"""Models: the paper's partitionable CNNs (``cnn``) for the SwapLess serving
path, and the model zoo (``transformer`` over ``attention``, ``rwkv`` and
``layers``) for prefill, decode and training (``forward_loss``)."""
from repro_torch.models.transformer import (
    backbone,
    count_params,
    decode_step,
    forward_loss,
    init_decode_caches,
    init_params,
    prefill_step,  # noqa: F401  (importable from here; the reference's __all__ leaves it out)
)

__all__ = [
    "backbone",
    "count_params",
    "decode_step",
    "forward_loss",
    "init_decode_caches",
    "init_params",
]
