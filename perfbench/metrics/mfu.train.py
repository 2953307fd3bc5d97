"""mfu.train: model FLOPs of every step of the window (3 x the forward's,
remat's recompute not counted: ``harness.flops.train_flops``) over the
window's wall time, as a share of the bf16 peak, in %."""
from harness import flops
from harness.peaks import PEAK_BF16_FLOPS


def read(ctx, outcome):
    w = outcome.window
    total = w["steps"] * w["global_batch"] * flops.train_flops(ctx.conf, w["seq_len"])
    return 100.0 * total / (w["wall_s"] * PEAK_BF16_FLOPS)
