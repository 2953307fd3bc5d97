"""flash_attention_roofline.prefill: the least time of the traced
requests' ``flash_attention`` calls over the device time of the kernels
named ``flash_kernel``, in %.  A call's least time is the larger of its
FLOPs (the pairs its causal or window mask keeps) over the bf16 peak and
its bytes (q, k, v read once, o written once) over the HBM bandwidth:
``harness.flops.flash_calls``, from the attention calls that the
configuration's reference family lists."""
import re

from harness import flops
from harness.peaks import PEAK_BF16_FLOPS, PEAK_HBM_BYTES_PER_S

KERNEL = re.compile(r"flash_kernel")


def read(ctx, outcome):
    kernel_s = outcome.reading.device_seconds(KERNEL)
    if kernel_s <= 0:
        return None
    least = 0.0
    for s in outcome.window["traced_lengths"]:
        for f, b in flops.flash_calls(ctx.conf, s):
            least += outcome.window["batch"] * max(f / PEAK_BF16_FLOPS, b / PEAK_HBM_BYTES_PER_S)
    return 100.0 * least / kernel_s
