"""matmul_share.prefill: device time of the matrix-product kernels (cuBLAS,
CUTLASS and their generated kernels, by the name patterns below) over all
device busy time of the traced requests, in %."""
import re

PATTERNS = re.compile(r"gemm|cutlass|xmma|nvjet|cublas", re.IGNORECASE)


def read(ctx, outcome):
    r = outcome.reading
    return 100.0 * r.device_seconds(PATTERNS) / r.busy_s if r.busy_s > 0 else None
