"""scan_share.prefill: device time of the kernels launched inside the
program's ``models/ssm.py::selective_scan_chunked`` (a profiler range that
the benchmark wraps around it while it traces) over all device busy time
of the requests traced with the host's activity (``Outcome.ranged``), in
%.  Nothing to read where the model has no scan."""

RANGES = [("repro_torch.models.ssm", "selective_scan_chunked")]


def read(ctx, outcome):
    r = outcome.ranged
    if r is None:
        return None
    t = r.ranges.get("selective_scan_chunked")
    if not t or r.busy_s <= 0:
        return None
    return 100.0 * t / r.busy_s
