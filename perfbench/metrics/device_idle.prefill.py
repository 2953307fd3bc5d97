"""device_idle.prefill: the share of the traced requests' wall time in
which no operation ran on the device (outside the union of their
intervals), in %."""


def read(ctx, outcome):
    r = outcome.reading
    return 100.0 * (1.0 - r.busy_s / r.window_s)
