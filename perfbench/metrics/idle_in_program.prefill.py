"""idle_in_program.prefill: the share of the traced requests' wall time in
which no operation ran on the device (a gap between two of them) while
the host was inside the program's prefill: any span of a request's root
span ``prefill`` (``repro_torch.tracing``), in %.  The traced requests
are the card-alone stretch's; a run with another count of ``prefill``
roots over that stretch, or a program without spans, reads nothing.
``device_idle.prefill`` holds besides the caller's time between requests
(the argmax, its copy to the host, the loop) and the stretch's edges."""
from harness import spans


def read(ctx, outcome):
    return spans.idle_in(outcome.reading, spans.program_spans(), "prefill", len(outcome.window["traced_lengths"]))
