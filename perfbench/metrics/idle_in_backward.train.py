"""idle_in_backward.train: the share of the traced step's wall time in which
no operation ran on the device (a gap between two of them) while the host
was inside the backward (``train.backward``: ``torch.autograd.grad``, with remat's
recompute, whose spans run on autograd's thread under it) of the step's root span ``train.step``
(``repro_torch.tracing``), in %.  A run with another count of
``train.step`` roots over the card-alone stretch, or a program without
spans, reads nothing.  ``idle_in_forward.train``,
``idle_in_backward.train`` and ``idle_in_optimizer.train`` split
``device_idle.train``; the rest is host work outside the three (the
harness's loop, the stretch's edges)."""
from harness import spans, spec


def read(ctx, outcome):
    expected = spec.generator(ctx.traffic).TRACE_STEPS
    return spans.idle_in(outcome.reading, spans.program_spans(), "train.step", expected, {"train.backward"})
