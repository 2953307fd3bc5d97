"""Cost of one step from its torch ops: the port's sibling of ``hlo_parse``.

torch produces no HLO, so a step bundle's ``fn`` runs once on its abstract
arguments under their ``FakeTensorMode`` (shapes and dtypes only: nothing
is allocated and nothing runs on a device), with two dispatch modes
listening:

* FLOPs: ``torch.utils.flop_counter.FlopCounterMode``, which counts the
  products (2 * M * N * K per matrix product; attention and convolutions
  likewise) and nothing elementwise, as the parser counts dots alone.
* Bytes: every op's tensor inputs read once and outputs written once;
  views move no bytes.  Eager torch fuses nothing, so each op is charged as
  the parser charges an unfused instruction.
* Collectives: the result bytes of the functional collectives that DTensor
  redistributions issue, by kind, and their count (none on a one-device
  mesh).

The step runs once with every layer and microbatch in turn, so the counts
need no loop multiplicities.  On fake host tensors the hand kernels' plain
versions run: attention is counted over every (query, key) pair, masked
ones included, as the reference's chunked attention computes them.  The
record is the parser's own ``HloCosts``, which ``analyze_compiled`` reads.
"""
from __future__ import annotations


import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import FlopCounterMode

from repro_torch.roofline.hlo_parse import _COLLECTIVE_KINDS, HloCosts
from repro_torch.training.tree import leaves_with_paths

# Functional collectives (``torch.ops._c10d_functional``) by the HLO kind
# the parser files them under.
_COLLECTIVES = {
    "all_reduce": "all-reduce",
    "all_gather_into_tensor": "all-gather",
    "reduce_scatter_tensor": "reduce-scatter",
    "all_to_all_single": "all-to-all",
}


def _tensor_bytes(tree) -> int:
    return sum(
        t.numel() * t.element_size()
        for _, t in leaves_with_paths(tree)
        if isinstance(t, torch.Tensor)
    )


class _ByteCounter(TorchDispatchMode):
    """Bytes read and written per op, and collective bytes by kind."""

    def __init__(self):
        super().__init__()
        self.bytes = 0
        self.collective_bytes = {k: 0.0 for k in _COLLECTIVE_KINDS}
        self.collective_ops = {k: 0 for k in _COLLECTIVE_KINDS}

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        namespace, _, name = func.name().partition("::")
        if namespace == "_c10d_functional" and name in _COLLECTIVES:
            kind = _COLLECTIVES[name]
            self.collective_bytes[kind] += _tensor_bytes(out)
            self.collective_ops[kind] += 1
        elif not func.is_view:
            self.bytes += _tensor_bytes(list(args)) + _tensor_bytes(dict(kwargs)) + _tensor_bytes(out)
        return out


def count_step(bundle) -> HloCosts:
    """FLOPs, bytes and collective bytes of one call of ``bundle.fn`` on
    ``bundle.args`` (a ``launch.steps`` bundle); decode's position is
    given as 0."""
    from repro_torch.launch.steps import fake_mode

    args = bundle.args
    if bundle.shape.kind == "decode":
        args = (*args[:3], 0)
    flops = FlopCounterMode(display=False)
    nbytes = _ByteCounter()
    with fake_mode(bundle.args), flops, nbytes:
        bundle.fn(*args)
    coll = nbytes.collective_bytes
    return HloCosts(
        flops=float(flops.get_total_flops()),
        bytes_accessed=float(nbytes.bytes),
        collective_bytes={**coll, "total": sum(coll.values())},
        collective_ops=nbytes.collective_ops,
        trip_counted_whiles=0,
    )
