"""Cost and memory of one step from its torch ops, per rank: the port's
sibling of ``hlo_parse`` and of XLA's ``memory_analysis``.

torch produces no HLO, so a step bundle's ``fn`` runs once on abstract
arguments under their ``FakeTensorMode`` (shapes and dtypes only: nothing
is allocated and nothing runs on a device), with one dispatch mode
listening.  On a mesh of more than one rank the arguments are fake
DTensors: each holds rank 0's shard under the bundle's ``in_placements``.
The mode sees the ops that rank 0 executes, not the global ones: an op on
DTensors is passed on (``NotImplemented``) to DTensor, whose local ops on
the shards, redistributions and collectives come back through the mode;
the ops that DTensor's sharding propagation runs once more at the global
shapes, to learn an output's metadata, are work no rank does and are
skipped.

* FLOPs: ``torch.utils.flop_counter``'s formulas (2 * M * N * K per matrix
  product; attention and convolutions likewise; the hand kernels' fake
  forms at their plain versions' counts) and nothing elementwise, as the
  parser counts dots alone.
* Bytes: every op's tensor inputs read once and outputs written once;
  views, queries (an op with no tensor output) and collectives move none.  Eager torch fuses nothing, so each op
  is charged as the parser charges an unfused instruction.
* Collectives: the result bytes of the functional collectives that DTensor
  redistributions issue, by kind, and their count (none on a one-rank
  mesh).
* Memory: the bytes of every storage live on rank 0, from the arguments'
  shards on (the caller holds them) until each storage's last tensor is
  freed; ``peak_bytes`` is the most at once during the call.  A gradient
  that an autograd formula builds in a fresh zero tensor is charged as on
  plain tensors, where the formula writes into it in place
  (``_IN_PLACE_ON_PLAIN``).

The step runs once with every layer and microbatch in turn, so those
loops need no multiplicities.  A long sequential loop is the exception:
hymba's token-by-token SSM scan (``models/ssm.py::selective_scan``) runs,
on fake tensors, one representative step inside ``repeated(n)``, which
counts its ops n times over (FLOPs, bytes, collectives), as the
reference's parser multiplies a while body by its ``known_trip_count``;
the step's backward is counted n times over too.  Each such region (a
forward or a backward loop) adds one to ``trip_counted_whiles``.  The
backward region is opened and closed by two autograd nodes around the
step's own, which brackets exactly the step's backward only because the
autograd engine runs one device's ready nodes in decreasing order of
creation: an engine detail, not an API.  The markers raise where the
bracket breaks, and ``count`` raises on a region still open after the
step (its backward pass included).  Memory
is charged as the loop holds it: a storage allocated inside a region and
still live when it closes (a state saved for the backward pass, an output
the loop collects) stands for every step's copy and is charged n times,
a temporary freed inside it once, and the state the step hands the next
one n times only if it outlives that step (``Repeats``).  The hand kernels
take their fake forms (``kernels.build.fake_launch``) on fake tensors:
their outputs and workspaces, no launch and no plain version.  ``count_step``'s record is the
parser's own ``HloCosts``, which ``analyze_compiled`` reads.
"""
from __future__ import annotations

import contextlib
import math
import sys
import weakref

import torch
from torch._subclasses.fake_tensor import unset_fake_temporarily
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import flop_registry

from repro_torch.roofline.hlo_parse import _COLLECTIVE_KINDS, HloCosts
from repro_torch.training.tree import leaves_with_paths, tree_unflatten

# Functional collectives (``torch.ops._c10d_functional``), and DTensor's
# own move of a split between dimensions on a card mesh
# (``torch.ops._dtensor.shard_dim_alltoall``), by the HLO kind the parser
# files them under.
_COLLECTIVES = {
    ("_c10d_functional", "all_reduce"): "all-reduce",
    ("_c10d_functional", "all_gather_into_tensor"): "all-gather",
    ("_c10d_functional", "reduce_scatter_tensor"): "reduce-scatter",
    ("_c10d_functional", "all_to_all_single"): "all-to-all",
    ("_dtensor", "shard_dim_alltoall"): "all-to-all",
}


def _dtensor_type():
    mod = sys.modules.get("torch.distributed.tensor")
    return None if mod is None else mod.DTensor


def _local(t):
    """A tensor as rank 0 holds it: a DTensor's local shard, any other
    tensor itself."""
    dtensor = _dtensor_type()
    return t._local_tensor if dtensor is not None and isinstance(t, dtensor) else t


def _tensors(tree) -> list[torch.Tensor]:
    return [_local(t) for _, t in leaves_with_paths(tree) if isinstance(t, torch.Tensor)]


def _tensor_bytes(tree) -> int:
    return sum(t.numel() * t.element_size() for t in _tensors(tree))


def _dtensor_internal() -> str | None:
    """Whether the op now dispatched is DTensor's own work rather than a
    rank's: ``"metadata"`` for an op that its sharding propagation runs
    once more at the global shapes to learn an output's shape
    (``ShardingPropagator._propagate_tensor_meta*``), ``"indices"`` for
    the index arithmetic by which it sizes a strided shard
    (``local_shard_size_and_offset``), which needs values; None
    otherwise."""
    frame = sys._getframe(2)
    while frame is not None:
        name = frame.f_code.co_name
        if name.startswith("_propagate_tensor_meta"):
            return "metadata"
        if name == "local_shard_size_and_offset":
            return "indices"
        frame = frame.f_back
    return None


# Autograd formulas that build a gradient in a fresh zero tensor write
# into it in place on plain tensors, and out of place on tensor subclasses
# or under a dispatch mode (``isTensorSubclassLike``), which fake tensors
# and this counter both are: ``index_put`` (indexing's backward, an
# embedding table's), ``scatter_add`` (``gather``'s, the MoE's) and
# ``scatter`` (``topk``'s, the router's).  The counter charges such an
# output, inside a backward pass and on a zero tensor that the same pass
# made, as the run on plain tensors holds it: the zero tensor's bytes,
# not bytes of its own.
_IN_PLACE_ON_PLAIN = {torch.ops.aten.index_put, torch.ops.aten.scatter_add, torch.ops.aten.scatter}
_ZEROS = {torch.ops.aten.zeros, torch.ops.aten.new_zeros, torch.ops.aten.zeros_like}


class Repeats:
    """A region of repeated ops (``repeated``, ``push_repeats``): one
    representative step of a loop of ``n`` steps.  Its ops count ``n``
    times over (``times``, within the enclosing regions' multiplicity).  A
    storage allocated inside it and still live when it closes stands for
    every step's copy (a state saved for the backward pass, an output the
    loop collects) and is charged ``n`` times; one freed inside it is a
    step's temporary, live once at a time in the loop too, and charged
    once.  The step's ``carry`` (what it hands the next step) is live at
    the close because the next step has not run yet: it is charged once,
    and ``n`` times only if ``settle``, called after the step that
    consumes it, finds it still live (saved for the backward pass)."""

    def __init__(self, n: int, times: int):
        self.n = n
        self.times = times
        self.held: list = []            # (counter, storage key) allocated inside
        self.carried: set[int] = set()  # storage keys of the carry
        self.pending: list = []         # (counter, storage key) of carries live at the close

    def carry(self, t: torch.Tensor) -> None:
        """Mark ``t`` as the step's carry (see the class)."""
        self.carried.add(t.untyped_storage()._cdata)

    def settle(self) -> None:
        """Charge ``n`` times each carry that outlived the step consuming
        it."""
        for counter, key in self.pending:
            if counter._carried.pop(key, None) is not None:
                counter._charge(key, self.n)
        self.pending = []


# The open regions of repeated ops, innermost last, above the unit
# multiplicity of the ops outside any region; and the regions entered.
_REPEATS: list[Repeats] = [Repeats(1, 1)]
_REGIONS = [0]


def push_repeats(n: int) -> Repeats:
    """Open a region whose ops count ``n`` times over (within any open
    region's multiplicity); ``pop_repeats`` closes it.  For a region that
    one context manager cannot span, as a loop's backward pass."""
    region = Repeats(n, _REPEATS[-1].times * n)
    _REPEATS.append(region)
    _REGIONS[0] += 1
    return region


def open_regions() -> int:
    """The number of regions of repeated ops now open."""
    return len(_REPEATS) - 1


def pop_repeats() -> None:
    """Close the innermost region: each storage allocated in it and still
    live is charged ``n`` times (the carry once, until ``settle``), and
    counts as allocated in the enclosing region."""
    if len(_REPEATS) == 1:
        raise RuntimeError("no region of repeated ops is open")
    region = _REPEATS.pop()
    outer = _REPEATS[-1] if len(_REPEATS) > 1 else None
    for counter, key in dict.fromkeys(region.held):
        if key not in counter._storages:
            continue                           # a step's temporary
        if key in region.carried:
            counter._carried[key] = region.n
            region.pending.append((counter, key))
        else:
            counter._charge(key, region.n)
        if outer is not None:
            outer.held.append((counter, key))
    region.held = []


@contextlib.contextmanager
def repeated(n: int):
    """Within: every op counted ``n`` times over, the way the reference's
    parser counts a while loop's body by its trip count; yields the
    ``Repeats`` region."""
    region = push_repeats(n)
    try:
        yield region
    finally:
        pop_repeats()


class _Counter(TorchDispatchMode):
    """FLOPs, bytes, collectives and live storage bytes of the ops rank 0
    executes."""

    def __init__(self, sharded: bool):
        super().__init__()
        self.sharded = sharded
        self.flops = 0
        self.bytes = 0
        self.collective_bytes = {k: 0.0 for k in _COLLECTIVE_KINDS}
        self.collective_ops = {k: 0 for k in _COLLECTIVE_KINDS}
        self.live = 0
        self.peak = 0
        self._storages: dict[int, int] = {}     # storage key -> bytes charged
        self._carried: dict[int, int] = {}      # carries awaiting ``Repeats.settle``
        self._zeros: set[int] = set()           # zero tensors a backward pass made

    def hold(self, t: torch.Tensor, instead_of: int | None = None) -> None:
        """Count ``t``'s storage as live until its last tensor is freed;
        with ``instead_of``, a live storage of the same size whose bytes
        it takes over (see ``_IN_PLACE_ON_PLAIN``)."""
        storage = t.untyped_storage()
        key = storage._cdata
        if key in self._storages:
            return
        n = storage.nbytes()
        if instead_of is not None and self._storages.get(instead_of) == n:
            self._storages[key], self._storages[instead_of] = n, 0
        else:
            self._storages[key] = n
            self.live += n
            self.peak = max(self.peak, self.live)
        if len(_REPEATS) > 1:
            _REPEATS[-1].held.append((self, key))
        weakref.finalize(storage, self._free, key)

    def _charge(self, key: int, n: int) -> None:
        """Charge a live storage ``n`` times what it is charged now."""
        extra = (n - 1) * self._storages[key]
        self._storages[key] += extra
        self.live += extra
        self.peak = max(self.peak, self.live)

    def _free(self, key: int) -> None:
        self.live -= self._storages.pop(key)
        self._carried.pop(key, None)
        self._zeros.discard(key)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        dtensor = _dtensor_type()
        if dtensor is not None and any(issubclass(t, dtensor) for t in types):
            return NotImplemented          # DTensor runs it; its local ops come back here
        internal = _dtensor_internal() if self.sharded else None
        if internal == "indices":
            with unset_fake_temporarily():     # small index tensors, on real values
                return func(*args, **kwargs)
        out = func(*args, **kwargs)
        if internal == "metadata":
            return out
        times = _REPEATS[-1].times
        namespace, _, name = func.name().partition("::")
        kind = _COLLECTIVES.get((namespace, name.split(".")[0]))
        if kind is not None:
            self.collective_bytes[kind] += times * _tensor_bytes(out)
            self.collective_ops[kind] += times
        elif namespace != "_c10d_functional" and not func.is_view and _tensors(out):     # a query (device, item) moves nothing
            self.bytes += times * (_tensor_bytes(list(args)) + _tensor_bytes(dict(kwargs)) + _tensor_bytes(out))
        formula = flop_registry.get(func._overloadpacket)
        if formula is not None:
            self.flops += times * formula(*args, **kwargs, out_val=out)
        in_backward = torch._C._current_autograd_node() is not None
        instead_of = None
        if in_backward and func.overloadpacket in _IN_PLACE_ON_PLAIN:
            key = _local(args[0]).untyped_storage()._cdata
            instead_of = key if key in self._zeros else None
        for t in _tensors(out):
            self.hold(t, instead_of)
        if in_backward and func.overloadpacket in _ZEROS:
            self._zeros.update(t.untyped_storage()._cdata for t in _tensors(out))
        return out


def _clear_dtensor_caches() -> None:
    """Empty DTensor's caches of sharding decisions and output metadata,
    so that no decision from an earlier step (another arch's fake tensors,
    another mesh) is reused for this one; each call of ``count`` starts
    from the same state."""
    from torch.distributed.tensor import DTensor, debug

    clear = getattr(debug, "_clear_sharding_prop_cache", None)    # the C++ fast path's too, where it exists
    if clear is not None:
        clear()
    propagator = DTensor._op_dispatcher.sharding_propagator
    for name in ("propagate_op_sharding", "_propagate_tensor_meta_cached"):
        cached = getattr(propagator, name, None)
        if hasattr(cached, "cache_clear"):
            cached.cache_clear()


def _n_ranks(mesh) -> int:
    from repro_torch.launch.mesh import mesh_view

    return math.prod(mesh_view(mesh).shape.values())


def _local_shape(shape: tuple[int, ...], mesh, placements) -> tuple[int, ...]:
    """Rank 0's shard of a tensor of ``shape``: each ``Shard(d)`` cuts
    dimension d into that mesh dimension's size of chunks, in mesh order,
    and rank 0 keeps the first (``torch.chunk``'s split)."""
    local = list(shape)
    for size, place in zip(mesh.shape, placements):
        if place.is_shard():
            local[place.dim] = -(-local[place.dim] // size)
    return tuple(local)


def placed_args(bundle) -> tuple:
    """The bundle's abstract arguments as rank 0 holds them: on a mesh of
    one rank the fake tensors themselves; otherwise fake DTensors on the
    bundle's ``DeviceMesh`` under ``in_placements``, each holding a fake
    tensor of rank 0's shard."""
    from torch.distributed.tensor import DTensor, Replicate

    from repro_torch.launch.sharding import _spec_leaves
    from repro_torch.launch.steps import fake_mode

    mesh = bundle.mesh
    if _n_ranks(mesh) == 1:
        return bundle.args
    out = []
    with fake_mode(bundle.args):
        for arg, places in zip(bundle.args, bundle.in_placements):
            flat = leaves_with_paths(arg)
            pls = [p for _, p in _spec_leaves(places)]
            if len(pls) != len(flat):
                raise ValueError(f"{len(flat)} tensors but {len(pls)} placements")
            leaves = []
            for (_, t), pl in zip(flat, pls):
                # A shard over a mesh dimension of one rank is that rank's
                # whole tensor: replicated, which DTensor propagates with
                # fewer detours.
                pl = [Replicate() if n == 1 else p for n, p in zip(mesh.shape, pl)]
                local = torch.empty(_local_shape(t.shape, mesh, pl), dtype=t.dtype, device=t.device)
                leaves.append(DTensor.from_local(local, mesh, pl, run_check=False,
                                                 shape=t.shape, stride=t.stride()))
            out.append(tree_unflatten(arg, leaves))
    return tuple(out)


def argument_bytes(bundle) -> int:
    """The bytes of rank 0's shards of the bundle's arguments."""
    return _tensor_bytes(placed_args(bundle))


def count(bundle) -> tuple[HloCosts, dict]:
    """One call of ``bundle.fn`` (a ``launch.steps`` bundle) on rank 0's
    abstract arguments (``placed_args``; decode's position given as 0),
    counted: its ``HloCosts`` and its memory record, bytes per rank:
    ``argument_bytes`` (the arguments' shards, decode's position
    included), ``output_bytes`` (the outputs' shards), ``peak_bytes`` (the
    most live at once, arguments included) and ``temp_bytes`` (peak less
    arguments)."""
    from torch.distributed.tensor.experimental import implicit_replication

    from repro_torch.launch.steps import fake_mode

    placed = placed_args(bundle)
    args = (*placed[:3], 0) if bundle.shape.kind == "decode" else placed
    del _REPEATS[1:]
    _REGIONS[0] = 0
    sharded = _n_ranks(bundle.mesh) > 1
    counter = _Counter(sharded)
    for t in _tensors(placed):
        counter.hold(t)
    arg_bytes = counter.live
    with contextlib.ExitStack() as stack:
        if sharded:
            _clear_dtensor_caches()
            # As the reference runs its step under ``with mesh:``: the
            # model's ``constrain`` calls act, and plain tensors the step
            # makes (zeros, positions) count as replicated.
            stack.enter_context(bundle.mesh)
            stack.enter_context(implicit_replication())
        stack.enter_context(fake_mode(bundle.args))
        stack.enter_context(counter)
        out = bundle.fn(*args)
    if len(_REPEATS) != 1:
        raise RuntimeError(f"{len(_REPEATS) - 1} region(s) of repeated ops left open")
    seen, out_bytes = set(), 0
    for t in _tensors(out):
        storage = t.untyped_storage()
        if storage._cdata not in seen:
            seen.add(storage._cdata)
            out_bytes += storage.nbytes()
    coll = counter.collective_bytes
    costs = HloCosts(
        flops=float(counter.flops),
        bytes_accessed=float(counter.bytes),
        collective_bytes={**coll, "total": sum(coll.values())},
        collective_ops=counter.collective_ops,
        trip_counted_whiles=_REGIONS[0],
    )
    memory = {
        "argument_bytes": arg_bytes,
        "output_bytes": out_bytes,
        "temp_bytes": counter.peak - arg_bytes,
        "peak_bytes": counter.peak,
    }
    return costs, memory


def count_step(bundle) -> HloCosts:
    """FLOPs, bytes and collective bytes that rank 0 executes in one call
    of ``bundle.fn``."""
    return count(bundle)[0]
