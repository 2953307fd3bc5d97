"""Loop-aware cost accounting over compiled (SPMD-partitioned) HLO text.

``compiled.cost_analysis()`` visits each while-loop body ONCE, so scanned
programs (layer stacks, microbatch accumulation, chunked attention) are
under-counted by the loop trip counts; and it reports no collective traffic
at all.  This parser fixes both:

* Computations are extracted from the HLO text with a per-instruction
  symbol table (name -> shape) so operand shapes can be resolved.
* Execution multiplicity per computation is propagated through the call
  graph: while bodies/conditions multiply by the loop's exact
  ``known_trip_count`` backend annotation (present for all lax.scan loops),
  fusion/call/to_apply edges inherit the caller's multiplicity.
* FLOPs: 2 * prod(result dims) * prod(lhs contracting dims) per dot,
  times multiplicity.  (Elementwise flops are excluded -- matmul-dominated
  models; the analysis reports cost_analysis' static number alongside.)
* Bytes: operand + result bytes per instruction, skipping the *insides* of
  fusion computations (fused ops don't touch HBM; the fusion instruction
  itself accounts for its operands/result), times multiplicity.  Sliced
  access is charged at slice size, not buffer size: dynamic-slice charges
  its result, dynamic-update-slice charges its update, and a fusion operand
  whose only internal uses are dynamic-slices/gathers is charged at the
  sliced sizes (scan bodies slice one layer's weights out of the stacked
  (n_groups, ...) buffers -- charging the full stack every iteration would
  overstate traffic ~500x).
* Collectives: result bytes of all-gather / all-reduce / reduce-scatter /
  all-to-all / collective-permute, times multiplicity.
"""
from __future__ import annotations

import dataclasses
import re
from collections import defaultdict

_DTYPE_BYTES = {
    "pred": 1, "s4": 1, "u4": 1, "s8": 1, "u8": 1,
    "f8e4m3fn": 1, "f8e5m2": 1, "f8e4m3b11fnuz": 1,
    "s16": 2, "u16": 2, "f16": 2, "bf16": 2,
    "s32": 4, "u32": 4, "f32": 4,
    "s64": 8, "u64": 8, "f64": 8, "c64": 8, "c128": 16,
}

_SHAPE_RE = re.compile(r"(\w+)\[([\d,]*)\]")
_COLLECTIVE_KINDS = (
    "all-gather",
    "all-reduce",
    "reduce-scatter",
    "all-to-all",
    "collective-permute",
)
_INSTR_RE = re.compile(r"^\s*(?:ROOT\s+)?(%[\w\.\-]+)\s*=\s*(.*)$")
_OPNAME_RE = re.compile(r"^((?:\([^=]*\))|(?:[\w\[\]\{\},\/\* ]+?))\s+([\w\-]+)\(")


def _shapes_in(type_str: str) -> list[tuple[str, list[int]]]:
    out = []
    for dtype, dims in _SHAPE_RE.findall(type_str):
        if dtype not in _DTYPE_BYTES:
            continue
        out.append((dtype, [int(d) for d in dims.split(",") if d]))
    return out


def _bytes_of(type_str: str) -> int:
    total = 0
    for dtype, dims in _shapes_in(type_str):
        n = 1
        for d in dims:
            n *= d
        total += n * _DTYPE_BYTES[dtype]
    return total


@dataclasses.dataclass
class Instr:
    name: str
    type_str: str       # result type portion
    op: str             # op name (add, dot, fusion, while, ...)
    rest: str           # full text after '='


@dataclasses.dataclass
class Computation:
    name: str
    instrs: list[Instr]


def _parse_computations(hlo_text: str) -> tuple[dict[str, Computation], str]:
    comps: dict[str, Computation] = {}
    entry_name = ""
    current: Computation | None = None
    for line in hlo_text.splitlines():
        stripped = line.strip()
        if stripped.endswith("{") and ("->" in stripped or stripped.startswith("ENTRY")):
            m = re.match(r"(?:ENTRY\s+)?(%?[\w\.\-]+)", stripped)
            name = m.group(1) if m else "?"
            current = Computation(name=name, instrs=[])
            comps[name] = current
            if stripped.startswith("ENTRY"):
                entry_name = name
            continue
        if stripped == "}":
            current = None
            continue
        if current is None:
            continue
        im = _INSTR_RE.match(line)
        if not im:
            # parameter declarations inside header already handled; also
            # lines like "%param = s32[] parameter(0)" DO match _INSTR_RE.
            continue
        name, rest = im.group(1), im.group(2)
        # Split result type from op: the op name is the token right before
        # the first '(' that isn't part of a tuple type.
        op = ""
        type_str = rest
        om = re.search(r"([\w\-]+)\(", rest)
        if om:
            op = om.group(1)
            type_str = rest[: om.start()]
        current.instrs.append(Instr(name=name, type_str=type_str, op=op, rest=rest))
    return comps, entry_name


def _trip_count(rest: str) -> float:
    m = re.search(r'known_trip_count":\{"n":"(\d+)"', rest)
    if m:
        return float(m.group(1))
    return 1.0


def _callees(instr: Instr) -> list[tuple[str, float]]:
    """(callee computation, multiplier) edges for one instruction."""
    out: list[tuple[str, float]] = []
    if instr.op == "while":
        trip = _trip_count(instr.rest)
        for key in ("condition", "body"):
            m = re.search(rf"{key}=(%?[\w\.\-]+)", instr.rest)
            if m:
                out.append((m.group(1), trip))
        return out
    m = re.search(r"calls=(%?[\w\.\-]+)", instr.rest)
    if m:
        out.append((m.group(1), 1.0))
    m = re.search(r"to_apply=(%?[\w\.\-]+)", instr.rest)
    if m:
        out.append((m.group(1), 1.0))
    for m in re.finditer(r"branch_computations=\{([^}]*)\}", instr.rest):
        for name in m.group(1).split(","):
            out.append((name.strip(), 1.0))
    return out


@dataclasses.dataclass
class HloCosts:
    flops: float                       # loop-aware dot flops (per device)
    bytes_accessed: float              # loop-aware HBM bytes (per device)
    collective_bytes: dict[str, float]
    collective_ops: dict[str, int]
    # While loops counted by their known trip count; from the port's
    # counter, the regions it repeated (``counter.repeated``: hymba's
    # sequential scan, forward and backward).
    trip_counted_whiles: int


def parse_hlo_costs(hlo_text: str) -> HloCosts:
    comps, entry = _parse_computations(hlo_text)

    # Symbol tables per computation: name -> result type string.
    symtab: dict[str, dict[str, str]] = {}
    for cname, comp in comps.items():
        tab = {}
        for ins in comp.instrs:
            tab[ins.name] = ins.type_str
        symtab[cname] = tab

    # Fusion-target computations (their internals don't touch HBM).
    fused_targets: set[str] = set()
    for comp in comps.values():
        for ins in comp.instrs:
            if ins.op == "fusion":
                m = re.search(r"calls=(%?[\w\.\-]+)", ins.rest)
                if m:
                    fused_targets.add(m.group(1))

    # Multiplicities via BFS from entry.
    mult: dict[str, float] = defaultdict(float)
    mult[entry] = 1.0
    n_whiles = 0
    frontier = [entry]
    seen_edges = set()
    while frontier:
        cname = frontier.pop()
        comp = comps.get(cname)
        if comp is None:
            continue
        for ins in comp.instrs:
            if ins.op == "while":
                n_whiles += 1
            for callee, k in _callees(ins):
                edge = (cname, ins.name, callee)
                if edge in seen_edges:
                    continue
                seen_edges.add(edge)
                mult[callee] += mult[cname] * k
                frontier.append(callee)

    flops = 0.0
    bytes_acc = 0.0
    coll_bytes = {k: 0.0 for k in _COLLECTIVE_KINDS}
    coll_ops = {k: 0 for k in _COLLECTIVE_KINDS}

    def operand_names(rest: str, op: str) -> list[str]:
        m = re.search(rf"{op}\(([^)]*)\)", rest)
        if not m:
            return []
        return re.findall(r"%[\w\.\-]+", m.group(1))

    # For fusion computations: effective bytes per parameter index.  If a
    # fused parameter is only consumed through dynamic-slice/gather, the
    # fusion reads only the slices, not the whole buffer.
    _PASSTHROUGH = ("bitcast", "reshape", "copy", "convert", "transpose")
    _SLICE_OPS = ("dynamic-slice", "gather", "slice")

    def fused_param_bytes(comp: Computation) -> dict[int, float]:
        tab = {i.name: i for i in comp.instrs}
        uses_of: dict[str, list[Instr]] = defaultdict(list)
        for ins in comp.instrs:
            for opn in re.findall(r"%[\w\.\-]+", ins.rest):
                if opn in tab and opn != ins.name:
                    uses_of[opn].append(ins)
        param_idx: dict[str, int] = {}
        for ins in comp.instrs:
            if ins.op == "parameter":
                pm = re.search(r"parameter\((\d+)\)", ins.rest)
                if pm:
                    param_idx[ins.name] = int(pm.group(1))

        def effective(pname: str) -> float:
            """Slice-size bytes if all terminal uses slice; else full size."""
            full = float(_bytes_of(tab[pname].type_str))
            total = 0.0
            frontier = [pname]
            visited = set()
            while frontier:
                n = frontier.pop()
                if n in visited:
                    continue
                visited.add(n)
                for u in uses_of.get(n, []):
                    if u.op in _SLICE_OPS:
                        total += _bytes_of(u.type_str)
                    elif u.op in _PASSTHROUGH:
                        frontier.append(u.name)
                    else:
                        return full       # consumed whole somewhere
            return min(total, full) if total > 0 else full

        return {idx: effective(p) for p, idx in param_idx.items()}

    fused_pb: dict[str, dict[int, float]] = {
        name: fused_param_bytes(comps[name])
        for name in fused_targets
        if name in comps
    }
    # Fusion output: if the root is a dynamic-update-slice, the write is the
    # update slice, not the full carry buffer.
    fused_out_bytes: dict[str, float] = {}
    for name in fused_targets:
        comp = comps.get(name)
        if comp is None or not comp.instrs:
            continue
        root = comp.instrs[-1]
        if root.op == "dynamic-update-slice":
            ops = operand_names(root.rest, root.op)
            if len(ops) >= 2 and ops[1] in symtab[name]:
                fused_out_bytes[name] = float(_bytes_of(symtab[name][ops[1]]))

    _SKIP_BYTES_OPS = (
        "parameter", "constant", "tuple", "get-tuple-element",
        "bitcast", "while", "conditional", "call", "custom-call",
        "after-all", "partition-id", "replica-id",
    )

    for cname, comp in comps.items():
        m = mult.get(cname, 0.0)
        if m <= 0.0:
            continue
        in_fusion = cname in fused_targets
        tab = symtab[cname]
        for ins in comp.instrs:
            # --- FLOPs: dots (also inside fusions -- they do real math).
            if ins.op == "dot":
                res_dims = 1
                for _, dims in _shapes_in(ins.type_str):
                    for d in dims:
                        res_dims *= d
                ops = operand_names(ins.rest, "dot")
                cdims = re.search(r"lhs_contracting_dims=\{([\d,]*)\}", ins.rest)
                contract = 1
                if ops and cdims:
                    lhs_type = tab.get(ops[0], "")
                    shapes = _shapes_in(lhs_type)
                    if shapes:
                        _, lhs_dims = shapes[0]
                        for ci in cdims.group(1).split(","):
                            if ci and int(ci) < len(lhs_dims):
                                contract *= lhs_dims[int(ci)]
                flops += 2.0 * res_dims * contract * m

            # --- collectives.
            base_op = ins.op.replace("-start", "").replace("-done", "")
            if base_op in _COLLECTIVE_KINDS and not ins.op.endswith("-done"):
                coll_bytes[base_op] += _bytes_of(ins.type_str) * m
                coll_ops[base_op] += 1

            # --- bytes: skip fusion internals; count real instructions.
            if in_fusion or ins.op in _SKIP_BYTES_OPS:
                continue
            if ins.op == "dynamic-slice" or ins.op == "gather":
                b = 2.0 * _bytes_of(ins.type_str)          # read slice + write
            elif ins.op == "dynamic-update-slice":
                ops = operand_names(ins.rest, ins.op)
                upd = (
                    _bytes_of(tab[ops[1]])
                    if len(ops) >= 2 and ops[1] in tab
                    else _bytes_of(ins.type_str)
                )
                b = 2.0 * upd                                # read + write slice
            elif ins.op == "fusion":
                cm = re.search(r"calls=(%?[\w\.\-]+)", ins.rest)
                callee = cm.group(1) if cm else ""
                pb = fused_pb.get(callee, {})
                ops = operand_names(ins.rest, "fusion")
                b = fused_out_bytes.get(callee, float(_bytes_of(ins.type_str)))
                for i_op, opn in enumerate(ops):
                    if opn in tab:
                        b += pb.get(i_op, float(_bytes_of(tab[opn])))
            else:
                b = float(_bytes_of(ins.type_str))
                for opn in re.findall(r"%[\w\.\-]+", ins.rest):
                    if opn in tab:
                        b += _bytes_of(tab[opn])
            bytes_acc += b * m

    return HloCosts(
        flops=flops,
        bytes_accessed=bytes_acc,
        collective_bytes={**coll_bytes, "total": sum(coll_bytes.values())},
        collective_ops=coll_ops,
        trip_counted_whiles=n_whiles,
    )


# Back-compat helpers --------------------------------------------------------
def parse_collective_bytes(hlo_text: str) -> dict[str, float]:
    return parse_hlo_costs(hlo_text).collective_bytes


def count_collective_ops(hlo_text: str) -> dict[str, int]:
    return parse_hlo_costs(hlo_text).collective_ops
