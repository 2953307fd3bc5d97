"""The port's roofline package against the JAX package's.

``model_flops``, the HLO parser and the report are copies of the
reference's and are held ``==`` to it: on ``tests/test_roofline.py``'s
cases and HLO texts, on every arch x input shape, and on records built
here for every branch of the report.  The hardware constants copied from
``hw/specs.py`` equal the reference's.  The port's counter, which stands in
for XLA's cost analysis, is held to an independent count of a reduced
prefill bundle's products, and ``analyze_compiled`` to the reference's
output keys.  On fake meshes the counter counts what rank 0 executes: a
sharded product's local shard, half the FLOPs where the batch splits in
two; on one rank its FLOPs are ``FlopCounterMode``'s.
"""
import dataclasses
import math
import textwrap
from types import SimpleNamespace

import pytest
import torch
import torch.distributed as dist

from repro.configs import ARCHS as REF_ARCHS
from repro.configs import INPUT_SHAPES as REF_SHAPES
from repro.hw import specs as ref_specs
from repro.roofline import analysis as ref_analysis
from repro.roofline import hlo_parse as ref_hlo
from repro.roofline import report as ref_report
from repro_torch.configs import ARCHS, INPUT_SHAPES
from repro_torch.hw import specs
from repro_torch.launch import steps
from repro_torch.launch.mesh import MeshView
from repro_torch.roofline import analysis, hlo_parse, report
from repro_torch.roofline.counter import count_step
from tests.test_roofline import SIMPLE_HLO

NO_LOOP_HLO = textwrap.dedent(
    """
    HloModule t
    ENTRY %main (a: f32[64,32], b: f32[32,16]) -> f32[64,16] {
      %a = f32[64,32]{1,0} parameter(0)
      %b = f32[32,16]{1,0} parameter(1)
      ROOT %dot.0 = f32[64,16]{1,0} dot(%a, %b), lhs_contracting_dims={1}, rhs_contracting_dims={0}
    }
    """
)
ONE = MeshView({"data": 1, "model": 1}, ("data", "model"))


@pytest.mark.parametrize("shape_name", list(INPUT_SHAPES))
@pytest.mark.parametrize("name", list(ARCHS))
def test_model_flops_is_the_references(name, shape_name):
    got = analysis.model_flops(ARCHS[name], INPUT_SHAPES[shape_name])
    assert got == ref_analysis.model_flops(REF_ARCHS[name], REF_SHAPES[shape_name])


def test_model_flops_on_the_references_cases():
    """tests/test_roofline.py's TestModelFlops, on the port."""
    cfg = ARCHS["qwen1.5-0.5b"]
    assert analysis.model_flops(cfg, INPUT_SHAPES["train_4k"]) == pytest.approx(
        6.0 * cfg.active_param_count() * 256 * 4096)
    cfg = ARCHS["gemma3-1b"]
    assert analysis.model_flops(cfg, INPUT_SHAPES["decode_32k"]) == pytest.approx(
        2.0 * cfg.active_param_count() * 128)
    cfg = ARCHS["llama4-maverick-400b-a17b"]
    assert analysis.model_flops(cfg, INPUT_SHAPES["train_4k"]) < 0.1 * 6.0 * cfg.param_count() * 256 * 4096


@pytest.mark.parametrize("text", [SIMPLE_HLO, NO_LOOP_HLO], ids=["loop", "no-loop"])
def test_parse_hlo_costs_is_the_references(text):
    got, want = hlo_parse.parse_hlo_costs(text), ref_hlo.parse_hlo_costs(text)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert hlo_parse.parse_collective_bytes(text) == ref_hlo.parse_collective_bytes(text)
    assert hlo_parse.count_collective_ops(text) == ref_hlo.count_collective_ops(text)


def _records() -> list[dict]:
    """One record per branch of the report: skipped, error, and ok with
    each bottleneck (compute with a low and a high useful ratio; memory
    far above and near compute; collective with and without a breakdown)."""

    def ok(arch, shape, compute, memory, collective, useful, breakdown):
        terms = {"compute": compute, "memory": memory, "collective": collective}
        return {
            "arch": arch, "shape": shape, "status": "ok", "memory": {"peak_bytes": 3.5 * 2**30},
            "roofline": {"compute_s": compute, "memory_s": memory, "collective_s": collective,
                         "bottleneck": max(terms, key=terms.get), "model_flops": 1.25e15,
                         "useful_flops_ratio": useful, "collective_breakdown": breakdown},
        }

    return [
        {"arch": "qwen1.5-0.5b", "shape": "long_500k", "status": "skipped", "reason": "no long context " * 8},
        {"arch": "grok-1-314b", "shape": "decode_32k", "status": "error", "error": "out of memory " * 8},
        ok("gemma3-1b", "train_4k", 2.0, 1.0, 0.5, 0.3, {}),
        ok("gemma3-1b", "prefill_32k", 2.0, 1.0, 0.5, 0.8, {}),
        ok("rwkv6-7b", "train_4k", 0.01, 1.0, 0.5, 0.9, {}),
        ok("rwkv6-7b", "decode_32k", 0.5, 1.0, 0.25, 0.9, {}),
        ok("llama4-maverick-400b-a17b", "train_4k", 0.5, 1.0, 4.0, 0.9,
           {"all-gather": 3.0, "all-reduce": 9.0, "all-to-all": 1.0}),
        ok("hymba-1.5b", "train_4k", 0.5, 1.0, 4.0, 0.9, {}),
    ]


def test_report_is_the_references():
    recs = _records()
    assert report.markdown_table(recs) == ref_report.markdown_table(recs)
    for r in recs:
        if r["status"] == "ok":
            assert report._diagnose(r["roofline"]) == ref_report._diagnose(r["roofline"])


def test_report_load_sorts_as_the_reference(tmp_path):
    import json

    path = tmp_path / "dryrun.jsonl"
    path.write_text("".join(json.dumps(r) + "\n" for r in reversed(_records())))
    assert report.load(str(path)) == ref_report.load(str(path))


def test_tpu_constants_are_the_references():
    for name in ("TPU_V5E", "TPU_V5E_SERVING_PLATFORM"):
        assert dataclasses.asdict(getattr(specs, name)) == dataclasses.asdict(getattr(ref_specs, name))
    assert [f.name for f in dataclasses.fields(specs.TPUChipSpec)] == [
        f.name for f in dataclasses.fields(ref_specs.TPUChipSpec)]


def test_h100_spec():
    """The data sheet's H100 SXM figures (dense, 700 W) that PERF.md uses."""
    h = specs.H100_SXM
    assert (h.peak_flops_bf16, h.peak_flops_tf32, h.peak_flops_f32) == (989.4e12, 494.7e12, 66.9e12)
    assert (h.hbm_bw, h.hbm_bytes) == (3.35e12, 80 * 2**30)


def _independent_prefill_flops(cfg, b, s) -> float:
    """2 * M * K * N per product of a prefill of the reduced dense text
    model, from its config alone: per layer the q, k, v, o projections,
    both attention products over every (query, key) pair of every head (the
    plain version's), the SwiGLU's three matrices; then the unembedding of
    the last position."""
    t, d, hd = b * s, cfg.d_model, cfg.resolved_head_dim
    per_layer = (
        2 * t * d * cfg.n_heads * hd + 2 * 2 * t * d * cfg.n_kv_heads * hd + 2 * t * cfg.n_heads * hd * d
        + 2 * (2 * b * cfg.n_heads * s * s * hd)
        + 3 * 2 * t * d * cfg.d_ff
    )
    return float(cfg.n_layers * per_layer + 2 * b * d * cfg.vocab_size)


@pytest.mark.parametrize("name", ["qwen1.5-0.5b", "minicpm-2b"])
def test_counter_counts_a_prefill_bundles_products(name):
    cfg = ARCHS[name].reduced()
    assert cfg.mlp == "swiglu" and cfg.frontend == "none" and not cfg.is_moe
    shape = dataclasses.replace(INPUT_SHAPES["prefill_32k"], seq_len=32, global_batch=2)
    bundle = steps.build_step(cfg, shape, ONE)
    costs = count_step(bundle)
    assert costs.flops == _independent_prefill_flops(cfg, 2, 32)
    assert costs.bytes_accessed > 0
    assert costs.collective_bytes["total"] == 0 and set(costs.collective_bytes) == set(hlo_parse._COLLECTIVE_KINDS) | {"total"}


def test_counter_on_train_and_decode_bundles():
    """A train step's products from the prefill's: each layer's products
    run forward, again under remat, and twice backward (input and weight
    gradients), except that the recomputation stops once every tensor the
    backward saved is back (``torch.utils.checkpoint``'s early stop), which
    leaves out each layer's last product, the MLP's ``w_out``; the plain
    attention's backward is five products of the forward's two; the loss
    unembeds every position, forward and twice backward.  Decode counts one
    position."""
    cfg = ARCHS["qwen1.5-0.5b"].reduced()
    b, s = 2, 32
    pre = count_step(steps.build_step(
        cfg, dataclasses.replace(INPUT_SHAPES["prefill_32k"], seq_len=s, global_batch=b), ONE))
    train = count_step(steps.build_step(
        cfg, dataclasses.replace(INPUT_SHAPES["train_4k"], seq_len=s, global_batch=b), ONE))
    t, d = b * s, cfg.d_model
    lm_last = 2 * b * d * cfg.vocab_size
    body = pre.flops - lm_last                                 # every position's layers
    attention = cfg.n_layers * 2 * (2 * b * cfg.n_heads * s * s * cfg.resolved_head_dim)
    w_out = cfg.n_layers * 2 * t * cfg.d_ff * d
    assert train.flops == 4 * body + attention / 2 + 3 * s * lm_last - w_out
    decode = count_step(steps.build_step(
        cfg, dataclasses.replace(INPUT_SHAPES["decode_32k"], seq_len=s, global_batch=b), ONE))
    assert 0 < decode.flops < pre.flops


def test_analyze_compiled_has_the_references_keys():
    cfg, ref_cfg = ARCHS["qwen1.5-0.5b"].reduced(), REF_ARCHS["qwen1.5-0.5b"].reduced()
    shape = dataclasses.replace(INPUT_SHAPES["prefill_32k"], seq_len=32, global_batch=2)
    ref_shape = dataclasses.replace(REF_SHAPES["prefill_32k"], seq_len=32, global_batch=2)
    costs = count_step(steps.build_step(cfg, shape, ONE))
    got = analysis.analyze_compiled(cfg, shape, ONE, costs)
    compiled = SimpleNamespace(cost_analysis=lambda: {"flops": 1.0, "bytes accessed": 2.0},
                               as_text=lambda: SIMPLE_HLO)
    mesh = SimpleNamespace(devices=SimpleNamespace(size=1))
    want = ref_analysis.analyze_compiled(ref_cfg, ref_shape, mesh, compiled)
    assert set(got) == set(want) == {"roofline"}
    assert set(got["roofline"]) == set(want["roofline"])
    ro = got["roofline"]
    assert ro["flops_per_device"] == costs.flops and ro["n_chips"] == 1
    assert ro["compute_s"] == costs.flops / specs.H100_SXM.peak_flops_bf16
    assert ro["memory_s"] == costs.bytes_accessed / specs.H100_SXM.hbm_bw
    assert ro["model_flops"] == analysis.model_flops(cfg, shape)
    tpu = analysis.analyze_compiled(cfg, shape, ONE, costs, chip=specs.TPU_V5E)["roofline"]
    assert tpu["compute_s"] == costs.flops / specs.TPU_V5E.peak_flops_bf16
    assert math.isfinite(ro["useful_flops_ratio"]) and ro["bottleneck"] in ("compute", "memory", "collective")


# --------------------------------------------------------------------------
# Per-rank counts on fake meshes
# --------------------------------------------------------------------------
@pytest.fixture
def fake_group():
    """A fake process group of the asked size (its collectives move
    nothing), destroyed afterwards; none may be left over."""
    from torch.testing._internal.distributed.fake_pg import FakeStore

    started = []

    def start(n):
        assert not dist.is_initialized()
        dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=n)
        started.append(n)

    yield start
    if started:
        dist.destroy_process_group()
    assert not dist.is_initialized()


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _small(shape_name, **kw):
    return dataclasses.replace(INPUT_SHAPES[shape_name], seq_len=32, global_batch=4, **kw)


def test_a_sharded_product_counts_rank_zeros_shard(fake_group):
    """(64, 32) @ (32, 16) with rows Shard(0) over 4 ranks: rank 0 computes
    (16, 32) @ (32, 16), 16,384 FLOPs, where the DTensor-level op counts
    65,536; its bytes are the shards', and the product needs no collective."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor import DTensor, Replicate, Shard

    from repro_torch.roofline.counter import _Counter

    fake_group(4)
    mesh = init_device_mesh("cpu", (4,))
    mode = FakeTensorMode()
    with mode:
        a = DTensor.from_local(torch.empty(16, 32), mesh, [Shard(0)], run_check=False,
                               shape=torch.Size((64, 32)), stride=(32, 1))
        b = DTensor.from_local(torch.empty(32, 16), mesh, [Replicate()], run_check=False)
    counter = _Counter(sharded=True)
    with mode, counter:
        c = a @ b
    assert c.shape == (64, 16) and c.placements == (Shard(0),)
    assert counter.flops == 2 * 16 * 32 * 16 == 16_384
    assert counter.bytes == 4 * (16 * 32 + 32 * 16 + 16 * 16)
    assert sum(counter.collective_ops.values()) == 0


@pytest.mark.parametrize("shape_name", ["prefill_32k", "train_4k", "decode_32k"])
def test_counts_halve_when_the_batch_splits_over_two_ranks(fake_group, shape_name):
    """Reduced qwen1.5-0.5b on a fake 2 x 1 ("data", "model") mesh: every
    product's batch is halved and nothing else changes, so rank 0 counts
    exactly half the one-rank FLOPs."""
    from repro_torch.launch.dryrun import dryrun_mesh

    cfg, shape = ARCHS["qwen1.5-0.5b"].reduced(), _small(shape_name)
    one = count_step(steps.build_step(cfg, shape, ONE))
    fake_group(2)
    two = count_step(steps.build_step(cfg, shape, dryrun_mesh((2, 1), ("data", "model"))))
    assert two.flops * 2 == one.flops


@pytest.mark.parametrize("shape_name", ["prefill_32k", "train_4k"])
def test_counts_on_a_model_axis_of_two(fake_group, shape_name):
    """On a fake 1 x 2 mesh the heads and the MLP's columns split and the
    norms, embeddings and loss stay whole: rank 0 counts between half the
    one-rank FLOPs and all of them, and its activations' all-reduces and
    gathers move bytes."""
    from repro_torch.launch.dryrun import dryrun_mesh

    cfg, shape = ARCHS["qwen1.5-0.5b"].reduced(), _small(shape_name)
    one = count_step(steps.build_step(cfg, shape, ONE))
    fake_group(2)
    two = count_step(steps.build_step(cfg, shape, dryrun_mesh((1, 2), ("data", "model"))))
    assert one.flops / 2 <= two.flops <= one.flops
    assert two.collective_bytes["total"] > 0


@pytest.mark.parametrize("shape_name", ["prefill_32k", "train_4k", "decode_32k"])
@pytest.mark.parametrize("name", list(ARCHS))
def test_counter_flops_are_flop_counter_modes_on_one_rank(monkeypatch, name, shape_name):
    """On one rank the counter's FLOPs are ``FlopCounterMode``'s over the
    same call (the hand kernels' fake forms included), for every reduced
    arch and kind of step.  ``FlopCounterMode`` sees hymba's sequential
    scan run token by token, the counter its repeated step."""
    from torch.utils.flop_counter import FlopCounterMode

    from repro_torch.models import ssm as ssm_mod

    cfg = ARCHS[name].reduced()
    bundle = steps.build_step(cfg, _small(shape_name), ONE)
    args = (*bundle.args[:3], 0) if shape_name == "decode_32k" else bundle.args
    flops = FlopCounterMode(display=False)
    monkeypatch.setattr(ssm_mod, "is_fake", lambda t: False)
    with steps.fake_mode(bundle.args), flops:
        bundle.fn(*args)
    monkeypatch.undo()
    assert count_step(bundle).flops == flops.get_total_flops() > 0


@pytest.mark.parametrize("gathered", ["index", "gather"])
def test_counter_charges_a_zero_filled_gradient_as_plain_tensors_hold_it(gathered):
    """Indexing's backward (``index_put``, an embedding table's) and
    ``gather``'s (``scatter_add``) write into a fresh zero tensor in place
    on plain tensors, out of place under the counter's dispatch mode: the
    counter charges the table's gradient once, not twice."""
    from repro_torch.roofline import counter

    table = torch.randn(4096, 64, requires_grad=True)
    idx = torch.randint(0, 4096, (256,))
    n = table.numel() * table.element_size()
    c = counter._Counter(False)
    for t in (table, idx):
        c.hold(t)
    base = c.live
    with c:
        rows = table[idx] if gathered == "index" else table.gather(0, idx[:, None].expand(-1, 64))
        (grad,) = torch.autograd.grad(rows.square().sum(), table)
    assert grad.shape == table.shape
    small = 8 * rows.numel() * rows.element_size()
    assert n <= c.peak - base < n + small, (c.peak - base, n)
