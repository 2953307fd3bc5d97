"""The ``selective_scan`` kernel's wrapper and plain version
(``repro_torch/kernels/selective_scan.py``) against ``models/ssm.py``'s
sequential scan and the JAX package's, and the kernel on the card.

On the CPU the wrapper computes ``selective_scan_plain``, the kernel's
segment algorithm in PyTorch; it is held to the port's and the JAX
package's sequential scans at mild and strong decays, at lengths that
leave a ragged last segment, at the segment length the card would take and
at the longest.  The JAX package is imported inside the one test that uses
it, so that the card's tests run where JAX is not installed.  DTensors take
the kernel's route on each rank's shards, checked on a fake two-rank group.

On the card (skipped without one) the kernel is held per output row to the
plain version and to a float64 sequential scan at hymba-1.5b's full width,
in bfloat16 and float32, two calls must be bitwise equal, the launch
counter must follow the dispatch rule of ``selective_scan_chunked``, the
row limit must catch a planted fault (a segment entered from a zero
state), and DTensors on a 1 x 1 mesh must take the kernel.
"""
import re

import numpy as np
import pytest
import torch
import torch.distributed as dist

from repro_torch import tracing
from repro_torch.kernels import build
from repro_torch.kernels import selective_scan as scan_mod
from repro_torch.kernels.selective_scan import segment_len, selective_scan, selective_scan_plain
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.models import ssm

TOL = 1e-5                 # float32 against float32, the arithmetic the same up to order
ROW_TOL = 1e-4             # the card's per-row limit (``_row_err``)
HYMBA_D, HYMBA_N = 3200, 16


def _inputs(b, s, d, n, seed, dt_shift, with_h0, dtype=torch.float32, device="cpu"):
    """u, B_t, C_t, dt (pre-softplus), A, h0 from numpy's generator: the
    reference's test distribution (``tests/test_torch_ssm.py``) with dt
    shifted by ``dt_shift`` (-3: softplus about 0.05, a state that lasts
    some 20 tokens; +6: about 6, a chunk of 32 summing far past float32's
    exp limit).  u, B_t, C_t, dt in ``dtype``; A and h0 float32."""
    rng = np.random.default_rng(seed)
    u = rng.standard_normal((b, s, d))
    bt = rng.standard_normal((b, s, n)) * 0.5
    ct = rng.standard_normal((b, s, n)) * 0.5
    dt = rng.standard_normal((b, s, d)) * 0.5 + dt_shift
    a = np.exp(rng.standard_normal(d) * 0.2)
    h0 = rng.standard_normal((b, d, n)) * 0.5 if with_h0 else np.zeros((b, d, n))
    ins = [torch.from_numpy(v.astype(np.float32)).to(device) for v in (u, bt, ct, dt, a, h0)]
    return [v.to(dtype) for v in ins[:4]] + ins[4:]


@pytest.mark.parametrize("decays", [-3.0, 6.0], ids=["mild", "strong"])
@pytest.mark.parametrize("with_h0", [False, True], ids=["zero_h0", "random_h0"])
@pytest.mark.parametrize("s", [2, 31, 37, 96, 1000])
def test_plain_version_matches_the_sequential_scans(s, with_h0, decays, monkeypatch):
    """The segment algorithm against ``ssm.selective_scan`` and the JAX
    package's ``selective_scan``, segmented as an H100 would be and into
    segments of 1, 7 and SEG_MAX tokens (ragged last segments)."""
    from repro.models import ssm as ref_ssm   # JAX, on the CPU only
    import jax.numpy as jnp

    args = _inputs(2, s, 12, 8, seed=s, dt_shift=decays, with_h0=with_h0)
    want_y, want_h = ssm.selective_scan(*args)
    ref_y, ref_h = ref_ssm.selective_scan(*(jnp.asarray(a.numpy()) for a in args))
    results = [selective_scan(*args)]
    for seg in (1, 7, scan_mod.SEG_MAX):
        monkeypatch.setattr(scan_mod, "segment_len", lambda *shape, seg=seg: seg)
        results.append(selective_scan_plain(*args))
    for y, h in results:
        assert y.dtype == h.dtype == torch.float32 and y.shape == want_y.shape and h.shape == want_h.shape
        torch.testing.assert_close(y, want_y, rtol=TOL, atol=TOL)
        torch.testing.assert_close(h, want_h, rtol=TOL, atol=TOL)
        np.testing.assert_allclose(y.numpy(), np.asarray(ref_y), rtol=TOL, atol=TOL)
        np.testing.assert_allclose(h.numpy(), np.asarray(ref_h), rtol=TOL, atol=TOL)


def test_segments_fill_one_wave_of_the_card():
    """hymba's prompts at batch 1 take one wave of an H100 (132 SMs x 8
    blocks of 128 channels), each of 25 channel blocks as many segments as
    fit; past SEG_MAX tokens a segment, whole waves more.  A CPU call
    segments as an H100 would."""
    sms = scan_mod.H100_SMS
    wave = sms * scan_mod.MIN_BLOCKS
    blocks = -(-HYMBA_D // scan_mod.THREADS)
    for s, seg in {1024: 25, 2048: 49, 3072: 74, 4096: 98}.items():
        assert segment_len(1, s, HYMBA_D, sms) == seg
        assert (wave // blocks - 1) * blocks <= -(-s // seg) * blocks <= wave
    seg = segment_len(1, 8192, HYMBA_D, sms)
    assert seg <= scan_mod.SEG_MAX and -(-8192 // seg) == 2 * (wave // blocks)
    assert segment_len(64, 4096, HYMBA_D, sms) == scan_mod.SEG_MAX
    assert segment_len(1, 2, 12, sms) == 1
    assert segment_len(1, 4096, HYMBA_D, 66) == 98    # two waves of 21 segments
    assert scan_mod._sms(torch.device("cpu")) == sms


def test_kernel_constants_mirror_the_wrapper():
    """The .cu's state size, block width, longest segment (its static
    shared memory) and blocks an SM (its launch bounds) are the wrapper's;
    the source has no atomics."""
    src = (build.CSRC_DIR / "selective_scan.cu").read_text()
    for name, want in (("N", scan_mod.N_STATE), ("THREADS", scan_mod.THREADS), ("MAX_SEG", scan_mod.SEG_MAX),
                       ("MIN_BLOCKS", scan_mod.MIN_BLOCKS)):
        assert int(re.search(rf"constexpr int {name} = (\d+);", src).group(1)) == want
    assert not re.search(r"\batomic\w*\s*\(|\batom\.|\bred\.", src)


def test_wrapper_refuses_what_the_kernel_does_not_take():
    u, bt, ct, dt, a, h0 = _inputs(1, 8, 6, 4, seed=0, dt_shift=0.0, with_h0=True)
    with pytest.raises(TypeError):                                   # u, dt, B_t, C_t share a type
        selective_scan(u.double(), bt, ct, dt.double(), a, h0)
    with pytest.raises(TypeError):
        selective_scan(u, bt, ct, dt.bfloat16(), a, h0)
    with pytest.raises(TypeError):                                   # A and h0 float32
        selective_scan(u, bt, ct, dt, a.bfloat16(), h0)
    with pytest.raises(ValueError):                                  # shapes
        selective_scan(u, bt[:, :, :3], ct, dt, a, h0)
    with pytest.raises(ValueError):
        selective_scan(u, bt, ct, dt, a, h0[:, :, :3])
    with pytest.raises(ValueError):
        selective_scan(u, bt, ct, dt, a[:5], h0)
    with pytest.raises(ValueError):
        selective_scan(u[:, :0], bt[:, :0], ct[:, :0], dt[:, :0], a, h0)
    with pytest.raises(ValueError):                                  # one device
        selective_scan(u, bt, ct, dt, a, h0.to("meta"))
    with pytest.raises(ValueError):                                  # cpu or cuda
        selective_scan(*(t.to("meta") for t in (u, bt, ct, dt, a, h0)))
    with pytest.raises(ValueError):                                  # contiguous
        selective_scan(u.mT.contiguous().mT, bt, ct, dt, a, h0)
    with pytest.raises(ValueError):
        selective_scan(u, bt, ct.mT.contiguous().mT, dt, a, h0)
    before = tracing.counter("launches.selective_scan")
    selective_scan(u, bt, ct, dt, a, h0)
    assert tracing.counter("launches.selective_scan") == before     # the plain version launches nothing


def test_chunked_scan_under_autograd_keeps_the_closed_form():
    """Neither CPU nor fake tensors take the kernel; under autograd the
    chunked scan's gradient is the sequential scan's, as before."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    args = [t.requires_grad_(True) for t in _inputs(2, 64, 12, 16, seed=1, dt_shift=-3.0, with_h0=True)]
    assert not ssm._takes_kernel(*args)
    with torch.no_grad():
        assert not ssm._takes_kernel(*args)
    with FakeTensorMode():
        fake = [torch.empty(t.shape, device="cuda") for t in args]
    assert not ssm._takes_kernel(*fake)
    before = tracing.counter("launches.selective_scan")
    g = torch.Generator().manual_seed(2)
    dy, dh = torch.randn(2, 64, 12, generator=g), torch.randn(2, 12, 16, generator=g)
    grads = []
    for fn in (ssm.selective_scan_chunked, ssm.selective_scan):
        y, h = fn(*args)
        grads.append(torch.autograd.grad((y * dy).sum() + (h * dh).sum(), args))
    assert tracing.counter("launches.selective_scan") == before
    for got, want in zip(*grads):
        torch.testing.assert_close(got, want, rtol=1e-3, atol=1e-3)


def _rank0_shard(t, mesh, placements):
    """Rank 0's shard of ``t`` under ``placements`` on ``mesh``, as a DTensor."""
    from torch.distributed.tensor import DTensor

    local = t
    for i, p in enumerate(placements):
        if p.is_shard():
            local = local.narrow(p.dim, 0, local.shape[p.dim] // mesh.size(i))
    return DTensor.from_local(local.contiguous(), mesh, placements, run_check=False)


@pytest.mark.parametrize("layout", ["batch", "channels"])
def test_sharded_scan_runs_on_each_ranks_shards(layout):
    """On DTensors the chunked scan's kernel route runs the wrapper on each
    rank's shards: on a 2 x 1 mesh the batch rows over 'data', on a 1 x 2
    mesh the d_inner channels over 'model' (a fake two-rank group, seen
    from rank 0: its collectives move nothing, and the scan needs none).
    Rank 0's shards of y and of the final state are the full scan's, and
    they keep x's and h0's placements; h0 comes as a plain tensor, as
    ``ssm_forward`` makes it."""
    from torch.distributed.tensor import DTensor, Replicate, Shard
    from torch.testing._internal.distributed.fake_pg import FakeStore

    u, bt, ct, dt, a, h0 = _inputs(2, 37, 12, 8, seed=7, dt_shift=-3.0, with_h0=True)
    want_y, want_h = ssm.selective_scan(u, bt, ct, dt, a, h0)
    assert not dist.is_initialized()
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=2)
    try:
        if layout == "batch":
            mesh = make_host_mesh(2, 1, device="cpu")
            px, pn, pa, ph = (Shard(0), Replicate()), (Shard(0), Replicate()), (Replicate(), Replicate()), \
                (Shard(0), Replicate())
            rows, chans = slice(0, 1), slice(None)
        else:
            mesh = make_host_mesh(1, 2, device="cpu")
            px, pn, pa, ph = (Replicate(), Shard(2)), (Replicate(), Replicate()), (Replicate(), Shard(0)), \
                (Replicate(), Shard(1))
            rows, chans = slice(None), slice(0, 6)
        before = tracing.counter("launches.selective_scan")
        shards = [_rank0_shard(t, mesh, p) for t, p in ((u, px), (bt, pn), (ct, pn), (dt, px), (a, pa))]
        y, h = ssm._kernel_scan(*shards, h0)
        assert tracing.counter("launches.selective_scan") == before      # the host's plain version
        assert isinstance(y, DTensor) and isinstance(h, DTensor)
        assert y.placements == px and h.placements == ph
        assert y.shape == want_y.shape and h.shape == want_h.shape
        torch.testing.assert_close(y.to_local(), want_y[rows, :, chans], rtol=TOL, atol=TOL)
        torch.testing.assert_close(h.to_local(), want_h[rows, chans], rtol=TOL, atol=TOL)
    finally:
        dist.destroy_process_group()


def _needs_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")


def _sequential64(u, bt, ct, dt, a, h0):
    """The recurrence token by token in float64, a yardstick."""
    u, bt, ct, dt, a, h = (t.double() for t in (u, bt, ct, dt, a, h0))
    sp = torch.nn.functional.softplus(dt)
    decay, inp = torch.exp(-sp * a), sp * u
    ys = []
    for t in range(u.shape[1]):
        h = decay[:, t, :, None] * h + inp[:, t, :, None] * bt[:, t, None, :]
        ys.append(torch.einsum("bdn,bn->bd", h, ct[:, t]))
    return torch.stack(ys, dim=1), h


def _row_err(got, want):
    """Largest ||got_t - want_t|| / ||want_t|| over the rows of d channels
    (output rows of every token, state rows of every channel), the norm
    floored at 0.1 of the RMS row norm."""
    got, want = got.double().reshape(-1, got.shape[-1]), want.double().reshape(-1, want.shape[-1])
    norms = want.norm(dim=-1)
    floor = 0.1 * float(norms.square().mean().sqrt())
    return float(((got - want).norm(dim=-1) / norms.clamp_min(floor)).max())


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("s", [1000, 1024, 4096])
def test_cuda_kernel_matches_plain_version_and_float64(s, dtype, monkeypatch):
    """At hymba-1.5b's width (1, S, 3200, 16): the kernel against the plain
    version and a float64 sequential scan, per row within ROW_TOL, at mild
    and strong decays, from a zero and a random state; a second call
    bitwise equal; one launch counted a call; and a planted fault (the
    middle segment entered from a zero state) past ROW_TOL."""
    _needs_card()
    for decays in (-3.0, 6.0):
        for with_h0 in (False, True):
            args = _inputs(1, s, HYMBA_D, HYMBA_N, seed=s, dt_shift=decays, with_h0=with_h0,
                           dtype=getattr(torch, dtype), device="cuda")
            before = tracing.counter("launches.selective_scan")
            y, h = selective_scan(*args)
            y2, h2 = selective_scan(*args)
            torch.cuda.synchronize()
            assert tracing.counter("launches.selective_scan") == before + 2
            assert torch.equal(y, y2) and torch.equal(h, h2)
            assert torch.isfinite(y).all() and torch.isfinite(h).all()
            exact = _sequential64(*args)
            plain = selective_scan_plain(*args)
            label = f"S={s} {dtype} dt shift {decays} h0={'random' if with_h0 else 'zero'}"
            for got, want, what in ((y, exact[0], "y vs float64"), (h, exact[1], "state vs float64"),
                                    (y, plain[0], "y vs plain"), (h, plain[1], "state vs plain")):
                err = _row_err(got, want)
                assert err <= ROW_TOL, f"{label}: {what} row error {err:.3e}"
            n_seg = -(-s // segment_len(1, s, HYMBA_D, scan_mod._sms(y.device)))
            real = scan_mod._entering_states

            def cut(decay, local, h0, k=n_seg // 2):
                h_in, h_final = real(decay, local, h0)
                h_in[:, k] = 0
                return h_in, h_final

            monkeypatch.setattr(scan_mod, "_entering_states", cut)
            fault = _row_err(selective_scan_plain(*args)[0], exact[0])
            monkeypatch.setattr(scan_mod, "_entering_states", real)
            assert fault > ROW_TOL, f"{label}: the row limit cannot see a segment entered from zero ({fault:.3e})"


@pytest.mark.cuda
def test_cuda_dispatch_counts_a_launch_only_without_a_gradient():
    """``selective_scan_chunked`` on the card launches the kernel once a
    call when no gradient is needed (also at an S that the chunk does not
    divide), and none under autograd, where a gradient flows through the
    closed form; the wrapper itself refuses a call autograd would record."""
    _needs_card()
    before = tracing.counter("launches.selective_scan")
    for s in (1000, 96, 2):
        ssm.selective_scan_chunked(*_inputs(1, s, 256, HYMBA_N, seed=s, dt_shift=-3.0, with_h0=True, device="cuda"))
    assert tracing.counter("launches.selective_scan") == before + 3
    leaves = [t.requires_grad_(True) for t in _inputs(1, 96, 256, HYMBA_N, seed=3, dt_shift=-3.0, with_h0=True,
                                                         device="cuda")]
    y, h = ssm.selective_scan_chunked(*leaves)
    grads = torch.autograd.grad(y.sum() + h.sum(), leaves)
    torch.cuda.synchronize()
    assert tracing.counter("launches.selective_scan") == before + 3
    assert all(g is not None and torch.isfinite(g).all() for g in grads)
    with pytest.raises(NotImplementedError):
        selective_scan(*leaves)


@pytest.mark.cuda
def test_cuda_profiler_range_around_the_chunked_scan_sees_the_kernel():
    """A profiler range around ``selective_scan_chunked`` (as the benchmark
    draws one for ``scan_share.prefill``) holds the device time of the
    kernel's three launches: the wrapper encloses them in a function-scope
    event, without which the profiler links them to no range."""
    _needs_card()
    from torch.profiler import ProfilerActivity, profile, record_function

    args = _inputs(1, 1024, HYMBA_D, HYMBA_N, seed=5, dt_shift=-3.0, with_h0=False, dtype=torch.bfloat16,
                   device="cuda")
    ssm.selective_scan_chunked(*args)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(5):
            with record_function("scan_range"):
                ssm.selective_scan_chunked(*args)
        torch.cuda.synchronize()
    events = prof.key_averages()
    ranged = sum(e.device_time_total for e in events if e.key == "scan_range"
                 and e.device_type == torch.autograd.DeviceType.CPU)
    kernels = sum(e.device_time_total for e in events if e.device_type == torch.autograd.DeviceType.CUDA
                  and re.search(r"(maps|compose|outputs)_kernel", e.key))
    assert kernels > 0 and ranged >= kernels


@pytest.mark.cuda
def test_cuda_dtensors_take_the_kernel_on_their_shards():
    """On the card DTensors that need no gradient take the kernel through
    ``selective_scan_chunked`` on each rank's shards (a 1 x 1 mesh, batch
    and d_inner sharded): one launch counted, outputs under x's and h0's
    placements and bitwise equal to the plain tensors' kernel call."""
    _needs_card()
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor

    args = _inputs(2, 1000, HYMBA_D, HYMBA_N, seed=11, dt_shift=-3.0, with_h0=True, dtype=torch.bfloat16,
                   device="cuda")
    want_y, want_h = selective_scan(*args)
    assert not dist.is_initialized()
    mesh = make_host_mesh(1, 1)
    try:
        px, pn = (Shard(0), Shard(2)), (Shard(0), Replicate())
        u, bt, ct, dt = (distribute_tensor(t, mesh, p) for t, p in zip(args[:4], (px, pn, pn, px)))
        before = tracing.counter("launches.selective_scan")
        y, h = ssm.selective_scan_chunked(u, bt, ct, dt, *args[4:])
        assert tracing.counter("launches.selective_scan") == before + 1
        assert y.placements == px and h.placements == (Shard(0), Shard(1))
        assert torch.equal(y.full_tensor(), want_y) and torch.equal(h.full_tensor(), want_h)
    finally:
        dist.destroy_process_group()
