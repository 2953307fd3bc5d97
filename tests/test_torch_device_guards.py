"""The hand kernels and the device defaults of the mesh layer, without JAX
(so that the card's tests run where JAX is not installed).

* ``make_host_mesh()`` builds on the card unless the caller asks for the
  host, and raises without a card.
* A DTensor on the host goes to each wrapper's plain version (torch ops),
  with no launch counted; on the card each wrapper raises a ``TypeError``
  naming its kernel (the test needs a card and skips without one).

Each test that starts a process group destroys it.
"""
import pytest
import torch
import torch.distributed as dist
from torch.distributed.tensor import Replicate, distribute_tensor
from torch.distributed.tensor.experimental import implicit_replication

from repro_torch import tracing
from repro_torch.kernels import flash_attention as fa_mod
from repro_torch.kernels import wkv6 as wkv6_mod
from repro_torch.kernels.matmul import matmul
from repro_torch.launch.mesh import make_host_mesh


@pytest.fixture
def host_mesh():
    """A 1x1 mesh over a one-rank gloo group, destroyed afterwards."""
    assert not dist.is_initialized()
    mesh = make_host_mesh(1, 1, device="cpu")
    try:
        yield mesh
    finally:
        dist.destroy_process_group()


def test_make_host_mesh_needs_the_card_unless_asked_for_the_host():
    if torch.cuda.is_available():
        pytest.skip("a card is present: make_host_mesh() builds on it")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        make_host_mesh()
    assert not dist.is_initialized()


def _kernel_calls(make):
    """Each hand-kernel wrapper with operands from ``make(shape, dtype)``."""
    q, k, v = (make((1, 16, 2, 16), torch.float32) for _ in range(3))
    r, kk, vv, w = (make((1, 8, 2, 8), torch.float32) for _ in range(4))
    u = make((2, 8), torch.float32)
    x, y = make((8, 4), torch.float32), make((4, 6), torch.float32)
    o = make((1, 16, 2, 16), torch.float32)
    dout = make((1, 8, 2, 8), torch.float32)
    return {
        "flash_attention": lambda: fa_mod.causal_attention(q, k, v, scale=0.25),
        "flash_attention_bwd": lambda: fa_mod.causal_attention_bwd(q, k, v, o, o, scale=0.25),
        "wkv6": lambda: wkv6_mod.wkv6(r, kk, vv, w, u),
        "wkv6_bwd": lambda: wkv6_mod.wkv6_bwd(r, kk, vv, w, u, None, dout),
        "block_matmul": lambda: matmul(x, y),
    }


def test_dtensors_on_the_host_take_the_plain_versions(host_mesh):
    g = torch.Generator().manual_seed(0)
    plain = _kernel_calls(lambda shape, dt: torch.rand(shape, generator=g, dtype=dt) * 0.5 + 0.25)
    g.manual_seed(0)
    dist_calls = _kernel_calls(lambda shape, dt: distribute_tensor(
        torch.rand(shape, generator=g, dtype=dt) * 0.5 + 0.25, host_mesh, [Replicate(), Replicate()]))
    counters = ("launches.causal_attention", "launches.wkv6", "launches.matmul")
    before = [tracing.counter(c) for c in counters]
    with implicit_replication():
        for name, call in dist_calls.items():
            want, got = plain[name](), call()
            for a, b in zip(want if isinstance(want, tuple) else (want,), got if isinstance(got, tuple) else (got,)):
                torch.testing.assert_close(b.full_tensor(), a, msg=name)
    assert [tracing.counter(c) for c in counters] == before


@pytest.mark.cuda
def test_dtensors_on_the_card_raise():
    """A DTensor reaching a hand kernel's wrapper on the card raises a
    TypeError naming the kernel, whatever its placements."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    mesh = make_host_mesh(1, 1)
    try:
        calls = _kernel_calls(lambda shape, dt: distribute_tensor(
            torch.rand(shape, dtype=dt, device="cuda"), mesh, [Replicate(), Replicate()]))
        for name, call in calls.items():
            with pytest.raises(TypeError, match=f"the {name} kernel takes plain CUDA tensors"):
                call()
    finally:
        dist.destroy_process_group()
