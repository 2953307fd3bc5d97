"""The port's ``matmul`` against the JAX package's ``ops.matmul``.

On CPU tensors the port's wrapper computes its plain version; the JAX side
runs the Pallas kernel in interpret mode, as ``tests/test_kernels.py`` runs
it.  The hand-written CUDA kernel itself is held against the plain version
by the one test here that needs a card (skipped without one) and by
``chip_smoke.py``.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops, ref
from repro_torch.kernels import matmul as matmul_mod
from repro_torch.kernels.matmul import matmul, matmul_plain
from repro_torch.models.cnn import PAPER_CNN_SPECS, pointwise_shapes

ALIGNED = [(128, 128, 128), (256, 128, 64), (64, 256, 128), (512, 64, 256)]
RAGGED = [(1, 1, 1), (37, 200, 13), (5, 3, 7), (129, 65, 31), (200, 1, 9)]
TOL = {"float32": 1e-3, "bfloat16": 2e-2}   # tests/test_kernels.py::TestMatmul


def _operands(shape, dtype, seed=0):
    """The same seeded numpy operands as a (jax, torch) pair of ``dtype``.
    bfloat16 is rounded from float32 the same way (to nearest even) on
    both sides."""
    m, k, n = shape
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((m, k), dtype=np.float32)
    y = rng.standard_normal((k, n), dtype=np.float32)
    jdt = getattr(jnp, dtype)
    tdt = getattr(torch, dtype)
    return (
        (jnp.asarray(x).astype(jdt), jnp.asarray(y).astype(jdt)),
        (torch.from_numpy(x).to(tdt), torch.from_numpy(y).to(tdt)),
    )


def _f32(a):
    if isinstance(a, torch.Tensor):
        return a.float().numpy()
    return np.asarray(a, np.float32)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", ALIGNED)
def test_aligned_shapes_match_reference(shape, dtype):
    (jx, jy), (tx, ty) = _operands(shape, dtype)
    want = ops.matmul(jx, jy, block_m=64, block_n=64, block_k=64)
    got = matmul(tx, ty)
    assert got.dtype == getattr(torch, dtype) and tuple(got.shape) == want.shape
    np.testing.assert_allclose(_f32(got), _f32(want), rtol=TOL[dtype], atol=TOL[dtype])


@pytest.mark.parametrize("shape", RAGGED)
def test_ragged_shapes_match_reference(shape):
    (jx, jy), (tx, ty) = _operands(shape, "float32", seed=1)
    want = ops.matmul(jx, jy, block_m=32, block_n=32, block_k=32)
    got = matmul(tx, ty)
    np.testing.assert_allclose(_f32(got), _f32(want), rtol=1e-3, atol=1e-3)


@pytest.mark.parametrize(
    "in_dtype,out_dtype", [("float32", "bfloat16"), ("bfloat16", "float32")]
)
def test_out_dtype_matches_reference(in_dtype, out_dtype):
    (jx, jy), (tx, ty) = _operands((48, 40, 24), in_dtype, seed=2)
    want = ref.matmul_ref(jx, jy, out_dtype=getattr(jnp, out_dtype))
    got = matmul(tx, ty, out_dtype=getattr(torch, out_dtype))
    assert got.dtype == getattr(torch, out_dtype)
    np.testing.assert_allclose(_f32(got), _f32(want), rtol=2e-2, atol=2e-2)


@pytest.mark.parametrize("name", ["inceptionv4", "mnasnet"])
def test_serve_mix_pointwise_shapes_match_reference(name):
    # The shapes the serving path gives the kernel, at full width.
    for i, shape in enumerate(pointwise_shapes(PAPER_CNN_SPECS[name])):
        (jx, jy), (tx, ty) = _operands(shape, "float32", seed=i)
        want = ref.matmul_ref(jx, jy)
        np.testing.assert_allclose(
            _f32(matmul(tx, ty)), _f32(want), rtol=1e-3, atol=1e-3
        )


def test_cpu_tensors_take_the_plain_version_without_launching():
    x, y = torch.ones(3, 4), torch.ones(4, 5)
    before = matmul.launches
    assert torch.equal(matmul(x, y), matmul_plain(x, y))
    assert matmul.launches == before


@pytest.mark.parametrize(
    "x,y,out_dtype,error",
    [
        (torch.ones(3, 4), torch.ones(5, 6), None, ValueError),        # inner dims
        (torch.ones(2, 3, 4), torch.ones(4, 5), None, ValueError),     # rank
        (torch.ones(3, 4), torch.ones(4, 5, dtype=torch.bfloat16), None, TypeError),
        (torch.ones(3, 4, dtype=torch.float64), torch.ones(4, 5, dtype=torch.float64), None, TypeError),
        (torch.ones(3, 4), torch.ones(4, 5), torch.float16, TypeError),
        (torch.ones(3, 4), torch.ones(4, 5, device="meta"), None, ValueError),
    ],
    ids=["inner-dims", "rank", "mixed-dtype", "float64", "out-float16", "devices"],
)
def test_wrapper_rejects_what_the_kernel_does_not_take(x, y, out_dtype, error):
    with pytest.raises(error):
        matmul(x, y, out_dtype=out_dtype)


def test_library_path_is_under_the_checkout_build_dir():
    path = matmul_mod.build.library_path("block_matmul")
    assert path.parent.parts[-2:] == ("build", "repro_torch")
    assert path.parent.parent.parent == matmul_mod.build.CSRC_DIR.parents[3]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cuda_kernel_matches_plain_version(dtype):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    shapes = ALIGNED + RAGGED + pointwise_shapes(PAPER_CNN_SPECS["inceptionv4"])
    for shape in shapes:
        _, (tx, ty) = _operands(shape, dtype)
        tx, ty = tx.cuda(), ty.cuda()
        before = matmul.launches
        got = matmul(tx, ty)
        torch.cuda.synchronize()
        assert matmul.launches == before + 1
        want = matmul_plain(tx, ty)
        torch.testing.assert_close(got.float(), want.float(), rtol=TOL[dtype], atol=TOL[dtype])
