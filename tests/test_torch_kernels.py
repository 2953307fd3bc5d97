"""The port's ``matmul`` against the JAX package's ``ops.matmul``.

On CPU tensors the port's wrapper computes its plain version; the JAX side
runs the Pallas kernel in interpret mode, as ``tests/test_kernels.py`` runs
it.  The hand-written CUDA kernel itself is held against the plain version
by the one test here that needs a card (skipped without one) and by
``chip_smoke.py``.
"""
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops, ref
from repro_torch import tracing
from repro_torch.kernels import matmul as matmul_mod
from repro_torch.kernels.matmul import matmul, matmul_plain
from repro_torch.models.cnn import PAPER_CNN_SPECS, pointwise_shapes

ALIGNED = [(128, 128, 128), (256, 128, 64), (64, 256, 128), (512, 64, 256)]
RAGGED = [(1, 1, 1), (37, 200, 13), (5, 3, 7), (129, 65, 31), (200, 1, 9)]
TOL = {"float32": 1e-3, "bfloat16": 2e-2}   # tests/test_kernels.py::TestMatmul
# (M, K, N) that the tensor-core route takes in bfloat16: ragged tiles with
# 16-byte rows, one K stage short of a whole one, and the 4096^3 yardstick.
TENSOR_CORE_SHAPES = [(200, 64, 264), (1000, 1032, 520), (128, 128, 128), (4096, 4096, 4096)]
# K or N not a multiple of 8: rows are not whole 16-byte chunks.
UNALIGNED_ROWS = [(4096, 4100, 4096), (4096, 4096, 4100), (1000, 1030, 520), (1000, 1032, 522)]


def _path_shapes():
    return [s for name in ("inceptionv4", "mnasnet") for s in pointwise_shapes(PAPER_CNN_SPECS[name])]


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
    before = tracing.counter("launches.matmul")
    assert torch.equal(matmul(x, y), matmul_plain(x, y))
    assert tracing.counter("launches.matmul") == before


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


@pytest.mark.parametrize(
    "shape", ALIGNED + RAGGED + TENSOR_CORE_SHAPES + UNALIGNED_ROWS + _path_shapes()
)
def test_route_keeps_every_float32_call_on_the_cuda_cores(shape):
    m, k, n = shape
    assert matmul_mod.route(torch.float32, m, n, k) == "cuda-core"


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_route_keeps_the_serving_paths_products_on_the_cuda_cores(dtype):
    for m, k, n in _path_shapes():
        assert matmul_mod.route(dtype, m, n, k) == "cuda-core", (m, k, n)


@pytest.mark.parametrize("shape", TENSOR_CORE_SHAPES)
def test_route_puts_large_bf16_with_16_byte_rows_on_the_tensor_cores(shape):
    m, k, n = shape
    assert m * n * k >= matmul_mod.TENSOR_CORE_MIN_MNK
    assert matmul_mod.route(torch.bfloat16, m, n, k) == "tensor-core"


@pytest.mark.parametrize("shape", UNALIGNED_ROWS + RAGGED)
def test_route_keeps_bf16_rows_that_are_not_16_byte_chunks_on_the_cuda_cores(shape):
    m, k, n = shape
    assert matmul_mod.route(torch.bfloat16, m, n, k) == "cuda-core"


def test_route_threshold_is_inclusive():
    t = matmul_mod.TENSOR_CORE_MIN_MNK
    assert matmul_mod.route(torch.bfloat16, t // 64, 8, 8) == "tensor-core"
    assert matmul_mod.route(torch.bfloat16, t // 64 - 1, 8, 8) == "cuda-core"


def test_route_mirrors_the_c_dispatch():
    """``block_matmul.cu`` sends to ``tc::launch`` exactly the calls that
    ``route`` names ``"tensor-core"``: the same threshold, the same
    condition; float32 and the rest go to the CUDA-core dispatch."""
    src = (matmul_mod.build.CSRC_DIR / "block_matmul.cu").read_text()
    (threshold,) = re.findall(r"#define BLOCK_MATMUL_TC_MIN_MNK (\d+)LL", src)
    assert int(threshold) == matmul_mod.TENSOR_CORE_MIN_MNK
    entry = " ".join(src[src.index('extern "C" int block_matmul('):].split())
    assert (
        "if (in_bf16 && k % 8 == 0 && n % 8 == 0 && "
        "static_cast<long long>(m) * n * k >= BLOCK_MATMUL_TC_MIN_MNK) "
        "return out_bf16 ? tc::launch<bf16>(a, b, c, m, n, k, s) : tc::launch<float>(a, b, c, m, n, k, s);"
    ) in entry
    assert entry.count("tc::launch") == 2
    assert "cc::dispatch<float, float>" in entry and "cc::dispatch<bf16, bf16>" in entry


def _misaligned(shape, dtype):
    """A contiguous view whose data starts one element past an aligned base."""
    n = int(np.prod(shape))
    return torch.zeros(n + 1, dtype=dtype)[1:].view(shape)


@pytest.mark.parametrize("which", ["x", "y"])
def test_alignment_check_rejects_a_misaligned_view_on_the_tensor_core_route(which):
    ops_ = {"x": torch.zeros(200, 64, dtype=torch.bfloat16), "y": torch.zeros(64, 264, dtype=torch.bfloat16)}
    ops_[which] = _misaligned(tuple(ops_[which].shape), torch.bfloat16)
    assert ops_[which].is_contiguous() and ops_[which].data_ptr() % 16
    assert matmul_mod.route(torch.bfloat16, 200, 264, 64) == "tensor-core"
    with pytest.raises(ValueError, match="16-byte-aligned"):
        matmul_mod.check_alignment("tensor-core", ops_["x"], ops_["y"])
    matmul_mod.check_alignment("cuda-core", ops_["x"], ops_["y"])   # copies element by element
    # On the CPU the wrapper computes the plain version, aligned or not.
    torch.testing.assert_close(matmul(ops_["x"], ops_["y"]), matmul_plain(ops_["x"], ops_["y"]))


def test_library_path_is_under_the_checkout_build_dir():
    path = matmul_mod.build.library_path("block_matmul")
    assert path.parent.parts[-2:] == ("build", "repro_torch")
    assert path.parent.parent.parent == matmul_mod.build.CSRC_DIR.parents[3]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cuda_kernel_matches_plain_version(dtype):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    shapes = ALIGNED + RAGGED + _path_shapes() + TENSOR_CORE_SHAPES[:3] + UNALIGNED_ROWS[2:]
    routes = set()
    for shape in shapes:
        _, (tx, ty) = _operands(shape, dtype)
        tx, ty = tx.cuda(), ty.cuda()
        routes.add(matmul_mod.route(tx.dtype, shape[0], shape[2], shape[1]))
        for out_dtype in (torch.float32, torch.bfloat16):
            before = tracing.counter("launches.matmul")
            got = matmul(tx, ty, out_dtype=out_dtype)
            torch.cuda.synchronize()
            assert tracing.counter("launches.matmul") == before + 1 and got.dtype == out_dtype
            want = matmul_plain(tx, ty, out_dtype=out_dtype)
            tol = 2e-2 if torch.bfloat16 in (tx.dtype, out_dtype) else TOL[dtype]
            torch.testing.assert_close(got.float(), want.float(), rtol=tol, atol=tol)
    assert routes == ({"cuda-core", "tensor-core"} if dtype == "bfloat16" else {"cuda-core"})
    if dtype == "bfloat16":
        # A view one element past an aligned base, made on the card
        # (``.cuda()`` of a misaligned view would copy it to an aligned one).
        x = torch.zeros(200 * 64 + 1, dtype=torch.bfloat16, device="cuda")[1:].view(200, 64)
        y = torch.zeros(64, 264, dtype=torch.bfloat16, device="cuda")
        with pytest.raises(ValueError, match="16-byte-aligned"):
            matmul(x, y)
