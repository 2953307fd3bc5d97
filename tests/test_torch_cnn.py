"""The port's CNN stages and models against the JAX package's, with the
reference's weights carried across by ``params_from_jax``."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import cnn as ref_cnn
from repro_torch.kernels.matmul import matmul_plain
from repro_torch.models import cnn
from repro_torch.models.cnn import (
    PAPER_CNN_SPECS,
    Stage,
    build_executable,
    params_from_jax,
    pointwise_shapes,
    same_pads,
)

CPU = torch.device("cpu")


def _numpy_params(spec, seed):
    """Weights of the reference's shapes and scale, drawn with numpy (the
    reference's own ``init_cnn`` draws the same shapes with JAX keys, whose
    per-shape compiles dominate a test's time; see the init test below)."""
    rng = np.random.default_rng(seed)
    params, c_in = [], spec.in_channels
    for c_out in spec.stage_channels:
        fan = spec.kernel * spec.kernel * c_in
        params.append({
            "conv": (rng.standard_normal((spec.kernel, spec.kernel, c_in, c_out)) / np.sqrt(fan)).astype(np.float32),
            "pw": (rng.standard_normal((1, 1, c_out, c_out)) / np.sqrt(c_out)).astype(np.float32),
        })
        c_in = c_out
    return params


def _forward(segments, x):
    for seg in segments:
        x = seg(x)
    return x


@pytest.mark.parametrize("downsample", [True, False])
@pytest.mark.parametrize("size", [64, 5, 2, 1])
def test_stage_matches_reference(size, downsample):
    # Odd, even and 1x1 inputs cover XLA's asymmetric SAME split.
    rng = np.random.default_rng(size + 100 * downsample)
    c_in, c_out = 3, 8
    p = {
        "conv": (rng.standard_normal((3, 3, c_in, c_out)) / np.sqrt(27)).astype(np.float32),
        "pw": (rng.standard_normal((1, 1, c_out, c_out)) / np.sqrt(c_out)).astype(np.float32),
    }
    x = rng.standard_normal((1, size, size, c_in)).astype(np.float32)
    want = np.asarray(ref_cnn.stage_fn({k: jnp.asarray(v) for k, v in p.items()}, downsample)(jnp.asarray(x)))
    stage = Stage(params_from_jax([p])[0], downsample, CPU)
    got = stage(torch.from_numpy(x)).numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("size,stride,pads", [(64, 2, (0, 1)), (5, 2, (1, 1)), (2, 2, (0, 1)), (1, 2, (1, 1)), (64, 1, (1, 1)), (1, 1, (1, 1))])
def test_same_pads_follow_xla(size, stride, pads):
    assert same_pads(size, 3, stride) == pads


@pytest.mark.parametrize("name", sorted(PAPER_CNN_SPECS))
def test_model_matches_reference(name):
    spec = PAPER_CNN_SPECS[name]
    ref_params = _numpy_params(spec, seed=3)
    x = np.random.default_rng(7).standard_normal(
        (1, spec.in_size, spec.in_size, spec.in_channels)
    ).astype(np.float32)
    stages = [
        ref_cnn.stage_fn({k: jnp.asarray(v) for k, v in p.items()}, downsample=(i % 2 == 0))
        for i, p in enumerate(ref_params)
    ]
    want = jax.jit(lambda a: _forward(stages, a))(jnp.asarray(x))
    model = build_executable(spec, params=params_from_jax(ref_params), device="cpu")
    got = _forward(model.segments, torch.from_numpy(x)).numpy()
    # 11 stages of float32 sums in another order than XLA's.
    np.testing.assert_allclose(got, np.asarray(want), rtol=1e-4, atol=1e-4)


def test_partitioned_equals_unpartitioned():
    model = build_executable(PAPER_CNN_SPECS["mobilenetv2"], seed=1, device="cpu")
    x0 = model.make_input(7)
    full = _forward(model.segments, x0)
    for p in range(len(model.segments) + 1):
        y = _forward(model.segments[p:], _forward(model.segments[:p], x0))
        np.testing.assert_allclose(y.numpy(), full.numpy(), rtol=1e-5, atol=1e-5)


def test_specs_match_table_ii_partition_points():
    expected = {
        "squeezenet": 2,
        "mobilenetv2": 5,
        "efficientnet": 6,
        "mnasnet": 7,
        "gpunet": 5,
        "densenet201": 7,
        "resnet50v2": 8,
        "xception": 11,
        "inceptionv4": 11,
    }
    for name, pp in expected.items():
        assert len(PAPER_CNN_SPECS[name].stage_channels) == pp, name
        assert PAPER_CNN_SPECS[name] == cnn.CNNSpec(**vars(ref_cnn.PAPER_CNN_SPECS[name]))


def test_init_draws_the_reference_shapes_and_scale():
    spec = PAPER_CNN_SPECS["inceptionv4"]
    params = cnn.init_cnn(spec, torch.Generator().manual_seed(0))
    small = PAPER_CNN_SPECS["squeezenet"]
    ref_params = ref_cnn.init_cnn(small, jax.random.PRNGKey(0))
    for p, r in zip(cnn.init_cnn(small, torch.Generator().manual_seed(0)), ref_params):
        for k in ("conv", "pw"):
            assert tuple(p[k].shape) == r[k].shape and p[k].dtype == torch.float32
    # The reference's own init output carries across unchanged.
    carried = params_from_jax([{k: np.asarray(v) for k, v in r.items()} for r in ref_params])
    for c, r in zip(carried, ref_params):
        for k in ("conv", "pw"):
            np.testing.assert_array_equal(c[k].numpy(), np.asarray(r[k]))
    for p, q in zip(params, _numpy_params(spec, 0)):
        assert tuple(p["conv"].shape) == q["conv"].shape and tuple(p["pw"].shape) == q["pw"].shape
    # Unit-variance activations in expectation: std * sqrt(fan) ~ 1.
    last = params[-1]["conv"]
    fan = last.shape[0] * last.shape[1] * last.shape[2]
    assert abs(float(last.std()) * np.sqrt(fan) - 1.0) < 0.05
    # Seeded: the same seed gives the same weights.
    again = cnn.init_cnn(spec, torch.Generator().manual_seed(0))
    assert all(torch.equal(a["pw"], b["pw"]) for a, b in zip(params, again))


@pytest.mark.parametrize("name", ["inceptionv4", "mnasnet"])
def test_pointwise_shapes_are_the_stages_matmuls(name, monkeypatch):
    seen = []

    def spy(x, y, out_dtype=None):
        seen.append((x.shape[0], x.shape[1], y.shape[1]))
        return matmul_plain(x, y, out_dtype)

    monkeypatch.setattr(cnn, "matmul", spy)
    spec = PAPER_CNN_SPECS[name]
    model = build_executable(spec, device="cpu")
    _forward(model.segments, model.make_input(0))
    assert seen == pointwise_shapes(spec)


def test_cuda_build_raises_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        build_executable(PAPER_CNN_SPECS["squeezenet"])
