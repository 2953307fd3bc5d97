"""The port's ``models/frontend.py`` against the JAX package's: the specs'
shapes and dtypes for every architecture and input shape (token ids are
int64 in the port, int32 in the reference), and the random batches'."""
import jax.numpy as jnp
import pytest
import torch

from repro.configs import ARCHS as REF_ARCHS
from repro.models import frontend as ref_frontend
from repro_torch.configs import ARCHS, INPUT_SHAPES
from repro_torch.models import frontend

# The reference's dtype -> the port's.
DTYPES = {jnp.dtype(jnp.int32): torch.int64, jnp.dtype(jnp.bfloat16): torch.bfloat16}


def _same(spec: torch.Tensor, ref) -> bool:
    return spec.device.type == "meta" and tuple(spec.shape) == ref.shape and spec.dtype == DTYPES[ref.dtype]


@pytest.mark.parametrize("shape", INPUT_SHAPES)
@pytest.mark.parametrize("name", ARCHS)
def test_specs_equal_the_reference(name, shape):
    cfg, ref_cfg, sh = ARCHS[name], REF_ARCHS[name], INPUT_SHAPES[shape]
    batch = min(sh.global_batch, 4)
    specs = frontend.train_input_specs(cfg, batch, sh.seq_len)
    ref_specs = ref_frontend.train_input_specs(ref_cfg, batch, sh.seq_len)
    assert list(specs) == list(ref_specs)
    for key, spec in specs.items():
        assert _same(spec, ref_specs[key]), key
    assert _same(frontend.decode_token_specs(cfg, batch), ref_frontend.decode_token_specs(ref_cfg, batch))


@pytest.mark.parametrize("name", ["qwen1.5-0.5b", "phi-3-vision-4.2b", "musicgen-large"])
def test_random_batches_have_the_spec_shapes(name):
    cfg = ARCHS[name].reduced()
    specs = frontend.train_input_specs(cfg, 2, 24)
    batch = frontend.make_train_batch(cfg, 2, 24, seed=3, device="cpu")
    assert {k: (tuple(v.shape), v.dtype) for k, v in batch.items()} == {
        k: (tuple(v.shape), v.dtype) for k, v in specs.items()
    }
    for key, t in batch.items():
        if t.dtype == torch.int64:
            assert 0 <= int(t.min()) and int(t.max()) < cfg.vocab_size, key
    again = frontend.make_train_batch(cfg, 2, 24, seed=3, device="cpu")
    assert all(torch.equal(batch[k], again[k]) for k in batch)
    token = frontend.make_decode_token(cfg, 2, seed=1, device="cpu")
    spec = frontend.decode_token_specs(cfg, 2)
    assert tuple(token.shape) == tuple(spec.shape) and token.dtype == spec.dtype
    assert frontend.EMBED_DTYPE == torch.bfloat16


def test_random_batches_default_to_the_gpu():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    cfg = ARCHS["musicgen-large"].reduced()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        frontend.make_train_batch(cfg, 1, 8)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        frontend.make_decode_token(cfg, 1)
