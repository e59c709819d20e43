"""The port's layer primitives against ``repro.models.layers``.

Inputs come from numpy with a seed and go through both.  float32 on both
sides; the tolerance (1e-5 absolute at unit-scale values) covers the
different summation order of two float32 reductions."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import layers as JL
from repro_torch.models import layers as L

torch.set_num_threads(1)
TOL = 1e-5


def _rand(rng, *shape, scale=1.0):
    return (rng.standard_normal(shape) * scale).astype(np.float32)


def test_layer_norm_with_bias():
    rng = np.random.default_rng(0)
    x, w, b = _rand(rng, 3, 5, 64, scale=2.0), _rand(rng, 64), _rand(rng, 64)
    got = L.apply_norm(torch.from_numpy(x), {"scale": torch.from_numpy(w),
                                            "bias": torch.from_numpy(b)},
                       "layernorm")
    want = JL.apply_norm(jnp.asarray(x), {"scale": w, "bias": b}, "layernorm")
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=TOL)
    assert np.abs(b).max() > 0.5                  # the bias really is applied


def test_rms_norm():
    rng = np.random.default_rng(1)
    x, w = _rand(rng, 4, 64, scale=3.0), _rand(rng, 64, scale=0.1)
    got = L.apply_norm(torch.from_numpy(x), {"scale": torch.from_numpy(w)},
                       "rmsnorm")
    want = JL.apply_norm(jnp.asarray(x), {"scale": w}, "rmsnorm")
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=TOL)


def test_norm_rounds_back_to_the_input_dtype():
    """Both norms compute in float32 and cast back, as the reference does;
    in float16 the two agree to the last bit on most elements."""
    rng = np.random.default_rng(2)
    x = _rand(rng, 8, 128).astype(np.float16)
    w, b = np.ones(128, np.float16), _rand(rng, 128).astype(np.float16)
    got = L.layer_norm(torch.from_numpy(x), torch.from_numpy(w),
                       torch.from_numpy(b))
    want = JL.layer_norm(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b))
    assert got.dtype == torch.float16
    # one float16 ulp at |y| < 4 (2**-8): float32 sums in another order
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), atol=2 ** -8)


@pytest.mark.parametrize("ffn_type", ["relu", "gated_silu", "gelu"])
def test_dense_ffn(ffn_type):
    rng = np.random.default_rng(3)
    p = {"w1": _rand(rng, 32, 48, scale=0.2), "w2": _rand(rng, 48, 32, scale=0.2)}
    if ffn_type.startswith("gated"):
        p["w3"] = _rand(rng, 32, 48, scale=0.2)
    x = _rand(rng, 2, 3, 32)
    got = L.dense_ffn({k: torch.from_numpy(v) for k, v in p.items()},
                      torch.from_numpy(x), ffn_type)
    want = JL.dense_ffn({k: jnp.asarray(v) for k, v in p.items()},
                        jnp.asarray(x), ffn_type)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=TOL)


@pytest.mark.parametrize("H,KVH", [(4, 4), (4, 2)])
def test_decode_attention(H, KVH):
    rng = np.random.default_rng(4)
    B, S, D = 3, 20, 16
    q, k, v = _rand(rng, B, 1, H, D), _rand(rng, B, S, KVH, D), \
        _rand(rng, B, S, KVH, D)
    kv_len = np.array([1, 7, 20], np.int32)
    got = L.decode_attention(torch.from_numpy(q), torch.from_numpy(k),
                             torch.from_numpy(v),
                             kv_len=torch.from_numpy(kv_len))
    want = JL.decode_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                               kv_len=jnp.asarray(kv_len))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=TOL)
