"""The card's KV-Gen algorithm, on the CPU.

On the card ``kv_gen`` runs two kernels: a norm pass (each selected ACT row
normed once and rounded to the cache dtype) and a projection pass whose
d_model is cut across the blocks of a cluster, each block's float32 partial
summed in block order before the epilogue (round, K norm, RoPE, round).
Here that algorithm in plain PyTorch (``kv_gen_split_ref``) is held to the
plain version ``kv_gen_ref`` with a page index, RoPE, LayerNorm with its
bias, rmsnorm, int8 ACT pages and the K norm at head_dim 256, at 1, 2, 3 and
8 slices (and the slices of a d_model that is no multiple of 64), and, at a
zero bias with the JAX model's own layer weights carried across by
``params.from_numpy``, to the Pallas kernel in interpret mode.

Tolerances.  float32: 1e-5 absolute on K and V (entries up to ~5) against
the plain version: slices only reorder the projection's float32 sum over
d_model; measured 2.6e-6, 5 float32 ulps of the largest entry.  Against the
Pallas kernel also 1e-5, the limit ``tests/test_torch_kv_gen.py`` holds the
plain version to (the Pallas body norms in another float32 order).  In the
cache dtypes: 4 ulps of the dtype at the largest output, chip_smoke.py's
limit for the kernel (both round the normed rows and K/V at the same points,
and a float32 sum on either side of a rounding boundary differs by one ulp,
which RoPE and the K norm carry).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as j_get_config
from repro.kernels.kv_gen.kernel import kv_gen as j_kv_gen
from repro.models import model as JM
from repro_torch import params as P
from repro_torch.kernels.kv_gen.ref import (
    CHUNK, d_slices, kv_gen_ref, kv_gen_split_ref)
from repro_torch.models import layers as L
from repro_torch.models.quant_ops import quantize

torch.set_num_threads(1)
TOL = 1e-5
MANTISSA = {torch.float16: 10, torch.bfloat16: 7}
t = torch.from_numpy


def _case(rng, n_pool=9, d=192, kvh=2, hd=32, bias=0.3):
    f = lambda *sh, s=1.0, o=0.0: t((rng.standard_normal(sh) * s + o)
                                    .astype(np.float32))
    return dict(act_pages=f(n_pool, 16, d, s=0.5, o=0.2),
                norm_scale=f(d, s=0.1, o=1.0), norm_bias=f(d, s=bias),
                wk=f(d, kvh, hd, s=d ** -0.5), wv=f(d, kvh, hd, s=d ** -0.5))


def _index_and_rope(n_pool, hd, rng, theta=1e4):
    idx = t(rng.permutation(n_pool)[:6].astype(np.int32))
    pos = t(rng.integers(0, 4096, (6, 16)))
    sin, cos = L.rope_sin_cos(pos, hd, theta)
    return dict(page_index=idx, sin=sin, cos=cos)


def _both(case, **kw):
    n_slices = kw.pop("n_slices")
    return (kv_gen_split_ref(**case, **kw, n_slices=n_slices),
            kv_gen_ref(**case, **kw))


@pytest.mark.parametrize("d", [192, 200, 4096])
@pytest.mark.parametrize("n_slices", [1, 2, 3, 8])
def test_slices_cover_d_model_once(d, n_slices):
    """Block r of a cluster of n takes chunks [r nc / n, (r + 1) nc / n) of
    d_model's 64-column chunks: each column exactly once, in order."""
    cover = np.zeros(d, int)
    prev = 0
    for lo, hi in d_slices(d, n_slices):
        assert lo == prev and lo % CHUNK == 0
        cover[lo:hi] += 1
        prev = hi
    assert prev == d and (cover == 1).all()


@pytest.mark.parametrize("mode", ["rmsnorm", "layernorm", "int8_rmsnorm",
                                  "int8_layernorm"])
@pytest.mark.parametrize("n_slices", [1, 2, 3, 8])
def test_split_matches_plain_with_index_and_rope(mode, n_slices):
    rng = np.random.default_rng(n_slices + 10 * len(mode))
    case = _case(rng)
    norm = mode.removeprefix("int8_")
    if norm == "rmsnorm":
        case["norm_scale"] = case["norm_scale"] - 1.0
    kw = dict(_index_and_rope(9, 32, rng), norm_type=norm,
              eps=L.NORM_EPS[norm], n_slices=n_slices)
    if mode.startswith("int8"):
        case["act_pages"], kw["act_scales"] = quantize(case["act_pages"])
    (k, v), (wk_, wv_) = _both(case, **kw)
    assert k.shape == (6, 16, 2, 32) and k.dtype == torch.float32
    torch.testing.assert_close(k, wk_, atol=TOL, rtol=0)
    torch.testing.assert_close(v, wv_, atol=TOL, rtol=0)


@pytest.mark.parametrize("dtype", [torch.float16, torch.bfloat16])
@pytest.mark.parametrize("n_slices", [2, 8])
def test_split_knorm_at_hd256_in_cache_dtype(dtype, n_slices):
    """gemma3's shape of the call: one KV head of 256 columns (K and V in
    separate blocks on the card), the K norm before RoPE, in the cache
    dtype: within 4 ulps of the plain version."""
    rng = np.random.default_rng(20 + n_slices)
    case = {k: v.to(dtype) for k, v in _case(rng, d=256, kvh=1, hd=256).items()}
    case["norm_scale"] = case["norm_scale"] - 1
    kw = dict(_index_and_rope(9, 256, rng, theta=1e6), norm_type="rmsnorm",
              knorm=t(rng.standard_normal(256).astype(np.float32) * 0.3).to(dtype),
              n_slices=n_slices)
    got, want = _both(case, **kw)
    top = max(w.float().abs().max().item() for w in want)
    ulp = 2.0 ** (np.floor(np.log2(top)) - MANTISSA[dtype])
    for g, w in zip(got, want):
        assert g.dtype == dtype and g.shape == (6, 16, 1, 256)
        assert (g.float() - w.float()).abs().max() <= 4 * ulp


@pytest.mark.parametrize("norm", ["rmsnorm", "layernorm"])
def test_split_matches_pallas_with_model_weights(norm):
    """yi-6b-reduced's layer-0 ln1 scale and wk/wv (the JAX model's
    initialisation, scale perturbed), carried across by
    ``params.from_numpy``, at a zero bias (the Pallas kernel drops the
    bias), all pages in order, no RoPE: the Pallas kernel's function."""
    jcfg = j_get_config("yi-6b-reduced")
    jp = JM.init_params(jcfg, jax.random.PRNGKey(0))
    lp = jax.tree.map(lambda a: np.array(a[0]), jp["layers"])
    rng = np.random.default_rng(5)
    d, hd, kvh = jcfg.d_model, jcfg.head_dim, jcfg.num_kv_heads
    scale = (0.1 * rng.standard_normal(d)).astype(np.float32)
    if norm == "layernorm":
        scale = scale + 1.0
    lp["ln1"]["scale"] = scale
    tp = P.from_numpy(lp, "cpu")
    wk = tp["attn"]["wk"].reshape(d, kvh, hd)
    wv = tp["attn"]["wv"].reshape(d, kvh, hd)
    ap = (rng.standard_normal((5, 16, d)) * 0.5 + 0.2).astype(np.float32)
    eps = L.NORM_EPS[norm]
    k, v = kv_gen_split_ref(t(ap), tp["ln1"]["scale"], torch.zeros(d), wk, wv,
                            norm_type=norm, eps=eps, n_slices=3)
    pk, pv = j_kv_gen(jnp.asarray(ap), jnp.asarray(scale), jnp.asarray(wk.numpy()),
                      jnp.asarray(wv.numpy()), norm_type=norm, eps=eps,
                      interpret=True)
    np.testing.assert_allclose(k.numpy(), np.asarray(pk), atol=TOL)
    np.testing.assert_allclose(v.numpy(), np.asarray(pv), atol=TOL)
