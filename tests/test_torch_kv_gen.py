"""The plain version of the port's ``kv_gen`` kernel and of the hybrid
kernel's second-pool mode, against the JAX package.

On the CPU each wrapper runs its plain version (``ref.py``); the CUDA kernels
are held against these on the card by ``chip_smoke.py``.  The Pallas
``kv_gen`` runs in interpret mode, as ``tests/test_kernels.py`` runs it.
Everything is float32; 1e-5 absolute covers two float32 summation orders of
a d-deep product at unit-scale inputs."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as j_get_config
from repro.kernels.kv_gen.kernel import kv_gen as j_kv_gen
from repro.kernels.kv_gen.ref import kv_gen_ref as j_kv_gen_ref
from repro.models import layers as JL
from repro.models import model as JM
from repro.models import transformer as JT
from repro_torch import params as P
from repro_torch.configs import get_config
from repro_torch.kernels.hybrid_attention.ops import (
    hybrid_paged_attention, hybrid_paged_attention_two_pool)
from repro_torch.kernels.kv_gen import ops as kv_ops
from repro_torch.kernels.kv_gen.ops import kv_gen
from repro_torch.models import layers as L
from repro_torch.models import model as M
from test_torch_kernels import Elsewhere

torch.set_num_threads(1)
TOL = 1e-5
t = torch.from_numpy


def _pages(rng, n=5, d=64, kvh=2, hd=32, bias=0.0):
    ap = (rng.standard_normal((n, 16, d)) * 0.5 + 0.2).astype(np.float32)
    sc = (0.1 * rng.standard_normal(d)).astype(np.float32)
    bi = (bias * rng.standard_normal(d)).astype(np.float32)
    wk = (rng.standard_normal((d, kvh, hd)) * d ** -0.5).astype(np.float32)
    wv = (rng.standard_normal((d, kvh, hd)) * d ** -0.5).astype(np.float32)
    return ap, sc, bi, wk, wv


@pytest.mark.parametrize("norm", ["rmsnorm", "layernorm", "none"])
def test_kv_gen_plain_matches_pallas_at_zero_bias(norm):
    rng = np.random.default_rng(0)
    ap, sc, bi, wk, wv = _pages(rng)
    if norm == "layernorm":
        sc = sc + 1.0
    eps = 1e-5 if norm == "layernorm" else 1e-6
    launches = kv_gen.launches
    k, v = kv_gen(t(ap), t(sc), t(bi), t(wk), t(wv), norm_type=norm, eps=eps)
    assert kv_gen.launches == launches                # CPU tensor: plain version
    args = [jnp.asarray(a) for a in (ap, sc, wk, wv)]
    pk, pv = j_kv_gen(*args, norm_type=norm, eps=eps, interpret=True)
    rk, rv = j_kv_gen_ref(*args, norm_type=norm, eps=eps)
    for mine, pallas, ref in ((k, pk, rk), (v, pv, rv)):
        np.testing.assert_allclose(mine.numpy(), np.asarray(pallas), atol=TOL)
        np.testing.assert_allclose(mine.numpy(), np.asarray(ref), atol=TOL)


def test_kv_gen_page_index_selects_and_orders_pages():
    rng = np.random.default_rng(1)
    ap, sc, bi, wk, wv = _pages(rng)
    idx = np.array([3, 0, 3, 4], np.int32)
    k, v = kv_gen(t(ap), t(sc), None, t(wk), t(wv), page_index=t(idx))
    want = kv_gen(t(ap[idx]), t(sc), None, t(wk), t(wv))
    assert torch.equal(k, want[0]) and torch.equal(v, want[1])
    out = (torch.full_like(k, 7.0), torch.full_like(v, 7.0))
    got = kv_gen(t(ap), t(sc), None, t(wk), t(wv), page_index=t(idx), out=out)
    assert got[0] is out[0] and torch.equal(out[0], k) and torch.equal(out[1], v)


def _layer(name, bias_scale, rng):
    jcfg = j_get_config(name)
    jp = JM.init_params(jcfg, jax.random.PRNGKey(0))
    lp = jax.tree.map(lambda a: np.array(a[0]), jp["layers"])
    d = jcfg.d_model
    if jcfg.norm_type == "layernorm":
        lp["ln1"]["bias"] = (bias_scale * rng.standard_normal(d)).astype(np.float32)
        lp["ln1"]["scale"] = (1 + 0.1 * rng.standard_normal(d)).astype(np.float32)
    else:
        lp["ln1"]["scale"] = (0.1 * rng.standard_normal(d)).astype(np.float32)
    return jcfg, get_config(name), lp


@pytest.mark.parametrize("name", ["minitron-4b-reduced", "yi-6b-reduced"])
def test_kv_gen_plain_matches_model_path_with_bias_and_rope(name):
    """Against the reference model path's KV-Gen lines (norm, projection,
    RoPE at the recorded positions; ``model.py:680-686``) with a non-zero
    LayerNorm bias, where the Pallas kernel is no oracle (it drops the bias
    and has no RoPE).  The ACT positions interleave, as decode appends to
    both regions, and each request's prefix is read in place from its
    region through ``page_index``."""
    rng = np.random.default_rng(2)
    jcfg, cfg, lp = _layer(name, 0.5, rng)
    B, act_cap, n_act, d = 3, 64, 3, cfg.d_model
    KVH, hd = cfg.num_kv_heads, cfg.head_dim
    ac = rng.standard_normal((B, act_cap, d)).astype(np.float32)
    act_pos = np.sort(rng.choice(400, (B, act_cap), replace=False), 1) \
        .astype(np.int32)
    jlp = jax.tree.map(jnp.asarray, lp)
    an = JL.apply_norm(jnp.asarray(ac[:, :n_act * 16]), jlp["ln1"], jcfg.norm_type)
    ka = (an @ jlp["attn"]["wk"]).reshape(B, n_act * 16, KVH, hd)
    va = (an @ jlp["attn"]["wv"]).reshape(B, n_act * 16, KVH, hd)
    ka = JL.apply_rope(ka, *JT._rope_for(jcfg, jnp.asarray(act_pos[:, :n_act * 16])))

    sin, cos = L.rope_sin_cos(t(act_pos[:, :n_act * 16]), hd, cfg.rope_theta)
    idx = (np.arange(B)[:, None] * (act_cap // 16) + np.arange(n_act)).astype(np.int32)
    tp = P.from_numpy(lp, "cpu")
    k, v = kv_gen(t(ac).view(-1, 16, d), tp["ln1"]["scale"], tp["ln1"].get("bias"),
                  tp["attn"]["wk"].view(d, KVH, hd), tp["attn"]["wv"].view(d, KVH, hd),
                  page_index=t(idx.reshape(-1)),
                  sin=sin.reshape(-1, 16, hd // 2), cos=cos.reshape(-1, 16, hd // 2),
                  norm_type=cfg.norm_type, eps=L.NORM_EPS[cfg.norm_type])
    np.testing.assert_allclose(k.reshape(B, -1, KVH, hd).numpy(), np.asarray(ka),
                               atol=TOL)
    np.testing.assert_allclose(v.reshape(B, -1, KVH, hd).numpy(), np.asarray(va),
                               atol=TOL)
    if cfg.norm_type == "layernorm":     # the Pallas ref drops the bias
        jk, _ = j_kv_gen_ref(jnp.asarray(ac[:, :n_act * 16].reshape(-1, 16, d)),
                             jlp["ln1"]["scale"],
                             jlp["attn"]["wk"].reshape(d, KVH, hd),
                             jlp["attn"]["wv"].reshape(d, KVH, hd),
                             norm_type="layernorm", eps=1e-5)
        k0, _ = kv_gen(t(ac[:, :n_act * 16].reshape(-1, 16, d)), tp["ln1"]["scale"],
                       tp["ln1"]["bias"], tp["attn"]["wk"].view(d, KVH, hd),
                       tp["attn"]["wv"].view(d, KVH, hd), norm_type="layernorm",
                       eps=1e-5)
        assert np.abs(k0.numpy() - np.asarray(jk)).max() > 1e-2


@pytest.mark.parametrize("hd", [32, 256])
def test_kv_gen_knorm_matches_model_path(hd):
    """The K norm epilogue (q/k-norm models, gemma3): the reference model
    path's KV-Gen lines with ``qk_norm`` (``model.py:679-686``: norm,
    projection, ``rms_norm(ka, knorm)``, RoPE at the recorded positions),
    with a perturbed non-zero ``knorm``, at head_dim 32 and 256; MQA."""
    rng = np.random.default_rng(hd)
    B, act_cap, n_act, d, KVH = 2, 48, 2, 64, 1
    ap, sc, _, wk, wv = _pages(rng, n=B * act_cap // 16, d=d, kvh=KVH, hd=hd)
    knorm = (0.3 * rng.standard_normal(hd)).astype(np.float32)
    ac = ap.reshape(B, act_cap, d)
    act_pos = np.sort(rng.choice(3000, (B, act_cap), replace=False), 1) \
        .astype(np.int32)
    rows = n_act * 16
    an = JL.rms_norm(jnp.asarray(ac[:, :rows]), jnp.asarray(sc))
    ka = (an @ jnp.asarray(wk.reshape(d, -1))).reshape(B, rows, KVH, hd)
    va = (an @ jnp.asarray(wv.reshape(d, -1))).reshape(B, rows, KVH, hd)
    ka = JL.rms_norm(ka, jnp.asarray(knorm))
    jsin, jcos = JL.rope_sin_cos(jnp.asarray(act_pos[:, :rows]), hd, 1e6)
    ka = JL.apply_rope(ka, jsin, jcos)

    # each side its own tables (the port's match JAX's within 1e-7,
    # tests/test_torch_rope.py)
    sin, cos = L.rope_sin_cos(t(act_pos[:, :rows]), hd, 1e6)
    idx = (np.arange(B)[:, None] * (act_cap // 16) + np.arange(n_act)).astype(np.int32)
    launches = kv_gen.knorm_launches
    k, v = kv_gen(t(ap), t(sc), None, t(wk), t(wv), page_index=t(idx.reshape(-1)),
                  sin=sin.reshape(-1, 16, hd // 2), cos=cos.reshape(-1, 16, hd // 2),
                  knorm=t(knorm))
    assert kv_gen.knorm_launches == launches          # CPU tensor: plain version
    np.testing.assert_allclose(k.reshape(B, -1, KVH, hd).numpy(), np.asarray(ka),
                               atol=TOL)
    np.testing.assert_allclose(v.reshape(B, -1, KVH, hd).numpy(), np.asarray(va),
                               atol=TOL)
    k0, _ = kv_gen(t(ap), t(sc), None, t(wk), t(wv), page_index=t(idx.reshape(-1)),
                   sin=sin.reshape(-1, 16, hd // 2), cos=cos.reshape(-1, 16, hd // 2))
    assert np.abs(k0.reshape(B, -1, KVH, hd).numpy() - np.asarray(ka)).max() > 1e-2


def test_rope_layer_step_matches_model_path_with_layernorm_bias():
    """The port's RoPE decode layer (``kv_gen`` into the scratch pool, then
    the second-pool mode; plain versions on the CPU) against the reference's
    ``_hybrid_layer_step`` on minitron-4b-reduced with a non-zero LayerNorm
    bias, interleaved ACT positions, and both store kinds in one step."""
    rng = np.random.default_rng(7)
    jcfg, cfg, lp = _layer("minitron-4b-reduced", 0.5, rng)
    B, kv_cap, act_cap, d = 3, 48, 48, cfg.d_model
    KVH, D = cfg.num_kv_heads, cfg.head_dim
    h = rng.standard_normal((B, 1, d)).astype(np.float32)
    kc = (rng.standard_normal((B, kv_cap, KVH, D)) * 0.5).astype(np.float32)
    vc = (rng.standard_normal((B, kv_cap, KVH, D)) * 0.5).astype(np.float32)
    ac = rng.standard_normal((B, act_cap, d)).astype(np.float32)
    kv_len = np.array([20, 0, 33], np.int32)
    act_len = np.array([17, 40, 0], np.int32)
    store = np.array([True, False, True])
    ctx = kv_len + act_len
    act_pos = np.sort(rng.choice(400, (B, act_cap), replace=False), 1).astype(np.int32)
    act_pos[np.arange(B), act_len] = np.where(store, ctx, act_pos[np.arange(B), act_len])
    jsn = JT._rope_for(jcfg, jnp.asarray(ctx)[:, None])
    jsa = JT._rope_for(jcfg, jnp.asarray(act_pos))
    jh, jk, jv, ja = JM._hybrid_layer_step(
        jax.tree.map(jnp.asarray, lp), jcfg, jnp.asarray(h), jnp.asarray(kc),
        jnp.asarray(vc), jnp.asarray(ac), jnp.asarray(kv_len),
        jnp.asarray(act_len), jnp.asarray(store), jsn, jsa, False)
    s, n_act = t(store), act_cap // 16
    cache = {"act_pos": t(act_pos), "act": t(ac)[None]}
    act_kv = M._act_kv(cfg, cache, t(ctx), n_act)
    tables = M.hybrid_page_table(t(kv_len) + (~s).int(), t(act_len) + s.int(),
                                 kv_cap, n_act * 16, kv_cap // 16 + n_act)
    pk, pv, pa = t(kc.copy()), t(vc.copy()), t(ac.copy())
    got = M._hybrid_layer_step(P.from_numpy(lp, "cpu"), cfg, t(h), pk, pv, pa,
                               t(kv_len), t(act_len), s, tables, act_kv)
    np.testing.assert_allclose(got.numpy(), np.asarray(jh), atol=TOL)
    for mine, ref in ((pk, jk), (pv, jv), (pa, ja)):       # in-place appends
        np.testing.assert_allclose(mine.numpy(), np.asarray(ref), atol=TOL)


def _two_pool_case(rng, B=3, kvh=2, g=4, D=32, kv_cap=48, n_act=3):
    kc = (rng.standard_normal((B, kv_cap, kvh, D)) * 0.5).astype(np.float32)
    vc = (rng.standard_normal((B, kv_cap, kvh, D)) * 0.5).astype(np.float32)
    ka = (rng.standard_normal((B, n_act * 16, kvh, D)) * 0.5).astype(np.float32)
    va = (rng.standard_normal((B, n_act * 16, kvh, D)) * 0.5).astype(np.float32)
    q = rng.standard_normal((B, 1, kvh * g, D)).astype(np.float32)
    return q, kc, vc, ka, va


@pytest.mark.parametrize("lens", [([20, 0, 33], [17, 40, 0]),
                                  ([48, 1, 16], [0, 48, 31])],
                         ids=["mixed", "edges"])
def test_two_pool_plain_matches_masked_decode_attn(lens):
    """The second-pool mode over tables from ``hybrid_page_table`` (ACT
    stride = the scratch pool's n_act pages) against the reference's
    ``_masked_decode_attn`` over ``[KV ; recomputed]`` (``model.py:715-721``)."""
    rng = np.random.default_rng(3)
    q, kc, vc, ka, va = _two_pool_case(rng)
    B, kv_cap, kvh, D = kc.shape
    n_act = ka.shape[1] // 16
    kv_t, act_t = (np.asarray(x, np.int32) for x in lens)
    tables = M.hybrid_page_table(t(kv_t), t(act_t), kv_cap, n_act * 16,
                                 kv_cap // 16 + n_act)
    launches = hybrid_paged_attention_two_pool.launches
    got = hybrid_paged_attention_two_pool(
        t(q).reshape(B, kvh, -1, D), t(kc).view(-1, 16, kvh, D),
        t(vc).view(-1, 16, kvh, D), t(ka).view(-1, 16, kvh, D),
        t(va).view(-1, 16, kvh, D), *tables)
    assert hybrid_paged_attention_two_pool.launches == launches
    valid = np.concatenate([np.arange(kv_cap)[None] < kv_t[:, None],
                            np.arange(n_act * 16)[None] < act_t[:, None]], 1)
    want = JT._masked_decode_attn(jnp.asarray(q), jnp.concatenate([kc, ka], 1),
                                  jnp.concatenate([vc, va], 1), jnp.asarray(valid))
    np.testing.assert_allclose(got.reshape(B, 1, -1, D).numpy(), np.asarray(want),
                               atol=TOL)


def test_two_pool_over_kv_gen_equals_fused_plain_version():
    """KV-Gen then the second-pool mode computes what the fused mode computes
    (no RoPE, the learned-position models' case): the two routes differ only
    in where the recomputed K/V live."""
    rng = np.random.default_rng(4)
    ap, sc, bi, wk, wv = _pages(rng, n=4, bias=0.3)
    sc = sc + 1.0
    kp = (rng.standard_normal((4, 16, 2, 32)) * 0.3).astype(np.float32)
    vp = (rng.standard_normal((4, 16, 2, 32)) * 0.3).astype(np.float32)
    q = rng.standard_normal((2, 2, 3, 32)).astype(np.float32)
    pt = np.array([[0, 1, 0, 2], [2, 3, 0, 0]], np.int32)
    pty = np.array([[0, 1, 1, 2], [0, 1, 2, 2]], np.int32)
    pn = np.array([[16, 16, 9, 0], [5, 12, 0, 0]], np.int32)
    fused = hybrid_paged_attention(t(q), t(kp), t(vp), t(ap), t(sc), t(bi), t(wk),
                                   t(wv), t(pt), t(pty), t(pn), norm_type="layernorm")
    ak, av = kv_gen(t(ap), t(sc), t(bi), t(wk), t(wv), norm_type="layernorm",
                    eps=1e-5)
    two = hybrid_paged_attention_two_pool(t(q), t(kp), t(vp), ak, av, t(pt),
                                          t(pty), t(pn))
    np.testing.assert_allclose(two.numpy(), fused.numpy(), atol=TOL)


def test_two_pool_plain_with_empty_act_pool_reads_kv_only():
    rng = np.random.default_rng(5)
    q, kc, vc, _, _ = _two_pool_case(rng, B=2)
    empty = torch.zeros((0, 16, 2, 32))
    tables = M.hybrid_page_table(t(np.array([20, 3], np.int32)),
                                 t(np.zeros(2, np.int32)), 48, 0, 2)
    got = hybrid_paged_attention_two_pool(
        t(q).reshape(2, 2, 4, 32), t(kc).view(-1, 16, 2, 32),
        t(vc).view(-1, 16, 2, 32), empty, empty, *tables)
    valid = np.arange(48)[None] < np.array([20, 3])[:, None]
    want = JT._masked_decode_attn(jnp.asarray(q), jnp.asarray(kc),
                                  jnp.asarray(vc), jnp.asarray(valid))
    np.testing.assert_allclose(got.reshape(2, 1, -1, 32).numpy(), np.asarray(want),
                               atol=TOL)


def test_wrappers_refuse_other_devices_and_float32_on_the_card():
    """No silent fallback: only a CPU tensor, or a ``meta`` one (shapes
    only: the dry run's), takes the plain version, and the CUDA path takes
    float16 and bfloat16 only, and for ``kv_gen`` only what the decode path
    gives it: a page index, RoPE tables, and rmsnorm or layernorm (checked
    before launch)."""
    m, w = Elsewhere((2, 16, 64)), Elsewhere((64, 2, 32))
    with pytest.raises(ValueError, match="unsupported device"):
        kv_gen(m, m[0, 0], None, w, w)
    q, pool = Elsewhere((1, 2, 4, 32)), Elsewhere((2, 16, 2, 32))
    with pytest.raises(ValueError, match="unsupported device"):
        hybrid_paged_attention_two_pool(q, pool, pool, pool, pool, *([q] * 3))
    mm = torch.zeros((2, 16, 64), device="meta")
    mw = torch.zeros((64, 2, 32), device="meta")
    before = kv_gen.launches
    k, v = kv_gen(mm, mm[0, 0], None, mw, mw)
    assert k.device.type == v.device.type == "meta"
    assert k.shape == v.shape == (2, 16, 2, 32) and kv_gen.launches == before
    ap, sc, bi, wk, wv = (t(a) for a in _pages(np.random.default_rng(6)))
    out = tuple(torch.empty((5, 16, 2, 32)) for _ in range(2))
    idx = torch.arange(5, dtype=torch.int32)
    sin, cos = L.rope_sin_cos(torch.arange(80).view(5, 16), 32, 1e4)
    with pytest.raises(ValueError, match="dtype torch.float32"):
        kv_ops._validate(ap, idx, sc, None, wk, wv, sin, cos, out,
                         "rmsnorm", 5)
    h = [a.half() for a in (ap, sc, bi, wk, wv)]
    ho = tuple(o.half() for o in out)
    kv_ops._validate(h[0], idx, h[1], None, *h[3:], sin, cos, ho, "rmsnorm", 5)
    kv_ops._validate(h[0], idx, h[1], h[2], *h[3:], sin, cos, ho, "layernorm", 5)
    with pytest.raises(ValueError, match="layernorm needs norm_bias"):
        kv_ops._validate(h[0], idx, h[1], None, *h[3:], sin, cos, ho,
                         "layernorm", 5)
    with pytest.raises(ValueError, match="norm_type 'none'"):
        kv_ops._validate(h[0], idx, h[1], None, *h[3:], sin, cos, ho, "none", 5)
    for missing in ((None, sin, cos), (idx, None, cos), (idx, sin, None)):
        with pytest.raises(ValueError, match="needs page_index, sin and cos"):
            kv_ops._validate(h[0], missing[0], h[1], None, *h[3:], *missing[1:],
                             ho, "rmsnorm", 5)
