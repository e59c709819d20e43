"""The port's int8 cache (``quant=QuantConfig()``) against the JAX package.

Codes and scales, the int8 modes of the kernels' plain versions, the model
path's quantized prefill and decode (with ACT-bound rows), the q8 oracle,
the quantized pricing, and the engine.  The JAX side fake-quantizes every
cache write and keeps the values in the model dtype; the port stores the
codes and scales, so a cache is compared dequantized.

Tolerances: float32 paths as in the other port tests (1e-5 on kernel
outputs and cache values, 1e-4 on logits).  A cache value computed in
another float32 summation order can land on the other side of a rounding
boundary of its code (or of its scale's float16 rounding): those entries
differ by up to one quantization step of their row (all of a row's entries
when its scale flipped); ``_codes_close`` states how many it allows.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import example, given, settings
from hypothesis import strategies as st

from repro.configs import get_config as j_get_config
from repro.core import blocks as j_blocks
from repro.core import costmodel as j_cm
from repro.core import pipeline as j_pipe
from repro.core import policy as j_policy
from repro.core.quant import QuantConfig as JQuant
from repro.kernels.hybrid_attention.kernel import hybrid_paged_attention as j_hybrid
from repro.kernels.hybrid_attention.ref import hybrid_paged_attention_ref as j_hybrid_ref
from repro.kernels.kv_gen.kernel import kv_gen as j_kv_gen
from repro.kernels.kv_gen.ref import kv_gen_ref as j_kv_gen_ref
from repro.models import model as JM
from repro.models import quant_ops as JQ
from repro.models import quantized_cache as JQC
from repro.serving import HybridServeEngine as JEngine
from repro_torch import params as P
from repro_torch.configs import get_config
from repro_torch.core import blocks, costmodel as cm, pipeline, policy
from repro_torch.core.quant import QuantConfig
from repro_torch.data.pipeline import request_trace
from repro_torch.kernels.hybrid_attention.ops import (
    hybrid_paged_attention, hybrid_paged_attention_two_pool)
from repro_torch.kernels.kv_gen.ops import kv_gen
from repro_torch.models import model as M
from repro_torch.models import quantized_cache as QC
from repro_torch.models.quant_ops import dequantize, fake_quant, quantize
from repro_torch.serving import HybridServeEngine

torch.set_num_threads(1)
TOL, LOGIT_TOL, CACHE_TOL = 1e-5, 1e-4, 1e-5
FLIP_ROWS, FLIP_SHARE = 2, 1e-3
t = torch.from_numpy
DTYPES = {"float32": (torch.float32, jnp.float32),
          "float16": (torch.float16, jnp.float16),
          "bfloat16": (torch.bfloat16, jnp.bfloat16)}
# quant prices the link lanes at the int8 bytes, so Algorithm 1 keeps more
# KV: a spec with 20 TFLOP/s of compute and a 16 GB/s link splits each
# reduced prompt and sends some decode tokens to the ACT region
Q_MIXED = dataclasses.replace(cm.H100_SXM, name="h100-20tflops-16GBps",
                              flops=2e13, host_link_bw=16e9)


def _np(x):
    return np.array(jnp.asarray(x).astype(jnp.float32))


def _codes_close(codes, scales, want, what):
    """A port cache (codes, scales) against the reference's fake-quantized
    values ``want``, whose codes and scales requantizing recovers exactly.
    Rows neither side wrote (all codes 0) may differ in scale.  A float32
    input computed in another summation order may cross a
    rounding boundary: of its row's float16 scale (at most FLIP_ROWS rows or
    FLIP_SHARE of the rows, every value of such a row within one step), or
    of its code (at most FLIP_SHARE of the entries, by one code)."""
    ref_q, ref_s = quantize(torch.from_numpy(np.array(want, np.float32)))
    # an unwritten row holds zero codes under either scale
    written = (codes != 0).any(-1, keepdim=True) | (ref_q != 0).any(-1, keepdim=True)
    scale_off = (scales != ref_s) & written
    assert scale_off.sum() <= max(FLIP_ROWS, FLIP_SHARE * scale_off.numel()), \
        (what, int(scale_off.sum()), scale_off.numel())
    d = (dequantize(codes, scales) - dequantize(ref_q, ref_s)).abs()
    assert (d <= scales.float() * 1.01).all(), (what, float(d.max()))
    dq = (codes.int() - ref_q.int()).abs()[~scale_off.expand_as(codes)]
    assert dq.max() <= 1 and (dq > 0).float().mean() <= FLIP_SHARE, \
        (what, int((dq > 0).sum()), dq.numel())


# ------------------------------------------------------------ codes, scales

def _tie_rows(rng, n, D):
    """Rows whose absmax fixes the scale at 0.5 and whose other values sit
    exactly on code + 0.5 ties (round half to even decides them)."""
    x = (rng.integers(-120, 120, (n, D)) + 0.5) * 0.5
    x[:, 0] = 63.5                               # amax / 127 = 0.5
    return x.astype(np.float32)


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@settings(max_examples=25, deadline=None)
@given(scale=st.floats(1e-6, 1e4), seed=st.integers(0, 2**31 - 1),
       zero_row=st.integers(0, 7))
@example(scale=1.0, seed=0, zero_row=0)
def test_quantize_matches_jax_bit_for_bit(dtype, scale, seed, zero_row):
    """Codes, scales, dequantized and fake-quantized values equal the
    reference's in every cache dtype, an all-zero row and exact .5 ties
    included."""
    tdt, jdt = DTYPES[dtype]
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal((8, 64)) * scale).astype(np.float32)
    x[zero_row] = 0.0
    x = np.concatenate([x, _tie_rows(rng, 4, 64)])
    xt, xj = t(x).to(tdt), jnp.asarray(x).astype(jdt)
    q, s = quantize(xt)
    jq, js = JQ.quantize(xj)
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(s.numpy(), np.asarray(js))
    assert s.dtype == torch.float16 and float(s.min()) > 0.0
    assert not q[zero_row].any()
    np.testing.assert_array_equal(dequantize(q, s, tdt).float().numpy(),
                                  _np(JQ.dequantize(jq, js, jdt)))
    np.testing.assert_array_equal(fake_quant(xt).float().numpy(),
                                  _np(JQ.fake_quant(xj)))


def test_ties_round_half_to_even():
    x = np.zeros((1, 4), np.float32)
    x[0] = [63.5, 1.25, 1.75, -1.25]          # scale 0.5: 2.5, 3.5, -2.5
    q, s = quantize(t(x))
    assert float(s) == 0.5 and q.tolist() == [[127, 2, 4, -2]]


# ------------------------------------------------- int8 kernel plain versions

TABLES = {  # (page_table, page_type, page_ntok), B = 2
    "mixed": ([[0, 1, 0, 2, 3], [2, 1, 0, 0, 0]],
              [[0, 1, 0, 1, 0], [0, 0, 1, 2, 2]],
              [[16, 16, 16, 16, 9], [16, 16, 5, 0, 0]]),
    "empty_pages": ([[0, 0, 1, 0, 2], [0, 1, 0, 3, 0]],
                    [[2, 0, 2, 1, 1], [1, 2, 2, 0, 2]],
                    [[0, 16, 0, 16, 4], [13, 0, 0, 8, 0]]),
}


def _inputs(seed, kvh=2, g=3, d=64, D=32, B=2):
    rng = np.random.default_rng(seed)
    r = lambda *sh, s=1.0, o=0.0: (rng.standard_normal(sh) * s + o).astype(np.float32)
    return dict(q=r(B, kvh, g, D), k=r(4, 16, kvh, D, s=0.3),
                v=r(4, 16, kvh, D, s=0.3), act=r(3, 16, d, s=0.5, o=0.2),
                scale=r(d, s=0.1, o=1.0), wk=r(d, kvh, D, s=0.1),
                wv=r(d, kvh, D, s=0.1))


def _q8(x):
    """(codes, scales) of x by the reference's quantizer, as numpy."""
    q, s = JQ.quantize(jnp.asarray(x))
    return np.array(q), np.array(s)


@pytest.mark.parametrize("table", sorted(TABLES))
@pytest.mark.parametrize("norm", ["layernorm", "rmsnorm"])
def test_int8_fused_plain_matches_pallas_and_ref(table, norm):
    """float32, zero bias: the port's int8 fused mode against the reference
    Pallas kernel (interpret mode, as tests/test_kernels.py runs its int8
    mode) and its ref, given the same codes and scales."""
    x = _inputs(0)
    (kq, ks), (vq, vs), (aq, as_) = _q8(x["k"]), _q8(x["v"]), _q8(x["act"])
    pt, pty, pn = (np.asarray(a, np.int32) for a in TABLES[table])
    launches = hybrid_paged_attention.q8_launches
    got = hybrid_paged_attention(
        t(x["q"]), t(kq), t(vq), t(aq), t(x["scale"]),
        torch.zeros(x["scale"].shape), t(x["wk"]), t(x["wv"]), t(pt), t(pty),
        t(pn), k_scales=t(ks), v_scales=t(vs), act_scales=t(as_),
        norm_type=norm).numpy()
    assert hybrid_paged_attention.q8_launches == launches   # CPU: plain version
    args = [jnp.asarray(a) for a in (x["q"], kq, vq, aq, x["scale"], x["wk"],
                                     x["wv"], pt, pty, pn)]
    sc = dict(k_scales=jnp.asarray(ks), v_scales=jnp.asarray(vs),
              act_scales=jnp.asarray(as_))
    pallas = j_hybrid(*args, norm_type=norm, interpret=True, **sc)
    ref = j_hybrid_ref(*args, norm_type=norm, **sc)
    np.testing.assert_allclose(got, np.asarray(pallas), atol=TOL)
    np.testing.assert_allclose(got, np.asarray(ref), atol=TOL)


def test_int8_two_pool_plain_matches_ref():
    """The second-pool mode's int8 KV pools with a scratch pool that
    ``kv_gen`` recomputed from the int8 ACT pool: the reference's int8 ref
    over the fused tables, float32, zero bias."""
    x = _inputs(1)
    (kq, ks), (vq, vs), (aq, as_) = _q8(x["k"]), _q8(x["v"]), _q8(x["act"])
    pt, pty, pn = (np.asarray(a, np.int32) for a in TABLES["mixed"])
    ak, av = kv_gen(t(aq), t(x["scale"]), None, t(x["wk"]), t(x["wv"]),
                    act_scales=t(as_), eps=1e-5)
    got = hybrid_paged_attention_two_pool(
        t(x["q"]), t(kq), t(vq), ak, av, t(pt), t(pty), t(pn),
        k_scales=t(ks), v_scales=t(vs)).numpy()
    ref = j_hybrid_ref(*[jnp.asarray(a) for a in (x["q"], kq, vq, aq,
                                                  x["scale"], x["wk"], x["wv"],
                                                  pt, pty, pn)],
                       norm_type="rmsnorm", k_scales=jnp.asarray(ks),
                       v_scales=jnp.asarray(vs), act_scales=jnp.asarray(as_))
    np.testing.assert_allclose(got, np.asarray(ref), atol=TOL)


@pytest.mark.parametrize("norm", ["rmsnorm", "layernorm"])
def test_int8_kv_gen_plain_matches_pallas(norm):
    """kv_gen over int8 ACT pages against the reference kv_gen (which has
    no int8 mode) over the pages the model path's fake quantization
    stores, float32, zero bias."""
    x = _inputs(2)
    aq, as_ = _q8(x["act"])
    deq = JQ.dequantize(jnp.asarray(aq), jnp.asarray(as_))
    eps = 1e-5 if norm == "layernorm" else 1e-6
    launches = kv_gen.q8_launches
    k, v = kv_gen(t(aq), t(x["scale"]), torch.zeros(x["scale"].shape),
                  t(x["wk"]), t(x["wv"]), act_scales=t(as_), norm_type=norm,
                  eps=eps)
    assert kv_gen.q8_launches == launches
    args = [deq] + [jnp.asarray(x[n]) for n in ("scale", "wk", "wv")]
    pk, pv = j_kv_gen(*args, norm_type=norm, eps=eps, interpret=True)
    rk, rv = j_kv_gen_ref(*args, norm_type=norm, eps=eps)
    for mine, pallas, ref in ((k, pk, rk), (v, pv, rv)):
        np.testing.assert_allclose(mine.numpy(), np.asarray(pallas), atol=TOL)
        np.testing.assert_allclose(mine.numpy(), np.asarray(ref), atol=TOL)


# the reference's int8 kernel keeps code * scale in float32 and norms and
# projects without rounding; the port rounds where the model path does.  At
# these widths (d = 64, unit-scale outputs) the two differ by a few ulps of
# the dtype: 2**-7 (float16) and 2**-4 (bfloat16) absolute bound them.
LOW_TOL = {"float16": 2.0 ** -7, "bfloat16": 2.0 ** -4}


def _run_mode(mode, x, dt, q8):
    """The port's plain version of ``mode`` in dtype ``dt``: over int8 codes
    and scales (q8), else over ``x``'s pools as given."""
    tt = lambda a: t(np.asarray(a)) if isinstance(a, np.ndarray) else a
    pt, pty, pn = (t(np.asarray(a, np.int32)) for a in TABLES["mixed"])
    q, scale, wk, wv = (t(x[n]).to(dt) for n in ("q", "scale", "wk", "wv"))
    zero = torch.zeros(scale.shape, dtype=dt)
    if q8:
        k, v, act = (tt(x[n][0]) for n in ("k", "v", "act"))
        sc = {f"{n}_scales": tt(x[n][1]) for n in ("k", "v", "act")}
    else:
        k, v, act = (x[n] for n in ("k", "v", "act"))
        sc = {}
    act_s = {"act_scales": sc.pop("act_scales")} if q8 else {}
    if mode == "fused":
        return hybrid_paged_attention(q, k, v, act, scale, zero, wk, wv, pt, pty,
                                      pn, norm_type="rmsnorm", **sc, **act_s)
    if mode == "kv_gen":
        return torch.cat(kv_gen(act, scale, None, wk, wv, **act_s), -1)
    ak, av = kv_gen(act, scale, None, wk, wv, **act_s)
    return hybrid_paged_attention_two_pool(q, k, v, ak, av, pt, pty, pn, **sc)


@pytest.mark.parametrize("mode", ["fused", "two_pool", "kv_gen"])
@pytest.mark.parametrize("dtype", ["float16", "bfloat16"])
def test_int8_plain_rounds_where_the_model_path_rounds(mode, dtype):
    """In float16 and bfloat16 the int8 modes read rnd(code * scale), the
    value the model path's fake quantization stores: bit for bit the fp
    modes over the reference's ``dequantize(q, s, dtype)`` pools.  The same
    modes over pools dequantized in float32 (unrounded, as the reference's
    int8 kernel reads them) give other outputs, so the test sees the
    rounding point.  And the reference's int8 kernel (Pallas, interpret
    mode) stays within LOW_TOL."""
    tdt, jdt = DTYPES[dtype]
    x = _inputs(3)
    codes = {n: _q8(x[n]) for n in ("k", "v", "act")}
    got = _run_mode(mode, dict(x, **codes), tdt, q8=True)
    model = {n: t(_np(JQ.dequantize(jnp.asarray(c), jnp.asarray(s), jdt))).to(tdt)
             for n, (c, s) in codes.items()}
    assert torch.equal(got, _run_mode(mode, dict(x, **model), tdt, q8=False))
    unrounded = {n: dequantize(t(c), t(s)) for n, (c, s) in codes.items()}
    other = _run_mode(mode, dict(x, **unrounded), tdt, q8=False).to(tdt)
    assert not torch.equal(got, other)
    if mode == "fused":
        args = [jnp.asarray(a).astype(jdt) for a in (x["q"],)]
        args += [jnp.asarray(codes[n][0]) for n in ("k", "v", "act")]
        args += [jnp.asarray(x[n]).astype(jdt) for n in ("scale", "wk", "wv")]
        args += [jnp.asarray(np.asarray(a, np.int32)) for a in TABLES["mixed"]]
        pallas = j_hybrid(*args, norm_type="rmsnorm", interpret=True,
                          **{f"{n}_scales": jnp.asarray(codes[n][1])
                             for n in ("k", "v", "act")})
        np.testing.assert_allclose(got.float().numpy(), _np(pallas),
                                   atol=LOW_TOL[dtype])


def test_int8_wrappers_take_all_scales_or_none():
    x = _inputs(4)
    (kq, ks), (vq, vs), (aq, as_) = _q8(x["k"]), _q8(x["v"]), _q8(x["act"])
    pt, pty, pn = (t(np.asarray(a, np.int32)) for a in TABLES["mixed"])
    with pytest.raises(ValueError, match="all of"):
        hybrid_paged_attention(t(x["q"]), t(kq), t(vq), t(aq), t(x["scale"]),
                               None, t(x["wk"]), t(x["wv"]), pt, pty, pn,
                               k_scales=t(ks), v_scales=t(vs),
                               norm_type="rmsnorm")
    with pytest.raises(ValueError, match="all of"):
        hybrid_paged_attention_two_pool(t(x["q"]), t(kq), t(vq), t(kq), t(vq),
                                        pt, pty, pn, k_scales=t(ks))


# ----------------------------------------------------------------- the model

@pytest.fixture(scope="module", params=["opt-6.7b-reduced", "yi-6b-reduced"])
def model(request):
    name = request.param
    jcfg = j_get_config(name)
    jp = JM.init_params(jcfg, jax.random.PRNGKey(0))
    tp = P.from_numpy(jax.tree.map(np.asarray, jp), device="cpu")
    return get_config(name), tp, jcfg, jp


PREFILL_CAP = 64


def _prefill_batch(cfg, B=3, S=40):
    toks = np.random.default_rng(0).integers(0, cfg.vocab_size,
                                             (B, S)).astype(np.int32)
    return toks, np.array([16, 0, 32], np.int32), np.array([40, 37, 40], np.int32)


@pytest.fixture(scope="module")
def jax_prefill(model):
    """The reference's quantized prefill of ``_prefill_batch``, run once per
    model (its arrays are immutable)."""
    cfg, _, jcfg, jp = model
    toks, kv_keep, last = _prefill_batch(cfg)
    return JM.hybrid_prefill_batched(
        jp, jcfg, {"tokens": jnp.asarray(toks)}, PREFILL_CAP, PREFILL_CAP,
        jnp.asarray(kv_keep), jnp.asarray(last), quant=JQuant())


def _prefill(model, jax_prefill):
    cfg, tp, *_ = model
    toks, kv_keep, last = _prefill_batch(cfg)
    lg, c = M.hybrid_prefill_batched(tp, cfg, t(toks), PREFILL_CAP, PREFILL_CAP,
                                     t(kv_keep), t(last), quant=QuantConfig())
    return (lg, c) + tuple(jax_prefill)


def test_prefill_stores_the_references_codes(model, jax_prefill):
    lg, c, jlg, jc = _prefill(model, jax_prefill)
    np.testing.assert_allclose(lg.numpy(), np.asarray(jlg), atol=LOGIT_TOL)
    for key in ("k", "v", "act"):
        assert c[key].dtype == torch.int8 and c[key + "_s"].dtype == torch.float16
        _codes_close(c[key], c[key + "_s"], jc[key], key)
    for key in ("act_pos", "kv_len", "act_len"):
        np.testing.assert_array_equal(c[key].numpy(), np.asarray(jc[key]))


def test_decode_with_act_bound_rows_matches_jax(model, jax_prefill):
    """Two quantized decode steps from the same int8 cache (the reference's
    prefill, its fake-quantized values requantized: the same codes), with
    ACT-bound and KV-bound tokens.  The reference attends an ACT-bound
    token to its own EXACT K/V; a port that wrote the checkpoint first and
    let the kernels recompute that token's K/V from its int8 checkpoint
    (the unquantized path's order) misses LOGIT_TOL by far: that mutation
    of the port measured logit gaps of 1.6e-3 (opt-6.7b-reduced) and
    4.4e-3 (yi-6b-reduced)."""
    cfg, tp, jcfg, jp = model
    _, c, jlg, jc = _prefill(model, jax_prefill)
    for key in ("k", "v", "act"):              # the reference's exact state
        c[key], c[key + "_s"] = quantize(t(np.array(jc[key])))
    tok = np.asarray(jnp.argmax(jlg[:, -1], -1)).astype(np.int32)
    for store in ([True, False, True], [True, True, False]):
        s = np.array(store)
        lg, c = M.hybrid_decode_step(tp, cfg, t(tok)[:, None], c, t(s),
                                     quant=QuantConfig())
        jlg2, jc = JM.hybrid_decode_step(jp, jcfg, jnp.asarray(tok)[:, None],
                                         jc, jnp.asarray(s), quant=JQuant())
        np.testing.assert_allclose(lg.numpy(), np.asarray(jlg2), atol=LOGIT_TOL)
        for key in ("k", "v", "act"):
            _codes_close(c[key], c[key + "_s"], jc[key], key)
        tok = np.asarray(jnp.argmax(jlg2[:, -1], -1)).astype(np.int32)


def test_step_without_act_bound_tokens_skips_the_exact_rows(model, jax_prefill,
                                                           monkeypatch):
    """A quantized step whose schedule binds no token to the ACT region
    (``any_act=False``, what the engine passes in kv mode) runs the fused
    kernel without ``return_lse`` and writes no scratch row, and gives the
    reference's logits and cache as the merging step does."""
    cfg, tp, jcfg, jp = model
    _, c, jlg, jc = _prefill(model, jax_prefill)
    for key in ("k", "v", "act"):
        c[key], c[key + "_s"] = quantize(t(np.array(jc[key])))
    tok = np.asarray(jnp.argmax(jlg[:, -1], -1)).astype(np.int32)
    store = np.zeros(3, bool)
    seen = []
    real_fused, real_rows = M.hybrid_paged_attention, M._own_rows
    monkeypatch.setattr(M, "hybrid_paged_attention", lambda *a, **kw: (
        seen.append(("lse", kw["return_lse"])), real_fused(*a, **kw))[1])
    monkeypatch.setattr(M, "_own_rows", lambda *a: (
        seen.append(("rows", True)), real_rows(*a))[1])
    lg, c = M.hybrid_decode_step(tp, cfg, t(tok)[:, None], c, t(store),
                                 quant=QuantConfig(), any_act=False)
    assert seen == ([] if cfg.pos_type == "rope"
                    else [("lse", False)] * cfg.num_layers)
    jlg2, jc = JM.hybrid_decode_step(jp, jcfg, jnp.asarray(tok)[:, None], jc,
                                     jnp.asarray(store), quant=JQuant())
    np.testing.assert_allclose(lg.numpy(), np.asarray(jlg2), atol=LOGIT_TOL)
    for key in ("k", "v", "act"):
        _codes_close(c[key], c[key + "_s"], jc[key], key)


def test_cache_format_must_match_quant(model):
    cfg, tp, *_ = model
    c = M.init_hybrid_cache(cfg, 1, 16, 16, device="cpu")
    assert "k_s" not in c
    with pytest.raises(ValueError, match="does not match"):
        M.hybrid_decode_step(tp, cfg, torch.zeros((1, 1), dtype=torch.int32), c,
                             torch.tensor([False]), quant=QuantConfig())
    with pytest.raises(ValueError, match="int8 codes with float16"):
        M.init_hybrid_cache(cfg, 1, 16, 16, device="cpu",
                            quant=QuantConfig(kv_dtype="fp8"))


def test_q8_oracle_matches_jax(model):
    """prefill_q8 and three decode_step_q8 steps against the reference's."""
    cfg, tp, jcfg, jp = model
    B, S, max_len = 2, 9, 32
    toks = np.random.default_rng(0).integers(0, cfg.vocab_size,
                                             (B, S)).astype(np.int32)
    lg, c = QC.prefill_q8(tp, cfg, t(toks), max_len)
    jlg, jc = JQC.prefill_q8(jp, jcfg, {"tokens": jnp.asarray(toks)}, max_len)
    np.testing.assert_allclose(lg.numpy(), np.asarray(jlg), atol=LOGIT_TOL)
    for step in range(3):
        tok = np.asarray(jnp.argmax(jlg[:, -1], -1)).astype(np.int32)
        lg, c = QC.decode_step_q8(tp, cfg, t(tok)[:, None], c, bound=S + step + 1)
        jlg, jc = JQC.decode_step_q8(jp, jcfg, jnp.asarray(tok)[:, None], jc)
        np.testing.assert_allclose(lg.numpy(), np.asarray(jlg), atol=LOGIT_TOL)
        for key in ("k", "v"):
            _codes_close(c[key + "_q"], c[key + "_s"],
                         JQ.dequantize(jc[key + "_q"], jc[key + "_s"]), key)


# ------------------------------------------------------------------- pricing

@pytest.mark.parametrize("name", ["opt-6.7b-reduced", "yi-6b-reduced",
                                  "minitron-4b-reduced", "opt-6.7b", "yi-6b"])
def test_quant_pricing_matches_jax(name):
    """Block bytes, lane slopes, the host split, the device ACT blocks, the
    simulator's totals and ``explain()``'s quant line equal the reference's
    under QuantConfig(), and the blocks shrink at least 1.8x."""
    cfg, jcfg = get_config(name), j_get_config(name)
    hw = cm.H100_SXM
    jhw = j_cm.HardwareSpec(**dataclasses.asdict(hw))
    q, jq = QuantConfig(), JQuant()
    assert blocks.kv_block_bytes(cfg, quant=q) == j_blocks.kv_block_bytes(jcfg, quant=jq)
    assert blocks.act_block_bytes(cfg, quant=q) == j_blocks.act_block_bytes(jcfg, quant=jq)
    assert blocks.kv_block_bytes(cfg) / blocks.kv_block_bytes(cfg, quant=q) >= 1.8
    assert blocks.act_block_bytes(cfg) / blocks.act_block_bytes(cfg, quant=q) >= 1.8
    for mine, ref in zip(cm.profile_cost_fns(cfg, hw, quant=q),
                         j_cm.profile_cost_fns(jcfg, jhw, quant=jq)):
        assert (mine.slope, mine.intercept) == (ref.slope, ref.intercept)
    assert cm.cpu_attend_seconds_per_token(cfg, hw, quant=q) == \
        j_cm.cpu_attend_seconds_per_token(jcfg, jhw, quant=jq)
    specs = [[pipeline.MiniBatchSpec(2, 300 + 10 * s, 40 + s, 0, ctx_tokens=400,
                                     cpu_host_tokens=50)] for s in range(3)]
    jspecs = [[j_pipe.MiniBatchSpec(2, 300 + 10 * s, 40 + s, 0, ctx_tokens=400,
                                    cpu_host_tokens=50)] for s in range(3)]
    for mine, ref in zip(pipeline.simulate_steps(cfg, hw, specs, quant=q),
                         j_pipe.simulate_steps(jcfg, jhw, jspecs, quant=jq)):
        assert mine.total == pytest.approx(ref.total, rel=1e-12)
        assert mine.traffic == pytest.approx(ref.traffic, rel=1e-12)
    dev_act = policy.device_act_blocks(cfg, hw, quant=q)
    assert dev_act == j_policy.device_act_blocks(jcfg, jhw, quant=jq)
    mine = policy.host_block_allocation(cfg, hw, dev_act, quant=q)
    ref = j_policy.host_block_allocation(jcfg, jhw, dev_act, quant=jq)
    assert dataclasses.astuple(mine) == dataclasses.astuple(ref)
    # explain()'s byte math at small pools (a pool lists its free blocks)
    sizes = dict(host_kv_blocks=7, host_act_blocks=5, dev_kv_blocks=64,
                 dev_act_blocks=3)
    mine = blocks.BlockManager(cfg, quant=q, **sizes).explain().splitlines()
    ref = j_blocks.BlockManager(jcfg, quant=jq, **sizes).explain().splitlines()
    assert mine[0].split("quant=")[1] == ref[0].split("quant=")[1] == \
        "kv=int8 act=int8 scales=float16"
    assert mine[1:] == ref[1:]                # the per-shard column too


# ------------------------------------------------------------------ engine

@pytest.fixture(scope="module")
def reqs():
    return request_trace(1024, n_requests=3, prompt_mean=40, gen_tokens=6, seed=7)


@pytest.mark.parametrize("mode,hw", [("hybrid", Q_MIXED), ("kv", cm.H100_SXM)],
                         ids=["hybrid-mixed", "kv"])
def test_quant_engine_matches_jax_engine(model, reqs, mode, hw):
    """The quant engine's tokens, host split, block counters and simulated
    time equal the JAX quant engine's (Q_MIXED splits the prompts, so the
    hybrid decode reads KV and ACT pages and has ACT-bound tokens)."""
    cfg, tp, jcfg, jp = model
    eng = HybridServeEngine(cfg, tp, mode=mode, hw=hw, quant=QuantConfig(),
                            device="cpu")
    j_eng = JEngine(jcfg, jp, mode=mode, quant=JQuant(),
                    hw=j_cm.HardwareSpec(**dataclasses.asdict(hw)))
    assert eng.act_frac == j_eng.act_frac
    out, stats = eng.generate(reqs)
    j_out, j_stats = j_eng.generate(reqs)
    for r in reqs:
        np.testing.assert_array_equal(out[r.rid], j_out[r.rid])
    assert stats.device_calls == j_stats.device_calls
    assert stats.sim_time == pytest.approx(j_stats.sim_time, rel=1e-12)
    for key, pool in eng.blockman.pools.items():
        j_pool = j_eng.blockman.pools[(j_blocks.BlockType(key[0].value),
                                       j_blocks.Location(key[1].value))]
        assert (pool.capacity, pool.allocated) == (j_pool.capacity, 0)
    if mode == "hybrid":
        _, kv_keep, pbs, sched, *_ = eng.group_schedule(eng.plan_groups(reqs)[0])
        assert ((kv_keep > 0) & (kv_keep < np.asarray(pbs))).any()
        assert sched.any()
