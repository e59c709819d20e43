"""The port's encoder-decoder family (whisper) against the JAX package: the
flash kernel's non-causal mode (plain version), the fused hybrid kernel's
plain version over the cross-ACT checkpoint, and whisper-base-reduced's
``prefill`` and ``decode_step`` in both cross modes; the serving paths'
refusals and ``check_supported``'s message.

The same inputs, made from a numpy seed, go through both sides; the model
cases share the reference's weights (``init_params`` at seed 0 through
``params.from_numpy``), in float32.  Tolerances: 1e-5 for attention at
unit-scale inputs (two float32 softmax/dot orders), as
``tests/test_torch_kernels.py`` states it; logits and the greedy tokens
within 2e-3 of JAX, the bound of ``tests/test_decode_equiv.py``, and the
cross-ACT logits within 2e-3 of cross-KV, as that file's
``test_cross_act_matches_cross_kv`` holds the reference.  The port's
checkpoint is the encoder's last residual before ``enc_norm`` (ROADMAP
queue 3, O): ``enc_norm`` of it is the reference's ``enc_act``.  On the
CPU every wrapper takes its plain version, and no launch is counted."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as j_get_config
from repro.kernels.flash_attention.kernel import flash_attention as j_flash
from repro.kernels.flash_attention.ref import flash_attention_ref as j_flash_ref
from repro.models import layers as JL
from repro.models import model as JM
from repro_torch import params as P
from repro_torch.configs import get_config
from repro_torch.kernels.flash_attention.ops import flash_attention
from repro_torch.kernels.hybrid_attention.ops import hybrid_paged_attention
from repro_torch.models import model as M
from repro_torch.models import transformer as T
from repro_torch.offload.executor import OffloadExecutor
from repro_torch.serving import ContinuousBatchingServer, HybridServeEngine

torch.set_num_threads(1)
ATTN_TOL, TOL = 1e-5, 2e-3
NAME = "whisper-base-reduced"
B, S, MAX_LEN, STEPS = 2, 7, 16, 4
t = torch.from_numpy
_MODELS = {}


def _model(F=None):
    """(port cfg, port params, JAX cfg, JAX params) of whisper-base-reduced,
    with ``enc_seq_len`` F where given (the weights' ``enc_pos`` follows)."""
    if F not in _MODELS:
        cfg, jcfg = get_config(NAME), j_get_config(NAME)
        if F is not None:
            cfg = dataclasses.replace(cfg, enc_seq_len=F)
            jcfg = dataclasses.replace(jcfg, enc_seq_len=F)
        jp = JM.init_params(jcfg, jax.random.PRNGKey(0))
        tp = P.from_numpy(jax.tree.map(np.asarray, jp), device="cpu")
        _MODELS[F] = (cfg, tp, jcfg, jp)
    return _MODELS[F]


def _inputs(cfg, seed=0):
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)
    frames = rng.standard_normal((B, cfg.enc_seq_len, cfg.d_model)) \
        .astype(np.float32)
    return toks, frames


# ------------------------------------------------------------ flash, non-causal

@pytest.mark.parametrize("Bq,Sq,H,KVH,D", [(2, 64, 4, 4, 16), (1, 32, 4, 2, 32)])
def test_flash_plain_noncausal_matches_pallas_and_ref(Bq, Sq, H, KVH, D):
    rng = np.random.default_rng(Sq + KVH)
    q = rng.standard_normal((Bq, Sq, H, D)).astype(np.float32)
    k, v = (rng.standard_normal((Bq, Sq, KVH, D)).astype(np.float32)
            for _ in range(2))
    launches = flash_attention.noncausal_launches
    got = flash_attention(t(q), t(k), t(v), causal=False).numpy()
    assert flash_attention.noncausal_launches == launches   # CPU: plain version
    jq, jk, jv = map(jnp.asarray, (q, k, v))
    pallas = j_flash(jq, jk, jv, causal=False, q_chunk=16, k_chunk=16,
                     interpret=True)
    np.testing.assert_allclose(got, np.asarray(pallas), atol=ATTN_TOL)
    np.testing.assert_allclose(
        got, np.asarray(j_flash_ref(jq, jk, jv, causal=False)), atol=ATTN_TOL)
    # the causal mask is off: the causal result differs
    assert np.abs(got - flash_attention(t(q), t(k), t(v)).numpy()).max() > 0.1


@pytest.mark.parametrize("Sq,Sk,KVH", [(5, 37, 2), (48, 27, 4)])
def test_flash_plain_cross_lengths_match_blockwise(Sq, Sk, KVH):
    """Sq != Sk, as the decoder's cross attention over the F frames: the
    reference's ``blockwise_attention(causal=False)`` computes it there."""
    rng = np.random.default_rng(Sq * Sk)
    q = rng.standard_normal((2, Sq, 4, 16)).astype(np.float32)
    k, v = (rng.standard_normal((2, Sk, KVH, 16)).astype(np.float32)
            for _ in range(2))
    got = flash_attention(t(q), t(k), t(v), causal=False).numpy()
    want = JL.blockwise_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                  causal=False, q_chunk=16, k_chunk=16)
    np.testing.assert_allclose(got, np.asarray(want), atol=ATTN_TOL)


def test_flash_refuses_a_window_without_causality():
    """Refused before any device is looked at: no path attends through a
    bidirectional window, and none falls back to another mode."""
    for dev in ("cpu", "meta"):
        x = torch.zeros((1, 8, 2, 16), device=dev)
        with pytest.raises(ValueError, match="causal=False"):
            flash_attention(x, x, x, causal=False, window=4)


# ------------------------------------------------- fused plain, cross-ACT pages

@pytest.mark.parametrize("F", [32, 27])
def test_fused_plain_over_the_checkpoint_matches_cross_act_attention(F):
    """The fused plain version over an all-ACT table of the pre-norm
    checkpoint (``enc_norm`` as its norm, ``xattn.wk``/``wv`` as its
    projections, the last page ragged at F = 27) against the reference's
    cross-ACT attention: ``enc_norm``, the projections, ``decode_attention``
    over the F frames."""
    cfg, tp, jcfg, jp = _model(F)
    rng = np.random.default_rng(F)
    pre = rng.standard_normal((B, F, cfg.d_model)).astype(np.float32)
    q = rng.standard_normal((B, 1, cfg.num_heads, cfg.head_dim)).astype(np.float32)
    act = torch.zeros((B, M.enc_act_len(cfg), cfg.d_model))
    act[:, :F] = t(pre)
    assert act.shape[1] % M.PAGE == 0
    tables = M.cross_page_table(B, F, "cpu")
    assert tables[2][0, -1].item() == F - (M.enc_act_len(cfg) - M.PAGE)
    no_kv = torch.zeros((1, M.PAGE, cfg.num_kv_heads, cfg.head_dim))
    for i in range(cfg.num_layers):
        lp = T.layer_params(tp, i)
        launches = hybrid_paged_attention.launches
        got = M._cross_act_attend(lp, cfg, t(q), tp["enc_norm"], act, tables,
                                  no_kv)
        assert hybrid_paged_attention.launches == launches
        jl = jax.tree.map(lambda a: a[i], jp["layers"])
        enc = JL.apply_norm(jnp.asarray(pre), jp["enc_norm"], jcfg.norm_type)
        shape = (B, F, cfg.num_kv_heads, cfg.head_dim)
        ck = (enc @ jl["xattn"]["wk"]).reshape(shape)
        cv = (enc @ jl["xattn"]["wv"]).reshape(shape)
        want = JL.decode_attention(jnp.asarray(q), ck, cv, kv_len=F)
        np.testing.assert_allclose(got.reshape(B, 1, -1, cfg.head_dim).numpy(),
                                   np.asarray(want), atol=ATTN_TOL)


# ---------------------------------------------------------------- the model

def _run_jax(jcfg, jp, toks, frames, cross_act):
    lg, cache = JM.prefill(jp, jcfg, {"tokens": jnp.asarray(toks),
                                      "frames": jnp.asarray(frames)},
                           MAX_LEN, cross_act=cross_act)
    logits, cur = [np.asarray(lg)[:, -1]], np.asarray(lg)[:, -1].argmax(-1)
    first = cache
    for _ in range(STEPS):
        lg, cache = JM.decode_step(jp, jcfg, jnp.asarray(cur[:, None], jnp.int32),
                                   cache)
        logits.append(np.asarray(lg)[:, -1])
        cur = logits[-1].argmax(-1)
    return np.stack(logits, 1), first


def _run_port(cfg, tp, toks, frames, cross_act, feed):
    """Prefill, then STEPS decode steps fed the tokens ``feed`` (B, STEPS)
    chose.  -> (logits (B, STEPS + 1, V), the cache after prefill, copied)."""
    lg, cache = M.prefill(tp, cfg, t(toks), MAX_LEN, frames=t(frames),
                          cross_act=cross_act)
    first = {k: v.clone() for k, v in cache.items()}
    logits = [lg[:, -1].numpy()]
    for s in range(STEPS):
        lg, cache = M.decode_step(tp, cfg, t(feed[:, s:s + 1].astype(np.int32)),
                                  cache)
        logits.append(lg[:, -1].numpy())
    return np.stack(logits, 1), first


@pytest.mark.parametrize("F", [None, 27], ids=["F32", "F27"])
def test_whisper_matches_jax_in_both_cross_modes(F):
    """Prefill's last logits, the caches, and 4 greedy decode steps in both
    cross modes against JAX, the greedy tokens equal; cross-ACT within 2e-3
    of cross-KV.  F = 27 leaves the checkpoint's last page ragged."""
    cfg, tp, jcfg, jp = _model(F)
    toks, frames = _inputs(cfg)
    got = {}
    for cross_act in (False, True):
        want, jcache = _run_jax(jcfg, jp, toks, frames, cross_act)
        gold = want[:, :-1].argmax(-1)
        lg, cache = _run_port(cfg, tp, toks, frames, cross_act, gold)
        np.testing.assert_allclose(lg, want, atol=TOL)
        np.testing.assert_array_equal(lg.argmax(-1), want.argmax(-1))
        np.testing.assert_array_equal(cache["kv_len"].numpy(), [S] * B)
        for key in ("self_k", "self_v"):
            np.testing.assert_allclose(cache[key][:, :, :S].numpy(),
                                       np.asarray(jcache[key])[:, :, :S],
                                       atol=1e-5)
        if cross_act:
            assert "cross_k" not in cache and "cross_k" not in jcache
            act = cache["enc_act"]
            assert act.shape == (B, M.enc_act_len(cfg), cfg.d_model)
            assert not act[:, cfg.enc_seq_len:].any()        # the page padding
            normed = M.L.apply_norm(act[:, :cfg.enc_seq_len], tp["enc_norm"],
                                    cfg.norm_type)
            np.testing.assert_allclose(normed.numpy(),
                                       np.asarray(jcache["enc_act"]), atol=1e-5)
        else:
            for key in ("cross_k", "cross_v"):
                np.testing.assert_allclose(cache[key].numpy(),
                                           np.asarray(jcache[key]), atol=1e-5)
        got[cross_act] = lg
    np.testing.assert_allclose(got[True], got[False], atol=TOL)


def test_cross_act_cache_is_smaller_by_the_papers_ratio():
    """2·L·KVH·D/d_model fewer cross-cache bytes: 12x at whisper-base's
    widths, 11.9x with the checkpoint padded to whole pages (1504 rows)."""
    cfg = get_config("whisper-base")
    meta = lambda c: sum(v.numel() * v.element_size() for k, v in c.items()
                         if k not in ("self_k", "self_v", "kv_len"))
    kv = meta(M.init_cache(cfg, 4, 8, device="meta"))
    act = meta(M.cache_spec_cross_act(cfg, 4, 8, device="meta"))
    assert kv == 6 * 4 * 1500 * 8 * 64 * 2 * 2
    assert act == 4 * 1504 * 512 * 2
    assert 11.9 < kv / act < 12.0
    assert M.enc_act_len(cfg) // M.PAGE == 94
    tables = M.cross_page_table(4, cfg.enc_seq_len, "cpu")
    assert tables[2][:, :-1].eq(16).all() and tables[2][:, -1].eq(12).all()
    assert tables[1].eq(1).all() and tables[0][3, 0].item() == 3 * 94


def test_embed_input_frontends_match_jax():
    cfg, tp, jcfg, jp = _model()
    toks, frames = _inputs(cfg)
    # the reference reads the batch size from "token" when it has no tokens
    want, _ = JM.embed_input(jp, jcfg, {"frames": jnp.asarray(frames),
                                        "token": jnp.zeros((B, 1), jnp.int32)})
    got = M.embed_input(tp, cfg, frames=t(frames))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6)
    want, _ = JM.embed_input(jp, jcfg, {"tokens": jnp.asarray(toks)})
    np.testing.assert_allclose(M.embed_input(tp, cfg, t(toks)).numpy(),
                               np.asarray(want), atol=1e-6)


@pytest.mark.parametrize("name", ["whisper-base-reduced", "qwen2-vl-2b-reduced"])
def test_param_trees_convert_key_for_key(name):
    """``from_numpy`` maps the reference's encdec and vlm trees key for key
    and shape for shape, and the port's own ``init_params`` draws the same
    tree."""
    jp = JM.init_params(j_get_config(name), jax.random.PRNGKey(0))
    tp = P.from_numpy(jax.tree.map(np.asarray, jp), device="cpu")
    shapes = lambda tree: {k: shapes(v) if isinstance(v, dict)
                           else tuple(v.shape) for k, v in tree.items()}
    assert shapes(tp) == shapes(jp)
    assert shapes(M.init_params(get_config(name), seed=0, device="cpu")) == \
        shapes(jp)


# ------------------------------------------------------------------ refusals

@pytest.mark.parametrize("name", ["whisper-base-reduced", "qwen2-vl-2b-reduced"])
def test_serving_paths_refuse_the_frontend_models(name):
    """The engine, the offload executor and the server refuse whisper and
    qwen2-vl, as the reference's engine asserts its uniform family; so do
    the hybrid model functions."""
    cfg = get_config(name)
    tp = M.init_params(cfg, seed=0, device="cpu")
    with pytest.raises(NotImplementedError, match="the engine and the offload"):
        HybridServeEngine(cfg, tp, device="cpu")
    with pytest.raises(NotImplementedError, match="the engine and the offload"):
        OffloadExecutor(cfg, tp, device="cpu")
    with pytest.raises(NotImplementedError, match="the server"):
        ContinuousBatchingServer(cfg, tp, device="cpu")
    with pytest.raises(NotImplementedError, match="hybrid model functions"):
        M.init_hybrid_cache(cfg, 1, 16, 16, device="cpu")


@pytest.mark.parametrize("path", sorted(T.SERVES))
def test_refusal_message_names_each_path_and_what_it_serves(path):
    """Every refusal names the refusing path and carries what each path
    serves, and why the serving paths refuse the encdec and vlm models."""
    cfg = get_config(NAME) if path not in ("plain", "train") else \
        dataclasses.replace(get_config(NAME), frontend="none")
    with pytest.raises(NotImplementedError) as e:
        T.check_supported(cfg, path)
    fam = "encdec"
    assert str(e.value) == (
        f"{cfg.name} ({fam} family, frontend {cfg.frontend}, learned "
        f"positions): not served by {T.PATH_NAMES[path]}.  " + T.SERVED)
    text = T.SERVED
    for phrase in ("on the plain path (prefill -> decode_loop)",
                   "On the hybrid model functions",
                   "On the engine and the offload executor, and on the server",
                   "uniform-family", "SSD stacks", "asserts the uniform family",
                   "batched prefill takes no patches"):
        assert phrase in text, phrase
    T.check_supported(get_config(NAME))                # the plain path serves it
    T.check_supported(get_config("qwen2-vl-2b"))
