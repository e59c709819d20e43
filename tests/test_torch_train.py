"""The port's training path against the JAX reference: the loss, every
gradient leaf, the flash backward's plain version, AdamW, the (microbatched)
train step, the LM batches and the ``meta`` shape specs.

Weights are the reference's ``init_params`` through ``params.from_numpy``,
inputs come from numpy seeds, float32 on both sides (the reduced configs).
Tolerances, each the float32 summation-order noise of its quantity:
losses 1e-5 absolute (a mean of ~100 cross entropies of size ~7);
gradients 1e-5 of the leaf's largest reference entry (two framework's
reduction orders through two layers, the remat recompute and a 1024-wide
logsumexp); attention gradients 1e-5 absolute (unit-scale inputs, one
blockwise pass against one dense pass); AdamW 1e-6 of the largest entry
(element-wise float32 arithmetic in the same order, only the gradient norm's
reduction order differs)."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as j_get_config
from repro.data import DataConfig as JDataConfig
from repro.data import lm_batches as j_lm_batches
from repro.launch import specs as JS
from repro.models import layers as JL
from repro.models import model as JM
from repro.optim import adamw as jadamw
from repro_torch import params as P
from repro_torch.configs import SHAPES, get_config
from repro_torch.data import DataConfig, lm_batches
from repro_torch.kernels.flash_attention.ops import flash_attention
from repro_torch.kernels.flash_attention.ref import (flash_attention_bwd_ref,
                                                     flash_attention_ref)
from repro_torch.launch import specs as S
from repro_torch.models import model as M
from repro_torch.models import transformer as T
from repro_torch.optim import adamw

torch.set_num_threads(1)
LOSS_TOL, GRAD_RTOL, ATTN_TOL, ADAMW_RTOL = 1e-5, 1e-5, 1e-5, 1e-6
UNIFORM = ["opt-6.7b-reduced", "yi-6b-reduced", "minitron-4b-reduced",
           "dbrx-132b-reduced"]


def _jax_params(name, **changes):
    jcfg = dataclasses.replace(j_get_config(name), **changes)
    jp = JM.init_params(jcfg, jax.random.PRNGKey(0))
    return dataclasses.replace(get_config(name), **changes), P.from_numpy(
        jax.tree.map(np.asarray, jp), device="cpu"), jcfg, jp


def _batch(cfg, B, S, seed, masked=0):
    """tokens and labels (B, S) int32 numpy; ``masked`` labels set to -1."""
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)
    labels = rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)
    labels.reshape(-1)[rng.choice(B * S, masked, replace=False)] = -1
    return {"tokens": toks, "labels": labels}


def _torch_batch(b):
    return {k: torch.from_numpy(v) for k, v in b.items()}


def _flat(tree, prefix=""):
    """{path: leaf} of a nested dict (JAX arrays or torch tensors)."""
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, f"{prefix}/{k}" if prefix else k))
        return out
    return {prefix: tree}


def _np(x):
    return x.detach().float().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x, np.float32)


def _close_rel(got, want, rtol, what):
    want = _np(want)
    tol = rtol * max(1.0, float(np.abs(want).max()))
    np.testing.assert_allclose(_np(got), want, rtol=0, atol=tol, err_msg=what)


def _grads(params, cfg, batch, remat):
    return S.loss_and_grads(params, cfg, batch) if remat else \
        _grads_no_remat(params, cfg, batch)


def _grads_no_remat(params, cfg, batch):
    flat = adamw.leaves(params)
    for p in flat:
        p.requires_grad_(True)
    loss, metrics = M.apply_train(params, cfg, batch, remat=False)
    grads = dict(zip(map(id, flat), torch.autograd.grad(loss, flat)))
    for p in flat:
        p.requires_grad_(False)
    return loss.detach(), metrics, adamw.tree_map(lambda p: grads[id(p)],
                                                  params)


def test_lm_loss_masks_and_pads_like_the_reference():
    """Chunks of 16 over S = 37 (the last chunk padded with -1 labels), a
    fifth of the labels -1, the logsumexp over the padded vocab (V = 1000,
    1024 rows)."""
    cfg, tp, jcfg, jp = _jax_params("yi-6b-reduced", vocab_size=1000)
    rng = np.random.default_rng(3)
    h = rng.standard_normal((2, 37, cfg.d_model)).astype(np.float32)
    b = _batch(cfg, 2, 37, seed=4, masked=15)
    got = M.lm_loss(tp, cfg, torch.from_numpy(h),
                    torch.from_numpy(b["labels"]), chunk=16)
    want = JM.lm_loss(jp, jcfg, jnp.asarray(h), jnp.asarray(b["labels"]),
                      chunk=16)
    assert abs(got.item() - float(want)) <= LOSS_TOL
    assert tp["embed"].shape[0] > cfg.vocab_size       # the padding is there


@pytest.mark.parametrize("name", UNIFORM)
def test_apply_train_loss_aux_and_every_grad_leaf(name):
    """The loss, ce, aux and every gradient leaf against
    ``jax.value_and_grad(apply_train)`` (remat, as the train step runs it);
    the port's gradients with remat equal those without."""
    cfg, tp, jcfg, jp = _jax_params(name)
    b = _batch(cfg, 2, 24, seed=5, masked=6)
    (jl, jm), jg = jax.value_and_grad(
        lambda p: JM.apply_train(p, jcfg, jax.tree.map(jnp.asarray, b),
                                 remat=True), has_aux=True)(jp)
    loss, metrics, grads = _grads(tp, cfg, _torch_batch(b), remat=True)
    assert abs(loss.item() - float(jl)) <= LOSS_TOL
    assert abs(float(metrics["ce"]) - float(jm["ce"])) <= LOSS_TOL
    assert abs(float(metrics["aux"]) - float(jm["aux"])) <= LOSS_TOL
    if cfg.is_moe:
        assert float(metrics["aux"]) > 0
    mine, ref = _flat(grads), _flat(jg)
    assert set(mine) == set(ref)
    for key in ref:
        _close_rel(mine[key], ref[key], GRAD_RTOL, f"{name} grad {key}")
    _, _, plain = _grads(tp, cfg, _torch_batch(b), remat=False)
    for key, g in _flat(plain).items():
        torch.testing.assert_close(g, mine[key], rtol=0, atol=0,
                                   msg=f"{name} remat vs not: {key}")


@pytest.mark.parametrize("G", [1, 4, 8])
@pytest.mark.parametrize("D", [64, 128])
def test_flash_bwd_ref_matches_the_reference_vjp(G, D):
    """``flash_attention_bwd_ref`` from the forward's lse against
    ``jax.vjp`` of ``blockwise_attention`` (its custom VJP) at a ragged
    S = 37 over 16-position chunks; the CPU autograd path of
    ``flash_attention`` gives the same gradients."""
    B, Sq, KVH = 2, 37, 2
    H = KVH * G
    rng = np.random.default_rng(G * 1000 + D)
    q, do = (rng.standard_normal((B, Sq, H, D)).astype(np.float32)
             for _ in range(2))
    k, v = (rng.standard_normal((B, Sq, KVH, D)).astype(np.float32)
            for _ in range(2))
    out, vjp = jax.vjp(lambda q, k, v: JL.blockwise_attention(
        q, k, v, causal=True, q_chunk=16, k_chunk=16), q, k, v)
    want = vjp(jnp.asarray(do))
    tq, tk, tv, tdo = map(torch.from_numpy, (q, k, v, do))
    o, lse = flash_attention_ref(tq, tk, tv, return_lse=True)
    np.testing.assert_allclose(o.numpy(), np.asarray(out), atol=ATTN_TOL)
    got = flash_attention_bwd_ref(tq, tk, tv, o, lse, tdo)
    for name, g, w in zip("qkv", got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=ATTN_TOL,
                                   err_msg=f"d{name}")
    xs = [t.clone().requires_grad_(True) for t in (tq, tk, tv)]
    flash_attention(*xs).backward(tdo)
    for name, x, g in zip("qkv", xs, got):
        np.testing.assert_allclose(x.grad.numpy(), g.numpy(), atol=ATTN_TOL,
                                   err_msg=f"autograd d{name}")


def test_adamw_matches_the_reference_over_five_steps():
    """cosine_lr through warmup and decay, global_norm, clipping active
    (gradients ~10x the clip), a bfloat16 leaf: five updates, every leaf
    of the params and both moments, lr and gnorm."""
    ocfg = dict(lr=1e-2, warmup_steps=2, total_steps=5, grad_clip=0.5)
    rng = np.random.default_rng(7)
    shapes = {"a": (4, 6), "b": {"c": (7,), "d": (3, 2, 5)}}
    init = {k: rng.standard_normal(s).astype(np.float32)
            for k, s in (("a", (4, 6)), ("c", (7,)), ("d", (3, 2, 5)))}
    jp = {"a": jnp.asarray(init["a"]),
          "b": {"c": jnp.asarray(init["c"]).astype(jnp.bfloat16),
                "d": jnp.asarray(init["d"])}}
    tp = P.from_numpy(jax.tree.map(np.asarray, jp), device="cpu")
    assert tp["b"]["c"].dtype == torch.bfloat16
    jstate, tstate = jadamw.init(jp), adamw.init(tp)
    jc, tc = jadamw.AdamWConfig(**ocfg), adamw.AdamWConfig(**ocfg)
    for step in range(5):
        g = jax.tree.map(lambda s: (10 * rng.standard_normal(s)).astype(
            np.float32), shapes, is_leaf=lambda x: isinstance(x, tuple))
        jg = jax.tree.map(jnp.asarray, g)
        jg["b"]["c"] = jg["b"]["c"].astype(jnp.bfloat16)
        tg = P.from_numpy(jax.tree.map(np.asarray, jg), device="cpu")
        jp, jstate, jm = jadamw.update(jc, jp, jg, jstate)
        tp, tstate, tm = adamw.update(tc, tp, tg, tstate)
        assert float(jm["gnorm"]) > 10 * ocfg["grad_clip"]
        for key in ("lr", "gnorm"):
            np.testing.assert_allclose(tm[key].item(), float(jm[key]),
                                       rtol=ADAMW_RTOL, err_msg=key)
        assert int(tstate.step) == int(jstate.step) == step + 1
        for tree, jtree, what in ((tp, jp, "params"), (tstate.m, jstate.m, "m"),
                                  (tstate.v, jstate.v, "v")):
            for key, ref in _flat(jtree).items():
                got = _flat(tree)[key]
                assert str(got.dtype).removeprefix("torch.") == str(ref.dtype)
                _close_rel(got, ref, ADAMW_RTOL, f"step {step} {what} {key}")
    assert tp["b"]["c"].dtype == torch.bfloat16
    assert tstate.m["b"]["c"].dtype == torch.float32


def test_adamw_slices_equal_the_whole_leaf_update(monkeypatch):
    """``update`` walks each leaf in slices of ``CHUNK`` elements: slices
    of 1000 and of 7 elements give the whole-leaf update bit for bit."""
    rng = np.random.default_rng(8)
    p0 = {"a": torch.from_numpy(rng.standard_normal((100, 37)).astype(
        np.float32)).to(torch.bfloat16),
          "b": torch.from_numpy(rng.standard_normal(333).astype(np.float32))}
    g = adamw.tree_map(lambda t: torch.randn(t.shape).to(t.dtype), p0)
    runs = []
    for chunk in (adamw.CHUNK, 1000, 7):
        monkeypatch.setattr(adamw, "CHUNK", chunk)
        p = adamw.tree_map(torch.clone, p0)
        state = adamw.init(p)
        for _ in range(3):
            p, state, _ = adamw.update(adamw.AdamWConfig(lr=1e-2), p, g, state)
        runs.append(adamw.leaves(p) + adamw.leaves(state.m)
                    + adamw.leaves(state.v))
    for run in runs[1:]:
        for a, b in zip(run, runs[0]):
            assert torch.equal(a, b)


@pytest.mark.parametrize("microbatches", [1, 2])
def test_train_step_matches_the_reference(microbatches):
    """``make_train_step`` (remat, AdamW) against the reference's on
    minitron-4b-reduced, with 1 and 2 microbatches (sequential gradient
    accumulation), as ``tests/test_system.py`` runs it: loss, lr, gnorm and
    every updated parameter."""
    cfg, tp, jcfg, jp = _jax_params("minitron-4b-reduced")
    ocfg = dict(lr=1e-3, warmup_steps=1, total_steps=10)
    raw = next(lm_batches(DataConfig(vocab_size=cfg.vocab_size, seq_len=32,
                                     batch_size=4)))
    jstep = JS.make_train_step(jcfg, jadamw.AdamWConfig(**ocfg), microbatches)
    jp2, _, jm = jax.jit(jstep)(jp, jadamw.init(jp),
                                jax.tree.map(jnp.asarray, raw))
    step = S.make_train_step(cfg, adamw.AdamWConfig(**ocfg), microbatches)
    tp2, state, tm = step(tp, adamw.init(tp), _torch_batch(raw))
    assert int(state.step) == 1
    for key in ("loss", "lr", "gnorm"):
        assert abs(float(tm[key]) - float(jm[key])) <= \
            LOSS_TOL * max(1.0, abs(float(jm[key]))), key
    # AdamW's first step moves each element by ~lr whatever its gradient's
    # size, so an element whose gradient is at float32 noise level may step
    # the other way: every element within 2 lr, and all but 1e-4 of them
    # within 1e-5
    lr = ocfg["lr"]
    for key, ref in _flat(jp2).items():
        got, want = _np(_flat(tp2)[key]), _np(ref)
        diff = np.abs(got - want)
        assert diff.max() <= 2 * lr + 1e-5, (key, diff.max())
        assert (diff > 1e-5).mean() <= 1e-4, (key, (diff > 1e-5).sum())


def test_lm_batches_equal_the_reference():
    """Same DataConfig, same seed: the same token and label arrays."""
    kw = dict(vocab_size=1000, seq_len=40, batch_size=3, seed=11)
    mine, ref = lm_batches(DataConfig(**kw)), j_lm_batches(JDataConfig(**kw))
    for _ in range(3):
        a, b = next(mine), next(ref)
        for key in ("tokens", "labels"):
            assert a[key].dtype == b[key].dtype == np.int32
            np.testing.assert_array_equal(a[key], b[key])


def _same_specs(mine, ref, what):
    flat_m = _flat(mine._asdict() if hasattr(mine, "_asdict") else mine)
    flat_r = _flat(ref._asdict() if hasattr(ref, "_asdict") else ref)
    assert set(flat_m) == set(flat_r), what
    for key, r in flat_r.items():
        m = flat_m[key]
        assert m.device.type == "meta", (what, key)
        assert tuple(m.shape) == tuple(r.shape), (what, key, m.shape, r.shape)
        assert str(m.dtype).removeprefix("torch.") == str(r.dtype), \
            (what, key, m.dtype, r.dtype)


@pytest.mark.parametrize("name", UNIFORM + [
    "minitron-4b", "gemma3-1b-reduced", "whisper-base-reduced",
    "qwen2-vl-2b-reduced", "gemma3-1b", "whisper-base", "qwen2-vl-2b",
    "mamba2-2.7b-reduced", "jamba-1.5-large-398b-reduced", "mamba2-2.7b"])
def test_meta_specs_equal_jax_eval_shape(name):
    """params, optimizer state, the plain cache, the hybrid cache where the
    model has one (``T.SERVES["hybrid"]``), and the batch specs of every input
    shape (patches or frames beside the tokens): the shapes and dtypes of
    ``jax.eval_shape``, on the meta device (the full-size configs allocate
    nothing)."""
    cfg, jcfg = get_config(name), j_get_config(name)
    _same_specs(S.params_shape(cfg), JS.params_shape(jcfg), "params")
    ost, jost = S.optstate_shape(cfg), JS.optstate_shape(jcfg)
    _same_specs({"step": ost.step, "m": ost.m, "v": ost.v},
                {"step": jost.step, "m": jost.m, "v": jost.v}, "optstate")
    _same_specs(S.cache_shape(cfg, 2, 64), JS.cache_shape(jcfg, 2, 64), "cache")
    families, frontends, _ = T.SERVES["hybrid"]
    if T.family(cfg) in families and cfg.frontend in frontends:
        _same_specs(S.hybrid_cache_shape(cfg, 2, 32, 48),
                    JS.hybrid_cache_shape(jcfg, 2, 32, 48), "hybrid cache")
    from repro.configs import SHAPES as J_SHAPES
    for key, shape in SHAPES.items():
        for labels in (True, False):
            _same_specs(S.batch_specs_for(cfg, shape, with_labels=labels),
                        JS.batch_specs_for(jcfg, J_SHAPES[key],
                                           with_labels=labels), key)


@pytest.mark.parametrize("name", ["mamba2-2.7b-reduced",
                                  "jamba-1.5-large-398b-reduced"])
def test_training_accepts_the_ssm_and_hybrid_families(name):
    """The ssm and hybrid configs pass the training path's check, and at
    the reference's own init (dt bias 0: a chunk's decay passes exp()'s
    range above the diagonal, where the reference's gradient is NaN) the
    port's loss and every gradient leaf are finite, A_log's (which reaches
    the loss only through the scan's decay) nonzero.  Their gradients against the
    reference's, at Mamba-2's dt init, are in
    ``tests/test_torch_train_ssm.py``."""
    cfg = get_config(name)
    T.check_supported(cfg, "train")
    params = M.init_params(cfg, seed=0, device="cpu")
    b = _batch(cfg, 1, 24, seed=3)
    loss, metrics, grads = S.loss_and_grads(params, cfg, _torch_batch(b))
    assert np.isfinite(loss.item())
    for key, g in _flat(grads).items():
        assert torch.isfinite(g).all(), (name, key)
    assert float(_flat(grads)[next(k for k in _flat(grads)
                                   if k.endswith("A_log"))].abs().max()) > 0


def test_dense_and_moe_configs_keep_their_serving_signatures():
    """``layer_full`` keeps its (x, cache) pair for the serving callers and
    gives the aux triple only when asked; a dense layer's aux is 0."""
    cfg = dataclasses.replace(get_config("yi-6b-reduced"), num_layers=1)
    p = M.init_params(cfg, device="cpu")
    x = torch.randn(1, 5, cfg.d_model)
    lp = T.layer_params(p, 0)
    sincos = M._sincos_at(cfg, 1, 5, "cpu")
    y, cache = T.layer_full(lp, cfg, x, sincos)
    y2, cache2, aux = T.layer_full(lp, cfg, x, sincos, aux=True)
    assert torch.equal(y, y2) and aux == 0.0
