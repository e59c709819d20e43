"""Training of the ssm and hybrid families in the port against the JAX
reference: the SSD scan's plain backward (``ssd_scan_bwd_ref``, the plain
version of the card's ``ssd_scan_bwd`` kernel) against ``jax.vjp`` of the
reference's ``ssd_chunked``, the loss and every gradient leaf of
``apply_train`` for mamba2-2.7b and jamba-1.5-large (one period: seven SSD
layers, four of them MoE, and a NoPE attention layer) at their reduced
widths, the train step, and the training CLI.

Weights are the reference's ``init_params`` through ``params.from_numpy``,
inputs come from numpy seeds, float32 on both sides.  The SSD layers' dt
biases are drawn as Mamba-2 inits them (softplus(dt_bias) log-uniform in
[1e-3, 1e-1], as ``chip_smoke.py`` draws them): at the reference's zero
bias (dt ~ 0.7, A down to -16) a chunk's cum_i - cum_j above the diagonal
passes 88, exp() overflows there, and XLA's gradient of ``ssd_chunked``'s
``where(tri, exp(diff), 0)`` is 0 * inf: every gradient leaf of the
reference's ``apply_train`` is NaN (ROADMAP queue 3, Q).  The port's plain
scan zeroes that exponent first and its backward takes exp() only where
j <= i, so its gradients stay finite there
(``test_training_accepts_the_ssm_and_hybrid_families`` in
``tests/test_torch_train.py``; the sequential recurrence's autograd below).
Tolerances: the backward's outputs 1e-5 of each one's largest reference
entry (float32 sums of a few hundred terms in another order); losses 1e-5
absolute, gradients 1e-5 of the leaf's largest reference entry, the train
step's parameters as ``tests/test_torch_train.py`` holds them."""
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as j_get_config
from repro.launch import specs as JS
from repro.models import layers as JL
from repro.models import model as JM
from repro.optim import adamw as jadamw
from repro_torch import params as P
from repro_torch.configs import get_config
from repro_torch.data import DataConfig, lm_batches
from repro_torch.kernels.ssd_scan import ops as SSD
from repro_torch.kernels.ssd_scan.ref import (ssd_chunked_ref,
                                              ssd_ref_sequential,
                                              ssd_scan_bwd_ref)
from repro_torch.launch import specs as S
from repro_torch.launch import train
from repro_torch.models import model as M
from repro_torch.optim import adamw

torch.set_num_threads(1)
LOSS_TOL, GRAD_RTOL, BWD_RTOL = 1e-5, 1e-5, 1e-5
MODELS = ["mamba2-2.7b-reduced", "jamba-1.5-large-398b-reduced"]
GRADS = ("dx", "ddt", "dA", "dB", "dC")


def _dt_bias(shape, rng):
    """softplus^-1 of a log-uniform draw in [1e-3, 1e-1] (Mamba-2's init)."""
    dt0 = np.exp(rng.uniform(math.log(1e-3), math.log(1e-1), shape))
    return (dt0 + np.log(-np.expm1(-dt0))).astype(np.float32)


def _jax_params(name):
    """(port config, port params, reference config, reference params), the
    reference's weights with every SSD layer's dt bias at Mamba-2's init."""
    jcfg = j_get_config(name)
    tree = jax.tree.map(np.asarray, JM.init_params(jcfg, jax.random.PRNGKey(0)))
    rng = np.random.default_rng(1)
    stacks = [tree["layers"]] if "layers" in tree else \
        [tree["periods"][k] for k in ("ssd_dense", "ssd_moe")
         if k in tree["periods"]]
    for stack in stacks:
        stack["ssd"]["dt_bias"] = _dt_bias(stack["ssd"]["dt_bias"].shape, rng)
    return (get_config(name), P.from_numpy(tree, device="cpu"), jcfg,
            jax.tree.map(jnp.asarray, tree))


def _batch(cfg, B, S, seed, masked=0):
    rng = np.random.default_rng(seed)
    out = {"tokens": rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32),
           "labels": rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)}
    out["labels"].reshape(-1)[rng.choice(B * S, masked, replace=False)] = -1
    return out


def _torch_batch(b):
    return {k: torch.from_numpy(v) for k, v in b.items()}


def _flat(tree, prefix=""):
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


def _close_to_max(got, want, rtol, what):
    """Within ``rtol`` of ``want``'s largest entry."""
    want = _np(want)
    np.testing.assert_allclose(_np(got), want, rtol=0,
                               atol=rtol * float(np.abs(want).max()),
                               err_msg=what)


def _scan_inputs(b, s, h, p, n, seed, a_top=2.0, dt_top=0.3):
    """x, B, C ~ N(0, 1), dt uniform in [0.01, dt_top], A = -linspace(0.5,
    a_top, h), and the cotangents of y and of the final state, float32
    numpy."""
    rng = np.random.default_rng(seed)
    f = lambda *shape: rng.standard_normal(shape).astype(np.float32)
    return (f(b, s, h, p), rng.uniform(0.01, dt_top, (b, s, h)).astype(
        np.float32), -np.linspace(0.5, a_top, h).astype(np.float32),
        f(b, s, n), f(b, s, n), f(b, s, h, p), f(b, h, p, n))


def _grads_no_remat(params, cfg, batch):
    flat = adamw.leaves(params)
    for p in flat:
        p.requires_grad_(True)
    loss, _ = M.apply_train(params, cfg, batch, remat=False)
    grads = dict(zip(map(id, flat), torch.autograd.grad(loss, flat)))
    for p in flat:
        p.requires_grad_(False)
    return adamw.tree_map(lambda p: grads[id(p)], params)


# (p, n, chunk) at a chunk multiple and at a ragged s
BWD_CASES = [(16, 32, 16, 48), (16, 32, 16, 37), (64, 128, 64, 128),
             (64, 128, 64, 100)]


@pytest.mark.parametrize("p,n,chunk,s", BWD_CASES)
def test_ssd_scan_bwd_ref_matches_the_reference_vjp(p, n, chunk, s):
    """``ssd_scan_bwd_ref`` against ``jax.vjp`` of the reference's
    ``ssd_chunked`` (B and C as one group, (b, s, 1, n)) with cotangents for
    y and for the final state: dx, ddt, dA, dB and dC within 1e-5 of each
    one's largest reference entry.  dt |A| summed over a chunk stays under
    88, where the reference's gradient is finite.  Autograd through the
    plain forward ``ssd_chunked_ref``, and ``ssd_scan`` on CPU tensors that
    require a gradient, give the same gradients."""
    b, h = 2, 3
    x, dt, A, B, C, dy, dfin = _scan_inputs(b, s, h, p, n, seed=p + s)
    fwd = lambda x, dt, A, B, C: JL.ssd_chunked(
        x, dt, A, B[:, :, None], C[:, :, None], chunk=chunk)
    want = jax.jit(lambda *a: jax.vjp(fwd, *a[:5])[1]((a[5], a[6])))(
        x, dt, A, B, C, dy, dfin)
    t = [torch.from_numpy(a) for a in (x, dt, A, B, C, dy, dfin)]
    got = ssd_scan_bwd_ref(*t, chunk=chunk)
    for name, g, w in zip(GRADS, got, want):
        w = np.asarray(w).reshape(g.shape)
        assert g.dtype == torch.float32
        _close_to_max(g, w, BWD_RTOL, f"{name} vs jax.vjp")
    for fn in (lambda *a: ssd_chunked_ref(*a, chunk=chunk),
               lambda *a: SSD.ssd_scan(*a, chunk=chunk)):
        leaves = [a.clone().requires_grad_(True) for a in t[:5]]
        y, final = fn(*leaves)
        auto = torch.autograd.grad((y, final), leaves, (t[5], t[6]))
        for name, a, g in zip(GRADS, auto, got):
            _close_to_max(a, g, BWD_RTOL, f"autograd {name}")


def test_ssd_scan_bwd_ref_where_a_chunk_decays_past_exp_range():
    """At dt up to 1 and A down to -16 (mamba2's A at its zero dt bias), a
    chunk of 64 rows takes cum_i - cum_j past 88 above the diagonal, where
    the reference's gradient is 0 * inf: ``ssd_scan_bwd_ref`` and autograd
    through ``ssd_chunked_ref`` stay finite and equal the autograd of the
    sequential recurrence ``ssd_ref_sequential`` (whose decay factors are
    exp(dt A) <= 1, one step at a time), within 1e-5 of each output's
    largest entry, at a ragged s."""
    b, s, h, p, n, chunk = 2, 100, 3, 16, 32, 64
    x, dt, A, B, C, dy, _ = _scan_inputs(b, s, h, p, n, seed=9, a_top=16.0,
                                         dt_top=1.0)
    t = [torch.from_numpy(a) for a in (x, dt, A, B, C, dy)]
    assert float((t[1][:, :chunk] * -t[2]).sum(1).max()) > 88
    leaves = [a.clone().requires_grad_(True) for a in t[:5]]
    want = torch.autograd.grad(ssd_ref_sequential(*leaves), leaves, t[5])
    got = ssd_scan_bwd_ref(*t, chunk=chunk)
    leaves = [a.clone().requires_grad_(True) for a in t[:5]]
    auto = torch.autograd.grad(ssd_chunked_ref(*leaves, chunk=chunk)[0],
                               leaves, t[5])
    for name, g, a, w in zip(GRADS, got, auto, want):
        assert torch.isfinite(g).all() and torch.isfinite(a).all(), name
        _close_to_max(g, w, BWD_RTOL, f"{name} vs the sequential recurrence")
        _close_to_max(a, w, BWD_RTOL, f"autograd {name}")


def test_the_card_backward_takes_its_one_shape():
    """The card's backward is built for (p, n, chunk) = (64, 128, 64), the
    models the port trains; the wrapper refuses any other before a launch
    (the C entry refuses them too, ``chip_smoke.py`` checks)."""
    x = torch.zeros((1, 8, 2, 64))
    SSD._check_bwd(x, torch.zeros((1, 8, 128)), 64)
    for p, n, chunk in ((32, 128, 64), (64, 64, 64), (64, 128, 32)):
        with pytest.raises(ValueError, match="no gradient"):
            SSD._check_bwd(torch.zeros((1, 8, 2, p)), torch.zeros((1, 8, n)),
                           chunk)


@pytest.mark.parametrize("name", MODELS)
def test_apply_train_loss_aux_and_every_grad_leaf(name):
    """The loss, ce, aux (jamba's four MoE layers) and every gradient leaf
    against ``jax.value_and_grad(apply_train)`` with remat at a ragged S
    (40 over chunk 16), and the port's gradients with remat equal to those
    without."""
    cfg, tp, jcfg, jp = _jax_params(name)
    b = _batch(cfg, 2, 40, seed=5, masked=6)
    (jl, jm), jg = jax.jit(jax.value_and_grad(
        lambda p: JM.apply_train(p, jcfg, jax.tree.map(jnp.asarray, b),
                                 remat=True), has_aux=True))(jp)
    loss, metrics, grads = S.loss_and_grads(tp, cfg, _torch_batch(b))
    assert abs(loss.item() - float(jl)) <= LOSS_TOL
    assert abs(float(metrics["ce"]) - float(jm["ce"])) <= LOSS_TOL
    assert abs(float(metrics["aux"]) - float(jm["aux"])) <= LOSS_TOL
    assert (float(metrics["aux"]) > 0) == cfg.is_moe
    mine, ref = _flat(grads), _flat(jg)
    assert set(mine) == set(ref)
    for key in ref:
        assert np.isfinite(_np(ref[key])).all(), key
        _close_rel(mine[key], ref[key], GRAD_RTOL, f"{name} grad {key}")
    for key, g in _flat(_grads_no_remat(tp, cfg, _torch_batch(b))).items():
        torch.testing.assert_close(g, mine[key], rtol=0, atol=0,
                                   msg=f"{name} remat vs not: {key}")


def test_train_step_matches_the_reference():
    """``make_train_step`` (remat, AdamW) on mamba2-2.7b-reduced against
    the reference's: loss, lr, gnorm and every updated parameter, held as
    ``tests/test_torch_train.py`` holds minitron's."""
    cfg, tp, jcfg, jp = _jax_params(MODELS[0])
    ocfg = dict(lr=1e-3, warmup_steps=1, total_steps=10)
    raw = next(lm_batches(DataConfig(vocab_size=cfg.vocab_size, seq_len=32,
                                     batch_size=4)))
    jstep = JS.make_train_step(jcfg, jadamw.AdamWConfig(**ocfg))
    jp2, _, jm = jax.jit(jstep)(jp, jadamw.init(jp),
                                jax.tree.map(jnp.asarray, raw))
    step = S.make_train_step(cfg, adamw.AdamWConfig(**ocfg))
    tp2, state, tm = step(tp, adamw.init(tp), _torch_batch(raw))
    assert int(state.step) == 1
    for key in ("loss", "lr", "gnorm"):
        assert abs(float(tm[key]) - float(jm[key])) <= \
            LOSS_TOL * max(1.0, abs(float(jm[key]))), key
    lr = ocfg["lr"]
    for key, ref in _flat(jp2).items():
        diff = np.abs(_np(_flat(tp2)[key]) - _np(ref))
        assert diff.max() <= 2 * lr + 1e-5, (key, diff.max())
        assert (diff > 1e-5).mean() <= 1e-4, (key, (diff > 1e-5).sum())


def test_train_cli_trains_mamba2_on_the_cpu():
    """``python -m repro_torch.launch.train --arch mamba2-2.7b-reduced
    --device cpu --steps 2``: finite losses from the port's own init."""
    losses = train.main(["--arch", MODELS[0], "--device", "cpu", "--steps",
                         "2", "--batch", "2", "--seq", "16"])
    assert len(losses) == 2 and np.isfinite(losses).all()
