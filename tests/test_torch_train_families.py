"""Training of the windowed, encdec and vision families in the port against
the JAX reference: the flash backward's plain version in its window and
non-causal modes and at head_dim 256, the loss and every gradient leaf of
``apply_train`` (gemma3-1b and gemma3-27b with a window crossed and a tail
layer, whisper-base with its encoder, qwen2-vl-2b with its patches and
M-RoPE), the microbatched train step with frames, and the training CLI with
its zero patches and frames (the ``meta`` shape specs of the three families
are cases of ``tests/test_torch_train.py``'s).

Weights are the reference's ``init_params`` through ``params.from_numpy``
(the windowed models' q/k norm scales perturbed, so that the norms weigh on
q and k), inputs come from numpy seeds, float32 on both sides (the reduced
configs).  Tolerances are ``tests/test_torch_train.py``'s: losses 1e-5
absolute, gradients 1e-5 of each leaf's largest reference entry, attention
gradients 1e-5 absolute."""
import dataclasses

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
from repro_torch.kernels.flash_attention.ops import flash_attention
from repro_torch.kernels.flash_attention.ref import (flash_attention_bwd_ref,
                                                     flash_attention_ref)
from repro_torch.launch import specs as S
from repro_torch.launch import train
from repro_torch.models import model as M
from repro_torch.models import transformer as T
from repro_torch.optim import adamw

torch.set_num_threads(1)
LOSS_TOL, GRAD_RTOL, ATTN_TOL = 1e-5, 1e-5, 1e-5
# gemma3 cut to a local, a global and a tail layer, its window under the
# sequence (S 40 > W 16), so both the window mask and the tail run
WINDOWED = dict(num_layers=3, sliding_window=16)
MODELS = {"gemma3-1b-reduced": WINDOWED, "gemma3-27b-reduced": WINDOWED,
          "whisper-base-reduced": {}, "qwen2-vl-2b-reduced": {}}
TOKENS = {"gemma3-1b-reduced": 40, "gemma3-27b-reduced": 40}


def _jax_params(name, **changes):
    jcfg = dataclasses.replace(j_get_config(name), **changes)
    tree = jax.tree.map(np.asarray, JM.init_params(jcfg, jax.random.PRNGKey(0)))
    if "periods" in tree:
        rng = np.random.default_rng(5)
        stacks = [tree["periods"]["local"], tree["periods"]["global"]]
        stacks += [tree["tail"]] if "tail" in tree else []
        for stack in stacks:
            for key in ("qnorm", "knorm"):
                a = stack["attn"][key]
                stack["attn"][key] = (a + rng.normal(0, 0.3, a.shape)).astype(
                    a.dtype)
    return (dataclasses.replace(get_config(name), **changes),
            P.from_numpy(tree, device="cpu"), jcfg,
            jax.tree.map(jnp.asarray, tree))


def _batch(cfg, B, S, seed, masked=0):
    """tokens and labels (B, S) int32, ``masked`` labels -1, and the
    frontend's float32 input: patches (B, P, d) or frames (B, F, d)."""
    rng = np.random.default_rng(seed)
    out = {"tokens": rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32),
           "labels": rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)}
    out["labels"].reshape(-1)[rng.choice(B * S, masked, replace=False)] = -1
    if cfg.frontend == "vision_stub":
        out["patches"] = rng.standard_normal(
            (B, cfg.frontend_tokens, cfg.d_model)).astype(np.float32)
    if cfg.is_encoder_decoder:
        out["frames"] = rng.standard_normal(
            (B, cfg.enc_seq_len, cfg.d_model)).astype(np.float32)
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


def _grads_no_remat(params, cfg, batch):
    flat = adamw.leaves(params)
    for p in flat:
        p.requires_grad_(True)
    loss, metrics = M.apply_train(params, cfg, batch, remat=False)
    grads = dict(zip(map(id, flat), torch.autograd.grad(loss, flat)))
    for p in flat:
        p.requires_grad_(False)
    return adamw.tree_map(lambda p: grads[id(p)], params)


# (mode, D, G): each mode at D 64 and 256 and at G 1 and 4
BWD_CASES = [("window", 64, 1), ("window", 256, 4), ("noncausal", 64, 4),
             ("noncausal", 256, 1), ("causal", 256, 1), ("causal", 256, 4)]


@pytest.mark.parametrize("mode,D,G", BWD_CASES)
def test_flash_bwd_ref_matches_the_reference_vjp(mode, D, G):
    """``flash_attention_bwd_ref`` from the forward's lse against
    ``jax.vjp`` of ``blockwise_attention`` (its custom VJP, mask
    ``_tile_mask``) over 16-position chunks: a window of 16 at a ragged
    S = 37, non-causal with Sq 24 over Sk 37, and causal (D = 256 is new to
    the gradient in every mode).  The CPU autograd path of
    ``flash_attention`` in the same mode gives the same gradients."""
    B, KVH = 2, 2
    H = KVH * G
    Sq, Sk = (24, 37) if mode == "noncausal" else (37, 37)
    window, causal = (16 if mode == "window" else 0), mode != "noncausal"
    rng = np.random.default_rng(G * 1000 + D + len(mode))
    q, do = (rng.standard_normal((B, Sq, H, D)).astype(np.float32)
             for _ in range(2))
    k, v = (rng.standard_normal((B, Sk, KVH, D)).astype(np.float32)
            for _ in range(2))
    attn = lambda q, k, v: JL.blockwise_attention(
        q, k, v, causal=causal, window=window, q_chunk=16, k_chunk=16)
    out, want = jax.jit(lambda q, k, v, do: (
        lambda o, vjp: (o, vjp(do)))(*jax.vjp(attn, q, k, v)))(q, k, v, do)
    tq, tk, tv, tdo = map(torch.from_numpy, (q, k, v, do))
    o, lse = flash_attention_ref(tq, tk, tv, window, causal, return_lse=True)
    assert lse.shape == (B, H, Sq)
    np.testing.assert_allclose(o.numpy(), np.asarray(out), atol=ATTN_TOL)
    got = flash_attention_bwd_ref(tq, tk, tv, o, lse, tdo, window, causal)
    for name, g, w in zip("qkv", got, want):
        assert g.shape == w.shape
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=ATTN_TOL,
                                   err_msg=f"d{name}")
    xs = [t.clone().requires_grad_(True) for t in (tq, tk, tv)]
    flash_attention(*xs, causal=causal, window=window).backward(tdo)
    for name, x, g in zip("qkv", xs, got):
        np.testing.assert_allclose(x.grad.numpy(), g.numpy(), atol=ATTN_TOL,
                                   err_msg=f"autograd d{name}")


@pytest.mark.parametrize("name", sorted(MODELS))
def test_apply_train_loss_aux_and_every_grad_leaf(name):
    """The loss, ce, aux and every gradient leaf against
    ``jax.value_and_grad(apply_train)`` with remat (the encoder's leaves
    too: the gradient reaches them through the cross attention), and the
    port's gradients with remat equal to those without."""
    cfg, tp, jcfg, jp = _jax_params(name, **MODELS[name])
    b = _batch(cfg, 2, TOKENS.get(name, 24), seed=5, masked=6)
    (jl, jm), jg = jax.jit(jax.value_and_grad(
        lambda p: JM.apply_train(p, jcfg, jax.tree.map(jnp.asarray, b),
                                 remat=True), has_aux=True))(jp)
    loss, metrics, grads = S.loss_and_grads(tp, cfg, _torch_batch(b))
    assert abs(loss.item() - float(jl)) <= LOSS_TOL
    assert abs(float(metrics["ce"]) - float(jm["ce"])) <= LOSS_TOL
    assert abs(float(metrics["aux"]) - float(jm["aux"])) <= LOSS_TOL
    mine, ref = _flat(grads), _flat(jg)
    assert set(mine) == set(ref)
    for key in ref:
        _close_rel(mine[key], ref[key], GRAD_RTOL, f"{name} grad {key}")
    if cfg.is_encoder_decoder:
        assert float(mine["enc_layers/attn/wq"].abs().max()) > 0
    plain = _grads_no_remat(tp, cfg, _torch_batch(b))
    for key, g in _flat(plain).items():
        torch.testing.assert_close(g, mine[key], rtol=0, atol=0,
                                   msg=f"{name} remat vs not: {key}")


def test_microbatched_train_step_with_frames_matches_the_reference():
    """``make_train_step`` with 2 microbatches on whisper-base-reduced (one
    encoder and one decoder layer): frames, tokens and labels sliced by the
    same rows, loss, lr, gnorm and every updated parameter against the
    reference's step."""
    cfg, tp, jcfg, jp = _jax_params("whisper-base-reduced", num_layers=1,
                                    enc_num_layers=1)
    ocfg = dict(lr=1e-3, warmup_steps=1, total_steps=10)
    raw = _batch(cfg, 4, 16, seed=9)
    jstep = JS.make_train_step(jcfg, jadamw.AdamWConfig(**ocfg), 2)
    jp2, _, jm = jax.jit(jstep)(jp, jadamw.init(jp),
                                jax.tree.map(jnp.asarray, raw))
    step = S.make_train_step(cfg, adamw.AdamWConfig(**ocfg), 2)
    tp2, state, tm = step(tp, adamw.init(tp), _torch_batch(raw))
    assert int(state.step) == 1
    for key in ("loss", "lr", "gnorm"):
        assert abs(float(tm[key]) - float(jm[key])) <= \
            LOSS_TOL * max(1.0, abs(float(jm[key]))), key
    # as tests/test_torch_train.py's step: every element within 2 lr, all
    # but 1e-4 of them within 1e-5 (AdamW's first step is sign-like)
    lr = ocfg["lr"]
    for key, ref in _flat(jp2).items():
        diff = np.abs(_np(_flat(tp2)[key]) - _np(ref))
        assert diff.max() <= 2 * lr + 1e-5, (key, diff.max())
        assert (diff > 1e-5).mean() <= 1e-4, (key, (diff > 1e-5).sum())


@pytest.mark.parametrize("name", ["gemma3-1b", "gemma3-27b", "whisper-base",
                                  "qwen2-vl-2b"])
def test_training_accepts_the_three_families(name):
    """The windowed (q/k norm), encdec (audio frames) and vision (patches,
    M-RoPE) families pass the training path's check at full size."""
    T.check_supported(get_config(name), "train")


@pytest.mark.parametrize("name", ["whisper-base-reduced",
                                  "qwen2-vl-2b-reduced"])
def test_train_cli_builds_the_frontend_inputs(name):
    """``python -m repro_torch.launch.train --arch <name> --device cpu
    --steps 2``: the CLI builds zero frames or patches, as the reference's
    does, and gives finite losses."""
    losses = train.main(["--arch", name, "--device", "cpu", "--steps", "2",
                         "--batch", "2", "--seq", "16"])
    assert len(losses) == 2 and np.isfinite(losses).all()
