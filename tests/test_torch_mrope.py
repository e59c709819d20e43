"""qwen2-vl's M-RoPE path in the port against the JAX package: the
three-stream tables ``mrope_sin_cos``, the patch-grid positions, and
qwen2-vl-2b-reduced's ``prefill`` (16 patch embeddings before the text)
and ``decode_step``; the hybrid model functions' refusal of M-RoPE (the
reference's hybrid step rotates RoPE only).

Inputs from a numpy seed; the reference's weights (``init_params`` at seed
0 through ``params.from_numpy``), float32.  Tolerances: the tables 1e-7 up
to position 131,072, as ``tests/test_torch_rope.py`` holds RoPE's (the
frequencies taken in float64 and rounded once); logits 2e-3 with the greedy
tokens equal, the bound of ``tests/test_decode_equiv.py``."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as j_get_config
from repro.models import layers as JL
from repro.models import model as JM
from repro_torch import params as P
from repro_torch.configs import get_config
from repro_torch.models import layers as L
from repro_torch.models import model as M

torch.set_num_threads(1)
TABLE_TOL, TOL = 1e-7, 2e-3
NAME = "qwen2-vl-2b-reduced"
B, S, STEPS = 2, 9, 4
t = torch.from_numpy
_MODEL = {}


def _model():
    if not _MODEL:
        cfg, jcfg = get_config(NAME), j_get_config(NAME)
        jp = JM.init_params(jcfg, jax.random.PRNGKey(0))
        _MODEL["v"] = (cfg, P.from_numpy(jax.tree.map(np.asarray, jp),
                                         device="cpu"), jcfg, jp)
    return _MODEL["v"]


def _close(got, want, tol, what):
    err = np.abs(got.numpy() - np.asarray(want)).max()
    assert err <= tol, f"{what}: {err} > {tol}"


# (head_dim, theta): qwen2-vl-2b's, and its reduced variant's head_dim
@pytest.mark.parametrize("head_dim,theta", [(128, 1e6), (32, 1e6)])
def test_mrope_tables_match_jax_at_long_positions(head_dim, theta):
    """Three independent streams up to position 131,072: each frequency
    rotates by its own section's stream."""
    rng = np.random.default_rng(head_dim)
    n = 2048
    pos = np.stack([rng.integers(0, 131_073, n), rng.integers(0, 131_073, n),
                    np.arange(131_073 - n, 131_073)], -1).astype(np.int32)
    sin, cos = L.mrope_sin_cos(t(pos)[None], head_dim, theta)
    jsin, jcos = JL.mrope_sin_cos(jnp.asarray(pos)[None], head_dim, theta)
    assert sin.shape == (1, n, head_dim // 2)
    _close(sin, jsin, TABLE_TOL, "sin")
    _close(cos, jcos, TABLE_TOL, "cos")


def test_text_only_mrope_is_rope():
    """Three equal streams (text) give RoPE's tables exactly."""
    pos = np.arange(0, 131_073, 97).astype(np.int32)[None]
    three = np.repeat(pos[..., None], 3, -1)
    for a, b in zip(L.mrope_sin_cos(t(three), 128, 1e6),
                    L.rope_sin_cos(t(pos), 128, 1e6)):
        assert torch.equal(a, b)


@pytest.mark.parametrize("P_", [16, 256, 12])
def test_positions_match_the_references_grid(P_):
    cfg = dataclasses.replace(get_config(NAME), frontend_tokens=P_)
    jcfg = dataclasses.replace(j_get_config(NAME), frontend_tokens=P_)
    n = P_ + 11
    want = JM._positions_for(jcfg, {"tokens": jnp.zeros((B, 11), jnp.int32)}, n)
    got = M.mrope_positions(cfg, B, n, "cpu")
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_qwen2_vl_matches_jax():
    """``prefill`` over 16 patches + the prompt, then 4 greedy decode
    steps (the text continuing at kv_len - P + t0), against JAX; the greedy
    tokens equal, the self K/V cache too."""
    cfg, tp, jcfg, jp = _model()
    rng = np.random.default_rng(0)
    toks = rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)
    patches = rng.standard_normal((B, cfg.frontend_tokens, cfg.d_model)) \
        .astype(np.float32)
    max_len = cfg.frontend_tokens + S + STEPS
    jl, jc = JM.prefill(jp, jcfg, {"tokens": jnp.asarray(toks),
                                   "patches": jnp.asarray(patches)}, max_len)
    tl, tc = M.prefill(tp, cfg, t(toks), max_len, patches=t(patches))
    n = cfg.frontend_tokens + S
    np.testing.assert_allclose(tc["k"][:, :, :n].numpy(),
                               np.asarray(jc["k"])[:, :, :n], atol=1e-5)
    want, got = [np.asarray(jl)[:, -1]], [tl[:, -1].numpy()]
    for _ in range(STEPS):
        cur = want[-1].argmax(-1).astype(np.int32)[:, None]
        jl, jc = JM.decode_step(jp, jcfg, jnp.asarray(cur), jc)
        tl, tc = M.decode_step(tp, cfg, t(cur), tc)
        want.append(np.asarray(jl)[:, -1])
        got.append(tl[:, -1].numpy())
    want, got = np.stack(want, 1), np.stack(got, 1)
    np.testing.assert_allclose(got, want, atol=TOL)
    np.testing.assert_array_equal(got.argmax(-1), want.argmax(-1))
    assert tc["kv_len"].tolist() == [n + STEPS] * B


def test_prefill_needs_patches_and_takes_no_frames():
    cfg, tp, _, _ = _model()
    toks = torch.zeros((1, 3), dtype=torch.int32)
    with pytest.raises(ValueError, match="patches"):
        M.prefill(tp, cfg, toks, 32)
    with pytest.raises(ValueError, match="encdec"):
        M.prefill(tp, cfg, toks, 32, cross_act=True)


def test_hybrid_model_functions_refuse_mrope():
    """The reference's ``hybrid_decode_step`` rotates ``pos_type == "rope"``
    only, so the port has no hybrid M-RoPE path to hold against it: the
    hybrid prefill, cache and decode step refuse M-RoPE; the plain path
    serves it, and refuses M-RoPE without the patch grid it is laid on."""
    cfg, tp, _, _ = _model()
    toks = torch.zeros((1, 20), dtype=torch.int32)
    with pytest.raises(NotImplementedError, match="hybrid model functions"):
        M.hybrid_prefill(tp, cfg, toks, 32, 32, 16)
    with pytest.raises(NotImplementedError, match="hybrid model functions"):
        M.init_hybrid_cache(cfg, 1, 32, 32, device="cpu")
    yi = get_config("yi-6b-reduced")
    cache = M.init_hybrid_cache(yi, 1, 32, 32, device="cpu")
    with pytest.raises(NotImplementedError, match="hybrid model functions"):
        M.hybrid_decode_step(tp, cfg, toks[:, :1], cache,
                             torch.zeros(1, dtype=torch.bool))
    M.T.check_supported(cfg)
    with pytest.raises(NotImplementedError, match="plain path"):
        M.T.check_supported(dataclasses.replace(cfg, frontend="none"))
