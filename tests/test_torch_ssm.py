"""The port's SSM family (mamba2) against the JAX package: the plain version
of the ``ssd_scan`` kernel, the SSD layer primitives, and mamba2-2.7b-reduced's
``prefill`` and ``decode_step``.

The same inputs, made from a numpy seed, go through both sides; the model
cases share the reference's weights (``init_params`` through
``params.from_numpy``), in float32.  Tolerances: the kernel's plain version
against the Pallas kernel (interpret mode) and the sequential recurrence
within 2e-3 in float32 and 5e-2 with bfloat16 x, the bounds of
``tests/test_kernels.py``'s ssd cases; the final state, the conv and the
one-token step within 1e-5 (float32 sums of unit-scale terms in another
order); logits 1e-4 and caches 1e-5, as ``tests/test_torch_model.py`` states
them, the SSD state cache with 1e-5 relative beside it (``STATE_RTOL``);
decode against the reference's full forward 2e-3, the bound of
``tests/test_decode_equiv.py``.  On the CPU every wrapper takes its plain
version, and no launch is counted."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as j_get_config
from repro.kernels.ssd_scan.kernel import ssd_scan as j_ssd_scan
from repro.kernels.ssd_scan.ref import ssd_ref_sequential as j_sequential
from repro.models import layers as JL
from repro.models import model as JM
from repro_torch import params as P
from repro_torch.configs import get_config
from repro_torch.kernels.ssd_scan.ops import ssd_scan
from repro_torch.kernels.ssd_scan.ref import ssd_ref_sequential
from repro_torch.models import layers as L
from repro_torch.models import model as M
from repro_torch.offload.executor import OffloadExecutor
from repro_torch.serving import HybridServeEngine

torch.set_num_threads(1)
SCAN_TOL = {"float32": 2e-3, "bfloat16": 5e-2}
STATE_TOL, LOGIT_TOL, CACHE_TOL, FULL_TOL = 1e-5, 1e-4, 1e-5, 2e-3
# the model's SSD state entries reach ~17 at the reduced config (a chunk's
# sum of x dt B products of a few units each, its inputs already a few
# float32 ulps apart after the in_proj GEMM), where 1e-5 is under 10 ulps:
# the state cache is also allowed 1e-5 relative.  Measured: 1.0e-5 and
# 3.3e-5 absolute after prefill, at most 0.68 of the combined bound
STATE_RTOL = 1e-5
NAME = "mamba2-2.7b-reduced"
_MODEL = {}


def _model():
    if not _MODEL:
        jcfg = j_get_config(NAME)
        jp = JM.init_params(jcfg, jax.random.PRNGKey(0))
        tp = P.from_numpy(jax.tree.map(np.asarray, jp), device="cpu")
        _MODEL["v"] = (get_config(NAME), tp, jcfg, jp)
    return _MODEL["v"]


def _close(mine, ref, tol, what, rtol=0.0):
    np.testing.assert_allclose(mine.float().numpy(), np.asarray(ref, np.float32),
                               atol=tol, rtol=rtol, err_msg=what)


def _scan_inputs(b, s, h, p, n, seed=0):
    """The inputs of ``tests/test_kernels.py``'s ssd cases, drawn with numpy:
    x N(0, 0.25), dt softplus(N(0, 1)) / 2, A -exp(N(0, 0.09)), B and C
    N(0, 0.09)."""
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal((b, s, h, p)) * 0.5).astype(np.float32)
    dt = (np.logaddexp(rng.standard_normal((b, s, h)), 0) * 0.5).astype(np.float32)
    A = (-np.exp(rng.standard_normal(h) * 0.3)).astype(np.float32)
    B = (rng.standard_normal((b, s, n)) * 0.3).astype(np.float32)
    C = (rng.standard_normal((b, s, n)) * 0.3).astype(np.float32)
    return x, dt, A, B, C


@pytest.mark.parametrize("b,s,h,p,n,chunk", [
    (2, 64, 3, 16, 32, 16), (1, 128, 2, 32, 64, 32), (2, 32, 1, 8, 16, 8)])
def test_plain_ssd_scan_matches_pallas_and_sequential(b, s, h, p, n, chunk):
    x, dt, A, B, C = _scan_inputs(b, s, h, p, n)
    launches = ssd_scan.launches
    y, _ = ssd_scan(*map(torch.from_numpy, (x, dt, A, B, C)), chunk=chunk)
    assert ssd_scan.launches == launches          # CPU tensor: plain version
    jargs = [jnp.asarray(a) for a in (x, dt, A, B, C)]
    _close(y, j_ssd_scan(*jargs, chunk=chunk), SCAN_TOL["float32"], "pallas")
    _close(y, j_sequential(*jargs), SCAN_TOL["float32"], "sequential")
    seq = ssd_ref_sequential(*map(torch.from_numpy, (x, dt, A, B, C)))
    _close(seq, j_sequential(*jargs), STATE_TOL, "the port's sequential")


def test_plain_ssd_scan_bf16_matches_pallas():
    b, s, h, p, n = 1, 64, 2, 16, 32
    x, dt, A, B, C = _scan_inputs(b, s, h, p, n, seed=1)
    xb = torch.from_numpy(x).to(torch.bfloat16)
    y, _ = ssd_scan(xb, *map(torch.from_numpy, (dt, A, B, C)), chunk=16)
    assert y.dtype == torch.bfloat16
    jx = jnp.asarray(x).astype(jnp.bfloat16)
    rest = [jnp.asarray(a) for a in (dt, A, B, C)]
    _close(y, j_ssd_scan(jx, *rest, chunk=16), SCAN_TOL["bfloat16"], "pallas")
    _close(y, j_sequential(jx.astype(jnp.float32), *rest),
           SCAN_TOL["bfloat16"], "sequential")


@pytest.mark.parametrize("s", [64, 50, 7])
def test_final_state_matches_jax_ssd_chunked(s):
    """The layer's ``ssd_chunked`` (the ``ssd_scan`` wrapper): y and the
    final state against the reference's (the state it hands to decode), at
    a chunk multiple and ragged lengths: the zero padding leaves the state
    as the last real row left it."""
    b, h, p, n, chunk = 2, 3, 16, 32, 16
    x, dt, A, B, C = _scan_inputs(b, s, h, p, n, seed=s)
    y, state = L.ssd_chunked(*map(torch.from_numpy, (x, dt, A, B, C)),
                             chunk=chunk)
    jy, jstate = JL.ssd_chunked(jnp.asarray(x), jnp.asarray(dt), jnp.asarray(A),
                                jnp.asarray(B)[:, :, None], jnp.asarray(C)[:, :, None],
                                chunk=chunk)
    assert state.dtype == torch.float32 and state.shape == (b, h, p, n)
    _close(y, jy, STATE_TOL, "y")
    _close(state, jstate, STATE_TOL, "final state")
    seq = ssd_ref_sequential(*map(torch.from_numpy, (x, dt, A, B, C)))
    _close(y, seq.numpy(), SCAN_TOL["float32"], "sequential")


def test_strided_slices_give_the_contiguous_result():
    """x, B and C as the model passes them, slices of one tensor: the same
    y and state as contiguous copies."""
    b, s, h, p, n = 2, 40, 2, 16, 32
    rng = np.random.default_rng(3)
    xbc = torch.from_numpy((rng.standard_normal((b, s, h * p + 2 * n)) * 0.4)
                           .astype(np.float32))
    xs, Bc, Cc = torch.split(xbc, [h * p, n, n], dim=-1)
    _, dt, A, _, _ = _scan_inputs(b, s, h, p, n, seed=3)
    dt, A = torch.from_numpy(dt), torch.from_numpy(A)
    got = ssd_scan(xs.reshape(b, s, h, p), dt, A, Bc, Cc, chunk=16)
    want = ssd_scan(xs.contiguous().reshape(b, s, h, p), dt, A,
                    Bc.contiguous(), Cc.contiguous(), chunk=16)
    for g, w in zip(got, want):
        assert torch.equal(g, w)


@pytest.mark.parametrize("with_cache", [False, True])
def test_causal_conv1d_matches_jax(with_cache):
    rng = np.random.default_rng(4)
    b, s, ch, width = 2, 9, 24, 4
    x = rng.standard_normal((b, s, ch)).astype(np.float32)
    w = rng.standard_normal((ch, width)).astype(np.float32)
    cache = rng.standard_normal((b, width - 1, ch)).astype(np.float32) \
        if with_cache else None
    y, new = L.causal_conv1d(torch.from_numpy(x), torch.from_numpy(w),
                             None if cache is None else torch.from_numpy(cache))
    jy, jnew = JL.causal_conv1d(jnp.asarray(x), jnp.asarray(w),
                                None if cache is None else jnp.asarray(cache))
    _close(y, jy, STATE_TOL, "y")
    _close(new, jnew, 0.0, "new cache: the last width - 1 input rows")


def test_ssd_decode_step_matches_jax():
    rng = np.random.default_rng(5)
    b, h, p, n = 2, 4, 16, 32
    state = rng.standard_normal((b, h, p, n)).astype(np.float32)
    x_t = rng.standard_normal((b, h, p)).astype(np.float32)
    dt_t = np.logaddexp(rng.standard_normal((b, h)), 0).astype(np.float32)
    A = -np.linspace(1, 16, h).astype(np.float32)
    B_t, C_t = (rng.standard_normal((b, 1, n)).astype(np.float32) for _ in range(2))
    args = (state, x_t, dt_t, A, B_t, C_t)
    y, new = L.ssd_decode_step(*map(torch.from_numpy, args))
    jy, jnew = JL.ssd_decode_step(*map(jnp.asarray, args))
    _close(y, jy, STATE_TOL, "y")
    _close(new, jnew, STATE_TOL, "new state")


def test_params_bridge_keeps_the_ssd_tree():
    """``from_numpy`` carries the SSD leaves as a nested dict, dtypes kept
    (A_log, D and dt_bias float32); the port's own ``init_params`` makes the
    same keys and shapes."""
    cfg, tp, _, jp = _model()
    flat = jax.tree_util.tree_flatten_with_path(jp)[0]
    for path, leaf in flat:
        node = tp
        for key in path:
            node = node[key.key]
        assert tuple(node.shape) == leaf.shape
        np.testing.assert_array_equal(node.numpy(), np.asarray(leaf))
    assert set(tp["layers"]) == {"ln1", "ssd"} and "unembed" not in tp
    assert set(tp["layers"]["ssd"]) == {"in_proj", "conv_w", "A_log", "D",
                                        "dt_bias", "norm", "out_proj"}
    mine = M.init_params(cfg, seed=0, device="cpu")
    shapes = lambda t: jax.tree.map(lambda a: (tuple(a.shape), str(a.dtype)
                                               .removeprefix("torch.")), t)
    assert shapes(mine) == shapes(jp)
    np.testing.assert_allclose(mine["layers"]["ssd"]["A_log"].numpy(),
                               np.asarray(jp["layers"]["ssd"]["A_log"]),
                               rtol=1e-6)


def _tokens(cfg, B, S, seed):
    return np.random.default_rng(seed).integers(
        0, cfg.vocab_size, (B, S)).astype(np.int32)


@pytest.mark.parametrize("S", [40, 48], ids=["ragged", "chunk-multiple"])
def test_prefill_and_decode_match_jax(S):
    """Prefill logits and the state/conv caches against JAX ``prefill`` (the
    reduced config's chunk is 16: 40 leaves a ragged last chunk), then three
    ``decode_step``s, logits and caches each step."""
    cfg, tp, jcfg, jp = _model()
    toks = _tokens(cfg, 2, S + 3, seed=S)
    lg, cache = M.prefill(tp, cfg, torch.from_numpy(toks[:, :S]), max_len=S + 3)
    jlg, jcache = JM.prefill(jp, jcfg, {"tokens": jnp.asarray(toks[:, :S])},
                             max_len=S + 3)
    _close(lg, jlg, LOGIT_TOL, "prefill logits")
    for key in ("state", "conv", "kv_len"):
        _close(cache[key], jcache[key], CACHE_TOL, f"prefill {key}",
               STATE_RTOL if key == "state" else 0.0)
    for t in range(3):
        nxt = toks[:, S + t: S + t + 1]
        lg, cache = M.decode_step(tp, cfg, torch.from_numpy(nxt), cache)
        jlg, jcache = JM.decode_step(jp, jcfg, jnp.asarray(nxt), jcache)
        _close(lg, jlg, LOGIT_TOL, f"decode logits, step {t}")
        for key in ("state", "conv", "kv_len"):
            _close(cache[key], jcache[key], CACHE_TOL, f"{key}, step {t}",
                   STATE_RTOL if key == "state" else 0.0)


def test_decode_matches_the_full_forward():
    """Incremental decode against the reference's full forward over the
    whole sequence (``M.apply_logits``), the property
    ``tests/test_decode_equiv.py`` holds the reference to."""
    cfg, tp, jcfg, jp = _model()
    S, steps = 40, 3
    toks = _tokens(cfg, 2, S + steps, seed=9)
    _, cache = M.prefill(tp, cfg, torch.from_numpy(toks[:, :S]), max_len=S + steps)
    full, _ = JM.apply_logits(jp, jcfg, {"tokens": jnp.asarray(toks)})
    for t in range(steps):
        lg, cache = M.decode_step(tp, cfg, torch.from_numpy(toks[:, S + t: S + t + 1]),
                                  cache)
        _close(lg[:, 0], full[:, S + t], FULL_TOL, f"step {t}")


def test_greedy_decode_loop_matches_stepwise():
    cfg, tp, _, _ = _model()
    toks = torch.from_numpy(_tokens(cfg, 2, 24, seed=11))
    lg, cache = M.prefill(tp, cfg, toks, max_len=30)
    cur = lg[:, -1].argmax(-1).int()
    got, _ = M.decode_loop(tp, cfg, cur, cache, 4)
    lg, cache = M.prefill(tp, cfg, toks, max_len=30)
    want = [lg[:, -1].argmax(-1).int()]
    for _ in range(3):
        lg, cache = M.decode_step(tp, cfg, want[-1][:, None], cache)
        want.append(lg[:, -1].argmax(-1).int())
    assert torch.equal(got, torch.stack(want, 1))


def test_serving_paths_refuse_mamba2():
    """The engine, the offload executor and the hybrid cache take attention
    models only, as the reference's engine asserts its uniform family; the
    model functions serve mamba2, and refuse an SSD config with an FFN."""
    cfg, tp, _, _ = _model()
    with pytest.raises(NotImplementedError, match="uniform-family"):
        HybridServeEngine(cfg, tp, device="cpu")
    with pytest.raises(NotImplementedError, match="uniform-family"):
        OffloadExecutor(cfg, tp, device="cpu")
    with pytest.raises(NotImplementedError):
        M.init_hybrid_cache(cfg, 1, 16, 16, device="cpu")
    with pytest.raises(NotImplementedError, match="SSD stacks"):
        M.init_params(dataclasses.replace(cfg, d_ff=64), device="cpu")
    assert M.init_cache(cfg, 1, 16, device="cpu")["state"].shape == (
        cfg.num_layers, 1, cfg.ssm_num_heads, cfg.ssm_head_dim,
        cfg.ssm_state_size)
