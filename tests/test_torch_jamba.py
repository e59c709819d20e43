"""The port's hybrid family (jamba: SSD layers and one NoPE attention layer
per period, each layer's FFN dense or MoE by ``layer_is_moe``) against the
JAX package, through the plain path: ``prefill`` -> ``decode_step`` /
``decode_loop``.

Two configs: jamba-1.5-large-398b-reduced (8 layers, one whole period, so
the SSD layers' walk order -- dense, MoE, dense, MoE, attention, MoE,
dense, MoE -- is not their stack order; 4 experts at capacity 8.0, no
drops; float32) and the 4-layer cut the card runs at full width
(``attn_period=4, num_layers=4``: SSD-dense, SSD-MoE, attention,
SSD-MoE), here at the reduced width.  The same weights (the reference's
``init_params`` through ``params.from_numpy``) and tokens from a numpy
seed go through both sides.

Tolerances, ``tests/test_torch_ssm.py``'s: logits 1e-4; cache leaves 1e-5
absolute beside 1e-5 relative (``CACHE_RTOL``), the relative part taken
here of each leaf's largest entry, not of each entry: eight layers, four of
them MoE, of float32 sums in another order than XLA's put the deepest
leaves' errors at a few 1e-6 of their scale, on entries of every size
(measured on the 8-layer config, prefill and three steps: the SSD state
up to 1.5e-4 against its largest entry 21.9, 0.68 of the bound; the conv
tail 0.71 of it, the attention K/V 0.55; logits 0.13 of theirs).  Decode against the reference's full forward 2e-3,
the bound of ``tests/test_decode_equiv.py``; greedy tokens exactly equal.
On the CPU every kernel wrapper takes its plain version."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as j_get_config
from repro.models import model as JM
from repro_torch import params as P
from repro_torch.configs import get_config
from repro_torch.models import model as M
from repro_torch.models import transformer as T
from repro_torch.offload.executor import OffloadExecutor
from repro_torch.serving import ContinuousBatchingServer, HybridServeEngine

torch.set_num_threads(1)
LOGIT_TOL, CACHE_TOL, CACHE_RTOL, FULL_TOL = 1e-4, 1e-5, 1e-5, 2e-3
NAME = "jamba-1.5-large-398b-reduced"
CUT = dict(attn_period=4, num_layers=4)        # the card's cut of the period
KEYS = ("attn_k", "attn_v", "state", "conv", "kv_len")
_MODEL, _JAX = {}, {}


def _model(cut: bool = False):
    if cut not in _MODEL:
        jcfg, cfg = j_get_config(NAME), get_config(NAME)
        if cut:
            jcfg = dataclasses.replace(jcfg, **CUT)
            cfg = dataclasses.replace(cfg, **CUT)
        jp = JM.init_params(jcfg, jax.random.PRNGKey(0))
        tp = P.from_numpy(jax.tree.map(np.asarray, jp), device="cpu")
        _MODEL[cut] = (cfg, tp, jcfg, jp)
    return _MODEL[cut]


def _tokens(cfg, B, S, seed):
    return np.random.default_rng(seed).integers(
        0, cfg.vocab_size, (B, S)).astype(np.int32)


def _leaf_close(mine, ref, what):
    ref = np.asarray(ref, np.float32)
    tol = CACHE_TOL + CACHE_RTOL * float(np.abs(ref).max(initial=0.0))
    np.testing.assert_allclose(mine.float().numpy(), ref, atol=tol, rtol=0,
                               err_msg=what)


def _caches_close(cache, jcache, what):
    assert set(cache) == set(jcache) == set(KEYS)
    for key in KEYS:
        assert tuple(cache[key].shape) == jcache[key].shape, key
        _leaf_close(cache[key], jcache[key], f"{key}, {what}")


_J_PREFILL = jax.jit(JM.prefill, static_argnums=(1, 3))
_J_DECODE = jax.jit(JM.decode_step, static_argnums=(1,))


def _jax_run(cut: bool, S: int, steps: int = 3):
    """The reference's prefill logits and cache, then each decode step's,
    over ``_tokens(cfg, 2, S + steps, seed=S)`` (jitted: one compile for
    the three steps)."""
    if (cut, S) not in _JAX:
        _, _, jcfg, jp = _model(cut)
        toks = _tokens(jcfg, 2, S + steps, seed=S)
        run = [_J_PREFILL(jp, jcfg, {"tokens": jnp.asarray(toks[:, :S])},
                          S + steps)]
        for t in range(steps):
            run.append(_J_DECODE(jp, jcfg, jnp.asarray(toks[:, S + t:S + t + 1]),
                                 run[-1][1]))
        _JAX[cut, S] = (toks, run)
    return _JAX[cut, S]


@pytest.mark.parametrize("cut", [False, True], ids=["period8", "cut4"])
def test_slots_walk_and_params_bridge_keep_the_pytree(cut):
    """``hybrid_slots`` is the reference's; the walk visits every layer once
    in layer order, its SSD cache slots in walk order; the JAX tree crosses
    ``from_numpy`` leaf for leaf with its dtypes (the router, A_log, D and
    dt_bias float32), and the port's ``init_params`` draws the same tree."""
    from repro.models import transformer as JT
    cfg, tp, jcfg, jp = _model(cut)
    assert T.family(cfg) == "hybrid"
    assert T.hybrid_slots(cfg) == JT.hybrid_slots(jcfg)
    walk = list(T.hybrid_walk(cfg))
    kinds = ["attn" if s == "attn" else "ssd" for s, *_ in walk]
    assert kinds == list(cfg.layer_kinds())
    assert [m for *_, m in walk] == list(cfg.layer_is_moe())
    n_ssd = kinds[:cfg.attn_period].count("ssd")
    assert [si for _, _, _, si, _ in walk if si is not None] == \
        list(range(n_ssd)) * (cfg.num_layers // cfg.attn_period)
    flat = jax.tree_util.tree_flatten_with_path(jp)[0]
    for path, leaf in flat:
        node = tp
        for key in path:
            node = node[key.key]
        assert tuple(node.shape) == leaf.shape
        assert str(node.dtype).removeprefix("torch.") == str(leaf.dtype)
        np.testing.assert_array_equal(node.float().numpy(),
                                      np.asarray(leaf, np.float32))
    ssd = tp["periods"]["ssd_moe"]
    assert {ssd["ffn"]["router"].dtype, ssd["ssd"]["A_log"].dtype,
            ssd["ssd"]["D"].dtype, ssd["ssd"]["dt_bias"].dtype} == {torch.float32}
    assert set(tp["periods"]["ssd_dense"]["ffn"]) == {"w1", "w2", "w3"}
    lp = T.layer_params(tp, 0, 1, "ssd_moe")
    assert torch.equal(lp["ffn"]["we1"], ssd["ffn"]["we1"][0, 1])
    mine = M.init_params(cfg, seed=0, device="cpu")
    shapes = lambda t: jax.tree.map(lambda a: (tuple(a.shape), str(a.dtype)
                                               .removeprefix("torch.")), t)
    assert shapes(mine) == shapes(jp)


@pytest.mark.parametrize("cut,S", [(False, 40), (True, 40)],
                         ids=["period8-ragged", "cut4-ragged"])
def test_prefill_and_decode_match_jax(cut, S):
    """Prefill logits and every cache leaf against JAX ``prefill`` (the
    reduced chunk is 16: 40 leaves a ragged last chunk), then three
    ``decode_step``s, logits and every leaf each step."""
    cfg, tp, _, _ = _model(cut)
    toks, run = _jax_run(cut, S)
    lg, cache = M.prefill(tp, cfg, torch.from_numpy(toks[:, :S]), max_len=S + 3)
    for t, (jlg, jcache) in enumerate(run):
        if t:
            lg, cache = M.decode_step(tp, cfg, torch.from_numpy(
                toks[:, S + t - 1:S + t]), cache)
        what = "prefill" if t == 0 else f"decode step {t - 1}"
        np.testing.assert_allclose(lg.numpy(), np.asarray(jlg), atol=LOGIT_TOL,
                                   err_msg=f"logits, {what}")
        _caches_close(cache, jcache, what)


def _stack_order_walk(cfg):
    """A planted fault: the SSD cache slots numbered in stack order (each
    period's dense layers first, then its MoE layers), not walk order."""
    slots = T.hybrid_slots(cfg)
    n_dense = sum(s == "ssd_dense" for s, _, _ in slots)
    for stack, i, j, si, moe in _REAL_WALK(cfg):
        yield stack, i, j, (None if si is None else
                            j if stack == "ssd_dense" else n_dense + j), moe


_REAL_WALK = T.hybrid_walk


def test_states_in_stack_order_fail_the_comparison(monkeypatch):
    """The leaf comparison catches SSD states placed in stack order: on the
    8-layer period the two orders differ, and the decode that reads them
    back also leaves the reference's logits."""
    cfg, tp, _, _ = _model()
    S = 40
    toks, run = _jax_run(False, S)
    monkeypatch.setattr(T, "hybrid_walk", _stack_order_walk)
    assert [si for *_, si, _ in T.hybrid_walk(cfg) if si is not None] != \
        [si for *_, si, _ in _REAL_WALK(cfg) if si is not None]
    lg, cache = M.prefill(tp, cfg, torch.from_numpy(toks[:, :S]), max_len=S + 3)
    np.testing.assert_allclose(lg.numpy(), np.asarray(run[0][0]), atol=LOGIT_TOL)
    with pytest.raises(AssertionError, match="state, prefill"):
        _caches_close(cache, run[0][1], "prefill")
    monkeypatch.setattr(T, "hybrid_walk", _REAL_WALK)     # decode walks right
    lg, _ = M.decode_step(tp, cfg, torch.from_numpy(toks[:, S:S + 1]), cache)
    assert np.abs(lg.numpy() - np.asarray(run[1][0])).max() > 100 * LOGIT_TOL


def test_decode_matches_the_full_forward():
    """Incremental decode against the reference's full forward over the
    whole sequence (``JM.apply_logits``), the property
    ``tests/test_decode_equiv.py`` holds the reference to."""
    cfg, tp, jcfg, jp = _model()
    S, steps = 40, 3
    toks = _tokens(cfg, 2, S + steps, seed=9)
    _, cache = M.prefill(tp, cfg, torch.from_numpy(toks[:, :S]), max_len=S + steps)
    full, _ = JM.apply_logits(jp, jcfg, {"tokens": jnp.asarray(toks)})
    for t in range(steps):
        lg, cache = M.decode_step(tp, cfg, torch.from_numpy(
            toks[:, S + t:S + t + 1]), cache)
        np.testing.assert_allclose(lg[:, 0].numpy(), np.asarray(full[:, S + t]),
                                   atol=FULL_TOL, err_msg=f"step {t}")


@pytest.mark.parametrize("cut", [False, True], ids=["period8", "cut4"])
def test_greedy_decode_loop_matches_stepwise(cut):
    cfg, tp, _, _ = _model(cut)
    toks = torch.from_numpy(_tokens(cfg, 2, 24, seed=11))
    lg, cache = M.prefill(tp, cfg, toks, max_len=30)
    got, _ = M.decode_loop(tp, cfg, lg[:, -1].argmax(-1).int(), cache, 4)
    lg, cache = M.prefill(tp, cfg, toks, max_len=30)
    want = [lg[:, -1].argmax(-1).int()]
    for _ in range(3):
        lg, cache = M.decode_step(tp, cfg, want[-1][:, None], cache)
        want.append(lg[:, -1].argmax(-1).int())
    assert torch.equal(got, torch.stack(want, 1))


@pytest.mark.parametrize("path", ["hybrid", "engine", "executor", "server",
                                  "train"])
def test_other_paths_refuse_jamba(path):
    """Only the plain path serves the hybrid family: the hybrid model
    functions, the engine, the offload executor and the server refuse it,
    as the reference's hybrid KV/ACT functions and engine assert the
    uniform and windowed families; each message names the refusing path.
    The training path, which refused it until the ``ssd_scan`` backward,
    now trains it (its gradients against the reference's are in
    ``tests/test_torch_train_ssm.py``): its case checks a finite loss."""
    cfg, tp, _, _ = _model()
    toks = torch.from_numpy(_tokens(cfg, 1, 16, seed=1))
    name = T.PATH_NAMES["engine" if path == "executor" else path]
    calls = {
        "hybrid": lambda: M.hybrid_prefill(tp, cfg, toks, 32, 32, 8),
        "engine": lambda: HybridServeEngine(cfg, tp, device="cpu"),
        "executor": lambda: OffloadExecutor(cfg, tp, device="cpu"),
        "server": lambda: ContinuousBatchingServer(cfg, tp, device="cpu"),
        "train": lambda: M.apply_train(tp, cfg, {"tokens": toks,
                                                 "labels": toks})}
    if path == "train":
        loss, metrics = calls[path]()
        assert torch.isfinite(loss) and float(metrics["aux"]) > 0
        return
    with pytest.raises(NotImplementedError) as e:
        calls[path]()
    assert f"(hybrid family, frontend none, none positions): not served by " \
           f"{name}." in str(e.value)
    assert "hybrid family (jamba" in str(e.value)
    if path == "hybrid":
        with pytest.raises(NotImplementedError, match="hybrid model functions"):
            M.init_hybrid_cache(cfg, 1, 16, 16, device="cpu")


def test_plain_path_accepts_only_what_it_runs():
    """The plain path takes the hybrid family with NoPE attention and an
    FFN in every layer; the ssm family still refuses an FFN."""
    cfg = get_config("jamba-1.5-large-398b")
    T.check_supported(cfg)
    T.check_supported(dataclasses.replace(cfg, **CUT))
    for bad in (dict(pos_type="rope"), dict(d_ff=0), dict(qk_norm=True)):
        with pytest.raises(NotImplementedError, match="the plain path"):
            T.check_supported(dataclasses.replace(cfg, **bad))
    with pytest.raises(NotImplementedError, match="SSD stacks"):
        T.check_supported(dataclasses.replace(get_config("mamba2-2.7b"),
                                              d_ff=64))
