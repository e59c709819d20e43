"""The port's MoE FFN and the MoE models (dbrx-132b, grok-1-314b) against
the JAX reference.

``moe_ffn`` is held to ``repro.models.layers.moe_ffn`` on inputs made from a
seed with numpy: over token counts that 32 divides and that it does not,
expert counts and top-k, capacity factors that drop nothing, some pairs or
most of them, both gated activations, float32 and bfloat16.  The cases form
a pairwise covering of those values (every pair of values meets in some
case) rather than their full product, whose JAX compiles alone (~0.8 s
each) would take minutes.  The output must agree within a stated
tolerance, the aux loss too, and the set of rows that every choice of a
token dropped (zero rows) must be the same.  A capacity rank computed over
the whole batch instead of per group must fail the drop case.

Then the models, on the reference's weights through ``params.from_numpy``
(float32): the batched hybrid prefill of dbrx-reduced at capacity 1.25
with prompts of different lengths (pads and real tokens share dispatch
groups, and pairs drop), the hybrid decode against the plain one and JAX's
(``tests/test_decode_equiv.py::test_hybrid_cache_exact``), the engine in
hybrid and kv modes and spilled through the offload runtime, and the
continuous-batching server (dbrx; grok through the engine's hybrid mode),
each with the JAX engine's or server's tokens and counters.  A dispatch mode over one MoE decode step refuses every
device read."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro.configs import get_config as j_get_config
from repro.configs import offload as j_offload
from repro.core import costmodel as j_cm
from repro.models import layers as JL
from repro.models import model as JM
from repro.models import transformer as JT
from repro.serving import HybridServeEngine as JEngine
from repro.serving.scheduler import ContinuousBatchingServer as JServer
from repro_torch import params as P
from repro_torch.configs import get_config
from repro_torch.configs.offload import _tight
from repro_torch.core import costmodel as cm
from repro_torch.data.pipeline import open_loop_trace, request_trace
from repro_torch.models import layers as L
from repro_torch.models import model as M
from repro_torch.serving import (ContinuousBatchingServer, HybridServeEngine,
                                 exact_reference_generate)

torch.set_num_threads(1)

# (T, E, top_k, capacity_factor, ffn_type, dtype)
FFN_CASES = [
    (1, 4, 2, 8.0, "gated_silu", "float32"),
    (1, 8, 2, 1.25, "gated_gelu", "bfloat16"),
    (1, 16, 4, 0.25, "gated_gelu", "float32"),
    (1, 2, 1, 8.0, "gated_silu", "bfloat16"),
    (3, 4, 2, 1.25, "gated_gelu", "float32"),
    (3, 8, 2, 0.25, "gated_silu", "float32"),
    (3, 16, 4, 8.0, "gated_gelu", "bfloat16"),
    (3, 2, 1, 1.25, "gated_silu", "bfloat16"),
    (10, 4, 2, 0.25, "gated_gelu", "bfloat16"),
    (10, 8, 2, 8.0, "gated_gelu", "float32"),
    (10, 16, 4, 1.25, "gated_silu", "bfloat16"),
    (10, 2, 1, 0.25, "gated_silu", "float32"),
    (48, 4, 2, 0.25, "gated_silu", "bfloat16"),
    (48, 8, 2, 8.0, "gated_silu", "float32"),
    (48, 16, 4, 1.25, "gated_gelu", "float32"),
    (48, 2, 1, 8.0, "gated_gelu", "bfloat16"),
    (320, 4, 2, 8.0, "gated_silu", "float32"),
    (320, 8, 2, 1.25, "gated_silu", "bfloat16"),
    (320, 16, 4, 0.25, "gated_gelu", "bfloat16"),
    (320, 16, 4, 1.25, "gated_silu", "float32"),
    (320, 2, 1, 8.0, "gated_gelu", "float32"),
    (1024, 4, 2, 8.0, "gated_silu", "float32"),
    (1024, 8, 2, 1.25, "gated_gelu", "bfloat16"),
    (1024, 16, 4, 0.25, "gated_gelu", "float32"),
    (1024, 2, 1, 8.0, "gated_silu", "bfloat16"),
]
# the case the planted rank fault must fail: 32 groups, pairs dropped
FAULT_CASE = (320, 16, 4, 1.25, "gated_silu", "float32")
D, F = 32, 48
_FFN = {}


def _ffn_inputs(T, E, dtype, seed=0):
    """x (T, D) around a shared direction, so that the router favours some
    experts and the small capacity factors drop pairs; the router in
    float32, the experts in ``dtype`` (as ``init_moe`` keeps them)."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((T, D)) * 0.5 + rng.standard_normal(D)
    p = {"router": rng.standard_normal((D, E)),
         "we1": rng.standard_normal((E, D, F)) / np.sqrt(D),
         "we2": rng.standard_normal((E, F, D)) / np.sqrt(F),
         "we3": rng.standard_normal((E, D, F)) / np.sqrt(D)}
    jdt = jnp.dtype(dtype)
    jx = jnp.asarray(x, jdt)
    jp = {k: jnp.asarray(v, jnp.float32 if k == "router" else jdt)
          for k, v in p.items()}
    to = lambda a: P.from_numpy(np.asarray(a), device="cpu")
    return jx, jp, to(jx), {k: to(v) for k, v in jp.items()}


def _ffn_case(case):
    """-> (port inputs, JAX's y as float32 numpy, JAX's aux); JAX runs once
    per case."""
    if case not in _FFN:
        T, E, k, cf, ffn, dtype = case
        jx, jp, x, p = _ffn_inputs(T, E, dtype)
        jy, jaux = jax.jit(lambda p_, x_: JL.moe_ffn(
            p_, x_, num_experts=E, top_k=k, capacity_factor=cf,
            ffn_type=ffn))(jp, jx)
        _FFN[case] = (x, p, np.asarray(jy.astype(jnp.float32)), float(jaux))
    return _FFN[case]


def _port_ffn(case, x, p):
    T, E, k, cf, ffn, _ = case
    y, aux = L.moe_ffn(p, x, num_experts=E, top_k=k, capacity_factor=cf,
                       ffn_type=ffn)
    return y.float().numpy(), float(aux)


def _y_tol(want, dtype) -> float:
    """float32: 1e-5 of the largest output (two summation orders);
    bfloat16: 2 ulps of it (each product rounds to bfloat16, in another
    summation order than XLA's, and the gate-weighted sum rounds once
    more)."""
    top = max(float(np.abs(want).max()), 1e-30)
    if dtype == "float32":
        return 1e-5 * max(top, 1.0)
    return 2 * 2.0 ** (np.floor(np.log2(top)) - 7)


def _dropped_pairs(case, x, p) -> int:
    """Pairs ranked past the capacity, from the port's own routing."""
    T, E, k, cf, _, _ = case
    route = L.moe_route(p["router"], x, num_experts=E, top_k=k,
                        capacity_factor=cf)
    return int(L.moe_dropped(route, k).sum())


@pytest.mark.parametrize("case", FFN_CASES, ids=lambda c: "-".join(map(str, c)))
def test_moe_ffn_matches_jax(case):
    x, p, want, want_aux = _ffn_case(case)
    got, aux = _port_ffn(case, x, p)
    np.testing.assert_allclose(got, want, rtol=0, atol=_y_tol(want, case[-1]))
    assert aux == pytest.approx(want_aux, rel=1e-5, abs=1e-6)
    np.testing.assert_array_equal((got == 0).all(-1), (want == 0).all(-1))
    T, _, _, cf, _, _ = case
    if T >= 320 and cf < 8.0:        # the drop path is exercised
        assert _dropped_pairs(case, x, p) > 0


def test_moe_ffn_all_to_one_expert_drops_rows():
    """``tests/test_layers.py::test_moe_capacity_drops_tokens``: every
    token routed to expert 0 at capacity 0.25; the dropped tokens' rows
    are zero, the same rows as JAX's."""
    T, E, d, f = 1024, 2, 8, 16
    rng = np.random.default_rng(1)
    x = rng.standard_normal((T, d)).astype(np.float32)
    p = {"router": np.stack([np.ones(d), -np.ones(d)], 1).astype(np.float32),
         "we1": np.full((E, d, f), 0.01, np.float32),
         "we2": np.full((E, f, d), 0.01, np.float32),
         "we3": np.full((E, d, f), 0.01, np.float32)}
    jy, jaux = jax.jit(lambda p_, x_: JL.moe_ffn(
        p_, x_, num_experts=E, top_k=1, capacity_factor=0.25,
        ffn_type="gated_silu"))({k: jnp.asarray(v) for k, v in p.items()},
                                jnp.asarray(x))
    y, aux = L.moe_ffn(P.from_numpy(p, device="cpu"), torch.from_numpy(x),
                       num_experts=E, top_k=1, capacity_factor=0.25,
                       ffn_type="gated_silu")
    y, jy = y.numpy(), np.asarray(jy)
    np.testing.assert_allclose(y, jy, rtol=0, atol=1e-7)
    assert float(aux) == pytest.approx(float(jaux), rel=1e-6)
    zero = (np.abs(y).sum(-1) < 1e-9)
    assert zero.sum() > 0
    np.testing.assert_array_equal(zero, np.abs(jy).sum(-1) < 1e-9)


def _whole_batch_ranks(real):
    """A planted fault: each pair ranked among its expert's pairs in ALL
    groups so far, as one global dispatch would rank it."""
    def ranks(sorted_e, E):
        counts, starts, rank = real(sorted_e, E)
        before = counts.cumsum(0) - counts
        return counts, starts, rank + before.gather(1, sorted_e)
    return ranks


def test_rank_over_the_whole_batch_fails(monkeypatch):
    x, p, want, _ = _ffn_case(FAULT_CASE)
    tol = _y_tol(want, FAULT_CASE[-1])
    assert np.abs(_port_ffn(FAULT_CASE, x, p)[0] - want).max() <= tol
    monkeypatch.setattr(L, "_group_ranks", _whole_batch_ranks(L._group_ranks))
    assert np.abs(_port_ffn(FAULT_CASE, x, p)[0] - want).max() > tol


def test_top_k_takes_the_lower_index_on_ties():
    probs = torch.tensor([[0.25, 0.25, 0.25, 0.25], [0.1, 0.4, 0.1, 0.4]])
    gate, idx = L._top_k(probs, 2)
    jgate, jidx = jax.lax.top_k(jnp.asarray(probs.numpy()), 2)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(jidx))
    np.testing.assert_array_equal(gate.numpy(), np.asarray(jgate))


# --------------------------------------------------------------------------- models

NAMES = ["dbrx-132b-reduced", "grok-1-314b-reduced"]
# logits against JAX's (tests/test_torch_model.py), and the hybrid decode
# against the plain one (tests/test_decode_equiv.py)
LOGIT_TOL, CACHE_TOL, EQUIV_TOL = 1e-4, 1e-5, 2e-3
_MODELS = {}


def _model(name, **changes):
    """(port cfg, port params, JAX cfg, JAX params) on the reference's
    weights at seed 3, with ``changes`` made to both configs."""
    key = (name, tuple(sorted(changes.items())))
    if key not in _MODELS:
        jcfg = dataclasses.replace(j_get_config(name), **changes)
        cfg = dataclasses.replace(get_config(name), **changes)
        jp = _MODELS.get(name) or JM.init_params(jcfg, jax.random.PRNGKey(3))
        _MODELS[name] = jp
        tp = P.from_numpy(jax.tree.map(np.asarray, jp), device="cpu")
        _MODELS[key] = (cfg, tp, jcfg, jp)
    return _MODELS[key]


def _close(mine, ref, tol, what):
    np.testing.assert_allclose(mine.float().numpy(), np.asarray(ref, np.float32),
                               atol=tol, err_msg=what)


def test_params_keep_the_router_float32_and_the_experts_dtype():
    """``from_numpy`` of the MoE pytree keeps every leaf's dtype: the router
    float32 beside bfloat16 experts, as ``init_moe`` makes them."""
    jcfg = dataclasses.replace(j_get_config("dbrx-132b-reduced"),
                               dtype="bfloat16")
    jp = JT.init_moe(jax.random.PRNGKey(0), jcfg)
    tp = P.from_numpy(jax.tree.map(np.asarray, jp), device="cpu")
    assert tp["router"].dtype == torch.float32
    for key in ("we1", "we2", "we3"):
        assert tp[key].dtype == torch.bfloat16
        np.testing.assert_array_equal(
            tp[key].float().numpy(), np.asarray(jp[key].astype(jnp.float32)))
    np.testing.assert_array_equal(tp["router"].numpy(), np.asarray(jp["router"]))
    mine = M.init_params(get_config("dbrx-132b-reduced"), device="cpu")
    assert mine["layers"]["ffn"]["router"].dtype == torch.float32
    assert {k: tuple(v.shape) for k, v in mine["layers"]["ffn"].items()} == \
        {k: tuple(np.shape(v)) for k, v in _model(
            "dbrx-132b-reduced")[3]["layers"]["ffn"].items()}


def test_batched_prefill_drops_the_reference_pairs(monkeypatch):
    """dbrx-reduced at capacity 1.25, four prompts of different lengths in
    one padded batch: pads (each row's last token repeated) share dispatch
    groups with real tokens, and pairs drop.  Logits and every cache plane
    equal the reference's."""
    cfg, tp, jcfg, jp = _model("dbrx-132b-reduced", moe_capacity_factor=1.25)
    rng = np.random.default_rng(5)
    S = 80                      # 32 groups of 10 tokens: C = 8 can bind
    lens = np.array([80, 17, 53, 6], np.int32)
    toks = rng.integers(0, cfg.vocab_size, (4, S)).astype(np.int32)
    for b, n in enumerate(lens):
        toks[b, n:] = toks[b, n - 1]
    kv_keep = np.array([16, 0, 53, 6], np.int32)
    dropped = []
    real = L.moe_route

    def counting(*a, **kw):
        route = real(*a, **kw)
        dropped.append(int(L.moe_dropped(route, cfg.moe_top_k).sum()))
        return route

    monkeypatch.setattr(L, "moe_route", counting)
    lg, cache = M.hybrid_prefill_batched(
        tp, cfg, torch.from_numpy(toks), 96, 96, kv_keep, lens)
    assert len(dropped) == cfg.num_layers and sum(dropped) > 0
    jlg, jc = JM.hybrid_prefill_batched(
        jp, jcfg, {"tokens": jnp.asarray(toks)}, 96, 96, jnp.asarray(kv_keep),
        jnp.asarray(lens))
    _close(lg, jlg, LOGIT_TOL, "prefill logits")
    for key in ("k", "v", "act", "act_pos", "kv_len", "act_len"):
        _close(cache[key], jc[key], CACHE_TOL, key)


@pytest.mark.parametrize("name", NAMES)
def test_hybrid_cache_exact(name):
    """``tests/test_decode_equiv.py::test_hybrid_cache_exact``: the hybrid
    prefill (half KV) and five hybrid decode steps with mixed store flags
    give the plain path's logits, and JAX's hybrid logits step by step."""
    cfg, tp, jcfg, jp = _model(name)
    B, S = 2, 40
    toks = np.random.default_rng(4).integers(
        0, cfg.vocab_size, (B, S + 5)).astype(np.int32)
    t = torch.from_numpy(toks)
    _, c0 = M.prefill(tp, cfg, t[:, :S], max_len=S + 10)
    cap = 64                    # whole pages, the port's regions
    _, ch = M.hybrid_prefill(tp, cfg, t[:, :S], cap, cap, S // 2)
    _, jch = JM.hybrid_prefill(jp, jcfg, {"tokens": jnp.asarray(toks[:, :S])},
                               kv_cap=cap, act_cap=cap, kv_keep=S // 2)
    store = np.array([True, False])
    step = jax.jit(lambda p, tok, c, s: JM.hybrid_decode_step(p, jcfg, tok, c, s))
    for s in range(5):
        nxt = t[:, S + s: S + s + 1]
        lg_ref, c0 = M.decode_step(tp, cfg, nxt, c0)
        lg_hyb, ch = M.hybrid_decode_step(tp, cfg, nxt, ch,
                                          torch.from_numpy(store))
        jlg, jch = step(jp, jnp.asarray(toks[:, S + s: S + s + 1]), jch,
                        jnp.asarray(store))
        assert (lg_ref - lg_hyb).abs().max().item() < EQUIV_TOL, (name, s)
        _close(lg_hyb, jlg, LOGIT_TOL, f"{name} hybrid logits, step {s}")


class _RefuseReads(TorchDispatchMode):
    """Refuses every op that reads a tensor's value to the host; records
    the op sequence."""
    REFUSED = ("aten._local_scalar_dense", "aten.nonzero", "aten.masked_select")

    def __init__(self):
        super().__init__()
        self.ops = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        name = str(func.overloadpacket)
        if name in self.REFUSED:
            raise AssertionError(f"{name} reads the device")
        self.ops.append(str(func))
        return func(*args, **(kwargs or {}))


def test_moe_decode_step_reads_no_device_value():
    """One MoE decode step (the dispatch inside) runs no op that reads a
    value to the host, and two different routings run the same ops."""
    cfg, tp, *_ = _model("dbrx-132b-reduced")
    toks = torch.from_numpy(np.random.default_rng(6).integers(
        0, cfg.vocab_size, (3, 24)).astype(np.int32))
    lens = np.array([24, 24, 24], np.int32)
    seqs = []
    for nxt in ([[1], [2], [3]], [[900], [17], [17]]):
        _, cache = M.hybrid_prefill_batched(tp, cfg, toks, 32, 32,
                                            np.array([8, 0, 24], np.int32), lens)
        with _RefuseReads() as mode:
            M.hybrid_decode_step(tp, cfg, torch.tensor(nxt, dtype=torch.int32),
                                 cache, torch.tensor([True, False, True]))
        seqs.append(mode.ops)
    assert seqs[0] == seqs[1]
    assert any("sort" in op for op in seqs[0])      # the dispatch ran


# at reduced widths the H100 spec keeps nearly every token as ACT; 20
# TFLOP/s splits each prompt, so the decode runs both page types
MIXED = dataclasses.replace(cm.H100_SXM, name="h100-20tflops", flops=2e13)
J_MIXED = j_cm.HardwareSpec(**dataclasses.asdict(MIXED))
CAPS = dict(kv_cap=128, act_cap=128)
GEN_FIELDS = ("generated_tokens", "steps", "device_calls")


_ENGINE = {}


def _engine_setup(name):
    """(port cfg, port params, JAX cfg, JAX params, trace, the port's
    oracle tokens) of ``name``, built once per module."""
    if name not in _ENGINE:
        cfg, tp, jcfg, jp = _model(name)
        reqs = request_trace(cfg.vocab_size, n_requests=3, prompt_mean=40,
                             gen_tokens=6, seed=7)
        _ENGINE[name] = (cfg, tp, jcfg, jp, reqs, exact_reference_generate(
            cfg, tp, reqs, device="cpu"))
    return _ENGINE[name]


@pytest.mark.parametrize("case", ["dbrx-hybrid", "dbrx-kv",
                                  "dbrx-hybrid-offload-spilled",
                                  "grok-hybrid"])
def test_engine_matches_jax_engine_and_oracle(case):
    model, mode, *rest = case.split("-")
    name = "dbrx-132b-reduced" if model == "dbrx" else "grok-1-314b-reduced"
    cfg, tp, jcfg, jp, reqs, ref = _engine_setup(name)
    offload = bool(rest)
    kw = dict(offload=True, budget=_tight(cfg)) if offload else {}
    jkw = dict(offload=True, budget=j_offload._tight(jcfg)) if offload else {}
    eng = HybridServeEngine(cfg, tp, mode=mode, hw=MIXED, device="cpu",
                            **CAPS, **kw)
    j_eng = JEngine(jcfg, jp, mode=mode, hw=J_MIXED, **CAPS, **jkw)
    out, stats = eng.generate(reqs)
    j_out, j_stats = j_eng.generate(reqs)
    if offload:
        eng.close()
        j_eng.close()
    for r in reqs:
        np.testing.assert_array_equal(out[r.rid], j_out[r.rid])
        np.testing.assert_array_equal(out[r.rid], ref[r.rid])
    for f in GEN_FIELDS:
        assert getattr(stats, f) == getattr(j_stats, f), f
    assert stats.sim_time == pytest.approx(j_stats.sim_time, rel=1e-12)
    assert all(p.allocated == 0 for p in eng.blockman.pools.values())
    if mode == "hybrid":            # both page types on the decode path
        _, kv_keep, pbs, *_ = eng.group_schedule(eng.plan_groups(reqs)[0])
        assert ((kv_keep > 0) & (kv_keep < np.asarray(pbs))).any()
    if offload:
        assert sum(m.traffic["kv_load"] for m in eng.measured_steps) > 0
        assert eng.spill_kv_pool.allocated_blocks == 0


def test_server_matches_jax_server():
    """``ContinuousBatchingServer`` at S = 8 on dbrx-reduced: tokens and
    ``ServeStats`` equal the JAX server's on the same open-loop trace."""
    cfg, tp, jcfg, jp = _model("dbrx-132b-reduced")
    hw = cm.TPU_V5E
    reqs, arrivals = open_loop_trace(cfg.vocab_size, 3, seed=17)
    caps = dict(slots=2, kv_cap=128, act_cap=128)
    srv = ContinuousBatchingServer(cfg, tp, chunk_steps=8, hw=hw,
                                   device="cpu", **caps)
    out, st = srv.run(reqs, arrival_steps=arrivals)
    jsrv = JServer(jcfg, jp, chunk_steps=8,
                   hw=j_cm.HardwareSpec(**dataclasses.asdict(hw)), **caps)
    j_out, j_st = jsrv.run(reqs, arrival_steps=arrivals)
    ref = exact_reference_generate(cfg, tp, reqs, device="cpu")
    for r in reqs:
        np.testing.assert_array_equal(out[r.rid], j_out[r.rid])
        np.testing.assert_array_equal(out[r.rid], ref[r.rid])
    for f in ("device_calls", "host_syncs", "admission_batches", "admitted",
              "chunks", "steps", "generated_tokens", "completed_at"):
        assert getattr(st, f) == getattr(j_st, f), f
    assert st.sim_time == pytest.approx(j_st.sim_time, rel=1e-9)
    assert all(p.allocated == 0 for p in srv.blockman.pools.values())
