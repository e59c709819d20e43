"""MoE models under a ShardPlan against the JAX package.

The serve specs split the experts over the model axis where E divides it
(expert parallel) and d_ff otherwise (``rules.param_spec``, the reference's
rule).  Every position routes every token of its data row with the
replicated router, in the dispatch groups the single-device run forms over
the whole batch (``_moe_groups``, ROADMAP fault N), and runs its experts'
slots or every expert at its d_ff slice; the rows' float32 gated sums are
summed over the row:

  * dbrx-reduced and grok-reduced (4 experts) on 1x2 and 2x2 (expert
    parallel) serve JAX's oracle tokens through the engine, dbrx also
    through the server (each data row prefills the whole admission batch)
    and the spilled offload engine,
  * dbrx-reduced at capacity 1.25 on 2x2 drops exactly the single-device
    run's (token, choice) pairs in every layer of a batched prefill, whose
    logits and cache equal the reference's; routing a data row in groups of
    its own tokens instead drops other pairs,
  * dbrx-reduced on a port-only 1x8 mesh, where 4 experts do not divide 8,
    runs tensor parallel on d_ff and serves the oracle's tokens."""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as j_get_config
from repro.models import model as JM
from repro.serving import exact_reference_generate as j_reference
from repro_torch import params as P
from repro_torch.configs import get_config
from repro_torch.configs.offload import _tight
from repro_torch.core import costmodel as cm
from repro_torch.data.pipeline import request_trace
from repro_torch.launch.mesh import make_test_mesh
from repro_torch.models import layers as L
from repro_torch.models import model as M
from repro_torch.models import sharded as SHD
from repro_torch.serving import ContinuousBatchingServer, HybridServeEngine
from repro_torch.sharding import collectives as C
from repro_torch.sharding import make_shard_plan

torch.set_num_threads(1)

MIXED = dataclasses.replace(cm.H100_SXM, name="h100-20tflops", flops=2e13)
CAPS = dict(kv_cap=128, act_cap=128)
LOGIT_TOL, CACHE_TOL = 1e-4, 1e-5           # tests/test_torch_moe.py's


@functools.lru_cache(maxsize=None)
def setup(name, **changes):
    """The reference's weights (seed 0) on both sides, ``changes`` made to
    both configs, a trace of 4 requests and JAX's oracle tokens (none where
    ``changes`` are made)."""
    jcfg = dataclasses.replace(j_get_config(name), **changes)
    cfg = dataclasses.replace(get_config(name), **changes)
    jp = JM.init_params(jcfg, jax.random.PRNGKey(0))
    tp = P.from_numpy(jax.tree.map(np.asarray, jp), device="cpu")
    reqs = request_trace(cfg.vocab_size, n_requests=4, prompt_mean=40,
                         gen_tokens=6, seed=7)
    ref = None if changes else j_reference(jcfg, jp, reqs)
    return cfg, tp, jcfg, jp, reqs, ref


def plan_for(cfg, tp, shape):
    return make_shard_plan(cfg, make_test_mesh(*shape, device="cpu"), tp)


def assert_tokens(out, reqs, want):
    for r in reqs:
        np.testing.assert_array_equal(out[r.rid], want[r.rid])


@pytest.mark.parametrize("name", ["dbrx-132b-reduced", "grok-1-314b-reduced"])
def test_moe_serves_expert_parallel(name):
    """Expert parallel on 1x2 and 2x2 (2 and 2 experts a position; the
    group of 4 splits over data on 2x2): the engine's tokens equal JAX's
    oracle, and the expert sums cross the row as collective bytes.  dbrx
    also through the server on 2x2 and the spilled offload engine on
    1x2."""
    cfg, tp, *_, reqs, ref = setup(name)
    for shape in ((1, 2), (2, 2)):
        plan = plan_for(cfg, tp, shape)
        lay = SHD.Layout(plan)
        assert lay.moe_ep and lay.expert0 == [0, 2]
        assert plan.place_params(tp)["layers"]["ffn"]["we1"].spec == \
            (None, "model", None, None)
        C.COUNTER.reset()
        eng = HybridServeEngine(cfg, tp, hw=MIXED, plan=plan, **CAPS)
        out, _ = eng.generate(reqs)
        assert_tokens(out, reqs, ref)
        assert C.COUNTER.bytes["moe"] > 0
        if shape == (2, 2):
            assert any(plan.batch_split(len(g)) for g in eng.plan_groups(reqs))
    if not name.startswith("dbrx"):
        return
    with ContinuousBatchingServer(cfg, tp, plan=plan_for(cfg, tp, (2, 2)),
                                  slots=2, chunk_steps=4, **CAPS) as srv:
        out, st = srv.run(reqs)
        assert all(p.allocated == 0 for p in srv.blockman.pools.values())
    assert_tokens(out, reqs, ref)
    assert st.device_calls == st.admission_batches + st.chunks
    with HybridServeEngine(cfg, tp, hw=MIXED, plan=plan_for(cfg, tp, (1, 2)),
                           offload=True, budget=_tight(cfg), **CAPS) as eng:
        out, _ = eng.generate(reqs)
        assert sum(m.traffic["kv_load"] for m in eng.measured_steps) > 0
    assert_tokens(out, reqs, ref)


def _prefill_drops(monkeypatch, run):
    """Each ``L.moe_route`` call's dropped pairs per token during ``run``."""
    calls = []
    real = L.moe_route

    def counting(*a, **kw):
        route = real(*a, **kw)
        calls.append(L.moe_dropped(route, kw["top_k"]))
        return route

    with monkeypatch.context() as m:
        m.setattr(L, "moe_route", counting)
        out = run()
    return calls, out


def test_mesh_drops_the_reference_pairs(monkeypatch):
    """dbrx-reduced at capacity 1.25, four prompts of different lengths in
    one padded batch (``tests/test_torch_moe.py``'s case) on 2x2: each data
    row routes its two requests in 16 of the batch's 32 groups, so every
    layer drops exactly the single-device run's pairs, and the logits and
    every cache plane equal the reference's.  Routing a row in groups of
    its own 160 tokens (32 groups of 5) drops other pairs."""
    cfg, tp, jcfg, jp, *_ = setup("dbrx-132b-reduced",
                                  moe_capacity_factor=1.25)
    rng = np.random.default_rng(5)
    S = 80
    lens = np.array([80, 17, 53, 6], np.int32)
    toks = rng.integers(0, cfg.vocab_size, (4, S)).astype(np.int32)
    for b, n in enumerate(lens):
        toks[b, n:] = toks[b, n - 1]
    kv_keep = np.array([16, 0, 53, 6], np.int32)
    one, (lg1, _) = _prefill_drops(monkeypatch, lambda: M.hybrid_prefill_batched(
        tp, cfg, torch.from_numpy(toks), 96, 96, kv_keep, lens))
    assert len(one) == cfg.num_layers and sum(int(d.sum()) for d in one) > 0
    plan = plan_for(cfg, tp, (2, 2))
    params = plan.place_params(tp)
    gold = torch.zeros((4, 1), dtype=torch.int32)
    sched = torch.zeros((1, 4), dtype=torch.bool)

    def mesh():
        return SHD.forced_logits(plan, params, toks, 96, 96, kv_keep, lens,
                                 sched, gold)

    calls, lg = _prefill_drops(monkeypatch, mesh)
    # per layer: row 0's two positions, then row 1's
    assert len(calls) == 4 * cfg.num_layers
    for i in range(cfg.num_layers):
        r0, r0b, r1, r1b = calls[4 * i: 4 * i + 4]
        assert torch.equal(r0, r0b) and torch.equal(r1, r1b)
        assert torch.equal(torch.cat([r0, r1]), one[i])
    jlg, jc = JM.hybrid_prefill_batched(
        jp, jcfg, {"tokens": jnp.asarray(toks)}, 96, 96, jnp.asarray(kv_keep),
        jnp.asarray(lens))
    np.testing.assert_allclose(lg[:, 0].numpy(), np.asarray(jlg)[:, -1],
                               atol=LOGIT_TOL)
    _, cache = SHD.prefill(plan, params, toks, 96, 96, kv_keep, lens)
    for key in ("k", "v", "act", "act_pos", "kv_len", "act_len"):
        np.testing.assert_allclose(cache[key].full().float().numpy(),
                                   np.asarray(jc[key], np.float32),
                                   atol=CACHE_TOL, err_msg=key)
    real_groups = SHD.moe_groups
    with monkeypatch.context() as m:
        m.setattr(SHD, "moe_groups", lambda lay, b, B, S_: real_groups(
            lay, b, None, S_))
        bad, _ = _prefill_drops(monkeypatch, mesh)
    assert not all(torch.equal(torch.cat([bad[4 * i], bad[4 * i + 2]]),
                               one[i]) for i in range(cfg.num_layers))


def test_tensor_parallel_on_d_ff_where_experts_do_not_divide():
    """dbrx-reduced on 1x8: 4 experts over 8 positions do not divide, so
    ``we1``/``we3``/``we2`` split on d_ff (64 columns a position) and every
    position runs every expert at its slice; each holds one query head of
    the replicated KV head.  The engine serves JAX's oracle tokens."""
    cfg, tp, *_, reqs, ref = setup("dbrx-132b-reduced")
    plan = plan_for(cfg, tp, (1, 8))
    lay = SHD.Layout(plan)
    assert not lay.moe_ep and lay.ffn_split
    assert lay.cfg_l.num_heads == 1 and lay.cfg_l.num_kv_heads == 1
    placed = plan.place_params(tp)["layers"]["ffn"]
    assert placed["we1"].spec == (None, None, None, "model")
    assert placed["we2"].shards[0].shape == (2, 4, 64, 256)
    eng = HybridServeEngine(cfg, tp, hw=MIXED, plan=plan, **CAPS)
    out, _ = eng.generate(reqs)
    assert_tokens(out, reqs, ref)
