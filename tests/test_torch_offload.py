"""The port's host-offload runtime against its device-resident engine and the
JAX offload runtime.

Both packages get the same numpy weights and the same hardware numbers, so
they plan the same groups; the offload engine must then give EXACTLY the
device-resident tokens and the JAX offload engine's, at prefetch depth 0 and
1, with the KV region resident or spilled to the host arena.  On the CPU
every copy is synchronous; the overlap itself is measured on the card by
``chip_smoke.py``."""
import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_config as j_get_config
from repro.configs import offload as j_offload
from repro.core import costmodel as j_cm
from repro.core import pipeline as j_pipe
from repro.core.quant import QuantConfig as JQuant
from repro.models import model as JM
from repro.offload import HostBlockPool as JHostBlockPool
from repro.offload import HostWeightPool as JHostWeightPool
from repro.offload import WeightStreamer as JWeightStreamer
from repro.offload.faults import FaultPlan as JFaultPlan
from repro.serving import HybridServeEngine as JEngine
from repro_torch import params as P
from repro_torch.configs import get_config
from repro_torch.configs.offload import OffloadBudget, _tight, offload_budget
from repro_torch.core import costmodel as cm
from repro_torch.core.blocks import BlockType, Location
from repro_torch.core.pipeline import TimelineResult
from repro_torch.core.quant import QuantConfig
from repro_torch.data.pipeline import request_trace
from repro_torch.offload import (FaultPlan, HostBlockPool, HostWeightPool,
                                 MeasuredTimeline, WeightStreamer)
from repro_torch.offload.timeline import MeasuredStep, covered
from repro_torch.serving import HybridServeEngine

torch.set_num_threads(1)

# a spec with 20 TFLOP/s of compute splits each reduced prompt about half
# and half, so the decode runs KV pages and ACT pages side by side
MIXED = dataclasses.replace(cm.H100_SXM, name="h100-20tflops", flops=2e13)
J_MIXED = j_cm.HardwareSpec(**dataclasses.asdict(MIXED))
CAPS = dict(kv_cap=128, act_cap=128)
ROOMY = 16 * 2**30          # a budget whose device KV pool holds every group


def _setup(name, seed):
    jcfg = j_get_config(name)
    jp = JM.init_params(jcfg, jax.random.PRNGKey(seed))
    tp = P.from_numpy(jax.tree.map(np.asarray, jp), device="cpu")
    cfg = get_config(name)
    reqs = request_trace(1024, n_requests=3, prompt_mean=40, gen_tokens=6,
                         seed=7)
    ref, _ = HybridServeEngine(cfg, tp, hw=MIXED, device="cpu",
                               **CAPS).generate(reqs)
    # the JAX offload engine, spilled at prefetch depth 1 (tight budget)
    with JEngine(jcfg, jp, hw=J_MIXED, offload=True, **CAPS,
                 budget=j_offload._tight(jcfg)) as j_eng:
        j_out, j_stats = j_eng.generate(reqs)
    return cfg, tp, jcfg, jp, reqs, ref, j_out, j_stats


@pytest.fixture(scope="module")
def setup_opt():
    return _setup("opt-6.7b-reduced", 0)


@pytest.fixture(scope="module")
def setup_yi():
    return _setup("yi-6b-reduced", 1)


def _budget(cfg, spill: bool, depth: int) -> OffloadBudget:
    return _tight(cfg, prefetch_depth=depth) if spill \
        else OffloadBudget(ROOMY, prefetch_depth=depth)


def _run(setup, spill, depth, **kw):
    cfg, tp, *_ = setup
    eng = HybridServeEngine(cfg, tp, hw=MIXED, device="cpu", offload=True,
                            budget=_budget(cfg, spill, depth), **CAPS, **kw)
    out, stats = eng.generate(setup[4])
    eng.close()
    return eng, out, stats


def _expected_uploads(eng, reqs) -> int:
    """One pass of the layers per prefill and per decode step."""
    plan = eng.plan_groups(reqs)
    return eng.cfg.num_layers * sum(1 + max(r.max_new_tokens for r in g)
                                    for g in plan)


@pytest.mark.parametrize("case", ["opt-d0-resident", "opt-d1-resident",
                                  "opt-d0-spill", "opt-d1-spill",
                                  "yi-d1-spill"])
def test_offload_tokens_match_resident_and_jax_offload(setup_opt, setup_yi,
                                                       case):
    model, depth, where = case.split("-")
    setup = setup_opt if model == "opt" else setup_yi
    cfg, _, _, _, reqs, ref, j_out, j_stats = setup
    spill = where == "spill"
    eng, out, stats = _run(setup, spill, int(depth[1]))
    for r in reqs:
        np.testing.assert_array_equal(out[r.rid], ref[r.rid])
        np.testing.assert_array_equal(out[r.rid], j_out[r.rid])
    # the executor's stage count mirrors the reference's dispatches
    assert stats.device_calls == j_stats.device_calls
    st = eng.executor.streamer
    assert st.uploads == _expected_uploads(eng, reqs)
    assert st.bytes_uploaded == st.uploads * eng.executor.pool.layer_nbytes[0]
    assert st.peak_resident <= int(depth[1]) + 1
    kv_traffic = sum(m.traffic["kv_load"] for m in eng.measured_steps)
    assert (kv_traffic > 0) == spill
    assert eng.spill_kv_pool.allocated_blocks == 0
    eng.spill_kv_pool.check_invariants()
    assert all(p.allocated == 0 for p in eng.blockman.pools.values())
    if not spill:       # device-resident groups migrate their KV blocks
        assert eng.blockman.transitions.get(
            (BlockType.KV, Location.HOST, Location.DEVICE), 0) > 0


@pytest.mark.parametrize("quant", [False, True], ids=["fp", "int8"])
def test_spilled_kv_upload_bytes_match_jax_offload(setup_opt, quant):
    """The measured KV upload bytes of a spilled run equal the JAX offload
    engine's, fp and int8 (both sides move the int8 codes and float16
    scales): every decode step uploads each layer's spilled region once, the
    first layer of the first step included (the streamer arms its weights
    before that step opens; its KV region is uploaded inside the step)."""
    cfg, tp, jcfg, jp, reqs, *_ = setup_opt
    q = dict(quant=QuantConfig()) if quant else {}
    jq = dict(quant=JQuant()) if quant else {}
    with JEngine(jcfg, jp, hw=J_MIXED, offload=True, **CAPS,
                 budget=j_offload._tight(jcfg), **jq) as j_eng:
        j_out, _ = j_eng.generate(reqs)
    with HybridServeEngine(cfg, tp, hw=MIXED, device="cpu", offload=True,
                           budget=_tight(cfg), **CAPS, **q) as eng:
        out, _ = eng.generate(reqs)
    for r in reqs:
        np.testing.assert_array_equal(out[r.rid], j_out[r.rid])
    got, want = (sum(m.traffic["kv_load"] for m in e.measured_steps)
                 for e in (eng, j_eng))
    assert got > 0 and got == want


def test_layer_weight_bytes_are_the_pool_shards(setup_opt):
    """The pool's layer shard is the cost model's layer: every leaf of one
    layer, contiguous in one host buffer, aligned leaf by leaf."""
    cfg, tp, *_ = setup_opt
    pool = HostWeightPool(cfg, tp, device="cpu")
    raw = sum(t[0].numel() * t.element_size()
              for t in _leaves(tp["layers"]))
    assert raw <= pool.layer_nbytes[0] < raw + 16 * 16
    assert not pool.pinned                       # device="cpu": no pinning
    np.testing.assert_array_equal(pool.layer(1)["attn"]["wq"].numpy(),
                                  tp["layers"]["attn"]["wq"][1].numpy())
    assert cm.layer_weight_bytes(cfg) == j_cm.layer_weight_bytes(
        j_get_config(cfg.name))


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    else:
        yield tree


def test_measured_timeline_schema_matches_jax(setup_opt):
    """``MeasuredTimeline.results()`` has the JAX schema, key for key."""
    assert [f.name for f in dataclasses.fields(TimelineResult)] == \
        [f.name for f in dataclasses.fields(j_pipe.TimelineResult)]
    eng, _, stats = _run(setup_opt, True, 1)
    assert len(eng.measured_steps) == stats.steps
    for m in eng.measured_steps:
        assert isinstance(m, TimelineResult)
        assert set(m.traffic) == {"weights", "kv_load", "act_load", "store"}
        assert m.total > 0 and m.gpu_busy > 0 and m.pcie_busy > 0
        # a prefetched copy counts in the step that issues it
        assert 0 < m.traffic["weights"] <= eng.cfg.num_layers * \
            eng.executor.pool.layer_nbytes[0]
        assert all(f <= m.total + 1e-9 for f in m.finish)
        assert set(m.tag_busy) >= {"w", "kv", "st", "fwd"}
    assert stats.measured_time == pytest.approx(
        sum(m.total for m in eng.measured_steps))


def test_timeline_step_attribution():
    tl = MeasuredTimeline()
    tl.begin_step("decode")
    with tl.task("gpu", "fwd"):
        pass
    with tl.task("pcie", "w", nbytes=100):
        pass
    tl.begin_step("decode")
    with tl.task("pcie_up", "st", nbytes=7):
        pass
    assert len(tl.results("decode")) == 1      # in-flight step not included
    tl.end_step()
    res = tl.results("decode")
    assert len(res) == 2
    assert res[0].traffic["weights"] == 100 and res[0].gpu_busy > 0
    assert res[1].traffic["store"] == 7 and res[1].gpu_busy == 0.0
    assert tl.drain() and not tl.results()             # drain resets


@pytest.mark.parametrize("gpu,pcie,hidden", [
    ([(1.0, 2.0)], [(0.0, 3.0)], 1.0),                 # inside one copy
    ([(1.0, 2.0)], [(2.0, 3.0)], 0.0),                 # after it: serial
    ([(1.0, 3.0)], [(0.0, 1.5), (1.2, 2.0)], 1.0),     # overlapping copies
    ([(0.0, 1.0), (2.0, 4.0)], [(0.5, 2.5), (3.5, 5.0)], 1.5),
    ([(0.0, 1.0)], [], 0.0)])
def test_timeline_gpu_hidden_under_copies(gpu, pcie, hidden):
    """A measured step's gpu busy time that lies inside the pcie lane's busy
    intervals (their union, so two overlapping copies count once): the
    offload phase's reading of how much compute the copy stream hides."""
    tl = MeasuredTimeline()
    tl.begin_step("decode", now=0.0)
    for a, b in gpu:
        tl.record("gpu", "fwd", a, b)
    for a, b in pcie:
        tl.record("pcie", "w", a, b, 10)
    tl.record("cpu", "cpu", 0.0, 5.0)                  # other lanes hide nothing
    tl.end_step(now=5.0)
    res, = tl.results("decode")
    assert isinstance(res, MeasuredStep) and isinstance(res, TimelineResult)
    assert res.gpu_hidden == pytest.approx(hidden)
    assert covered(tl._steps[0].spans, "gpu", "pcie") == pytest.approx(hidden)
    assert 0.0 <= res.gpu_hidden <= res.gpu_busy


def test_timeline_records_from_many_threads():
    """The compute thread and the CPU lane's worker record into one
    timeline: no span may be lost to a race."""
    import sys
    import threading
    tl = MeasuredTimeline()
    tl.begin_step("decode")
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=lambda: [
            tl.record("cpu", "cpu", 0.0, 1.0, 1) for _ in range(500)])
            for _ in range(8)]
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=60)
        assert not any(th.is_alive() for th in threads)
    finally:
        sys.setswitchinterval(old)
    res = tl.drain("decode")
    assert res[0].cpu_busy == 8 * 500 and res[0].tag_busy["cpu"] == 8 * 500


@pytest.mark.parametrize("seed", [0, 3])
def test_host_block_pool_matches_jax_pool(seed):
    """The same seeded alloc/free sequence gives the same regions and the
    same accounting in both arenas."""
    pool, jpool = HostBlockPool(24, 64, device="cpu"), JHostBlockPool(24, 64)
    rng = np.random.default_rng(seed)
    live, jlive = [], []
    for _ in range(60):
        if live and rng.random() < 0.45:
            i = int(rng.integers(len(live)))
            live.pop(i).free()
            jlive.pop(i).free()
        else:
            n = int(rng.integers(1, 7))
            r, jr = pool.alloc(n), jpool.alloc(n)
            assert (r is None) == (jr is None)
            if r is not None:
                assert (r.offset, r.n_blocks) == (jr.offset, jr.n_blocks)
                live.append(r)
                jlive.append(jr)
        assert (pool.allocated_blocks, pool.free_blocks) == \
            (jpool.allocated_blocks, jpool.free_blocks)
        pool.check_invariants()
    if live:                  # a region view is the arena's bytes, in place
        v = live[0].view((live[0].n_blocks, 16), torch.float32)
        v.fill_(2.0)
        start = live[0].offset * 64
        assert pool.arena[start:start + 4].view(torch.float32).item() == 2.0
    with pytest.raises(ValueError):
        pool.alloc(0)


def test_fault_plan_draws_match_jax():
    kw = dict(stall_p=0.2, slow_p=0.3, copy_fail_p=0.25, arena_deny_p=0.5,
              max_events=3)
    plan, jplan = FaultPlan(11, **kw), JFaultPlan(11, **kw)
    for site, kinds in [("stage:0", ("stall", "copy_fail", "slow")),
                        ("arena", ("deny",)), ("host_attn", None)] * 20:
        args = (site,) if kinds is None else (site, kinds)
        got, want = plan.draw(*args), jplan.draw(*args)
        assert (got is None) == (want is None)
        if got is not None:
            assert (got.kind, got.seconds) == (want.kind, want.seconds)
    assert plan.injected == jplan.injected and plan.draws == jplan.draws


@pytest.mark.parametrize("case", ["retry", "give_up"])
def test_streamer_fault_ladder_matches_jax(setup_opt, case):
    """The same ``FaultPlan`` seed drives both streamers through the same
    acquire/release schedule to the same counters: copy failures retried,
    or given up on (lane degraded, synchronous fallback), and recovered at
    the next pass."""
    cfg, tp, jcfg, jp, *_ = setup_opt
    kw = dict(copy_fail_p=0.5, max_events=3) if case == "retry" \
        else dict(copy_fail_p=1.0, max_events=4)
    st = WeightStreamer(HostWeightPool(cfg, tp, device="cpu"),
                        prefetch_depth=1, faults=FaultPlan(5, **kw))
    jst = JWeightStreamer(JHostWeightPool(jcfg, jp), prefetch_depth=1,
                          faults=JFaultPlan(5, **kw))
    for s in (st, jst):
        for _ in range(2):
            s.begin(list(range(cfg.num_layers)) * 3)
            for i in range(3 * cfg.num_layers):
                s.acquire(i)
                s.release(i)
        s.close()
    assert st.fault_counters == jst.fault_counters
    assert (st.uploads, st.lane_health) == (jst.uploads, jst.lane_health)
    if case == "give_up":
        assert st.fault_counters["copy_failures"] == 1
        assert st.fault_counters["sync_fallbacks"] > 0
    else:
        assert st.fault_counters["copy_retries"] > 0
        assert st.fault_counters["copy_failures"] == 0


@pytest.mark.parametrize("case", ["copy_fail", "arena_deny"])
def test_faulted_offload_engine_stays_exact(setup_opt, case):
    """Injected copy failures and an arena denial change the path, never
    the tokens: a denied arena serves the group device-resident."""
    _, _, _, _, reqs, ref, _, _ = setup_opt
    faults = FaultPlan(2, copy_fail_p=1.0, max_events=4) if case == "copy_fail" \
        else FaultPlan(2, arena_deny_p=1.0, max_events=1)
    eng, out, _ = _run(setup_opt, True, 1, faults=faults)
    for r in reqs:
        np.testing.assert_array_equal(out[r.rid], ref[r.rid])
    if case == "copy_fail":
        assert eng.executor.fault_counters["copy_failures"] >= 1
        assert eng.executor.fault_counters["sync_fallbacks"] >= 1
    else:
        assert eng.arena_denials == 1
        assert sum(m.traffic["kv_load"] for m in eng.measured_steps) == 0
    assert all(p.allocated == 0 for p in eng.blockman.pools.values())


def test_budget_copy_matches_reference(setup_opt):
    cfg, _, jcfg, *_ = setup_opt
    for depth in (0, 1, 2):
        b, jb = _tight(cfg, prefetch_depth=depth), \
            j_offload._tight(jcfg, prefetch_depth=depth)
        assert (b.dev_bytes, b.dev_kv_blocks(cfg)) == \
            (jb.dev_bytes, jb.dev_kv_blocks(jcfg))
    full, jfull = get_config("opt-6.7b"), j_get_config("opt-6.7b")
    assert offload_budget(full).dev_kv_blocks(full) == \
        j_offload.offload_budget(jfull).dev_kv_blocks(jfull)


def test_offload_engine_holds_no_weights_and_refuses_host_attn_alone(setup_opt):
    cfg, tp, *_ = setup_opt
    with HybridServeEngine(cfg, tp, device="cpu", offload=True, **CAPS) as eng:
        assert eng.params is None
    with pytest.raises(ValueError, match="host_attn"):
        HybridServeEngine(cfg, tp, device="cpu", host_attn=True, **CAPS)
