"""Sharded serving of the port against the JAX package: shard invariance,
per-shard lanes, and the sharded path's trouble spots.

The counterpart of ``tests/test_sharded_serving.py``, whose reference meshes
this file builds with ``AxisType.Auto`` axes (on ``jax.make_mesh``'s
Explicit axes the reference's vocab-sharded gather raises in JAX 0.9); the
port's meshes put every position on the CPU:

  * the engine on 1x1, 1x2 and 2x2 is token-exact against JAX's
    ``exact_reference_generate``, leak-free, with the same calls and host
    reads on every mesh as the single-device run and as one reference
    sharded engine run on 1x2,
  * the continuous-batching server on 1x2 and 2x2 keeps its one call and
    one readback per admission batch and per chunk,
  * the offload path runs one weight lane per position, spills KV into
    per-shard arenas, and feeds the controller max-aggregated timelines;
    its traced server run stamps lane spans with shards 0 and 1,
  * KV-Gen needs the ACT rows gathered whole (a position's own slice alone
    reads far off), and neither the sharded prefill nor its decode reads a
    device value."""
import dataclasses
import functools

import jax
import numpy as np
import pytest
import torch
from jax.sharding import AxisType, Mesh as JMesh

from repro.configs import get_config as j_get_config
from repro.core import costmodel as j_cm
from repro.models import model as JM
from repro.serving import HybridServeEngine as JEngine
from repro.serving import exact_reference_generate as j_reference
from repro.sharding import make_shard_plan as j_make_shard_plan
from repro_torch import params as P
from repro_torch.configs import get_config
from repro_torch.core import ControllerConfig, costmodel as cm
from repro_torch.core.quant import QuantConfig
from repro_torch.data.pipeline import open_loop_trace
from repro_torch.launch import serve
from repro_torch.launch.mesh import make_test_mesh
from repro_torch.models import sharded as SHD
from repro_torch.models import transformer as T
from repro_torch.offload.host_pool import HostWeightPool
from repro_torch.obs import (MetricsRegistry, Tracer, assert_single_rooted,
                             validate_chrome_trace)
from repro_torch.serving import ContinuousBatchingServer, HybridServeEngine
from repro_torch.sharding import collectives as C
from repro_torch.sharding import make_shard_plan

torch.set_num_threads(1)

CONFIGS = ["opt-6.7b-reduced", "yi-6b-reduced"]
MESHES = [(1, 1), (1, 2), (2, 2)]
# at reduced widths the H100 spec keeps ~98% of the context as ACT; 20
# TFLOP/s splits the prompts, so groups hold KV blocks and the offload
# engine spills them
MIXED = dataclasses.replace(cm.H100_SXM, name="h100-20tflops", flops=2e13)


def j_mesh(d, m):
    devs = jax.devices()
    assert len(devs) >= d * m, \
        "needs XLA_FLAGS=--xla_force_host_platform_device_count=4 (conftest)"
    return JMesh(np.array(devs[:d * m]).reshape(d, m), ("data", "model"),
                 axis_types=(AxisType.Auto,) * 2)


@functools.lru_cache(maxsize=None)
def setup(name):
    jcfg = j_get_config(name)
    jp = JM.init_params(jcfg, jax.random.PRNGKey(0))
    tp = P.from_numpy(jax.tree.map(np.asarray, jp), device="cpu")
    cfg = get_config(name)
    reqs, arrivals = open_loop_trace(cfg.vocab_size, 4, seed=11)
    return cfg, tp, jcfg, jp, reqs, arrivals, j_reference(jcfg, jp, reqs)


def plan_for(cfg, tp, shape):
    return make_shard_plan(cfg, make_test_mesh(*shape, device="cpu"), tp)


def counting_reads(monkeypatch):
    """Count every host read of a tensor's value (``.cpu()`` and the scalar
    conversions)."""
    n = [0]
    for name in ("cpu", "item", "tolist", "__bool__", "__int__",
                 "__float__", "__index__"):
        orig = getattr(torch.Tensor, name)

        def wrapped(self, *a, _orig=orig, **k):
            n[0] += 1
            return _orig(self, *a, **k)
        monkeypatch.setattr(torch.Tensor, name, wrapped)
    return n


def assert_tokens(out, reqs, want):
    for r in reqs:
        np.testing.assert_array_equal(out[r.rid], want[r.rid])


@pytest.mark.parametrize("name", CONFIGS)
def test_engine_shard_invariance(name, monkeypatch):
    cfg, tp, jcfg, jp, reqs, _, ref = setup(name)
    calls, reads = {}, {}
    for shape in MESHES:
        eng = HybridServeEngine(cfg, tp, plan=plan_for(cfg, tp, shape))
        with monkeypatch.context() as m:
            n = counting_reads(m)
            out, st = eng.generate(reqs)
        calls[shape], reads[shape] = st.device_calls, n[0]
        assert_tokens(out, reqs, ref)
        assert all(p.allocated == 0 for p in eng.blockman.pools.values())
        assert not eng.blockman.tables
        if shape == (2, 2):         # a group splits over the data axis
            assert any(len(g) % 2 == 0 for g in eng.plan_groups(reqs))
    base = HybridServeEngine(cfg, tp, device="cpu")
    with monkeypatch.context() as m:
        n = counting_reads(m)
        out0, st0 = base.generate(reqs)
    assert_tokens(out0, reqs, ref)
    jplan = j_make_shard_plan(jcfg, j_mesh(1, 2), jp)
    j_eng = JEngine(jcfg, jp, mode="hybrid", plan=jplan,
                    hw=j_cm.HardwareSpec(**dataclasses.asdict(cm.H100_SXM)))
    j_out, j_st = j_eng.generate(reqs)
    assert_tokens(j_out, reqs, ref)
    assert set(calls.values()) == {st0.device_calls, j_st.device_calls}
    assert set(reads.values()) == {n[0]} and n[0] == len(base.plan_groups(reqs))


@pytest.mark.parametrize("name", CONFIGS)
def test_scheduler_shard_invariance(name):
    """The chunked server on 1x2 and 2x2: token-exact, one call and one
    readback per admission batch and per chunk, the single-device
    server's counts, leak-free."""
    cfg, tp, _, _, reqs, arrivals, ref = setup(name)
    kw = dict(slots=2, kv_cap=128, act_cap=128, chunk_steps=4)
    with ContinuousBatchingServer(cfg, tp, device="cpu", **kw) as srv:
        _, st0 = srv.run(reqs, arrival_steps=arrivals)
    for shape in MESHES[1:]:
        with ContinuousBatchingServer(cfg, tp, plan=plan_for(cfg, tp, shape),
                                      **kw) as srv:
            out, st = srv.run(reqs, arrival_steps=arrivals)
            assert_tokens(out, reqs, ref)
            assert st.device_calls == st.admission_batches + st.chunks
            assert st.host_syncs == st.device_calls
            assert (st.device_calls, st.host_syncs) == \
                (st0.device_calls, st0.host_syncs)
            assert not any(s.active for s in srv.slots)
            assert all(p.allocated == 0 for p in srv.blockman.pools.values())
            assert not srv.blockman.tables


def test_offload_per_shard_lanes_soak():
    """Offload on a 1x2 mesh: one weight lane per position (its own host
    slice, staging ring and copy stream), KV spilled into per-shard arenas
    and returned, token-exact, and the controller fed timelines whose lane
    seconds aggregate by the max across lanes."""
    cfg, tp, _, _, reqs, arrivals, ref = setup("opt-6.7b-reduced")
    plan = plan_for(cfg, tp, (1, 2))
    with HybridServeEngine(cfg, tp, offload=True, adaptive=True, plan=plan,
                           hw=MIXED) as eng:
        out, st = eng.generate(reqs)
        assert_tokens(out, reqs, ref)
        lanes = eng.executor.streamer.lanes
        assert len(lanes) == 2 and all(lane.uploads > 0 for lane in lanes)
        assert len(eng.spill_kv_pool.lanes) == 2      # one arena per shard
        assert eng.spill_kv_pool.allocated_blocks == 0
        eng.spill_kv_pool.check_invariants()
        assert all(p.allocated == 0 for p in eng.blockman.pools.values())
        assert eng.measured_steps
        assert sum(m.traffic["kv_load"] for m in eng.measured_steps) > 0
        for res in eng.measured_steps:
            assert res.pcie_busy <= res.total + 1e-6
        assert eng.controller.updates > 0
    with ContinuousBatchingServer(cfg, tp, slots=2, kv_cap=128, act_cap=128,
                                  chunk_steps=4, offload=True, adaptive=True,
                                  plan=plan,
                                  ctl=ControllerConfig(update_every=1)) as srv:
        out, st = srv.run(reqs, arrival_steps=arrivals)
        assert_tokens(out, reqs, ref)
        assert srv.measured_steps and srv.controller.updates > 0
        assert all(p.allocated == 0 for p in srv.blockman.pools.values())


def test_a_shared_pool_serves_the_plans_device():
    """A ``HostWeightPool`` built for a plan and handed to the engine serves
    position 0's device, as its executor does: on the card a mesh names
    ``cuda:0`` where the caller says ``cuda``; here the mesh names ``cpu:0``
    where the pool is asked for ``cpu``."""
    cfg, tp, _, _, reqs, _, ref = setup("opt-6.7b-reduced")
    plan = make_shard_plan(cfg, make_test_mesh(1, 2, device="cpu:0"), tp)
    pool = HostWeightPool(cfg, tp, plan=plan, device="cpu")
    assert pool.device == plan.mesh.devices[0] == torch.device("cpu", 0)
    with HybridServeEngine(cfg, pool, offload=True, plan=plan) as eng:
        assert eng.executor.pool is pool
        out, _ = eng.generate(reqs[:2])
    assert_tokens(out, reqs[:2], ref)
    with pytest.raises(ValueError, match="under a plan"):
        HostWeightPool(cfg, tp, plan=plan, device="meta")


def test_trace_sharded_timelines_complete():
    """A traced 1x2 offload server: lane spans on shards {0, 1}, every
    request's span tree complete and single-rooted, the measured timelines
    in the drift window, the collective bytes in the snapshot."""
    cfg, tp, _, _, reqs, arrivals, ref = setup("opt-6.7b-reduced")
    tracer, reg = Tracer(), MetricsRegistry()
    with ContinuousBatchingServer(cfg, tp, slots=2, kv_cap=128, act_cap=128,
                                  chunk_steps=4, offload=True,
                                  plan=plan_for(cfg, tp, (1, 2)),
                                  tracer=tracer, metrics=reg) as srv:
        out, st = srv.run(reqs, arrival_steps=arrivals)
        drift_samples = srv.drift.samples
    assert_tokens(out, reqs, ref)
    data = tracer.to_chrome()
    validate_chrome_trace(data)
    for r in reqs:
        assert_single_rooted(data, r.rid, require=("prefill", "complete"))
    shards = {e["args"].get("shard") for e in data["traceEvents"]
              if e["ph"] == "X" and e.get("cat", "").startswith("lane:")}
    assert {0, 1} <= shards
    assert drift_samples > 0
    snap = reg.snapshot()
    assert snap["lane_time_s{source=measured}"] > 0.0
    assert snap["collective_bytes{kind=total}"] > 0


def _step_logits(plan, tp, toks, kv_keep):
    """The prefill's and one decode step's logits through the sharded
    functions, teacher-forced."""
    gold = torch.tensor([[3, 5]] * len(toks), dtype=torch.int32)
    return SHD.forced_logits(plan, plan.place_params(tp), toks, 64, 64,
                             kv_keep, np.full(len(toks), toks.shape[1]),
                             torch.zeros((2, len(toks)), dtype=torch.bool),
                             gold)


@pytest.mark.parametrize("name", CONFIGS)
def test_kv_gen_needs_the_act_rows_gathered(name, monkeypatch):
    """The ACT region is stored split over d_model, and KV-Gen's norm and
    projection contract over all of it: with the rows gathered the 1x2
    step's logits equal the 1x1 run's within float32; KV-Gen on each
    position's own slice (the rest zero) reads far off."""
    cfg, tp, *_ = setup(name)
    rng = np.random.default_rng(3)
    toks = rng.integers(0, cfg.vocab_size, (2, 48)).astype(np.int32)
    kv_keep = np.array([16, 0])                  # both page types, ACT-heavy
    want = _step_logits(plan_for(cfg, tp, (1, 1)), tp, toks, kv_keep)
    plan = plan_for(cfg, tp, (1, 2))
    C.COUNTER.reset()
    got = _step_logits(plan, tp, toks, kv_keep)
    assert C.COUNTER.bytes["act"] > 0
    torch.testing.assert_close(got, want, rtol=0, atol=1e-4)

    def own_slice(parts, devices):
        d = parts[0].shape[-1]
        return [torch.nn.functional.pad(p, (c * d, (len(parts) - 1 - c) * d))
                for c, p in enumerate(parts)]
    monkeypatch.setattr(SHD, "_act_gather", own_slice)
    bad = _step_logits(plan, tp, toks, kv_keep)
    assert (bad - want).abs().max() > 1e-2


def test_sharded_prefill_and_decode_read_no_device_value(monkeypatch):
    """Neither the sharded prefill nor the decode loop reads a tensor's
    value on the host (fault K's pattern), on a 2x2 mesh for both
    routes."""
    def refuse(*_, **__):
        raise AssertionError("a device value was read")
    for name in CONFIGS:
        cfg, tp, *_ = setup(name)
        plan = plan_for(cfg, tp, (2, 2))
        params = plan.place_params(tp)
        toks = np.random.default_rng(4).integers(
            0, cfg.vocab_size, (4, 32)).astype(np.int32)
        sched = torch.tensor([[True, False, True, False]] * 3)
        with monkeypatch.context() as m:
            for attr in ("cpu", "item", "tolist", "numpy", "__bool__",
                         "__int__", "__float__", "__index__", "__array__"):
                m.setattr(torch.Tensor, attr, refuse)
            curs, cache = SHD.prefill(plan, params, toks, 64, 64,
                                      np.array([16, 0, 32, 16]),
                                      np.full(4, 32))
            both, _ = SHD.decode_chunk(plan, params, curs, cache, sched,
                                       pages_bound=6, act_pages_bound=3)
        assert both.shape == (4, 4)


def test_unsupported_combinations_name_item_5_2():
    """What a plan refused until item 5.2.1-5.2.3 (the int8 cache, the CPU
    lane, MoE) now builds under it: the engine, the server and the offload
    executor take each (``test_torch_shard_configs.py`` and
    ``test_torch_shard_moe.py`` serve them).  A family the engine does not
    serve is still refused under a plan, as without one."""
    cfg, tp, *_ = setup("opt-6.7b-reduced")
    plan = plan_for(cfg, tp, (1, 2))
    for kw in (dict(quant=QuantConfig()), dict(offload=True, host_attn=True)):
        with HybridServeEngine(cfg, tp, plan=plan, **kw) as eng:
            assert eng.plan is plan
    with ContinuousBatchingServer(cfg, tp, plan=plan, quant=QuantConfig(),
                                  offload=True, host_attn=True) as srv:
        assert srv.executor.plan is plan
        assert srv.cache["act_s"].spec == (None, None, None, None)
        assert srv.cache["k_s"].spec == (None, None, None, "model", None)
    moe = get_config("dbrx-132b-reduced")
    mp = T.init_params(moe, 0, device="cpu")
    assert HybridServeEngine(moe, mp, plan=plan_for(moe, mp, (1, 2))).plan
    ssm = get_config("mamba2-2.7b-reduced")
    sp = T.init_params(ssm, 0, device="meta")
    with pytest.raises(NotImplementedError, match="not served by"):
        HybridServeEngine(ssm, sp, plan=make_shard_plan(
            ssm, make_test_mesh(1, 2, device="meta"), sp))


def test_serve_cli_on_a_mesh(capsys):
    """``--mesh 1,2 --verify`` serves token-exact; ``--explain-plan`` prints
    the plan's decision log, built from shapes alone."""
    serve.main(["--arch", "yi-6b-reduced", "--device", "cpu", "--mesh", "1,2",
                "--requests", "3", "--gen-tokens", "4", "--verify"])
    assert "token-exact vs full-KV reference: True" in capsys.readouterr().out
    cfg, tp, *_ = setup("yi-6b-reduced")
    assert serve.main(["--arch", "yi-6b-reduced", "--device", "cpu",
                       "--mesh", "2,2", "--explain-plan"]) == (None, None)
    assert capsys.readouterr().out.strip() == \
        plan_for(cfg, tp, (2, 2)).explain()
