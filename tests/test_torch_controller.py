"""The port's adaptive controller against ``repro.core.controller``.

The controller, its online refit and both allocation laws are host numpy on
both sides, so each comparison is exact: the same seeded samples, fits and
``TimelineResult`` streams go through the JAX package's functions and the
port's, and the fits, allocations, ``frac_history`` and migrated blocks must
be equal.  The port's own properties follow the reference's tests: the
Algorithm-1 fixed point on analytic timelines, bounded migration,
conservation of host blocks, and capacity retags that move free blocks only
(fp and int8 pools)."""
import dataclasses

import numpy as np
import pytest
import torch

from repro.configs import get_config as j_get_config
from repro.core import blocks as j_blocks
from repro.core import controller as j_ctl
from repro.core import costmodel as j_cm
from repro.core import pipeline as j_pipe
from repro.core import policy as j_policy
from repro.core.quant import QuantConfig as JQuant
from repro_torch.configs import get_config
from repro_torch.core import (ControllerConfig, HybridCacheController,
                              LaneSample, LinearFit, damp_fit, ewma_refit,
                              fit_samples)
from repro_torch.core import blocks, costmodel as cm, pipeline, policy
from repro_torch.core.quant import QuantConfig

torch.set_num_threads(1)

NAME = "opt-6.7b-reduced"
HW = {"tpu-v5e": cm.TPU_V5E, "h100-sxm": cm.H100_SXM}


def j_hw(hw):
    return j_cm.HardwareSpec(**dataclasses.asdict(hw))


def same_fit(f, jf):
    return (f.slope, f.intercept, f.r2) == (jf.slope, jf.intercept, jf.r2)


def j_fit(f):
    return j_cm.LinearFit(f.slope, f.intercept, f.r2)


def exact_fits(cfg, hw, quant=None, cpu=False):
    """The analytic lanes fitted without profiling noise."""
    fns = cm.make_cost_fns(cfg, hw, quant=quant, cpu=cpu)
    idx = (0, 1, 3) if cpu else (0, 1)
    return tuple(cm.fit_linear(fns[i], cm.SAMPLE_TOKENS, 0.0, seed=0)
                 for i in idx)


def sim_step(cfg, hw, kv, act, cpu_tok=0, quant=None, n_req=4, ctx=512):
    return pipeline.simulate_steps(cfg, hw, [[pipeline.MiniBatchSpec(
        n_req, int(kv), int(act), ctx_tokens=ctx, cpu_host_tokens=cpu_tok)]],
        quant=quant)[0]


def j_result(res):
    return j_pipe.TimelineResult(**dataclasses.asdict(res))


# ------------------------------------------------------------- the refit
@pytest.mark.parametrize("case", ["spread", "one_n", "one", "junk", "empty"])
@pytest.mark.parametrize("lane", [0, 1])
def test_refit_functions_match_reference(case, lane):
    """``fit_samples``, ``damp_fit`` and ``ewma_refit`` on the same seeded
    samples, including the degenerate sets (one n, one sample, non-finite
    or non-positive seconds, none)."""
    cfg = get_config(NAME)
    prior = cm.profile_cost_fns(cfg, cm.H100_SXM)[lane]
    jprior = j_cm.profile_cost_fns(j_get_config(NAME), j_hw(cm.H100_SXM))[lane]
    assert same_fit(prior, jprior)
    rng = np.random.default_rng(lane * 7 + len(case))
    ns = rng.uniform(16, 8192, 12)
    if case == "one_n":
        ns[:] = 1024.0
    ts = np.abs(prior(ns) * rng.uniform(0.2, 5.0)
                * (1 + 0.3 * rng.standard_normal(ns.shape)))
    if case == "junk":
        ts[::3] = np.inf
        ts[1::4] = -1.0
    pairs = {"one": list(zip(ns, ts))[:1], "empty": []}.get(
        case, list(zip(ns, ts)))
    got = [LaneSample(float(n), float(t)) for n, t in pairs]
    want = [j_cm.LaneSample(float(n), float(t)) for n, t in pairs]
    assert same_fit(fit_samples(got, prior), j_cm.fit_samples(want, jprior))
    for damping in (1.0, 2.5, 4.0, 16.0):
        wild = LinearFit(prior.slope * 9.0, prior.intercept - 3e-4, 0.5)
        assert same_fit(damp_fit(wild, prior, damping),
                        j_cm.damp_fit(j_fit(wild), jprior, damping))
        for alpha in (0.25, 1.0):
            cur = LinearFit(prior.slope * 1.5, prior.intercept, 0.9)
            assert same_fit(
                ewma_refit(cur, prior, got, alpha=alpha, damping=damping),
                j_cm.ewma_refit(j_fit(cur), jprior, want, alpha=alpha,
                                damping=damping))


# ------------------------------------------------------ allocation laws
@pytest.mark.parametrize("quant", [False, True], ids=["fp", "int8"])
@pytest.mark.parametrize("name", ["opt-6.7b", NAME, "yi-6b-reduced"])
@pytest.mark.parametrize("hw_name", sorted(HW))
def test_allocation_laws_match_reference(name, hw_name, quant):
    """Two-way Algorithm 1 under given (refit-like) fits, generalized on and
    off, and the three-way law, profiled and under scaled lanes (which
    reach its corner branches), give the reference's allocations."""
    cfg, jcfg = get_config(name), j_get_config(name)
    hw, jhw = HW[hw_name], j_hw(HW[hw_name])
    q, jq = (QuantConfig(), JQuant()) if quant else (None, None)
    dev = policy.device_act_blocks(cfg, hw, quant=q)
    prof = cm.profile_cost_fns(cfg, hw, quant=q, cpu=True)
    jprof = j_cm.profile_cost_fns(jcfg, jhw, quant=jq, cpu=True)
    assert all(same_fit(f, jf) for f, jf in zip(prof, jprof))
    for g, l, c in ((1, 1, 1), (0.3, 2.5, 1), (4, 0.2, 1), (1, 1, 1e-4),
                    (1, 1, 1e4), (50, 1, 0.05), (1, 40, 0.02)):
        fits = tuple(dataclasses.replace(f, slope=f.slope * x)
                     for f, x in zip(prof, (g, l, c)))
        jfits = tuple(j_fit(f) for f in fits)
        for gen in (False, True):
            a = policy.host_block_allocation(cfg, hw, dev, fits=fits[:2],
                                             generalized=gen, quant=q)
            ja = j_policy.host_block_allocation(jcfg, jhw, dev,
                                                fits=jfits[:2],
                                                generalized=gen, quant=jq)
            assert dataclasses.asdict(a) == dataclasses.asdict(ja)
            a3 = policy.host_block_allocation_threeway(
                cfg, hw, dev, fits=fits, generalized=gen, quant=q)
            ja3 = j_policy.host_block_allocation_threeway(
                jcfg, jhw, dev, fits=jfits, generalized=gen, quant=jq)
            assert dataclasses.asdict(a3) == dataclasses.asdict(ja3)
    a3 = policy.host_block_allocation_threeway(cfg, hw, dev, quant=q)
    ja3 = j_policy.host_block_allocation_threeway(jcfg, jhw, dev, quant=jq)
    assert dataclasses.asdict(a3) == dataclasses.asdict(ja3)


# --------------------------------------------- the controller, step by step
def _pair(cfg, jcfg, hw, ctl, *, generalized=False, cpu=False, quant=False,
          fits=None):
    q, jq = (QuantConfig(), JQuant()) if quant else (None, None)
    dev = policy.device_act_blocks(cfg, hw, quant=q)
    jhw = j_hw(hw)
    if cpu:
        alloc = policy.host_block_allocation_threeway(
            cfg, hw, dev, fits=fits, generalized=generalized, quant=q)
        jalloc = j_policy.host_block_allocation_threeway(
            jcfg, jhw, dev, fits=None if fits is None else
            tuple(j_fit(f) for f in fits), generalized=generalized, quant=jq)
    else:
        alloc = policy.host_block_allocation(
            cfg, hw, dev, fits=fits, generalized=generalized, quant=q)
        jalloc = j_policy.host_block_allocation(
            jcfg, jhw, dev, fits=None if fits is None else
            tuple(j_fit(f) for f in fits), generalized=generalized, quant=jq)
    mine = HybridCacheController(cfg, hw, alloc, dev, fits=fits,
                                 generalized=generalized, ctl=ctl, quant=q,
                                 cpu=cpu)
    ref = j_ctl.HybridCacheController(
        jcfg, jhw, jalloc, dev,
        fits=None if fits is None else tuple(j_fit(f) for f in fits),
        generalized=generalized,
        ctl=j_ctl.ControllerConfig(**dataclasses.asdict(ctl)), quant=jq,
        cpu=cpu)
    return mine, ref


def _stream(cfg, hw, truth, cpu, quant, n=14):
    """Per-step (measured, predicted, kv, act, cpu) on a ``truth`` machine
    against the prior's ``hw``: some steps fused (no "gen" tag, the
    executor's shape) and one degraded (a robustness event)."""
    q = QuantConfig() if quant else None
    out = []
    for s in range(n):
        kv, act = 900 + 70 * s, 600 + 45 * s
        c = 400 + 30 * s if cpu else 0
        meas = sim_step(cfg, truth, 0 if cpu else kv, act, c, quant=q)
        pred = sim_step(cfg, hw, 0 if cpu else kv, act, c, quant=q)
        if s % 3 == 1:
            tb = dict(meas.tag_busy)
            tb["fwd"] = tb.pop("gen", 0.0) + tb.get("fwd", 0.0)
            meas = dataclasses.replace(meas, tag_busy=tb)
        if s == 5:
            meas = dataclasses.replace(meas, events={"copy_retry": 1})
        out.append((meas, pred, 0 if cpu else kv, act, c if cpu else None))
    return out


@pytest.mark.parametrize("quant", [False, True], ids=["fp", "int8"])
@pytest.mark.parametrize("mode", ["two_way", "generalized", "cpu"])
def test_controller_matches_reference_on_the_same_stream(mode, quant):
    """The same measured/predicted ``TimelineResult`` stream, a slower link
    and faster regen than priced, in batches of two steps: every update's
    allocation, the fits, ``frac_history``, ``migrated_blocks`` and
    ``faulted_skipped`` equal the reference controller's."""
    cfg, jcfg = get_config(NAME), j_get_config(NAME)
    hw = cm.TPU_V5E
    truth = dataclasses.replace(hw, gather_eff=hw.gather_eff * 0.3,
                                gen_mfu=hw.gen_mfu * 1.6,
                                host_mfu=hw.host_mfu * 0.5)
    cpu = mode == "cpu"
    ctl = ControllerConfig(min_samples=2, alpha=0.5, damping=10.0,
                           migrate_frac=0.02)
    mine, ref = _pair(cfg, jcfg, hw, ctl, generalized=mode == "generalized",
                      cpu=cpu, quant=quant)
    steps = _stream(cfg, hw, truth, cpu, quant)
    for i in range(0, len(steps), 2):
        batch = steps[i:i + 2]
        meas, pred, kv, act, c = (list(x) for x in zip(*batch))
        c = None if not cpu else c
        got = mine.observe(meas, kv, act, sim=pred, cpu_tokens=c)
        want = ref.observe([j_result(m) for m in meas], kv, act,
                           sim=[j_result(p) for p in pred], cpu_tokens=c)
        assert got == want
        a, ja = mine.update(), ref.update()
        assert dataclasses.asdict(a) == dataclasses.asdict(ja)
        mine.alloc, ref.alloc = a, ja
    assert mine.frac_history == ref.frac_history
    assert (mine.updates, mine.migrated_blocks, mine.faulted_skipped) == \
        (ref.updates, ref.migrated_blocks, ref.faulted_skipped)
    assert mine.faulted_skipped == 1 and mine.migrated_blocks > 0
    for f, jf in ((mine.fit_gen, ref.fit_gen), (mine.fit_load, ref.fit_load),
                  (mine.fit_cpu, ref.fit_cpu)):
        assert (f is None and jf is None) or same_fit(f, jf)
    # a slower link (or host lane) than priced: its refit slope rises; the
    # two-way split moves toward ACT
    if cpu:
        assert mine.fit_cpu.slope > mine.prior_cpu.slope
    else:
        assert mine.fit_load.slope > mine.prior_load.slope
        assert mine.frac_history[-1] > mine.frac_history[0]


# ------------------------------------------------- the port's own properties
@pytest.mark.parametrize("generalized", [False, True])
def test_fixed_point_on_analytic_timelines(generalized):
    """Timelines from the same analytic model the prior was fitted on leave
    the allocation at Algorithm 1's (the reference's test), as the
    reference's controller does."""
    cfg, jcfg = get_config(NAME), j_get_config(NAME)
    hw = cm.TPU_V5E
    fits = exact_fits(cfg, hw)
    ctl = ControllerConfig(min_samples=2, alpha=0.9)
    mine, ref = _pair(cfg, jcfg, hw, ctl, generalized=generalized, fits=fits)
    start = mine.alloc
    for s in range(12):
        kv, act = 900 + 40 * s, 600 + 25 * s
        res = sim_step(cfg, hw, kv, act)
        mine.observe([res], [kv], [act])
        ref.observe([j_result(res)], [kv], [act])
        mine.alloc, ref.alloc = mine.update(), ref.update()
    assert mine.updates >= 10
    assert (mine.alloc.act_blocks, mine.alloc.kv_blocks) == \
        (start.act_blocks, start.kv_blocks)
    assert mine.fit_gen.slope == pytest.approx(mine.prior_gen.slope, rel=5e-2)
    assert mine.fit_load.slope == pytest.approx(mine.prior_load.slope,
                                                rel=5e-2)
    assert mine.frac_history == ref.frac_history


@pytest.mark.parametrize("cpu", [False, True])
@pytest.mark.parametrize("seed", range(4))
def test_bounded_migration_conserves_host_blocks(seed, cpu):
    """However far the target, one update moves at most the bound, and
    act + kv (+ cpu) stays the host total (two-way and three-way)."""
    cfg = get_config(NAME)
    hw = cm.TPU_V5E
    rng = np.random.default_rng(seed)
    bound = int(rng.integers(1, 5000))
    dev = policy.device_act_blocks(cfg, hw)
    alloc = (policy.host_block_allocation_threeway(cfg, hw, dev) if cpu
             else policy.host_block_allocation(cfg, hw, dev))
    ctl = HybridCacheController(
        cfg, hw, alloc, dev, cpu=cpu,
        ctl=ControllerConfig(min_samples=1, migrate_bound=bound, alpha=1.0,
                             damping=100.0))
    truth = dataclasses.replace(
        hw, gather_eff=hw.gather_eff * float(rng.uniform(0.1, 10.0)),
        host_mfu=hw.host_mfu * float(rng.uniform(0.1, 10.0)))
    for _ in range(5):
        kv, act = int(rng.integers(500, 5000)), int(rng.integers(500, 5000))
        c = int(rng.integers(500, 5000)) if cpu else 0
        res = sim_step(cfg, truth, 0 if cpu else kv, act, c)
        ctl.observe([res], [0 if cpu else kv], [act],
                    cpu_tokens=[c] if cpu else None)
        before = ctl.alloc
        new = ctl.update()
        assert abs(new.act_blocks - before.act_blocks) <= bound
        assert abs(new.cpu_blocks - before.cpu_blocks) <= bound
        assert new.act_blocks + new.kv_blocks + new.cpu_blocks == \
            ctl.total_host
        assert min(new.act_blocks, new.kv_blocks, new.cpu_blocks) >= 0
        t = ctl.target_allocation()
        assert t.act_blocks + t.kv_blocks + t.cpu_blocks == ctl.total_host
        ctl.alloc = new


@pytest.mark.parametrize("quant", [False, True], ids=["fp", "int8"])
def test_retag_capacity_moves_free_blocks_only(quant):
    """``retag_capacity`` moves free capacity only, conserves the tier's
    total, counts its moves, and hands out the reference's block numbers
    afterwards, fp and int8 pools alike."""
    cfg, jcfg = get_config(NAME), j_get_config(NAME)
    q, jq = (QuantConfig(), JQuant()) if quant else (None, None)
    kw = dict(host_kv_blocks=10, host_act_blocks=4, dev_kv_blocks=0,
              dev_act_blocks=0)
    bm = blocks.BlockManager(cfg, quant=q, **kw)
    jbm = j_blocks.BlockManager(jcfg, quant=jq, **kw)
    B, L = blocks.BlockType, blocks.Location
    JB, JL = j_blocks.BlockType, j_blocks.Location
    for m, T in ((bm, B), (jbm, JB)):
        m.new_request(0)
        for _ in range(3 * 16):
            assert m.append_token(0, T.KV) is not None
    assert bm.retag_capacity(L.HOST, B.KV, B.ACT, 99) == \
        jbm.retag_capacity(JL.HOST, JB.KV, JB.ACT, 99) == 7
    kv, act = bm.pools[(B.KV, L.HOST)], bm.pools[(B.ACT, L.HOST)]
    assert (kv.capacity, act.capacity) == (3, 11)
    assert bm.retags[(L.HOST, B.KV, B.ACT)] == 7
    got = [act.alloc() for _ in range(11)]
    want = [jbm.pools[(JB.ACT, JL.HOST)].alloc() for _ in range(11)]
    assert got == want and act.alloc() is None
    for p in got[::2]:
        act.free(p)
    for p in want[::2]:
        jbm.pools[(JB.ACT, JL.HOST)].free(p)
    assert bm.retag_capacity(L.HOST, B.ACT, B.KV, 4) == \
        jbm.retag_capacity(JL.HOST, JB.ACT, JB.KV, 4) == 4
    assert [kv.alloc() for _ in range(4)] == \
        [jbm.pools[(JB.KV, JL.HOST)].alloc() for _ in range(4)]
    bm.free_request(0)
    assert kv.allocated == 4 and kv.free_blocks == 3
    assert bm.block_bytes(B.KV) == jbm.block_bytes(JB.KV)
