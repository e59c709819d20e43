"""The port's copied host modules give the reference's results.

Policy, packing and simulation are pure numpy on both sides, so every
comparison here is exact (integers, or floats from the same operations in
the same order)."""
import dataclasses
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_config as j_get_config
from repro.core import blocks as j_blocks
from repro.core import costmodel as j_cm
from repro.core import minibatch as j_mb
from repro.core import pipeline as j_pipe
from repro.core import policy as j_policy
from repro.models import model as JM
from repro.serving import util as j_util
from repro_torch.configs import REGISTRY, get_config
from repro_torch.core import blocks, costmodel as cm, minibatch, pipeline, policy
from repro_torch.data.pipeline import request_trace
from repro_torch.models import model as M
from repro_torch.serving import util

torch.set_num_threads(1)

NAMES = ["opt-6.7b", "opt-6.7b-reduced"]
HW = {"tpu-v5e": cm.TPU_V5E, "h100-sxm": cm.H100_SXM}


def j_hw(hw):
    """The reference's HardwareSpec with the port's numbers."""
    return j_cm.HardwareSpec(**dataclasses.asdict(hw))


@pytest.mark.parametrize("name", sorted(REGISTRY) + [
    n + "-reduced" for n in sorted(REGISTRY)])
def test_config_copies_equal_the_reference(name):
    """Each config the port copied is the reference's, field for field, and
    so is its ``-reduced`` variant."""
    assert dataclasses.asdict(get_config(name)) == \
        dataclasses.asdict(j_get_config(name))


@pytest.mark.parametrize("name", [n + "-reduced" for n in sorted(REGISTRY)
                                  if not n.startswith("opt-") or n == "opt-6.7b"])
def test_init_params_draws_the_reference_tree(name):
    """The port's own ``init_params`` makes the reference's pytree, key for
    key, shape for shape and dtype for dtype, for every family it serves
    (the reference's tree by ``jax.eval_shape``, nothing drawn)."""
    want = jax.eval_shape(lambda: JM.init_params(j_get_config(name),
                                                 jax.random.PRNGKey(0)))
    got = M.init_params(get_config(name), seed=0, device="cpu")
    flat = lambda tree: {k: flat(v) if isinstance(v, dict)
                         else (tuple(v.shape), str(v.dtype).split(".")[-1])
                         for k, v in tree.items()}
    assert flat(got) == flat(want)


@pytest.mark.parametrize("stem,name", [
    ("whisper_base", "whisper-base"), ("qwen2_vl_2b", "qwen2-vl-2b"),
    ("jamba_1_5_large", "jamba-1.5-large-398b"), ("gemma3_27b", "gemma3-27b")])
def test_frontend_config_sources_are_the_references(stem, name):
    """whisper-base's, qwen2-vl-2b's, jamba-1.5-large-398b's and
    gemma3-27b's config files are the reference's, line for line but for
    the package they import from."""
    root = Path(__file__).resolve().parents[1] / "src"
    mine = (root / "repro_torch" / "configs" / f"{stem}.py").read_text()
    ref = (root / "repro" / "configs" / f"{stem}.py").read_text()
    assert mine.replace("repro_torch.configs", "repro.configs") == ref
    assert name in REGISTRY


@pytest.mark.parametrize("name", ["dbrx-132b", "grok-1-314b",
                                  "dbrx-132b-reduced", "grok-1-314b-reduced",
                                  "jamba-1.5-large-398b",
                                  "jamba-1.5-large-398b-reduced"])
def test_moe_config_param_counts_equal_the_reference(name):
    """The MoE copies count the reference's parameters: every expert
    (``num_params``) and the top-k ones a token runs (``active_params``)."""
    cfg, jcfg = get_config(name), j_get_config(name)
    assert cfg.num_params() == jcfg.num_params()
    assert cfg.active_params() == jcfg.active_params()
    assert cfg.active_params() < cfg.num_params()


def test_h100_spec_is_the_data_sheet():
    hw = cm.H100_SXM
    assert (hw.flops, hw.hbm_bw, hw.device_mem) == (989e12, 3.35e12, 80 * 2**30)


@pytest.mark.parametrize("name", NAMES)
@pytest.mark.parametrize("hw_name", sorted(HW))
def test_allocation_and_schedule_match_reference(name, hw_name):
    cfg, jcfg = get_config(name), j_get_config(name)
    hw, jhw = HW[hw_name], j_hw(HW[hw_name])
    dev = policy.device_act_blocks(cfg, hw)
    assert dev == j_policy.device_act_blocks(jcfg, jhw)
    a = policy.host_block_allocation(cfg, hw, dev)
    ja = j_policy.host_block_allocation(jcfg, jhw, dev, generalized=False)
    assert (a.act_blocks, a.kv_blocks, a.act_init, a.kv_init) == \
        (ja.act_blocks, ja.kv_blocks, ja.act_init, ja.kv_init)
    act0, kv0 = np.array([0, 37, 64, 5]), np.array([48, 16, 0, 3])
    np.testing.assert_array_equal(
        policy.store_act_schedule(a, act0, kv0, 40),
        j_policy.store_act_schedule(ja, act0, kv0, 40))
    fits, jfits = cm.profile_cost_fns(cfg, hw), j_cm.profile_cost_fns(jcfg, jhw)
    for f, jf in zip(fits, jfits):
        assert (f.slope, f.intercept, f.r2) == (jf.slope, jf.intercept, jf.r2)


@pytest.mark.parametrize("name", NAMES)
def test_cost_fns_match_reference(name):
    """The lane costs, with bytes priced in the config dtype, equal the
    reference's at its default (unquantized) pricing."""
    cfg, jcfg = get_config(name), j_get_config(name)
    ns = np.array([0, 16, 1000, 65536])
    for f, jf in zip(cm.make_cost_fns(cfg, cm.H100_SXM),
                     j_cm.make_cost_fns(jcfg, j_hw(cm.H100_SXM))):
        np.testing.assert_array_equal(f(ns), jf(ns))
    assert blocks.kv_block_bytes(cfg) == j_blocks.kv_block_bytes(jcfg)
    assert blocks.act_block_bytes(cfg) == j_blocks.act_block_bytes(jcfg)


def test_full_size_opt_mixes_kv_and_act_on_the_h100():
    """Algorithm 1 for opt-6.7b under the H100 spec keeps both kinds, so
    the engine's hybrid path runs KV pages and ACT pages alike."""
    cfg = get_config("opt-6.7b")
    a = policy.host_block_allocation(
        cfg, cm.H100_SXM, policy.device_act_blocks(cfg, cm.H100_SXM))
    assert 0.5 < a.act_fraction < 0.7


@pytest.mark.parametrize("quant", [False, True], ids=["fp", "int8"])
@pytest.mark.parametrize("name", NAMES + ["yi-6b", "yi-6b-reduced"])
@pytest.mark.parametrize("hw_name", sorted(HW))
def test_generalized_allocation_matches_reference(name, hw_name, quant):
    """Algorithm 1 with the byte-ratio-aware balance (``generalized=True``,
    the continuous-batching server's default) gives the reference's
    allocation and schedule, fp and int8."""
    from repro.core.quant import QuantConfig as JQuant
    from repro_torch.core.quant import QuantConfig
    cfg, jcfg = get_config(name), j_get_config(name)
    hw, jhw = HW[hw_name], j_hw(HW[hw_name])
    q, jq = (QuantConfig(), JQuant()) if quant else (None, None)
    dev = policy.device_act_blocks(cfg, hw, quant=q)
    a = policy.host_block_allocation(cfg, hw, dev, generalized=True, quant=q)
    ja = j_policy.host_block_allocation(jcfg, jhw, dev, generalized=True,
                                        quant=jq)
    assert (a.act_blocks, a.kv_blocks, a.act_init, a.kv_init) == \
        (ja.act_blocks, ja.kv_blocks, ja.act_init, ja.kv_init)
    fits = cm.profile_cost_fns(cfg, hw, quant=q)
    assert policy.alloc_remaining(cfg, hw, *fits, 3, 0, generalized=True,
                                  quant=q) == \
        j_policy.alloc_remaining(jcfg, jhw, *j_cm.profile_cost_fns(
            jcfg, jhw, quant=jq), 3, 0, generalized=True, quant=jq)
    act0, kv0 = np.array([0, 37, 64, 5]), np.array([48, 16, 0, 3])
    np.testing.assert_array_equal(
        policy.store_act_schedule(a, act0, kv0, 24),
        j_policy.store_act_schedule(ja, act0, kv0, 24))


def test_dispatch_overhead_is_the_reference_default():
    assert cm.HardwareSpec("x", 1, 1, 1, 1, 1).dispatch_overhead == \
        j_cm.HardwareSpec("x", 1, 1, 1, 1, 1).dispatch_overhead == 40e-6
    assert cm.H100_SXM.dispatch_overhead == cm.TPU_V5E.dispatch_overhead


@pytest.mark.parametrize("caps", [(128, 128), (64, 32), (32, 64), (16, 16)])
@pytest.mark.parametrize("act_frac", [0.0, 0.4, 0.98])
def test_pack_group_clamp_matches_reference(act_frac, caps):
    """``clamp=True`` (the server's admission) moves a split that breaks a
    cap into the feasible window, or raises as the reference does."""
    reqs = request_trace(1024, 4, prompt_mean=40, gen_tokens=6, seed=7)
    try:
        want = j_util.pack_group(reqs, act_frac, *caps, clamp=True)
    except ValueError:
        with pytest.raises(ValueError):
            util.pack_group(reqs, act_frac, *caps, clamp=True)
        return
    got = util.pack_group(reqs, act_frac, *caps, clamp=True)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(np.asarray(g), np.asarray(w))


@pytest.mark.parametrize("act_frac", [0.0, 0.4, 0.98, 1.0])
@pytest.mark.parametrize("mode", ["hybrid", "kv", "act"])
def test_pack_group_matches_reference(act_frac, mode):
    reqs = request_trace(1024, 4, prompt_mean=40, gen_tokens=6, seed=7)
    got = util.pack_group(reqs, act_frac, 128, 128, mode=mode)
    want = j_util.pack_group(reqs, act_frac, 128, 128, mode=mode)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(np.asarray(g), np.asarray(w))
    assert [util.bucket(n) for n in (1, 16, 17, 70)] == [16, 16, 32, 80]


def test_form_minibatches_matches_reference():
    cfg, jcfg = get_config("opt-6.7b"), j_get_config("opt-6.7b")
    fits = cm.profile_cost_fns(cfg, cm.H100_SXM)
    jfits = j_cm.profile_cost_fns(jcfg, j_hw(cm.H100_SXM))
    rng = np.random.default_rng(0)
    rb = [(i, int(rng.integers(0, 9)), int(rng.integers(0, 9))) for i in range(12)]
    got = minibatch.form_minibatches(
        [minibatch.RequestBlocks(*r) for r in rb], *fits, act_max=20, kv_max=20)
    want = j_mb.form_minibatches(
        [j_mb.RequestBlocks(*r) for r in rb], *jfits, act_max=20, kv_max=20)
    assert [[r.rid for r in mb.requests] for mb in got] == \
        [[r.rid for r in mb.requests] for mb in want]


@pytest.mark.parametrize("name", NAMES)
def test_simulate_steps_totals_match_reference(name):
    cfg, jcfg = get_config(name), j_get_config(name)
    specs = [[pipeline.MiniBatchSpec(4, 100 + 16 * s, 60 + 8 * s,
                                     ctx_tokens=64 + s)] for s in range(5)]
    jspecs = [[j_pipe.MiniBatchSpec(act_dev_tokens=0, **dataclasses.asdict(m))
               for m in st] for st in specs]
    got = pipeline.simulate_steps(cfg, cm.H100_SXM, specs)
    want = j_pipe.simulate_steps(jcfg, j_hw(cm.H100_SXM), jspecs)
    for g, w in zip(got, want):
        assert (g.total, g.gpu_busy, g.pcie_busy, g.traffic) == \
            (w.total, w.gpu_busy, w.pcie_busy, w.traffic)


@pytest.mark.parametrize("name", NAMES)
def test_cpu_lane_pricing_matches_reference(name):
    """The CPU attention lane's pricing and its lane in the simulator equal
    the reference's, every field of every step."""
    cfg, jcfg = get_config(name), j_get_config(name)
    hw, jhw = cm.H100_SXM, j_hw(cm.H100_SXM)
    assert (hw.host_flops, hw.host_dram_bw, hw.host_mfu) == \
        (jhw.host_flops, jhw.host_dram_bw, jhw.host_mfu)
    assert cm.cpu_attend_seconds_per_token(cfg, hw) == \
        j_cm.cpu_attend_seconds_per_token(jcfg, jhw)
    specs = [[pipeline.MiniBatchSpec(4, 0, 60 + 8 * s, ctx_tokens=64 + s,
                                     cpu_host_tokens=100 + 16 * s)]
             for s in range(5)]
    jspecs = [[j_pipe.MiniBatchSpec(act_dev_tokens=0, **dataclasses.asdict(m))
               for m in st] for st in specs]
    got = pipeline.simulate_steps(cfg, hw, specs)
    want = j_pipe.simulate_steps(jcfg, jhw, jspecs)
    for g, w in zip(got, want):
        assert g.cpu_busy > 0
        assert dataclasses.asdict(g) == dataclasses.asdict(w)


def test_block_manager_residency_moves_match_reference():
    """Migration to the device, the host-attend tag, and their counters."""
    cfg, jcfg = get_config("opt-6.7b-reduced"), j_get_config("opt-6.7b-reduced")
    kw = dict(host_kv_blocks=4, host_act_blocks=2, dev_kv_blocks=2,
              dev_act_blocks=1)
    bm, jbm = blocks.BlockManager(cfg, **kw), j_blocks.BlockManager(jcfg, **kw)
    for m, T in ((bm, blocks.BlockType), (jbm, j_blocks.BlockType)):
        for rid in (1, 2):
            m.new_request(rid)
            for i in range(70):
                m.append_token(rid, T.ACT if i % 3 == 0 else T.KV)
    assert bm.migrate(1, blocks.BlockType.KV, blocks.Location.DEVICE) == \
        jbm.migrate(1, j_blocks.BlockType.KV, j_blocks.Location.DEVICE)
    assert bm.tag_host_attend(2) == jbm.tag_host_attend(2)
    assert bm.tag_host_attend(1) == jbm.tag_host_attend(1)
    for rid in (1, 2):
        assert bm.counts(rid) == jbm.counts(rid)
    assert {(k.value, a.value, b.value): n
            for (k, a, b), n in bm.transitions.items()} == \
        {(k.value, a.value, b.value): n
         for (k, a, b), n in jbm.transitions.items()}


def test_block_manager_free_blocks_match_reference():
    """``free_blocks(kind)``: free capacity of a kind over both tiers."""
    cfg, jcfg = get_config(NAMES[1]), j_get_config(NAMES[1])
    sizes = dict(host_kv_blocks=3, host_act_blocks=5, dev_kv_blocks=2,
                 dev_act_blocks=1)
    bm, jbm = (blocks.BlockManager(cfg, **sizes),
               j_blocks.BlockManager(jcfg, **sizes))
    for m, kinds in ((bm, blocks.BlockType), (jbm, j_blocks.BlockType)):
        m.new_request(0)
        for t in range(70):
            m.append_token(0, kinds.KV if t % 3 else kinds.ACT)
    for kind, jkind in zip(blocks.BlockType, j_blocks.BlockType):
        assert bm.free_blocks(kind) == jbm.free_blocks(jkind)
    assert bm.free_blocks(blocks.BlockType.KV) == 5 - 3     # 46 KV tokens
    assert bm.kind_transitions == {}


def test_block_manager_accounting_matches_reference():
    cfg, jcfg = get_config("opt-6.7b-reduced"), j_get_config("opt-6.7b-reduced")
    kw = dict(host_kv_blocks=3, host_act_blocks=2, dev_kv_blocks=1,
              dev_act_blocks=1)
    bm, jbm = blocks.BlockManager(cfg, **kw), j_blocks.BlockManager(jcfg, **kw)
    pattern = np.random.default_rng(1).random(90) < 0.5
    for m in (bm, jbm):
        m.new_request(7)
    for act in pattern:
        got = bm.append_token(7, blocks.BlockType.ACT if act else blocks.BlockType.KV)
        want = jbm.append_token(7, j_blocks.BlockType.ACT if act
                                else j_blocks.BlockType.KV)
        assert (got is None) == (want is None)
    assert bm.counts(7) == jbm.counts(7)
    for m in (bm, jbm):
        m.free_request(7)
    assert [p.allocated for p in bm.pools.values()] == [0, 0, 0, 0]
    assert blocks.kv_block_bytes(cfg) == j_blocks.kv_block_bytes(jcfg)
    assert blocks.act_block_bytes(cfg) == j_blocks.act_block_bytes(jcfg)
