"""Every serving configuration under a ShardPlan against the JAX package: the
int8 cache, the CPU attention lane, the head layouts whose heads do not
split, and the sharded logit gap next to the reference's own.

The reference meshes are built with ``AxisType.Auto`` axes (on
``jax.make_mesh``'s Explicit axes the reference's vocab-sharded gather
raises in JAX 0.9, ROADMAP fault C); the port's meshes put every position
on the CPU:

  * the int8 cache on 1x2 and 2x2 (opt, yi): the engine, the server and the
    spilled offload executor give the 1x1 int8 run's tokens, which are the
    JAX quant engine's (here for opt; yi's in ``test_torch_quant.py``); layer 0's codes and scales, whose rows every mesh
    computes alike, are the 1x1 run's bit for bit (the ACT rows quantized
    against each whole row's scale, ``encode_act``), and the deeper layers'
    differ only where the row-parallel sums round otherwise,
  * the CPU lane on 1x2 through the engine and the server, spilled: tokens
    equal JAX's ``exact_reference_generate`` (opt; yi's equal the 1x1 lane's,
    held to JAX's in ``test_torch_host_attn.py``),
  * opt on 1x3 (8 heads over 3: every position runs all heads, no ``wo``
    sum) and minitron on 1x4 (2 KV heads replicated over 4 positions, each
    attending over its one head): tokens equal JAX's oracle,
  * the teacher-forced logits of yi (bfloat16) and opt (float16) on 1x2
    against 1x1 sit as far apart as the reference's own 1x2 and 1x1 run on
    an Auto mesh (ROADMAP fault D: each ``wo``/``w2`` partial is rounded to
    the model dtype before the sum, in both packages)."""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import AxisType, Mesh as JMesh

from repro.configs import get_config as j_get_config
from repro.core import costmodel as j_cm
from repro.core.quant import QuantConfig as JQuant
from repro.models import model as JM
from repro.serving import HybridServeEngine as JEngine
from repro.serving import exact_reference_generate as j_reference
from repro.serving.util import trace_ctx as j_trace_ctx
from repro.sharding import make_shard_plan as j_make_shard_plan
from repro_torch import params as P
from repro_torch.configs import get_config
from repro_torch.configs.offload import _tight
from repro_torch.core import costmodel as cm
from repro_torch.core.quant import QuantConfig
from repro_torch.data.pipeline import open_loop_trace
from repro_torch.launch.mesh import make_test_mesh
from repro_torch.models import model as M
from repro_torch.models import sharded as SHD
from repro_torch.models.quant_ops import quantize
from repro_torch.serving import ContinuousBatchingServer, HybridServeEngine
from repro_torch.sharding import collectives as C
from repro_torch.sharding import make_shard_plan

torch.set_num_threads(1)

# a 20 TFLOP/s spec with a 16 GB/s link splits each reduced prompt under
# quant (tests/test_torch_quant_offload.py), and 20 TFLOP/s alone in fp
Q_MIXED = dataclasses.replace(cm.H100_SXM, name="h100-20tflops-16GBps",
                              flops=2e13, host_link_bw=16e9)
MIXED = dataclasses.replace(cm.H100_SXM, name="h100-20tflops", flops=2e13)
CAPS = dict(kv_cap=128, act_cap=128)
SERVER = dict(slots=2, kv_cap=128, act_cap=128, chunk_steps=4)


def j_mesh(d, m):
    return JMesh(np.array(jax.devices()[:d * m]).reshape(d, m),
                 ("data", "model"), axis_types=(AxisType.Auto,) * 2)


def j_hw(hw):
    return j_cm.HardwareSpec(**dataclasses.asdict(hw))


@functools.lru_cache(maxsize=None)
def setup(name, dtype=None):
    """The reference's weights (seed 0) on both sides and the trace; with
    ``dtype``, the float32 weights cast to it, on both sides."""
    jcfg, cfg = j_get_config(name), get_config(name)
    if dtype is None:
        jp = JM.init_params(jcfg, jax.random.PRNGKey(0))
    else:
        jcfg = dataclasses.replace(jcfg, dtype=dtype)
        cfg = dataclasses.replace(cfg, dtype=dtype)
        jp = jax.tree.map(lambda a: a.astype(dtype), setup(name)[3])
    tp = P.from_numpy(jax.tree.map(np.asarray, jp), device="cpu")
    reqs, arrivals = open_loop_trace(cfg.vocab_size, 4, seed=11)
    return cfg, tp, jcfg, jp, reqs, arrivals


@functools.lru_cache(maxsize=None)
def oracle(name):
    _, _, jcfg, jp, reqs, _ = setup(name)
    return j_reference(jcfg, jp, reqs)


def plan_for(cfg, tp, shape):
    return make_shard_plan(cfg, make_test_mesh(*shape, device="cpu"), tp)


def assert_tokens(out, reqs, want):
    for r in reqs:
        np.testing.assert_array_equal(out[r.rid], want[r.rid])


def test_shared_act_scale_quantizes_as_the_whole_row():
    """Each position's slice quantized against the max of the slices'
    scales is the whole row's ``quantize``, codes and scales bit for bit,
    on 2, 3 and 4 positions (rows whose absmax lies in any slice, zero
    rows included); each slice's own scale is not."""
    rng = np.random.default_rng(0)
    cfg = get_config("opt-6.7b-reduced")
    for m in (2, 4):
        plan = make_shard_plan(cfg, make_test_mesh(1, m, device="cpu"))
        lay = SHD.Layout(plan, QuantConfig())
        row = SHD.rows_for(plan, 1)[0]
        x = torch.from_numpy(rng.standard_normal((3, 5, 256)).astype(
            np.float32)) * torch.tensor([1.0, 30.0, 0.0])[:, None, None]
        x[0, :, 7] = 40.0                    # the absmax in the first slice
        want_q, want_s = quantize(x)
        parts = [x[..., sl] for sl in lay.dsl]
        C.COUNTER.reset()
        got = SHD.encode_act(lay, row, parts)
        assert C.COUNTER.bytes["act_scale"] == 2 * (m - 1) * 3 * 5 * 2
        assert torch.equal(torch.cat([q for q, _ in got], -1), want_q)
        assert all(torch.equal(s, want_s) for _, s in got)
        own = [quantize(p)[0] for p in parts]
        assert not torch.equal(torch.cat(own, -1), want_q)


@pytest.mark.parametrize("name", ["opt-6.7b-reduced", "yi-6b-reduced"])
def test_int8_serves_under_a_plan(name):
    """The int8 cache on 1x2 and 2x2: the engine, the server and the spilled
    offload engine give the 1x1 int8 run's tokens, which equal the JAX
    quant engine's.  A group's caches after its prefill and decode: layer
    0's planes (codes, K/V scales, ACT scales) are the 1x1 run's bit for
    bit, every deeper code within one step of it and fewer than 1e-4 of
    them off.  The ACT gather moves int8 codes: a quarter of the float32
    run's bytes (half a 16-bit run's)."""
    cfg, tp, jcfg, jp, reqs, arrivals = setup(name)
    q = QuantConfig()
    one, _ = HybridServeEngine(cfg, tp, hw=Q_MIXED, quant=q, device="cpu",
                               **CAPS).generate(reqs)
    if name.startswith("opt"):   # yi's 1x1 run: tests/test_torch_quant.py
        j_out, _ = JEngine(jcfg, jp, hw=j_hw(Q_MIXED), quant=JQuant(),
                           **CAPS).generate(reqs)
        assert_tokens(one, reqs, j_out)
    with ContinuousBatchingServer(cfg, tp, quant=q, device="cpu",
                                  **SERVER) as srv:
        s_one, _ = srv.run(reqs, arrival_steps=arrivals)
    for shape in ((1, 2), (2, 2)):
        plan = plan_for(cfg, tp, shape)
        eng = HybridServeEngine(cfg, tp, hw=Q_MIXED, quant=q, plan=plan,
                                **CAPS)
        out, _ = eng.generate(reqs)
        assert_tokens(out, reqs, one)
        g = eng.plan_groups(reqs)[0]
        toks, kv_keep, pbs, sched, pb, ab = eng.group_schedule(g)
        sched_t = torch.from_numpy(np.ascontiguousarray(sched.T))
        C.COUNTER.reset()
        curs, cache = SHD.prefill(plan, eng.params, toks, eng.kv_cap,
                                  eng.act_cap, kv_keep, pbs, lay=eng._layout)
        SHD.decode_chunk(plan, eng.params, curs, cache, sched_t,
                         pages_bound=pb, act_pages_bound=ab,
                         any_act=sched.any(0), lay=eng._layout)
        q8 = C.COUNTER.read()
        lg, c1 = M.hybrid_prefill_batched(tp, cfg, torch.from_numpy(toks),
                                          eng.kv_cap, eng.act_cap, kv_keep,
                                          pbs, quant=q)
        M.hybrid_decode_loop(tp, cfg, lg[:, -1].argmax(-1).int(), c1,
                             sched_t, pages_bound=pb, act_pages_bound=ab,
                             quant=q, any_act=sched.any(0))
        for key in M.region_planes(c1) + ("act_pos", "kv_len", "act_len"):
            got = cache[key].full()
            if key in ("act_pos", "kv_len", "act_len"):
                assert torch.equal(got, c1[key]), key
                continue
            assert torch.equal(got[0], c1[key][0]), key
            off = (got.float() - c1[key].float()).abs()
            if c1[key].dtype == torch.int8:
                assert off.max() <= 1 and (off > 0).float().mean() < 1e-4, key
        assert q8["act_scale"] > 0
        C.COUNTER.reset()
        fp = SHD.Layout(plan)
        curs, cache = SHD.prefill(plan, eng.params, toks, eng.kv_cap,
                                  eng.act_cap, kv_keep, pbs, lay=fp)
        SHD.decode_chunk(plan, eng.params, curs, cache, sched_t,
                         pages_bound=pb, act_pages_bound=ab, lay=fp)
        assert 4 * q8["act"] == C.COUNTER.read()["act"]   # int8 vs float32
        with ContinuousBatchingServer(cfg, tp, quant=q, plan=plan,
                                      **SERVER) as srv:
            s_out, _ = srv.run(reqs, arrival_steps=arrivals)
            assert all(p.allocated == 0 for p in srv.blockman.pools.values())
        assert_tokens(s_out, reqs, s_one)
    plan = plan_for(cfg, tp, (1, 2))
    with HybridServeEngine(cfg, tp, hw=Q_MIXED, quant=q, plan=plan,
                           offload=True, budget=_tight(cfg), **CAPS) as eng:
        out, _ = eng.generate(reqs)
        assert sum(m.traffic["kv_load"] for m in eng.measured_steps) > 0
        assert eng.spill_kv_pool.allocated_blocks == 0
    assert_tokens(out, reqs, one)


@pytest.mark.parametrize("name", ["opt-6.7b-reduced", "yi-6b-reduced"])
def test_cpu_lane_under_a_plan(name):
    """The CPU lane on 1x2: every group spills under the tight budget and
    attends over its per-shard arenas in place (no KV upload, the CPU lane
    busy), through the engine and, over the chunk's per-position host
    mirrors, the server.  Tokens equal JAX's oracle (yi: the 1x1 lane's);
    the server counts the 1x1 host-attend server's calls and syncs."""
    cfg, tp, *_, reqs, arrivals = setup(name)
    if name.startswith("opt"):
        ref = oracle(name)
    else:                        # the 1x1 lane's: tests/test_torch_host_attn.py
        with HybridServeEngine(cfg, tp, hw=MIXED, offload=True,
                               host_attn=True, budget=_tight(cfg),
                               device="cpu", **CAPS) as eng:
            ref, _ = eng.generate(reqs)
    plan = plan_for(cfg, tp, (1, 2))
    with HybridServeEngine(cfg, tp, hw=MIXED, plan=plan, offload=True,
                           host_attn=True, budget=_tight(cfg), **CAPS) as eng:
        out, st = eng.generate(reqs)
        assert st.measured_cpu_busy > 0
        assert sum(m.traffic["kv_load"] for m in eng.measured_steps) == 0
        assert eng.spill_kv_pool.allocated_blocks == 0
        assert eng.executor.host_lane.fault_counters["sync_fallbacks"] == 0
    assert_tokens(out, reqs, ref)
    kw = dict(SERVER, offload=True, host_attn=True)
    with ContinuousBatchingServer(cfg, tp, device="cpu", **kw) as srv:
        _, st0 = srv.run(reqs, arrival_steps=arrivals)
    with ContinuousBatchingServer(cfg, tp, plan=plan, **kw) as srv:
        out, st = srv.run(reqs, arrival_steps=arrivals)
        assert sum(m.cpu_busy for m in srv.measured_steps) > 0
        assert all(p.allocated == 0 for p in srv.blockman.pools.values())
    assert_tokens(out, reqs, ref)
    assert (st.device_calls, st.host_syncs) == (st0.device_calls,
                                                st0.host_syncs)


@pytest.mark.parametrize("name,shape", [("opt-6.7b-reduced", (1, 3)),
                                        ("minitron-4b-reduced", (1, 4))],
                         ids=["opt-1x3", "minitron-1x4"])
def test_head_layouts_that_do_not_split(name, shape):
    """opt-reduced's 8 heads over 3 positions: nothing of the layer divides
    3, every position runs all heads and no ``wo`` sum is taken.
    minitron-reduced's 2 KV heads over 4 positions: the K/V cache is
    replicated, each position runs 2 query heads against the KV head they
    map to (positions 0, 1 -> head 0; 2, 3 -> head 1).  The engine's tokens
    equal JAX's oracle, and each position holds its specs' bytes."""
    cfg, tp, *_, reqs, _ = setup(name)
    plan = plan_for(cfg, tp, shape)
    lay = SHD.Layout(plan)
    if name.startswith("opt"):
        assert not lay.heads_split and lay.cfg_l.num_heads == 8
    else:
        assert lay.heads_split and lay.kv_slice and lay.kv0 == [0, 0, 1, 1]
        assert (lay.cfg_l.num_heads, lay.cfg_l.num_kv_heads) == (2, 1)
    C.COUNTER.reset()
    eng = HybridServeEngine(cfg, tp, hw=MIXED, plan=plan)
    out, _ = eng.generate(reqs)
    assert_tokens(out, reqs, oracle(name))
    assert ("wo" in C.COUNTER.bytes) == name.startswith("minitron")
    layers = eng.params["layers"]
    for leaf in (layers["attn"]["wq"], layers["attn"]["wk"],
                 layers["ffn"]["w1"]):
        sizes = {leaf.nbytes(p) for p in plan.mesh.positions}
        want = leaf.shards[0].numel() * leaf.shards[0].element_size()
        assert sizes == {want}


def _j_forced(jcfg, jp, shape, toks, kv_keep, last, sched, gold, caps):
    """The reference's teacher-forced hybrid logits on an Auto mesh: its
    batched prefill and decode step, each jitted under the plan's placement
    and cache constraints, as its engine dispatches them."""
    jplan = j_make_shard_plan(jcfg, j_mesh(*shape), jp)
    params = jplan.place_params(jp)

    def prefill(params, toks, kk, lp):
        lg, cache = JM.hybrid_prefill_batched(params, jcfg, {"tokens": toks},
                                              *caps, kk, lp)
        return lg[:, -1], jplan.constrain_cache(cache)

    def step(params, tok, cache, store):
        lg, cache = JM.hybrid_decode_step(params, jcfg, tok, cache, store)
        return lg[:, -1], jplan.constrain_cache(cache)

    with j_trace_ctx(jplan):
        lg, cache = jax.jit(prefill)(params, toks, kv_keep, last)
        out, step = [lg], jax.jit(step)
        for s in range(gold.shape[1] - 1):
            lg, cache = step(params, gold[:, s:s + 1], cache, sched[s])
            out.append(lg)
    return np.stack([np.asarray(x, np.float32) for x in out], 1)


@pytest.mark.parametrize("name,dtype", [("yi-6b-reduced", "bfloat16"),
                                        ("opt-6.7b-reduced", "float16")])
def test_sharded_logit_gap_is_the_references(name, dtype):
    """Fault D: the teacher-forced logits on 1x2 against 1x1, in the port
    and in the reference (an Auto mesh).  Each ``wo``/``w2`` partial is
    rounded to the model dtype before the row's sum in both, so the port's
    gap is the reference's (within a factor of 2) and its 1x2 logits sit
    within the dtype's logit limit (0.25 bfloat16, 0.1 float16) of the
    reference's 1x2 logits."""
    cfg, tp, jcfg, jp, *_ = setup(name, dtype)
    rng = np.random.default_rng(3)
    B, S, n = 2, 48, 4
    toks = rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)
    gold = rng.integers(0, cfg.vocab_size, (B, n)).astype(np.int32)
    kv_keep, last = np.array([16, 0], np.int32), np.full(B, S, np.int32)
    sched = np.zeros((n, B), bool)
    sched[::2, 0] = sched[1::2, 1] = True
    caps = (64, 64)
    V = cfg.vocab_size
    port = {}
    for shape in ((1, 1), (1, 2)):
        plan = plan_for(cfg, tp, shape)
        port[shape] = SHD.forced_logits(
            plan, plan.place_params(tp), toks, *caps, kv_keep, last,
            torch.from_numpy(sched), torch.from_numpy(gold))[..., :V].numpy()
    ref = {shape: _j_forced(jcfg, jp, shape, toks, kv_keep, last, sched,
                            gold, caps)[..., :V]
           for shape in ((1, 1), (1, 2))}
    gap = np.abs(port[1, 2] - port[1, 1]).max()
    j_gap = np.abs(ref[1, 2] - ref[1, 1]).max()
    limit = 0.25 if dtype == "bfloat16" else 0.1
    assert 0 < gap <= 2 * j_gap
    assert np.abs(port[1, 2] - ref[1, 2]).max() <= limit
