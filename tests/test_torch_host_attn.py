"""The CPU attention lane of the port against the JAX package: the hybrid
kernel's ``return_lse`` mode (plain version), the partial merge, the host
flash attention and its worker's fault ladder, and the engine's
``host_attn=True`` tokens.

Everything runs in float32 on the CPU.  The Pallas kernel runs in interpret
mode at LayerNorm bias 0 (it drops the bias, ROADMAP queue 3, A).  1e-5
absolute covers two float32 softmax/dot orders at unit-scale inputs; ``l``,
a sum of up to ~50 terms of at most 1, is held to 1e-5 relative."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as j_get_config
from repro.configs import offload as j_offload
from repro.core import costmodel as j_cm
from repro.kernels.hybrid_attention.kernel import hybrid_paged_attention as j_hybrid
from repro.kernels.hybrid_attention.ref import hybrid_paged_attention_ref as j_hybrid_ref
from repro.models import model as JM
from repro.offload import HostAttnExecutor as JHostAttnExecutor
from repro.offload import host_flash_attention as j_host_flash
from repro.offload import merge_partials as j_merge
from repro.offload.faults import FaultPlan as JFaultPlan
from repro.serving import HybridServeEngine as JEngine
from repro_torch import params as P
from repro_torch.configs import get_config
from repro_torch.configs.offload import _tight
from repro_torch.core import costmodel as cm
from repro_torch.data.pipeline import request_trace
from repro_torch.kernels.hybrid_attention.ops import (
    hybrid_paged_attention, hybrid_paged_attention_two_pool)
from repro_torch.models import model as M
from repro_torch.offload import (FaultPlan, HostAttnExecutor,
                                 host_flash_attention, merge_partials_torch)
from repro_torch.offload.host_attn import NEG_INF
from repro_torch.serving import HybridServeEngine

torch.set_num_threads(1)
TOL = 1e-5
t = torch.from_numpy
# a spec with 20 TFLOP/s of compute splits each reduced prompt about half
# and half, so host-attended groups also hold ACT pages
MIXED = dataclasses.replace(cm.H100_SXM, name="h100-20tflops", flops=2e13)
J_MIXED = j_cm.HardwareSpec(**dataclasses.asdict(MIXED))
CAPS = dict(kv_cap=128, act_cap=128)

TABLES = {  # (page_table, page_type, page_ntok), B = 2
    "mixed": ([[0, 1, 0, 2, 3], [2, 1, 0, 0, 0]],
              [[0, 1, 0, 1, 0], [0, 0, 1, 2, 2]],
              [[16, 16, 16, 16, 9], [16, 16, 5, 0, 0]]),
    "act_only": ([[0, 1, 2], [2, 0, 0]], [[1, 1, 1], [1, 1, 2]],
                 [[16, 16, 3], [16, 11, 0]]),
    "empty_pages": ([[0, 0, 1, 0, 2], [0, 1, 0, 3, 0]],
                    [[2, 0, 2, 1, 1], [1, 2, 2, 0, 2]],
                    [[0, 16, 0, 16, 4], [13, 0, 0, 8, 0]]),
}


def _inputs(seed, kvh=2, g=3, d_model=64, D=32, B=2):
    rng = np.random.default_rng(seed)
    r = lambda *shape, s=1.0, o=0.0: (rng.standard_normal(shape) * s + o
                                      ).astype(np.float32)
    return dict(q=r(B, kvh, g, D), ks=r(4, 16, kvh, D, s=0.3),
                vs=r(4, 16, kvh, D, s=0.3), ap=r(3, 16, d_model, s=0.5, o=0.2),
                sc=r(d_model, s=0.1, o=1.0), bi=np.zeros(d_model, np.float32),
                wk=r(d_model, kvh, D, s=0.1), wv=r(d_model, kvh, D, s=0.1))


def _recomputed(x):
    """K/V of the ACT pages, LayerNorm then projection, in float32 (what the
    JAX ref computes for type-1 entries)."""
    a = x["ap"]
    mu = a.mean(-1, keepdims=True)
    var = ((a - mu) ** 2).mean(-1, keepdims=True)
    a = (a - mu) / np.sqrt(var + 1e-5) * x["sc"]
    return (np.einsum("ptd,dhe->pthe", a, x["wk"]).astype(np.float32),
            np.einsum("ptd,dhe->pthe", a, x["wv"]).astype(np.float32))


@pytest.mark.parametrize("table", sorted(TABLES))
def test_return_lse_fused_matches_jax_ref_and_pallas(table):
    x = _inputs(2)
    tabs = [np.asarray(a, np.int32) for a in TABLES[table]]
    launches = hybrid_paged_attention.lse_launches
    got = hybrid_paged_attention(
        *[t(x[k]) for k in ("q", "ks", "vs", "ap", "sc", "bi", "wk", "wv")],
        *map(t, tabs), return_lse=True)
    assert hybrid_paged_attention.lse_launches == launches   # plain version
    args = [jnp.asarray(x[k]) for k in ("q", "ks", "vs", "ap", "sc", "wk",
                                        "wv")] + [jnp.asarray(a) for a in tabs]
    for want in (j_hybrid_ref(*args, return_lse=True),
                 j_hybrid(*args, interpret=True, return_lse=True)):
        np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]),
                                   atol=TOL)
        np.testing.assert_allclose(got[1].numpy(), np.asarray(want[1]),
                                   atol=TOL)
        np.testing.assert_allclose(got[2].numpy(), np.asarray(want[2]),
                                   rtol=TOL)
    assert got[1].dtype == got[2].dtype == torch.float32
    assert got[1].shape == got[2].shape == (2, 2, 3, 1)


@pytest.mark.parametrize("table", sorted(TABLES))
def test_return_lse_two_pool_matches_jax_ref(table):
    """Second-pool mode with its type-1 pools holding the ACT pages' K/V
    recomputed in float32: the same attention as the JAX ref's."""
    x = _inputs(3)
    tabs = [np.asarray(a, np.int32) for a in TABLES[table]]
    ak, av = _recomputed(x)
    got = hybrid_paged_attention_two_pool(
        t(x["q"]), t(x["ks"]), t(x["vs"]), t(ak), t(av), *map(t, tabs),
        return_lse=True)
    want = j_hybrid_ref(*[jnp.asarray(x[k]) for k in ("q", "ks", "vs", "ap",
                                                      "sc", "wk", "wv")],
                        *[jnp.asarray(a) for a in tabs], return_lse=True)
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]), atol=TOL)
    np.testing.assert_allclose(got[1].numpy(), np.asarray(want[1]), atol=TOL)
    np.testing.assert_allclose(got[2].numpy(), np.asarray(want[2]), rtol=TOL)


def test_return_lse_empty_partition():
    """A request that attends over no token: o = 0, m = -1e30, l = 0, in
    both modes and for a table with no entry at all."""
    x = _inputs(4)
    pt = np.zeros((2, 3), np.int32)
    pty = np.array([[0, 1, 2], [2, 2, 2]], np.int32)
    pn = np.array([[16, 5, 0], [0, 0, 0]], np.int32)
    fused = lambda *tabs: hybrid_paged_attention(
        *[t(x[k]) for k in ("q", "ks", "vs", "ap", "sc", "bi", "wk", "wv")],
        *tabs, return_lse=True)
    two_pool = lambda *tabs: hybrid_paged_attention_two_pool(
        t(x["q"]), t(x["ks"]), t(x["vs"]), t(x["ks"]), t(x["vs"]), *tabs,
        return_lse=True)
    for run in (fused, two_pool):
        o, m, l = run(t(pt), t(pty), t(pn))
        assert not o[1].any() and (m[1] == NEG_INF).all() and not l[1].any()
        assert (l[0] >= 1).all()                     # the max term is exp(0)
        no_entry = torch.zeros((2, 0), dtype=torch.int32)
        o, m, l = run(no_entry, no_entry, no_entry)
        assert not o.any() and (m == NEG_INF).all() and not l.any()


def test_merge_partials_and_host_flash_attention_match_reference():
    rng = np.random.default_rng(5)
    B, KVH, G, D, cap = 4, 2, 3, 32, 50
    q = rng.standard_normal((B, KVH, G, D)).astype(np.float32)
    hk = rng.standard_normal((B, cap, KVH, D)).astype(np.float32)
    hv = rng.standard_normal((B, cap, KVH, D)).astype(np.float32)
    kv_len = np.array([50, 17, 1, 0])
    for chunk in (4, 256):
        want = j_host_flash(q, hk, hv, kv_len, chunk=chunk)
        for planes in ((hk, hv), (t(hk), t(hv))):     # numpy or the arena's
            got = host_flash_attention(q, *planes, kv_len, chunk=chunk)
            for a, b in zip(got[:3], want[:3]):
                np.testing.assert_array_equal(a, b)
            assert got[3] == want[3]
    o_a, m_a, l_a = host_flash_attention(q, hk, hv, kv_len)[:3]
    o_b, m_b, l_b = host_flash_attention(q, hk[:, 25:], hv[:, 25:],
                                         np.maximum(kv_len - 25, 0))[:3]
    want = j_merge(o_a, m_a, l_a, o_b, m_b, l_b)
    got = merge_partials_torch(*map(t, (o_a, m_a, l_a, o_b, m_b, l_b)))
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.numpy(), b, rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("mode", ["fused", "two_pool"])
def test_device_partial_merged_with_host_partial_is_one_pool(mode):
    """The executor's split: the host attends over the KV region's rows
    [0, kv_len); the device over [the new token's own row as a one-token KV
    page, valid only when KV-bound ; the ACT pages, the new checkpoint
    included when ACT-bound].  Merged, they equal the one-pool attention
    over the region with the new row appended."""
    rng = np.random.default_rng(6)
    B, KVH, G, D, d, cap = 3, 2, 2, 32, 64, 48
    r = lambda *shape, s=1.0, o=0.0: t((rng.standard_normal(shape) * s + o
                                        ).astype(np.float32))
    q = r(B, KVH, G, D)
    kc, vc = r(B, cap, KVH, D, s=0.5), r(B, cap, KVH, D, s=0.5)
    k_new, v_new = r(B, KVH, D, s=0.5), r(B, KVH, D, s=0.5)
    ac = r(B, cap, d, s=0.5, o=0.2)
    sc, bi = r(d, s=0.1, o=1.0), r(d, s=0.3)
    wk, wv = r(d, KVH, D, s=0.1), r(d, KVH, D, s=0.1)
    kv_len = torch.tensor([20, 0, 33], dtype=torch.int32)
    act_len = torch.tensor([17, 40, 0], dtype=torch.int32)
    store = torch.tensor([True, False, False])
    act_read = act_len + store.int()

    if mode == "fused":
        attend = lambda kp, vp, tabs, **kw: hybrid_paged_attention(
            q, kp, vp, ac.view(-1, 16, d), sc, bi, wk, wv, *tabs, **kw)
    else:     # the second pools hold the ACT region's K/V, as kv_gen makes them
        a = torch.nn.functional.layer_norm(ac, (d,), sc, bi, 1e-5)
        ak = torch.einsum("bsd,dhe->bshe", a, wk).reshape(-1, 16, KVH, D)
        av = torch.einsum("bsd,dhe->bshe", a, wv).reshape(-1, 16, KVH, D)
        attend = lambda kp, vp, tabs, **kw: hybrid_paged_attention_two_pool(
            q, kp, vp, ak, av, *tabs, **kw)

    one = kc.clone(), vc.clone()
    ar = torch.arange(B)
    for pool, new in zip(one, (k_new, v_new)):
        pool[ar, kv_len.long()] = torch.where(store[:, None, None],
                                              pool[ar, kv_len.long()], new)
    tabs = M.hybrid_page_table(kv_len + (~store).int(), act_read, cap, cap,
                               2 * cap // 16)
    want = attend(one[0].view(-1, 16, KVH, D), one[1].view(-1, 16, KVH, D),
                  tabs)

    own = torch.zeros((B, 16, KVH, D)), torch.zeros((B, 16, KVH, D))
    own[0][:, 0], own[1][:, 0] = k_new, v_new
    tabs = M.hybrid_page_table((~store).int(), act_read, 16, cap,
                               1 + cap // 16)
    o_d, m_d, l_d = attend(*own, tabs, return_lse=True)
    o_h, m_h, l_h = host_flash_attention(q.numpy(), kc, vc, kv_len.numpy())[:3]
    got, _, _ = merge_partials_torch(o_d, m_d, l_d, t(o_h), t(m_h), t(l_h))
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=TOL)


def _setup(name, seed):
    jcfg = j_get_config(name)
    jp = JM.init_params(jcfg, jax.random.PRNGKey(seed))
    tp = P.from_numpy(jax.tree.map(np.asarray, jp), device="cpu")
    reqs = request_trace(1024, n_requests=3, prompt_mean=40, gen_tokens=6,
                         seed=7)
    return get_config(name), tp, jcfg, jp, reqs


@pytest.mark.parametrize("name,seed", [("opt-6.7b-reduced", 0),
                                       ("yi-6b-reduced", 1)])
def test_engine_host_attn_tokens_match_jax_host_attn(name, seed):
    """Spilled groups attend over the arena on the CPU lane: the tokens are
    the JAX ``host_attn=True`` engine's and the device-resident engine's, and
    no spilled KV rides the link back up."""
    cfg, tp, jcfg, jp, reqs = _setup(name, seed)
    with JEngine(jcfg, jp, hw=J_MIXED, offload=True, host_attn=True,
                 budget=j_offload._tight(jcfg), **CAPS) as j_eng:
        j_out, j_stats = j_eng.generate(reqs)
    ref, _ = HybridServeEngine(cfg, tp, hw=MIXED, device="cpu",
                               **CAPS).generate(reqs)
    with HybridServeEngine(cfg, tp, hw=MIXED, device="cpu", offload=True,
                           host_attn=True, budget=_tight(cfg), **CAPS) as eng:
        out, stats = eng.generate(reqs)
    for r in reqs:
        np.testing.assert_array_equal(out[r.rid], j_out[r.rid])
        np.testing.assert_array_equal(out[r.rid], ref[r.rid])
    assert stats.device_calls == j_stats.device_calls
    assert sum(m.traffic["kv_load"] for m in eng.measured_steps) == 0
    assert stats.measured_cpu_busy > 0
    assert stats.sim_time == pytest.approx(j_stats.sim_time, rel=1e-12)
    assert eng.spill_kv_pool.allocated_blocks == 0
    assert all(p.allocated == 0 for p in eng.blockman.pools.values())


def _tiny_job():
    rng = np.random.default_rng(0)
    r = lambda *shape: rng.standard_normal(shape).astype(np.float32)
    return r(1, 1, 2, 8), r(1, 16, 1, 8), r(1, 16, 1, 8), np.array([5])


@pytest.mark.parametrize("case", ["retry", "give_up", "watchdog"])
def test_host_lane_fault_ladder_matches_jax(case):
    """The same plan drives both lanes to the same counters, and every
    path returns the exact partial."""
    kw, lane_kw = {
        "retry": (dict(copy_fail_p=1.0, max_events=1), {}),
        "give_up": (dict(copy_fail_p=1.0, max_events=None), {}),
        "watchdog": (dict(stall_p=1.0, stall_s=0.4, max_events=1),
                     dict(watchdog_s=0.02)),
    }[case]
    job = _tiny_job()
    want = host_flash_attention(*job)[:3]
    counters = []
    for lane_cls, plan_cls in ((HostAttnExecutor, FaultPlan),
                               (JHostAttnExecutor, JFaultPlan)):
        with lane_cls(faults=plan_cls(**kw), **lane_kw) as lane:
            for _ in range(2):
                for a, b in zip(lane.collect(lane.submit(*job)), want):
                    np.testing.assert_array_equal(a, b)
            counters.append((lane.fault_counters, lane.lane_health))
    assert counters[0] == counters[1]
