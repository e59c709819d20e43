"""The port's continuous-batching server against ``repro.serving.scheduler``.

Both packages get the same numpy weights, the same open-loop trace and the
same hardware numbers (the port's ``TPU_V5E`` copy, the reference's
default), so they plan the same admissions and chunks.  At S in {1, 4, 8}
the port must give exactly the JAX server's tokens (and the oracle's) and
its ``ServeStats``; ``hybrid_decode_chunk`` is held to the JAX one step by
step, with idle and retired slots, and with a retired slot whose frozen
lengths exceed the next chunk's bounds."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as j_get_config
from repro.core import costmodel as j_cm
from repro.data.pipeline import open_loop_trace as j_open_loop_trace
from repro.models import model as JM
from repro.serving.scheduler import ContinuousBatchingServer as JServer
from repro_torch import params as P
from repro_torch.configs import get_config
from repro_torch.core import costmodel as cm
from repro_torch.data.pipeline import Request, _zipf, open_loop_trace
from repro_torch.models import model as M
from repro_torch.serving import (CapacityError, ContinuousBatchingServer,
                                 exact_reference_generate)
from repro_torch.serving.scheduler import ServeStats

torch.set_num_threads(1)

NAMES = ["opt-6.7b-reduced", "yi-6b-reduced"]
SEEDS = {"opt-6.7b-reduced": 0, "yi-6b-reduced": 1}
HW = cm.TPU_V5E
J_HW = j_cm.HardwareSpec(**dataclasses.asdict(HW))
CAPS = dict(slots=2, kv_cap=128, act_cap=128)
# hybrid_decode_step's logits against JAX's (tests/test_torch_model.py)
LOGIT_TOL, CACHE_TOL = 1e-4, 1e-5
_SETUPS = {}


def _setup(name):
    """Weights, trace, oracle and the JAX server's runs at S = 1, 4, 8 of
    ``name``, built once per module."""
    if name not in _SETUPS:
        jcfg = j_get_config(name)
        jp = JM.init_params(jcfg, jax.random.PRNGKey(SEEDS[name]))
        tp = P.from_numpy(jax.tree.map(np.asarray, jp), device="cpu")
        cfg = get_config(name)
        reqs, arrivals = open_loop_trace(cfg.vocab_size, 6, seed=17)
        ref = exact_reference_generate(cfg, tp, reqs, device="cpu")
        j_runs = {}
        for S in (1, 4, 8):
            jsrv = JServer(jcfg, jp, chunk_steps=S, hw=J_HW, **CAPS)
            j_runs[S] = (jsrv,) + jsrv.run(reqs, arrival_steps=arrivals)
        _SETUPS[name] = (cfg, tp, jcfg, jp, reqs, arrivals, ref, j_runs)
    return _SETUPS[name]


def _serve(cfg, tp, reqs, arrivals, S, **kw):
    srv = ContinuousBatchingServer(cfg, tp, chunk_steps=S, hw=HW,
                                   device="cpu", **dict(CAPS, **kw))
    out, stats = srv.run(reqs, arrival_steps=arrivals)
    return srv, out, stats


def test_trace_is_the_reference_trace():
    reqs, arr = open_loop_trace(50272, 6, seed=17)
    j_reqs, j_arr = j_open_loop_trace(50272, 6, seed=17)
    assert arr == j_arr
    for r, jr in zip(reqs, j_reqs):
        assert r.rid == jr.rid and r.max_new_tokens == jr.max_new_tokens
        np.testing.assert_array_equal(r.prompt, jr.prompt)


@pytest.mark.parametrize("S", [1, 4, 8])
@pytest.mark.parametrize("name", NAMES)
def test_tokens_and_stats_match_jax_server(name, S):
    cfg, tp, _, _, reqs, arrivals, ref, j_runs = _setup(name)
    jsrv, j_out, j_st = j_runs[S]
    srv, out, st = _serve(cfg, tp, reqs, arrivals, S)
    assert srv.act_frac == jsrv.act_frac
    for r in reqs:
        np.testing.assert_array_equal(out[r.rid], j_out[r.rid])
        np.testing.assert_array_equal(out[r.rid], ref[r.rid])
    for f in ("device_calls", "host_syncs", "admission_batches", "admitted",
              "chunks", "steps", "generated_tokens", "completed_at"):
        assert getattr(st, f) == getattr(j_st, f), f
    assert st.sim_time == pytest.approx(j_st.sim_time, rel=1e-9)
    for f in ("ttft", "tbt"):
        got, want = getattr(st, f), getattr(j_st, f)
        assert set(got) == set(want)
        for rid in want:
            assert got[rid] == pytest.approx(want[rid], rel=1e-9), (f, rid)
    # one call and one readback per admission batch and per chunk
    assert st.device_calls == st.admission_batches + st.chunks
    assert st.host_syncs == st.device_calls
    assert not any(s.active for s in srv.slots)
    assert all(p.allocated == 0 for p in srv.blockman.pools.values())
    assert not srv.blockman.tables


@pytest.mark.parametrize("name", NAMES)
def test_chunking_cuts_dispatches_per_token(name):
    """The reference's guard (tests/test_scheduler_chunk.py): S = 8 issues
    under half of S = 1's calls per generated token."""
    cfg, tp, _, _, reqs, arrivals, _, _ = _setup(name)
    s1 = _serve(cfg, tp, reqs, arrivals, 1)[2]
    s8 = _serve(cfg, tp, reqs, arrivals, 8)[2]
    assert s8.device_calls * 2 < s1.device_calls
    assert s8.dispatches_per_token < 0.5 * s1.dispatches_per_token
    assert s8.chunks <= int(np.ceil(s8.steps / 8)) + s8.admission_batches + 1


@pytest.mark.parametrize("name", NAMES)
def test_region_overflow_raises_and_server_stays_admissible(name):
    """A budget that would outgrow both regions raises a structured
    ``CapacityError`` before the call, releases the slot and its blocks,
    and the server then serves work that fits (as the JAX server does)."""
    cfg, tp, jcfg, jp, *_ = _setup(name)
    rng = np.random.default_rng(7)
    prompt = _zipf(rng, 1.2, cfg.vocab_size, 12).astype(np.int32)
    big, ok = (Request(rid=0, prompt=prompt, max_new_tokens=64),
               Request(rid=1, prompt=prompt, max_new_tokens=4))
    caps = dict(slots=1, kv_cap=32, act_cap=32, chunk_steps=4)
    srv = ContinuousBatchingServer(cfg, tp, hw=HW, device="cpu", **caps)
    jsrv = JServer(jcfg, jp, hw=J_HW, **caps)
    for s in (srv, jsrv):
        with pytest.raises(RuntimeError, match="region would overflow") as ei:
            s.run([big])
        assert ei.value.rids == [0] and ei.value.resource == "cache region"
    assert isinstance(ei.value, RuntimeError)
    assert not any(s.active for s in srv.slots)
    assert all(p.allocated == 0 for p in srv.blockman.pools.values())
    out, _ = srv.run([ok])
    j_out, _ = jsrv.run([ok])
    np.testing.assert_array_equal(out[1], j_out[1])
    assert len(out[1]) == 4


def test_refusals():
    cfg, tp, *_ = _setup("opt-6.7b-reduced")
    # the controller and the telemetry are ported: accepted, and snapshot()
    # answers with the drift summary even without a registry
    srv = ContinuousBatchingServer(cfg, tp, device="cpu", adaptive=True)
    assert srv.controller is not None and srv.controller.ctl.update_every == 4
    assert set(srv.snapshot()) == {"predictor_drift"}
    # under a plan the int8 cache is served (item 5.2.1); a format the
    # cache does not store is refused there as on one device
    from repro_torch.core.quant import QuantConfig
    from repro_torch.launch.mesh import make_test_mesh
    from repro_torch.sharding import make_shard_plan
    plan = make_shard_plan(cfg, make_test_mesh(1, 2, device="cpu"), tp)
    srv = ContinuousBatchingServer(cfg, tp, device="cpu", plan=plan,
                                   quant=QuantConfig())
    assert srv.cache["act"].dtype == torch.int8
    with pytest.raises(ValueError, match="int8 codes"):
        ContinuousBatchingServer(cfg, tp, device="cpu", plan=plan,
                                 quant=QuantConfig(kv_dtype="fp8"))
    with pytest.raises(ValueError, match="host_attn"):
        ContinuousBatchingServer(cfg, tp, device="cpu", host_attn=True)
    # the windowed and ssm families, as the reference's assert refuses them
    for other in ("gemma3-1b-reduced", "mamba2-2.7b-reduced"):
        with pytest.raises((ValueError, NotImplementedError)):
            ContinuousBatchingServer(get_config(other), None, device="cpu")
    assert ServeStats().dispatches_per_token == 0.0
    assert issubclass(CapacityError, RuntimeError)


# ------------------------------------------------------ hybrid_decode_chunk
KV_CAP = ACT_CAP = 64


def _prefilled(name, kv_keep, last_pos):
    """A 3-slot hybrid cache prefilled on both sides; -> port and JAX
    (first tokens, cache)."""
    cfg, tp, jcfg, jp, *_ = _setup(name)
    toks = np.random.default_rng(3).integers(
        0, cfg.vocab_size, (3, max(last_pos))).astype(np.int32)
    kv_keep, last_pos = (np.asarray(a, np.int32) for a in (kv_keep, last_pos))
    lg, cache = M.hybrid_prefill_batched(
        tp, cfg, torch.from_numpy(toks), KV_CAP, ACT_CAP,
        torch.from_numpy(kv_keep), torch.from_numpy(last_pos))
    jlg, jcache = JM.hybrid_prefill_batched(
        jp, jcfg, {"tokens": jnp.asarray(toks)}, KV_CAP, ACT_CAP,
        jnp.asarray(kv_keep), jnp.asarray(last_pos))
    cur = np.array(jnp.argmax(jlg[:, -1], -1), np.int32)
    return cur, cache, jcache


def _chunk_vs_jax(name, cache, jcache, cur, store, active, bounds):
    """Run the port's chunk (its per-step logits recorded) and the JAX
    chunk, plus JAX's steps one by one with the chunk's masking (the logits
    the chunk argmaxes); hold tokens, logits at active entries, and the
    final cache to JAX's.  -> the port's tokens, cur and cache."""
    cfg, tp, jcfg, jp, *_ = _setup(name)
    kv_b, act_b = bounds
    seen, real = [], M.hybrid_decode_step

    def recording(*a, **kw):
        lg, c = real(*a, **kw)
        seen.append(lg[:, -1])
        return lg, c

    M.hybrid_decode_step = recording
    try:
        toks, nxt, cache = M.hybrid_decode_chunk(
            tp, cfg, torch.from_numpy(cur), cache, torch.from_numpy(store),
            torch.from_numpy(active),
            pages_bound=(kv_b + act_b) // 16 if kv_b else None,
            act_pages_bound=act_b // 16 if act_b else None,
            any_act=(store & active).any(1))
    finally:
        M.hybrid_decode_step = real
    jb = dict(kv_bound=kv_b, act_bound=act_b) if kv_b else {}
    j_toks, j_nxt, j_cache = JM.hybrid_decode_chunk(
        jp, jcfg, jnp.asarray(cur), dict(jcache), jnp.asarray(store),
        jnp.asarray(active), **jb)
    np.testing.assert_array_equal(toks.numpy(), np.asarray(j_toks))
    np.testing.assert_array_equal(nxt.numpy(), np.asarray(j_nxt))
    step = jax.jit(lambda p, t, c, s: JM.hybrid_decode_step(p, jcfg, t, c, s,
                                                            **jb))
    c, tok = dict(jcache), jnp.asarray(cur)
    for s in range(store.shape[0]):
        a = jnp.asarray(active[s])
        jlg, c2 = step(jp, tok[:, None], c, jnp.asarray(store[s] & active[s]))
        c2["kv_len"] = jnp.where(a, c2["kv_len"], c["kv_len"])
        c2["act_len"] = jnp.where(a, c2["act_len"], c["act_len"])
        on = active[s]
        np.testing.assert_allclose(seen[s][on].numpy(),
                                   np.asarray(jlg[:, -1])[on], atol=LOGIT_TOL,
                                   err_msg=f"step {s}")
        tok = jnp.where(a, jnp.argmax(jlg[:, -1], -1).astype(jnp.int32), tok)
        c = c2
    return toks.numpy(), nxt.numpy(), cache, j_cache


@pytest.mark.parametrize("name", NAMES)
def test_decode_chunk_with_idle_and_retired_slots_matches_jax(name):
    """Slot 0 runs every step, slot 1 retires after two, slot 2 was never
    admitted (lengths 0).  Tokens and per-step logits equal JAX's, inactive
    entries are -1, and every cache tensor, frozen lengths included, is
    JAX's."""
    cur, cache, jcache = _prefilled(name, [16, 32, 0], [48, 40, 48])
    cache["kv_len"][2] = cache["act_len"][2] = 0
    jcache = dict(jcache, kv_len=jcache["kv_len"].at[2].set(0),
                  act_len=jcache["act_len"].at[2].set(0))
    S = 5
    active = np.zeros((S, 3), bool)
    active[:, 0], active[:2, 1] = True, True
    store = np.random.default_rng(4).random((S, 3)) < 0.5
    len0 = [t.clone() for t in (cache["kv_len"], cache["act_len"])]
    toks, nxt, cache, j_cache = _chunk_vs_jax(name, cache, jcache, cur, store,
                                              active, (0, 0))
    assert (toks[~active.T] == -1).all() and (toks[active.T] >= 0).all()
    assert nxt[2] == cur[2]
    st = store & active
    np.testing.assert_array_equal(cache["kv_len"].numpy(),
                                  len0[0].numpy() + (active & ~st).sum(0))
    np.testing.assert_array_equal(cache["act_len"].numpy(),
                                  len0[1].numpy() + st.sum(0))
    for key in ("k", "v", "act", "act_pos", "kv_len", "act_len"):
        np.testing.assert_allclose(cache[key].float().numpy(),
                                   np.asarray(j_cache[key], np.float32),
                                   atol=CACHE_TOL, err_msg=key)


@pytest.mark.parametrize("name", NAMES)
def test_retired_slot_past_the_chunk_bound(name):
    """A retired slot's device lengths stay frozen while the host mirror the
    server bounds a chunk by reads 0, so the bounds can sit below them:
    here slot 1 holds 48 KV + 48 ACT tokens and the chunk's bounds are 32 +
    32 tokens.  The slot's page tables (and RoPE's ACT page index) stay
    inside its own regions, the active slot's tokens and logits are JAX's
    under the same bounds, and the retired slot emits -1 with its lengths
    unchanged."""
    cfg = _setup(name)[0]
    cur, cache, jcache = _prefilled(name, [16, 48, 8], [32, 96, 8])
    assert cache["kv_len"].tolist() == [16, 48, 8]
    assert cache["act_len"].tolist() == [16, 48, 0]
    S, bounds = 4, (32, 32)
    active = np.zeros((S, 3), bool)
    active[:, 0] = True
    store = np.array([[True, False, False], [False] * 3] * 2)
    plan = M.hybrid_decode_begin(
        _setup(name)[1], cfg, torch.from_numpy(cur)[:, None], dict(
            cache, act_pos=cache["act_pos"].clone()),
        torch.from_numpy(store[0]), pages_bound=4, act_pages_bound=2)
    table, ptype, ntok = (t[1] for t in plan.tables)
    kv_pages, act_pages = KV_CAP // 16, plan.act_stride // 16
    assert ((table[ptype == 0] >= kv_pages)
            & (table[ptype == 0] < 2 * kv_pages)).all()
    assert ((table[ptype == 1] >= act_pages)
            & (table[ptype == 1] < 2 * act_pages)).all()
    if plan.act_kv is not None:
        idx = plan.act_kv.page_index.view(3, -1)[1]
        assert ((idx >= ACT_CAP // 16) & (idx < 2 * ACT_CAP // 16)).all()
    toks, _, cache, _ = _chunk_vs_jax(name, cache, jcache, cur, store, active,
                                      bounds)
    assert (toks[1] == -1).all() and (toks[0] >= 0).all()
    assert cache["kv_len"][1].item() == 48 and cache["act_len"][1].item() == 48
