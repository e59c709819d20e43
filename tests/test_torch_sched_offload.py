"""The continuous-batching server's offload paths against the port's
device-resident server and the JAX offload servers.

``offload=True`` decodes through ``OffloadExecutor.decode_chunk`` (weights
streamed per layer, one prefetch window over the chunk); ``host_attn=True``
also attends over a per-chunk host mirror of the KV region on the cpu lane.
Tokens must equal the device-resident server's and the JAX server's of the
same mode (``tests/test_offload.py::test_offload_scheduler_exact``,
``tests/test_host_attn.py::test_scheduler_host_attn_token_exact_opt``), fp
and int8.  On the CPU every copy is synchronous."""
import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_config as j_get_config
from repro.core import costmodel as j_cm
from repro.core.quant import QuantConfig as JQuant
from repro.models import model as JM
from repro.serving.scheduler import ContinuousBatchingServer as JServer
from repro_torch import params as P
from repro_torch.configs import get_config
from repro_torch.core import costmodel as cm
from repro_torch.core.quant import QuantConfig
from repro_torch.data.pipeline import request_trace
from repro_torch.serving import ContinuousBatchingServer

torch.set_num_threads(1)

HW = cm.TPU_V5E
J_HW = j_cm.HardwareSpec(**dataclasses.asdict(HW))
CAPS = dict(slots=2, kv_cap=128, act_cap=128)
_SETUPS = {}


def _setup(name, seed, n, prompt_mean, gen):
    if name not in _SETUPS:
        jcfg = j_get_config(name)
        jp = JM.init_params(jcfg, jax.random.PRNGKey(seed))
        tp = P.from_numpy(jax.tree.map(np.asarray, jp), device="cpu")
        reqs = request_trace(jcfg.vocab_size, n, prompt_mean=prompt_mean,
                             gen_tokens=gen, seed=3 if seed == 0 else 7)
        _SETUPS[name] = (get_config(name), tp, jcfg, jp, reqs)
    return _SETUPS[name]


def _opt():
    return _setup("opt-6.7b-reduced", 0, 4, 40, 8)


def _yi():
    return _setup("yi-6b-reduced", 1, 3, 30, 6)


def _pair(setup, S, quant=False, **kw):
    """The port's and the JAX server's runs of ``setup`` -> (port server,
    tokens, stats, JAX server, tokens, stats)."""
    cfg, tp, jcfg, jp, reqs = setup
    q = dict(quant=QuantConfig()) if quant else {}
    jq = dict(quant=JQuant()) if quant else {}
    with ContinuousBatchingServer(cfg, tp, chunk_steps=S, hw=HW, device="cpu",
                                  **CAPS, **q, **kw) as srv:
        out, st = srv.run(list(reqs))
    with JServer(jcfg, jp, chunk_steps=S, hw=J_HW, **CAPS, **jq,
                 **kw) as jsrv:
        j_out, j_st = jsrv.run(list(reqs))
    return srv, out, st, jsrv, j_out, j_st


def _resident(setup, S, quant=False):
    cfg, tp, _, _, reqs = setup
    q = dict(quant=QuantConfig()) if quant else {}
    srv = ContinuousBatchingServer(cfg, tp, chunk_steps=S, hw=HW,
                                   device="cpu", **CAPS, **q)
    return srv.run(list(reqs))[0]


@pytest.mark.parametrize("S", [1, 4])
@pytest.mark.parametrize("model", ["opt", "yi"])
def test_offload_server_tokens_match_resident_and_jax(model, S):
    setup = _opt() if model == "opt" else _yi()
    cfg, *_, reqs = setup
    srv, out, st, jsrv, j_out, j_st = _pair(setup, S, offload=True)
    ref = _resident(setup, S)
    for r in reqs:
        np.testing.assert_array_equal(out[r.rid], ref[r.rid])
        np.testing.assert_array_equal(out[r.rid], j_out[r.rid])
    assert (st.chunks, st.steps, st.admission_batches, st.generated_tokens) \
        == (j_st.chunks, j_st.steps, j_st.admission_batches,
            j_st.generated_tokens)
    # the executor issues the reference's stages: a begin and an end stage
    # per step and one per layer, so device_calls (admissions + stages)
    # equal JAX's
    assert st.device_calls == j_st.device_calls
    assert st.device_calls == st.admission_batches + st.steps * (
        cfg.num_layers + 2)
    # blocking syncs differ by design: the reference blocks after every
    # layer and reads each step's token (L + 1 a step); the port issues the
    # chunk's layers without a wait and reads back once per chunk
    assert j_st.host_syncs == st.admission_batches + st.steps * (
        cfg.num_layers + 1)
    assert st.host_syncs == st.admission_batches + st.chunks
    meas = srv.measured_steps
    assert len(meas) == st.steps and all(m.gpu_busy > 0 for m in meas)
    assert st.measured_time == pytest.approx(sum(m.total for m in meas))
    st_ = srv.executor.streamer
    assert st_.uploads == cfg.num_layers * st.steps
    assert all(p.allocated == 0 for p in srv.blockman.pools.values())


@pytest.mark.parametrize("quant", [False, True], ids=["fp", "int8"])
def test_host_attn_server_tokens_match_jax(quant):
    """The cpu lane over the chunk's host mirror, fp and int8, at S = 3
    (chunks cross slot retirements): tokens equal the JAX host-attend
    server's and the port's device-resident server's.  Per layer both
    executors issue three stages (projections, device partial, merge); the
    reference blocks four times a layer (query, partial, merge, the new
    row), the port once (the query), plus the chunk's mirror pull and its
    readback."""
    setup = _opt()
    cfg, *_, reqs = setup
    L = cfg.num_layers
    srv, out, st, jsrv, j_out, j_st = _pair(setup, 3, quant, offload=True,
                                            host_attn=True)
    ref = _resident(setup, 3, quant)
    for r in reqs:
        np.testing.assert_array_equal(out[r.rid], j_out[r.rid])
        np.testing.assert_array_equal(out[r.rid], ref[r.rid])
    assert st.device_calls == j_st.device_calls == \
        st.admission_batches + st.steps * (3 * L + 2)
    assert j_st.host_syncs == st.admission_batches + st.chunks + st.steps * (
        4 * L + 1)
    assert st.host_syncs == st.admission_batches + 2 * st.chunks \
        + st.steps * L
    assert sum(m.cpu_busy for m in srv.measured_steps) > 0
    assert srv.executor.host_lane.fault_counters["sync_fallbacks"] == 0
    assert all(p.allocated == 0 for p in srv.blockman.pools.values())


def test_host_attn_server_yi_matches_jax():
    """RoPE + GQA through the cpu lane (``kv_gen`` into the scratch pool,
    the second-pool ``return_lse`` partial), at S = 2."""
    setup = _yi()
    srv, out, st, jsrv, j_out, j_st = _pair(setup, 2, offload=True,
                                            host_attn=True)
    for r in setup[4]:
        np.testing.assert_array_equal(out[r.rid], j_out[r.rid])
    assert st.device_calls == j_st.device_calls


def test_decode_chunk_matches_the_model_chunk():
    """``OffloadExecutor.decode_chunk``, S streamed iterations over the slot
    cache with a slot retiring mid-chunk and an idle one, gives
    ``M.hybrid_decode_chunk``'s tokens, next tokens and cache, issuing a
    begin, an end and a stage per layer each step and one readback."""
    from repro_torch.models import model as M
    from repro_torch.offload import OffloadExecutor
    cfg, tp, *_ = _opt()
    toks = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab_size, (3, 32)).astype(np.int32))
    kv_keep, last = (torch.tensor(v, dtype=torch.int32)
                     for v in ([16, 0, 32], [32, 24, 32]))

    def fresh():
        return M.hybrid_prefill_batched(tp, cfg, toks, 64, 64, kv_keep, last)

    S = 4
    store = torch.from_numpy(np.random.default_rng(1).random((S, 3)) < 0.5)
    active = torch.tensor([[True, True, False]] * 2 + [[True, False, False]] * 2)
    bounds = dict(kv_bound=64, act_bound=48)
    lg, cache = fresh()
    cur = lg[:, -1].argmax(-1).int()
    want, w_cur, c_want = M.hybrid_decode_chunk(
        tp, cfg, cur, cache, store, active, pages_bound=4 + 3,
        act_pages_bound=3, any_act=(store & active).any(1).numpy())
    _, cache = fresh()
    with OffloadExecutor(cfg, tp, device="cpu") as ex:
        got, g_cur, c_got = ex.decode_chunk(cur.numpy(), cache, store.numpy(),
                                            active.numpy(), **bounds)
        assert ex.dispatches == S * (cfg.num_layers + 2)
        assert ex.blocking_syncs == 1
    np.testing.assert_array_equal(got, want.numpy())
    np.testing.assert_array_equal(g_cur, w_cur.numpy())
    assert (got[2] == -1).all() and (got[1, 2:] == -1).all()
    for key in ("k", "v", "act", "act_pos", "kv_len", "act_len"):
        torch.testing.assert_close(c_got[key], c_want[key], rtol=0, atol=0)
