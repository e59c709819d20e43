"""The port's pressure recovery (preempt, park, resume) against
``repro.serving`` on opt-6.7b-reduced: the cases of
``tests/test_recovery.py``, each served by both packages with the same
weights, requests and pool sizes.  Tokens must equal the JAX server's and
the never-preempted oracle's, ``RecoveryStats`` must equal JAX's field for
field, and every raise must leave the server admissible."""
import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_config as j_get_config
from repro.core import blocks as j_blocks
from repro.core import costmodel as j_cm
from repro.core.quant import QuantConfig as JQuant
from repro.models import model as JM
from repro.serving import RecoveryConfig as JRecoveryConfig
from repro.serving import recovery as j_recovery
from repro.serving.scheduler import ContinuousBatchingServer as JServer
from repro_torch import params as P
from repro_torch.configs import get_config
from repro_torch.core import costmodel as cm
from repro_torch.core.blocks import (BLOCK_TOKENS, BlockManager, BlockType,
                                     Location)
from repro_torch.core.quant import QuantConfig
from repro_torch.data.pipeline import Request, _zipf
from repro_torch.serving import (CapacityError, ContinuousBatchingServer,
                                 RecoveryConfig, exact_reference_generate)
from repro_torch.serving.recovery import (ParkedRequest, RecoveryStats,
                                          blocks_for_tokens, resume_cost)

torch.set_num_threads(1)

NAME = "opt-6.7b-reduced"
HW = cm.TPU_V5E
J_HW = j_cm.HardwareSpec(**dataclasses.asdict(HW))
SERVE = dict(slots=2, kv_cap=192, act_cap=192, chunk_steps=4)
KV_PRESSURE = dict(host_kv_blocks=3, dev_kv_blocks=0, host_act_blocks=64,
                   dev_act_blocks=8)
# case -> (requests, server knobs, arrival steps); the reference's cases
CASES = {
    "demote_to_act": ("long", KV_PRESSURE, None),
    "tokens_fallback": ("long", dict(KV_PRESSURE, recovery="no_act"), None),
    "joint_pressure": ("short", dict(host_kv_blocks=5, dev_kv_blocks=0,
                                     host_act_blocks=5, dev_act_blocks=0),
                       None),
    "arrival_churn": ("long", KV_PRESSURE, [0, 0, 30]),
    "clamping": ("short", dict(kv_cap=128, act_cap=16), None),
    # int8 splits a 64-token prompt 32 KV + 32 ACT (fp: 16 + 48), so its
    # KV pressure needs one more block to admit two requests
    "quant_demote": ("long", dict(KV_PRESSURE, host_kv_blocks=4, quant=True),
                     None),
}


@pytest.fixture(scope="module")
def setup():
    jcfg = j_get_config(NAME)
    jp = JM.init_params(jcfg, jax.random.PRNGKey(0))
    tp = P.from_numpy(jax.tree.map(np.asarray, jp), device="cpu")
    cfg = get_config(NAME)
    rng = np.random.default_rng(5)

    def mk(rid, plen, n):
        return Request(
            rid=rid,
            prompt=_zipf(rng, 1.2, cfg.vocab_size, plen).astype(np.int32),
            max_new_tokens=n)

    reqs = {"short": [mk(0, 16, 40), mk(1, 16, 40), mk(2, 16, 40)],
            "long": [mk(10, 64, 40), mk(11, 64, 40), mk(12, 64, 40)]}
    refs = {}
    for rs in reqs.values():
        refs.update(exact_reference_generate(cfg, tp, rs, device="cpu"))
    return cfg, tp, jcfg, jp, reqs, refs


def _knobs(kw, port: bool):
    kw = dict(SERVE, **kw)
    if kw.pop("recovery", None) == "no_act":
        kw["recovery"] = (RecoveryConfig if port else JRecoveryConfig)(
            prefer_act=False)
    if kw.pop("quant", False):
        kw["quant"] = QuantConfig() if port else JQuant()
    return kw


def _servers(setup, kw):
    cfg, tp, jcfg, jp, *_ = setup
    return (ContinuousBatchingServer(cfg, tp, hw=HW, device="cpu",
                                     **_knobs(kw, True)),
            JServer(jcfg, jp, hw=J_HW, **_knobs(kw, False)))


def _stats(srv) -> dict:
    return {f: getattr(srv.recovery_stats, f) for f in RecoveryStats._FIELDS}


def _leak_free(srv):
    assert not any(s.active for s in srv.slots)
    assert not srv.parked
    assert all(p.allocated == 0 for p in srv.blockman.pools.values())
    assert not srv.blockman.tables


@pytest.mark.parametrize("case", sorted(CASES))
def test_recovery_case_matches_jax(setup, case):
    which, kw, arrivals = CASES[case]
    reqs, refs = setup[4][which], setup[5]
    srv, jsrv = _servers(setup, kw)
    out, st = srv.run(reqs, arrival_steps=arrivals)
    j_out, j_st = jsrv.run(reqs, arrival_steps=arrivals)
    for r in reqs:
        np.testing.assert_array_equal(out[r.rid], j_out[r.rid])
        if "quant" not in kw:
            np.testing.assert_array_equal(out[r.rid], refs[r.rid])
    got, want = _stats(srv), _stats(jsrv)
    assert got.pop("resume_cost_s") == pytest.approx(
        want.pop("resume_cost_s"), rel=1e-9)
    assert got == want
    assert {(a.value, b.value): n for (a, b), n in
            srv.blockman.kind_transitions.items()} == \
        {(a.value, b.value): n for (a, b), n in
         jsrv.blockman.kind_transitions.items()}
    assert (st.device_calls, st.chunks, st.admission_batches, st.steps) == \
        (j_st.device_calls, j_st.chunks, j_st.admission_batches, j_st.steps)
    assert st.sim_time == pytest.approx(j_st.sim_time, rel=1e-9)
    rs = srv.recovery_stats
    if case == "clamping":
        assert rs.sched_clamps > 0
    else:
        assert rs.preemptions > 0 and rs.resumes == rs.preemptions
    if case in ("demote_to_act", "quant_demote"):
        assert rs.preempt_to_act == rs.preemptions and rs.demoted_blocks > 0
        assert srv.blockman.kind_transitions[
            (BlockType.KV, BlockType.ACT)] == rs.demoted_blocks
    if case in ("tokens_fallback", "joint_pressure"):
        assert rs.preempt_to_tokens == rs.preemptions
    _leak_free(srv)


def test_capacity_error_structured_and_server_stays_admissible(setup):
    """Genuine overcommit raises a ``CapacityError`` with the affected rids
    and a hint, as JAX's does, with every slot, table and parked holding
    released; the server then serves work that fits."""
    reqs = setup[4]["long"]
    kw = dict(KV_PRESSURE, host_kv_blocks=2)
    srv, jsrv = _servers(setup, kw)
    errs = []
    for s in (srv, jsrv):
        with pytest.raises(RuntimeError) as ei:
            s.run(reqs)
        errs.append(ei.value)
    err, j_err = errs
    assert isinstance(err, CapacityError)
    assert (err.rids, err.resource, err.hint) == \
        (j_err.rids, j_err.resource, j_err.hint)
    assert str(err.rids) in str(err) and err.hint in str(err)
    _leak_free(srv)
    ok = Request(rid=99, prompt=reqs[0].prompt[:16], max_new_tokens=4)
    out, _ = srv.run([ok])
    j_out, _ = jsrv.run([ok])
    np.testing.assert_array_equal(out[99], j_out[99])


def test_max_parked_zero_fails_loud(setup):
    """``RecoveryConfig(max_parked=0)``: the pressure the default absorbs
    raises instead, with no preemption, on both sides."""
    cfg, tp, jcfg, jp, reqs, _ = setup
    kw = dict(SERVE, **KV_PRESSURE)
    srv = ContinuousBatchingServer(cfg, tp, hw=HW, device="cpu",
                                   recovery=RecoveryConfig(max_parked=0), **kw)
    jsrv = JServer(jcfg, jp, hw=J_HW, recovery=JRecoveryConfig(max_parked=0),
                   **kw)
    for s in (srv, jsrv):
        with pytest.raises(RuntimeError):
            s.run(reqs["long"])
        assert s.recovery_stats.preemptions == 0
        assert all(p.allocated == 0 for p in s.blockman.pools.values())
    assert isinstance(srv, ContinuousBatchingServer)


def test_preempting_the_longest_slot_trims_the_chunk():
    """A victim preempted at a chunk boundary may be the slot whose
    remaining tokens set the chunk's length, leaving trailing steps where no
    slot is active.  The server drops them (the reference runs them, and its
    step simulation takes the mean context of no slot and raises): it
    serves the trace with tokens equal to the oracle's and leaks nothing."""
    from repro_torch.data.pipeline import open_loop_trace
    from repro_torch.models import model as M
    cfg = get_config("yi-6b-reduced")
    tp = M.init_params(cfg, seed=0, device="cpu")
    reqs, arrivals = open_loop_trace(cfg.vocab_size, 4, seed=17, prompt_lo=16,
                                     prompt_hi=80, max_new_choices=(6, 10),
                                     arrival_hi=8)
    srv = ContinuousBatchingServer(cfg, tp, hw=cm.H100_SXM, device="cpu",
                                   slots=2, kv_cap=128, act_cap=128,
                                   chunk_steps=4, host_kv_blocks=8,
                                   dev_kv_blocks=0)
    out, st = srv.run(reqs, arrival_steps=arrivals)
    refs = exact_reference_generate(cfg, tp, reqs, device="cpu")
    for r in reqs:
        np.testing.assert_array_equal(out[r.rid], refs[r.rid])
    rs = srv.recovery_stats
    assert rs.preemptions > 0 and rs.resumes == rs.preemptions
    assert st.generated_tokens == sum(r.max_new_tokens for r in reqs)
    _leak_free(srv)


@pytest.mark.parametrize("quant", [False, True], ids=["fp", "int8"])
def test_demote_request_kv_full_and_partial_matches_jax(quant):
    """Full demotion, then a partial one (one ACT slot left for a 2-block
    victim): the same counts, pools and ``kind_transitions`` as JAX's."""
    cfg, jcfg = get_config(NAME), j_get_config(NAME)
    q = dict(quant=QuantConfig()) if quant else {}
    jq = dict(quant=JQuant()) if quant else {}
    sizes = dict(host_kv_blocks=8, host_act_blocks=8, dev_kv_blocks=0,
                 dev_act_blocks=0)
    bms = (BlockManager(cfg, **sizes, **q),
           j_blocks.BlockManager(jcfg, **sizes, **jq))
    moves = []
    for bm, kinds in zip(bms, (BlockType, j_blocks.BlockType)):
        bm.new_request(0)
        for _ in range(3 * BLOCK_TOKENS):
            assert bm.append_token(0, kinds.KV) is not None
        moves.append(bm.demote_request_kv(0))
        bm.new_request(1)
        for _ in range(2 * BLOCK_TOKENS):
            bm.append_token(1, kinds.KV)
        for _ in range(4 * BLOCK_TOKENS):
            bm.append_token(1, kinds.ACT)          # ACT now 7 of 8
        moves.append(bm.demote_request_kv(1))
    assert moves[:2] == moves[2:] == [3, 1]
    bm, jbm = bms
    for rid in (0, 1):
        assert bm.counts(rid) == jbm.counts(rid)
        assert [(b.kind.value, b.location.value, b.pbn, b.ntokens, b.dtype,
                 b.scale_dtype) for b in bm.tables[rid]] == \
            [(b.kind.value, b.location.value, b.pbn, b.ntokens, b.dtype,
              b.scale_dtype) for b in jbm.tables[rid]]
    assert bm.kind_transitions[(BlockType.KV, BlockType.ACT)] == 4
    assert bm.free_blocks(BlockType.ACT) == \
        jbm.free_blocks(j_blocks.BlockType.ACT) == 0
    assert bm.free_blocks(BlockType.KV) == \
        jbm.free_blocks(j_blocks.BlockType.KV) == 7
    assert bm.pools[(BlockType.KV, Location.HOST)].allocated == 1
    for rid in (0, 1):
        bm.free_request(rid)
    assert all(p.allocated == 0 for p in bm.pools.values())


def test_recovery_helpers_match_jax():
    assert RecoveryStats._FIELDS == j_recovery.RecoveryStats._FIELDS
    assert RecoveryConfig() == RecoveryConfig(**dataclasses.asdict(
        JRecoveryConfig()))
    for t0, t1 in [(0, 0), (0, 1), (0, 16), (0, 17), (16, 17), (15, 16),
                   (5, 5), (3, 40)]:
        assert blocks_for_tokens(t0, t1) == j_recovery.blocks_for_tokens(t0, t1)
    r = Request(rid=0, prompt=np.arange(17, dtype=np.int32), max_new_tokens=8)
    pk = ParkedRequest(request=r, generated=[5, 6, 7])
    jpk = j_recovery.ParkedRequest(request=r, generated=[5, 6, 7])
    assert (pk.prefix_tokens, pk.remaining, pk.rid) == \
        (jpk.prefix_tokens, jpk.remaining, jpk.rid) == (35, 5, 0)
    cfg, jcfg = get_config(NAME), j_get_config(NAME)
    fits = cm.profile_cost_fns(cfg, HW)
    j_fits = j_cm.profile_cost_fns(jcfg, J_HW)
    for n in (0, 40, 300):
        for mode in ("act", "tokens"):
            assert resume_cost(cfg, HW, fits, n, mode) == \
                j_recovery.resume_cost(jcfg, J_HW, j_fits, n, mode)
        assert resume_cost(cfg, HW, None, n, "act") == \
            j_recovery.resume_cost(jcfg, J_HW, None, n, "act")
