"""The port's telemetry (``repro_torch.obs``) and its hooks, against
``repro.obs`` and the JAX engine and server.

  * UNIT — the registry, its views, the drift monitor and the tracer give
    the reference's snapshots and events for the same calls;
  * TIMELINE — a lane span stamped with (stand-in) CUDA events reaches the
    tracer only when the timeline resolves it, in host seconds, inside its
    step; host-stamped spans and robustness events go at once;
  * INVARIANCE — tracing and metrics on change no token, ``device_calls``,
    ``host_syncs`` or ``admission_batches`` of the engine and the server,
    device-resident and offload, and the tokens are the JAX runs';
  * LIFECYCLE — a request's span tree stays single-rooted through preempt,
    park and resume;
  * SNAPSHOT and ADAPTIVE — ``snapshot()`` has the reference's keys, and
    adaptive runs (simulated timelines on both sides) give the JAX runs'
    tokens and ``frac_history``."""
import dataclasses
import json
import time

import jax
import numpy as np
import pytest
import torch

import repro.obs as jobs
from repro.configs import get_config as j_get_config
from repro.core import costmodel as j_cm
from repro.core.controller import ControllerConfig as JControllerConfig
from repro.models import model as JM
from repro.serving import HybridServeEngine as JEngine
from repro.serving.scheduler import ContinuousBatchingServer as JServer
import repro_torch.obs as obs
from repro_torch import params as P
from repro_torch.configs import get_config
from repro_torch.configs.offload import _tight
from repro_torch.core import ControllerConfig, costmodel as cm
from repro_torch.data.pipeline import Request, _zipf, open_loop_trace
from repro_torch.obs import (MetricsRegistry, Tracer, assert_single_rooted,
                             span_forest, validate_chrome_trace)
from repro_torch.obs.metrics import CounterDictView
from repro_torch.offload import MeasuredTimeline
from repro_torch.serving import (ContinuousBatchingServer, HybridServeEngine,
                                 RecoveryConfig, exact_reference_generate)

torch.set_num_threads(1)

NAME = "opt-6.7b-reduced"
HW = cm.TPU_V5E                      # the reference serving stack's default
J_HW = j_cm.HardwareSpec(**dataclasses.asdict(HW))
# 20 TFLOP/s splits the reduced prompts, so offload groups run both kinds
MIXED = dataclasses.replace(cm.H100_SXM, name="h100-20tflops", flops=2e13)
ENG = dict(mode="hybrid", max_minibatch=4, kv_cap=128, act_cap=128)
SRV = dict(slots=2, kv_cap=128, act_cap=128, chunk_steps=4)
CTL = dict(update_every=1, min_samples=1)


@pytest.fixture(scope="module")
def setup():
    """Weights, the reference's obs trace, the oracle, and the JAX adaptive
    traced engine (two ``generate`` calls) and server runs."""
    jcfg = j_get_config(NAME)
    jp = JM.init_params(jcfg, jax.random.PRNGKey(0))
    tp = P.from_numpy(jax.tree.map(np.asarray, jp), device="cpu")
    cfg = get_config(NAME)
    reqs, arrivals = open_loop_trace(cfg.vocab_size, 4, seed=11)
    ref = exact_reference_generate(cfg, tp, reqs, device="cpu")
    jeng = JEngine(jcfg, jp, hw=J_HW, adaptive=True,
                   ctl=JControllerConfig(**CTL), tracer=jobs.Tracer(),
                   metrics=jobs.MetricsRegistry(), **ENG)
    j_eng = [jeng.generate(reqs) for _ in range(2)]
    j_eng_run = (jeng, j_eng, jeng.snapshot())
    with JServer(jcfg, jp, hw=J_HW, adaptive=True,
                 ctl=JControllerConfig(**CTL), tracer=jobs.Tracer(),
                 metrics=jobs.MetricsRegistry(), **SRV) as jsrv:
        j_out, j_st = jsrv.run(reqs, arrival_steps=arrivals)
        j_srv_run = (jsrv, j_out, j_st, jsrv.snapshot())
    return cfg, tp, reqs, arrivals, ref, j_eng_run, j_srv_run


# ================================================================= unit
class _Res:
    def __init__(self, total, pcie, gpu, st=0.0, faulted=False):
        self.total, self.pcie_busy, self.gpu_busy = total, pcie, gpu
        self.cpu_busy = 0.25 * gpu
        self.tag_busy = {"st": st}
        self.traffic = {"weights": 100.0, "store": 7.0}
        self.events = {"watchdog": 1} if faulted else {}
        self.faulted = faulted


def _registry_script(o):
    """The same calls on one obs package -> everything they expose."""
    reg = o.MetricsRegistry()
    reg.counter("reqs").inc()
    reg.counter("reqs").inc(2)
    reg.counter("faults", kind="stall").inc()
    reg.counter("x", a="1", b="2").inc(0.5)
    reg.gauge("depth").set(3.5)
    for v in (1.0, 2.0, 3.0, 4.0, 0.5):
        reg.histogram("lat_s").observe(v)
    keys = ("copy_retries", "stalls_injected")
    d1 = o.CounterDictView(reg, "streamer_faults", labels={"shard": 0},
                           keys=keys)
    d1["copy_retries"] += 2
    d1["stalls_injected"] = 1
    d2 = o.CounterDictView(reg, "streamer_faults", labels={"shard": 0},
                           keys=keys)
    d2["copy_retries"] += 1

    class Stats(o.ScalarStatsView):
        _FIELDS = {"steps": 0, "time_s": 0.0}

        def __init__(self, registry=None):
            super().__init__(registry, prefix="t")

    free, bound = Stats(), Stats(reg)
    free.steps += 4
    bound.steps += 2
    bound.time_s += 0.5
    later = Stats(reg)
    later.steps += 1
    drift = o.DriftMonitor(min_samples=2, registry=reg)
    drift.observe_steps([_Res(2.0, 1.5, 0.5, st=0.25)] * 3,
                        [_Res(1.0, 1.0, 0.5, st=0.25)] * 3)
    same = _Res(1.0, 0.5, 0.4)
    drift.observe(same, same)
    drift.observe(_Res(1.0, 0.5, 0.4, faulted=True), same)
    o.register_busy_fraction_collector(reg)
    o.register_busy_fraction_collector(reg)
    o.fold_timeline_metrics(reg, [_Res(2.0, 1.0, 0.5, st=0.25),
                                  _Res(1.0, 0.5, 0.2, faulted=True)],
                            source="measured")
    o.fold_timeline_metrics(reg, [_Res(1.5, 1.0, 0.5)], source="sim")
    return (reg.snapshot(), dict(d1), dict(d2), len(d1), free.as_dict(),
            bound.as_dict(), later.as_dict(), isinstance(bound.steps, int),
            drift.summary(), drift.residuals("pcie"))


def test_registry_views_and_drift_match_reference():
    got, want = _registry_script(obs), _registry_script(jobs)
    assert got == want
    snap = got[0]
    assert snap["reqs"] == 3
    # two views over one counter family: the registry keeps the total, a
    # view reads from its own base (the first sees the second's increment)
    assert snap["streamer_faults{key=copy_retries,shard=0}"] == 3
    assert got[2] == {"copy_retries": 1, "stalls_injected": 0}
    assert got[6] == {"steps": 1, "time_s": 0.0} and got[7]
    assert "pcie" in got[8]["flagged"]


def _trace_script(o):
    clk = iter(range(1000))
    t = o.Tracer(clock=lambda: float(next(clk)))
    t.request_begin(7, prompt_tokens=8)
    t.request_begin(7)                              # idempotent re-open
    with t.server_span("admit", batch=1):
        with t.request_span(7, "prefill"):
            pass
    with t.server_span("chunk", steps=4, idx=0):
        with t.request_span(7, "decode", chunk=0, steps=4):
            pass
    t.request_event(7, "preempt", mode="act", generated=4)
    t.request_event(7, "park", depth=1)
    t.request_event(7, "resume", mode="act", generated=4)
    with t.request_span(7, "resume_prefill"):
        pass
    t.lane_span("pcie", "w", 0.5, 1.5, nbytes=64, shard=1)
    t.lane_span("gpu", "fwd", 1.0, 2.0)
    t.lane_event("watchdog_timeout")
    t.request_begin(8)
    t.request_end(8, "fail")
    t.request_end(7, "complete", tokens=4)
    t.request_end(99)                               # unknown rid: no-op
    return t.events(), t.to_chrome(), t.open_requests()


def test_tracer_events_match_reference(tmp_path):
    got, want = _trace_script(obs), _trace_script(jobs)
    assert got == want
    path = tmp_path / "t.json"
    clk = iter(range(100))
    t = Tracer(clock=lambda: float(next(clk)))
    t.request_begin(3)
    t.request_end(3)
    t.export(str(path))
    data = json.loads(path.read_text())
    assert validate_chrome_trace(data) == jobs.validate_chrome_trace(data)
    assert validate_chrome_trace(got[1]) == jobs.validate_chrome_trace(got[1])
    assert_single_rooted(got[1], 7, require=("prefill", "preempt", "park",
                                             "resume", "resume_prefill",
                                             "complete"))
    assert span_forest(got[1]) == jobs.span_forest(got[1])
    bad = {"traceEvents": [
        {"name": "a", "ph": "X", "ts": 0.0, "dur": 2.0, "pid": 1, "tid": 0},
        {"name": "b", "ph": "X", "ts": 1.0, "dur": 2.0, "pid": 1, "tid": 0}]}
    with pytest.raises(AssertionError, match="partially overlaps"):
        validate_chrome_trace(bad)


def test_null_tracer_records_nothing():
    t = obs.NULL_TRACER
    t.request_begin(0)
    with t.request_span(0, "decode"):
        with t.server_span("chunk"):
            pass
    t.lane_span("pcie", "w", 0.0, 1.0)
    t.lane_event("copy_retry")
    t.request_end(0, "complete")
    assert t.events() == [] and not t.enabled
    assert all(e["ph"] == "M" for e in t.to_chrome()["traceEvents"])


# ============================================================= timeline
class _Event:
    """A stand-in CUDA event: ``record`` stamps the device clock (ms),
    ``elapsed_time`` reads the difference, ``synchronize`` counts."""
    device_ms = 0.0
    syncs = 0

    def __init__(self, enable_timing=True):
        self.t = None

    def record(self, stream=None):
        self.t = _Event.device_ms

    def synchronize(self):
        _Event.syncs += 1

    def elapsed_time(self, other):
        return other.t - self.t


def _at(ms):
    _Event.device_ms = ms
    ev = _Event()
    ev.record()
    return ev


def test_timeline_spans_reach_the_tracer_when_resolved(monkeypatch):
    """Event-stamped spans are held until ``results`` resolves them, then
    reach the tracer once, in host seconds on the tracer's clock, inside
    their step; host-stamped spans and robustness events go at once."""
    monkeypatch.setattr(torch.cuda, "Event", _Event)
    tracer = Tracer()
    tl = MeasuredTimeline(tracer=tracer)
    tl.begin_step("decode", now=_at(0.0))
    tl.record("pcie", "w", _at(0.0), _at(2.0), nbytes=100)
    tl.record("gpu", "fwd", _at(1.0), _at(3.0))
    tl.record_event("copy_retry")
    tl.end_step(now=_at(4.0))
    lanes = lambda: [e for e in tracer.events() if e["ph"] == "X"]
    assert lanes() == []
    assert [e["name"] for e in tracer.events() if e["ph"] == "i"] == \
        ["copy_retry"]
    _Event.device_ms = 10.0                       # the anchor's stamp
    before = time.perf_counter()
    (res,) = tl.results()
    after = time.perf_counter()
    spans = {e["name"]: e for e in lanes()}
    assert set(spans) == {"w", "fwd"}
    assert res.total == pytest.approx(4e-3) and res.events == {"copy_retry": 1}
    # the anchor (device 10 ms) lands between before and after on the host
    start = spans["w"]["ts"]
    assert before - 10e-3 - 1e-9 <= start <= after - 10e-3 + 1e-9
    assert spans["w"]["dur"] == pytest.approx(2e-3)
    assert spans["w"]["args"]["nbytes"] == 100
    assert spans["fwd"]["ts"] == pytest.approx(start + 1e-3)
    for e in (spans["w"], spans["fwd"]):
        assert start - 1e-9 <= e["ts"] and \
            e["ts"] + e["dur"] <= start + res.total + 1e-9
    tl.results()                                  # no second emission
    assert len(lanes()) == 2
    tl.drain()
    validate_chrome_trace(tracer.to_chrome())
    # host-stamped spans (the CPU lane's worker; every span on the CPU) go
    # to the tracer as they are recorded
    host = MeasuredTimeline(tracer=tracer)
    h0 = time.perf_counter()
    host.record("cpu", "cpu", h0, h0 + 1e-3, nbytes=8)
    assert [e["name"] for e in lanes()] == ["w", "fwd", "cpu"]
    assert lanes()[-1]["ts"] == h0


def test_timeline_and_tracer_keep_every_span_across_threads():
    """The cpu lane's worker records spans while the compute thread does:
    with a tiny switch interval and more threads than cores, every span and
    event reaches the timeline's steps and the tracer (a lost append would
    drop one)."""
    import sys
    import threading
    tracer = Tracer()
    tl = MeasuredTimeline(tracer=tracer)
    tl.begin_step("decode")
    n_threads, n_spans = 16, 200

    def work(i):
        for j in range(n_spans):
            t = time.perf_counter()
            tl.record("cpu" if i % 2 else "gpu", "fwd", t, t + 1e-6)
            if j % 50 == 0:
                tl.record_event("copy_retry")

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=work, args=(i,))
                   for i in range(n_threads)]
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=60)
    finally:
        sys.setswitchinterval(old)
    assert not any(th.is_alive() for th in threads)
    (res,) = tl.drain()
    spans = [e for e in tracer.events() if e["ph"] == "X"]
    assert len(spans) == n_threads * n_spans
    assert res.events == {"copy_retry": n_threads * n_spans // 50}
    assert res.gpu_busy > 0 and res.cpu_busy > 0


# ============================================================ invariance
def _lane_names(tracer):
    return {e["name"] for e in tracer.events()
            if e["ph"] == "X" and e["cat"].startswith("lane:")}


def test_engine_trace_invariance_and_snapshot(setup):
    """Device-resident engine: tracing and metrics add no call; the tokens
    are the oracle's and the JAX engine's; ``snapshot()`` of an adaptive
    traced engine has the reference's keys after the same two calls, and
    its ``frac_history`` and fits are the reference's."""
    cfg, tp, reqs, _, ref, (jeng, j_runs, j_snap), _ = setup
    kw = dict(hw=HW, device="cpu", **ENG)
    out0, st0 = HybridServeEngine(cfg, tp, **kw).generate(reqs)
    tracer, reg = Tracer(), MetricsRegistry()
    eng1 = HybridServeEngine(cfg, tp, tracer=tracer, metrics=reg, **kw)
    out1, st1 = eng1.generate(reqs)
    assert st1.device_calls == st0.device_calls == 2 * len(
        eng1.plan_groups(reqs))
    for r in reqs:
        np.testing.assert_array_equal(out1[r.rid], out0[r.rid])
        np.testing.assert_array_equal(out1[r.rid], ref[r.rid])
        np.testing.assert_array_equal(out1[r.rid], j_runs[0][0][r.rid])
    data = tracer.to_chrome()
    validate_chrome_trace(data)
    for r in reqs:
        assert_single_rooted(data, r.rid, require=("admit", "complete"))
    assert eng1.drift.samples == 0            # device-resident: identity only
    assert reg.snapshot()["gen_device_calls"] == st1.device_calls
    # adaptive, traced and metered: the reference's run, call for call
    eng2 = HybridServeEngine(cfg, tp, adaptive=True,
                             ctl=ControllerConfig(**CTL), tracer=Tracer(),
                             metrics=MetricsRegistry(), **kw)
    for _ in range(2):
        out, st = eng2.generate(reqs)
        assert st.device_calls == st0.device_calls
        for r in reqs:
            np.testing.assert_array_equal(out[r.rid], ref[r.rid])
    ctl, jctl = eng2.controller, jeng.controller
    assert ctl.frac_history == jctl.frac_history
    assert (ctl.updates, ctl.migrated_blocks) == \
        (jctl.updates, jctl.migrated_blocks) and ctl.updates == 2
    assert (ctl.fit_gen.slope, ctl.fit_load.slope) == \
        (jctl.fit_gen.slope, jctl.fit_load.slope)
    assert eng2.act_frac == jeng.act_frac
    snap = eng2.snapshot()
    assert set(snap) == set(j_snap)
    assert set(snap["predictor_drift"]) == set(j_snap["predictor_drift"])
    assert all(p.allocated == 0 for p in eng2.blockman.pools.values())


def test_server_trace_invariance_and_snapshot(setup, tmp_path):
    """Device-resident server: tracing on vs off gives the same tokens,
    calls, syncs and admission batches (and the JAX server's tokens); the
    exported trace validates with single-rooted requests; an adaptive traced
    server has the reference's ``frac_history`` and snapshot keys."""
    cfg, tp, reqs, arrivals, ref, _, (jsrv, j_out, j_st, j_snap) = setup
    kw = dict(hw=HW, device="cpu", **SRV)
    with ContinuousBatchingServer(cfg, tp, **kw) as srv:
        out0, st0 = srv.run(reqs, arrival_steps=arrivals)
    tracer, reg = Tracer(), MetricsRegistry()
    with ContinuousBatchingServer(cfg, tp, tracer=tracer, metrics=reg,
                                  **kw) as srv:
        out1, st1 = srv.run(reqs, arrival_steps=arrivals)
        snap1 = srv.snapshot()
    for r in reqs:
        np.testing.assert_array_equal(out1[r.rid], out0[r.rid])
        np.testing.assert_array_equal(out1[r.rid], ref[r.rid])
        np.testing.assert_array_equal(out1[r.rid], j_out[r.rid])
    for f in ("device_calls", "host_syncs", "admission_batches", "chunks"):
        assert getattr(st1, f) == getattr(st0, f) == getattr(j_st, f), f
    assert st1.device_calls == st1.admission_batches + st1.chunks
    path = tmp_path / "server.json"
    tracer.export(str(path))
    data = json.loads(path.read_text())
    validate_chrome_trace(data)
    for r in reqs:
        assert_single_rooted(data, r.rid, require=("prefill", "complete"))
    assert snap1["ttft_s"]["count"] == snap1["tbt_s"]["count"] == len(reqs)
    assert any(k.startswith("lane_busy_frac") for k in snap1)
    assert snap1["recovery_preemptions"] == 0
    assert snap1["serve_chunks"] == st1.chunks
    with ContinuousBatchingServer(cfg, tp, adaptive=True,
                                  ctl=ControllerConfig(**CTL),
                                  tracer=Tracer(), metrics=MetricsRegistry(),
                                  **kw) as srv:
        out2, st2 = srv.run(reqs, arrival_steps=arrivals)
        snap2 = srv.snapshot()
        ctl = srv.controller
    for r in reqs:
        np.testing.assert_array_equal(out2[r.rid], ref[r.rid])
    assert (st2.device_calls, st2.host_syncs) == (st0.device_calls,
                                                   st0.host_syncs)
    jctl = jsrv.controller
    assert ctl.frac_history == jctl.frac_history
    assert (ctl.updates, ctl.migrated_blocks) == \
        (jctl.updates, jctl.migrated_blocks) and ctl.updates == st2.chunks
    assert set(snap2) == set(j_snap)


def test_offload_trace_invariance(setup):
    """Offload engine (spilled, cpu lane) and offload server (cpu lane):
    tracing and metrics change no token, stage count or blocking sync; the
    lane spans and the fault counters reach the trace and the registry; the
    server's per-chunk host-mirror pull is a lane span of its own inside
    its chunk."""
    cfg, tp, reqs, arrivals, ref, _, _ = setup
    kw = dict(hw=MIXED, device="cpu", offload=True, budget=_tight(cfg),
              host_attn=True, **ENG)
    runs = []
    for traced in (False, True):
        tracer = Tracer() if traced else None
        reg = MetricsRegistry() if traced else None
        with HybridServeEngine(cfg, tp, tracer=tracer, metrics=reg,
                               **kw) as eng:
            out, st = eng.generate(reqs)
            runs.append((out, st, eng.executor.blocking_syncs, tracer, reg,
                         eng))
    (out0, st0, b0, *_), (out1, st1, b1, tracer, reg, eng) = runs
    for r in reqs:
        np.testing.assert_array_equal(out1[r.rid], out0[r.rid])
        np.testing.assert_array_equal(out1[r.rid], ref[r.rid])
    assert (st1.device_calls, b1) == (st0.device_calls, b0)
    assert st1.measured_cpu_busy > 0
    assert {"w", "fwd", "cpu", "st"} <= _lane_names(tracer)
    assert isinstance(eng.executor.streamer.counters, CounterDictView)
    snap = eng.snapshot()
    assert snap["streamer_faults{key=copy_retries,shard=0}"] == 0
    assert snap["host_attn_faults{key=copy_retries}"] == 0
    assert snap["timeline_steps{source=measured}"] == st1.steps
    assert eng.drift.samples == st1.steps      # measured vs predicted pairs
    validate_chrome_trace(tracer.to_chrome())

    skw = dict(hw=MIXED, device="cpu", offload=True, host_attn=True, **SRV)
    sruns = []
    for traced in (False, True):
        tracer = Tracer() if traced else None
        with ContinuousBatchingServer(cfg, tp, tracer=tracer,
                                      metrics=MetricsRegistry()
                                      if traced else None, **skw) as srv:
            out, st = srv.run(reqs, arrival_steps=arrivals)
            sruns.append((out, st, tracer))
    (out0, st0, _), (out1, st1, tracer) = sruns
    for r in reqs:
        np.testing.assert_array_equal(out1[r.rid], out0[r.rid])
        np.testing.assert_array_equal(out1[r.rid], ref[r.rid])
    for f in ("device_calls", "host_syncs", "admission_batches", "chunks"):
        assert getattr(st1, f) == getattr(st0, f), f
    data = tracer.to_chrome()
    validate_chrome_trace(data)
    mirrors = [e for e in data["traceEvents"]
               if e["ph"] == "X" and e["name"] == "mirror"]
    chunks = [e for e in data["traceEvents"]
              if e["ph"] == "X" and e["name"] == "chunk"]
    assert len(mirrors) == len(chunks) == st1.chunks
    assert all(m["cat"] == "lane:pcie" and m["args"]["nbytes"] > 0
               for m in mirrors)
    for m, c in zip(mirrors, chunks):
        assert c["ts"] <= m["ts"] and \
            m["ts"] + m["dur"] <= c["ts"] + c["dur"] + 1e-3
    for r in reqs:
        assert_single_rooted(data, r.rid, require=("prefill", "complete"))


# ============================================================= lifecycle
def test_trace_survives_park_resume(setup):
    """Tight pools force preemption: each request's tree stays single-rooted
    with preempt -> park -> resume -> resume_prefill inside the root, the
    tokens are the oracle's, and the registry-backed ``RecoveryStats``
    surface in ``snapshot()``."""
    cfg, tp, *_ = setup
    rng = np.random.default_rng(5)
    reqs = [Request(rid=i, prompt=_zipf(rng, 1.2, cfg.vocab_size, 64)
                    .astype(np.int32), max_new_tokens=40) for i in range(3)]
    ref = exact_reference_generate(cfg, tp, reqs, device="cpu")
    tracer, reg = Tracer(), MetricsRegistry()
    with ContinuousBatchingServer(
            cfg, tp, slots=2, kv_cap=192, act_cap=192, chunk_steps=4, hw=HW,
            recovery=RecoveryConfig(prefer_act=True), host_kv_blocks=3,
            dev_kv_blocks=0, host_act_blocks=64, dev_act_blocks=8,
            tracer=tracer, metrics=reg, device="cpu") as srv:
        out, _ = srv.run(reqs)
        rs = srv.recovery_stats
        snap = srv.snapshot()
    assert rs.preemptions > 0 and rs.resumes > 0
    for r in reqs:
        np.testing.assert_array_equal(out[r.rid], ref[r.rid])
    data = tracer.to_chrome()
    validate_chrome_trace(data)
    preempted = 0
    for r in reqs:
        assert_single_rooted(data, r.rid, require=("complete",))
        names = [e["name"] for e in span_forest(data)[r.rid]]
        assert names.count("request") == 1
        if "preempt" in names:
            preempted += 1
            assert names.index("preempt") < names.index("park") < \
                names.index("resume") < names.index("resume_prefill")
    assert preempted > 0
    assert snap["recovery_preemptions"] == rs.preemptions
    assert snap["recovery_resumes"] == rs.resumes
    assert not tracer.open_requests()


# ============================================================== adaptive
def test_adaptive_offload_engine_refits_between_calls(setup):
    """The offload engine with the controller, on the CPU's measured
    timelines: the second ``generate`` runs on the refit split, the tokens
    stay the oracle's, the calls those of the engine without it, nothing
    leaks and no degraded step is fitted."""
    cfg, tp, reqs, _, ref, _, _ = setup
    kw = dict(hw=MIXED, device="cpu", offload=True, budget=_tight(cfg),
              **ENG)
    with HybridServeEngine(cfg, tp, **kw) as eng0:
        _, st0 = eng0.generate(reqs)
    with HybridServeEngine(cfg, tp, adaptive=True,
                           ctl=ControllerConfig(**CTL), **kw) as eng:
        host = lambda: sum(p.capacity for (_, loc), p in
                           eng.blockman.pools.items() if loc.value == "host")
        total = host()
        for _ in range(2):
            out, st = eng.generate(reqs)
            for r in reqs:
                np.testing.assert_array_equal(out[r.rid], ref[r.rid])
            assert st.device_calls == st0.device_calls
        ctl = eng.controller
        assert ctl.updates == 2 * len(eng.plan_groups(reqs))
        assert len(ctl.frac_history) == ctl.updates + 1
        assert ctl.faulted_skipped == 0
        assert eng.drift.samples == st.steps * 2
        assert all(p.allocated == 0 for p in eng.blockman.pools.values())
        assert host() == total             # retags conserve the host tier
