"""The golden-trace recipe through the port's server, held to the stored
snapshot ``tests/golden/trace_golden.json`` (read, never written).

The recipe is the reference's (``tests/test_trace_golden.py``): one seeded
2-request serve of opt-6.7b-reduced through the pressure path (three host KV
blocks force preemptions) with a seeded copy-fail fault plan on the offload
lane, traced and metered.  The port must give the same STRUCTURE: each
request's event-name sequence, the server track's span sequence, the lane
fault-event vocabulary and the fault and recovery counters (timestamps are
wall clock and are not compared), with the oracle's tokens."""
import json
import pathlib

import jax
import numpy as np
import torch

from repro.configs import get_config as j_get_config
from repro.models import model as JM
from repro_torch import params as P
from repro_torch.configs import get_config
from repro_torch.core import costmodel as cm
from repro_torch.data.pipeline import Request, _zipf
from repro_torch.obs import (PID_SERVER, MetricsRegistry, Tracer,
                             assert_single_rooted, span_forest,
                             validate_chrome_trace)
from repro_torch.offload import FaultPlan
from repro_torch.serving import (ContinuousBatchingServer, RecoveryConfig,
                                 exact_reference_generate)

torch.set_num_threads(1)

GOLDEN = pathlib.Path(__file__).parent / "golden" / "trace_golden.json"


def _build() -> dict:
    name = "opt-6.7b-reduced"
    jp = JM.init_params(j_get_config(name), jax.random.PRNGKey(0))
    params = P.from_numpy(jax.tree.map(np.asarray, jp), device="cpu")
    cfg = get_config(name)
    rng = np.random.default_rng(5)
    reqs = [Request(rid=i, prompt=_zipf(rng, 1.2, cfg.vocab_size, 64)
                    .astype(np.int32), max_new_tokens=40) for i in range(2)]
    ref = exact_reference_generate(cfg, params, reqs, device="cpu")
    # deterministic copy failures only: no stalls, no watchdog
    plan = FaultPlan(9, copy_fail_p=0.4, max_events=2)
    tracer, reg = Tracer(), MetricsRegistry()
    # the reference server's default machine, in the port's copy
    with ContinuousBatchingServer(
            cfg, params, slots=2, kv_cap=192, act_cap=192, chunk_steps=4,
            hw=cm.TPU_V5E, offload=True, faults=plan,
            recovery=RecoveryConfig(prefer_act=True),
            host_kv_blocks=3, dev_kv_blocks=0, host_act_blocks=64,
            dev_act_blocks=8, tracer=tracer, metrics=reg,
            device="cpu") as srv:
        out, _ = srv.run(reqs)
        rs = srv.recovery_stats
        fc = dict(srv.executor.fault_counters)
    for r in reqs:
        np.testing.assert_array_equal(out[r.rid], ref[r.rid])
    assert rs.preemptions > 0, "recipe no longer forces preemption"
    assert plan.total_injected > 0, "fault plan no longer fires"
    data = tracer.to_chrome()
    validate_chrome_trace(data)
    for r in reqs:
        assert_single_rooted(data, r.rid, require=("complete",))
    forest = span_forest(data)
    server = [e["name"] for e in span_forest(data, pid=PID_SERVER).get(0, [])]
    lane_names = sorted({e["name"] for e in data["traceEvents"]
                         if e["ph"] == "i" and e.get("cat") == "fault"})
    return {
        "requests": {str(rid): [e["name"] for e in evs]
                     for rid, evs in sorted(forest.items())},
        "server_track": server,
        "lane_fault_events": lane_names,
        "fault_counters": fc,
        "recovery": {
            "preemptions": rs.preemptions,
            "preempt_to_act": rs.preempt_to_act,
            "preempt_to_tokens": rs.preempt_to_tokens,
            "resumes": rs.resumes,
        },
    }


def test_port_trace_matches_the_golden_snapshot():
    data = _build()
    stored = json.loads(GOLDEN.read_text())
    assert set(stored) == set(data)
    for key in ("requests", "server_track", "lane_fault_events",
                "fault_counters", "recovery"):
        assert data[key] == stored[key], key
