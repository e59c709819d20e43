"""The engine's and the server's last constructor knobs, and the offload
microbenchmark.

- ``HybridServeEngine(generalized=)``: with the knob flipped from its
  default the allocation is the reference engine's (GQA, so the
  byte-ratio-aware balance moves it) and the tokens are the JAX engine's;
  the adaptive controller retargets with the same variant.
- ``ContinuousBatchingServer(generalized=, prefetch_depth=)``: the
  allocation follows ``generalized`` as the reference server's does, and
  under offload at ``prefetch_depth=2`` the executor streams two layers
  ahead and the tokens are the offline oracle's.
- ``weight_stream_microbench`` on the CPU: every key of the reference's
  result, positive times, and no overlap (the CPU's copies are
  synchronous)."""
import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_config as j_get_config
from repro.core import costmodel as j_cm
from repro.core import policy as j_policy
from repro.models import model as JM
from repro.serving import HybridServeEngine as JEngine
from repro_torch import params as P
from repro_torch.configs import get_config
from repro_torch.core import costmodel as cm
from repro_torch.data.pipeline import request_trace
from repro_torch.offload.microbench import bench_config, weight_stream_microbench
from repro_torch.serving import (ContinuousBatchingServer, HybridServeEngine,
                                 exact_reference_generate)

torch.set_num_threads(1)

# a spec whose compute splits yi-reduced's prompts between KV and ACT
MIXED = dataclasses.replace(cm.H100_SXM, name="h100-20tflops", flops=2e13)


def j_hw(hw):
    return j_cm.HardwareSpec(**dataclasses.asdict(hw))


@pytest.fixture(scope="module")
def yi():
    jcfg = j_get_config("yi-6b-reduced")
    jp = JM.init_params(jcfg, jax.random.PRNGKey(0))
    tp = P.from_numpy(jax.tree.map(np.asarray, jp), device="cpu")
    reqs = request_trace(1024, n_requests=3, prompt_mean=40, gen_tokens=5,
                         seed=7)
    return get_config("yi-6b-reduced"), tp, jcfg, jp, reqs


def test_engine_generalized_matches_the_jax_engine(yi):
    cfg, tp, jcfg, jp, reqs = yi
    plain = HybridServeEngine(cfg, tp, hw=MIXED, device="cpu")
    eng = HybridServeEngine(cfg, tp, hw=MIXED, generalized=True,
                            adaptive=True, device="cpu")
    j_eng = JEngine(jcfg, jp, hw=j_hw(MIXED), generalized=True)
    assert dataclasses.asdict(eng.alloc) == dataclasses.asdict(j_eng.alloc)
    assert eng.alloc != plain.alloc           # GQA: the variant moves it
    assert eng.controller.generalized and not plain.controller
    out, _ = eng.generate(reqs)
    j_out, _ = j_eng.generate(reqs)
    for r in reqs:
        np.testing.assert_array_equal(out[r.rid], j_out[r.rid])


@pytest.mark.parametrize("generalized", [True, False])
def test_server_knobs_reach_the_policy_and_the_executor(yi, generalized):
    cfg, tp, jcfg, _, reqs = yi
    srv = ContinuousBatchingServer(cfg, tp, slots=2, kv_cap=128, act_cap=128,
                                   chunk_steps=4, hw=MIXED,
                                   generalized=generalized, offload=True,
                                   prefetch_depth=2, adaptive=True,
                                   device="cpu")
    want = j_policy.host_block_allocation(
        jcfg, j_hw(MIXED), j_policy.device_act_blocks(jcfg, j_hw(MIXED)),
        generalized=generalized)
    assert dataclasses.asdict(srv.alloc) == dataclasses.asdict(want)
    assert srv.controller.generalized == generalized
    assert srv.executor.streamer.depth == 2
    if not generalized:
        return
    out, stats = srv.run(reqs)
    ref = exact_reference_generate(cfg, tp, reqs, device="cpu")
    for r in reqs:
        np.testing.assert_array_equal(out[r.rid], ref[r.rid])
    assert srv.executor.streamer.peak_resident == 3   # two ahead + the live


def test_microbench_on_the_cpu_reports_every_key_and_no_overlap():
    r = weight_stream_microbench(bench_config(num_layers=2), n_steps=2,
                                 reps=2, device="cpu")
    assert set(r) == {"stream_s", "compute_s", "overlap_s", "saving_s",
                      "overlap_efficiency", "weight_bytes_streamed",
                      "prefetch_depth"}
    assert min(r["stream_s"], r["compute_s"], r["overlap_s"]) > 0
    assert r["weight_bytes_streamed"] > 0 and r["prefetch_depth"] == 1.0
    # synchronous copies: the overlapped loop pays both lanes, so at most
    # noise of the shorter lane is "hidden"
    assert r["overlap_efficiency"] < 0.5
