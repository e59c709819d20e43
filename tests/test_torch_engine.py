"""The port's serving engine against the JAX engine and the JAX oracle.

Both engines get the same weights and the same hardware numbers (the JAX
``HardwareSpec`` is built from the port's), so they plan the same groups and
splits; greedy tokens must then be EXACTLY equal."""
import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_config as j_get_config
from repro.core import costmodel as j_cm
from repro.models import model as JM
from repro.serving import HybridServeEngine as JEngine
from repro.serving import exact_reference_generate as j_reference
from repro_torch import params as P
from repro_torch.configs import get_config
from repro_torch.core import costmodel as cm
from repro_torch.data.pipeline import request_trace
from repro_torch.serving import (CapacityError, HybridServeEngine,
                                 exact_reference_generate)

torch.set_num_threads(1)

# at reduced widths the H100 spec keeps ~98% of the context as ACT; a spec
# with 20 TFLOP/s of compute splits each prompt about half and half, so the
# decode runs KV pages and ACT pages side by side
MIXED = dataclasses.replace(cm.H100_SXM, name="h100-20tflops", flops=2e13)
CASES = {"hybrid": ("hybrid", cm.H100_SXM), "kv": ("kv", cm.H100_SXM),
         "hybrid-mixed": ("hybrid", MIXED)}


@pytest.fixture(scope="module")
def setup():
    jcfg = j_get_config("opt-6.7b-reduced")
    jp = JM.init_params(jcfg, jax.random.PRNGKey(0))
    tp = P.from_numpy(jax.tree.map(np.asarray, jp), device="cpu")
    cfg = get_config("opt-6.7b-reduced")
    reqs = request_trace(1024, n_requests=3, prompt_mean=40, gen_tokens=6, seed=7)
    return cfg, tp, jcfg, jp, reqs, j_reference(jcfg, jp, reqs)


def test_oracle_matches_jax_oracle(setup):
    cfg, tp, _, _, reqs, j_ref = setup
    ref = exact_reference_generate(cfg, tp, reqs, device="cpu")
    for r in reqs:
        np.testing.assert_array_equal(ref[r.rid], j_ref[r.rid])


@pytest.mark.parametrize("case", sorted(CASES))
def test_engine_matches_jax_engine_and_oracle(setup, case):
    cfg, tp, jcfg, jp, reqs, j_ref = setup
    mode, hw = CASES[case]
    eng = HybridServeEngine(cfg, tp, mode=mode, hw=hw, device="cpu")
    j_eng = JEngine(jcfg, jp, mode=mode,
                    hw=j_cm.HardwareSpec(**dataclasses.asdict(hw)))
    assert eng.act_frac == j_eng.act_frac
    groups = eng.plan_groups(reqs)
    assert [[r.rid for r in g] for g in groups] == \
        [[r.rid for r in g] for g in j_eng.plan_groups(reqs)]
    out, stats = eng.generate(reqs)
    j_out, j_stats = j_eng.generate(reqs)
    for r in reqs:
        np.testing.assert_array_equal(out[r.rid], j_out[r.rid])
        np.testing.assert_array_equal(out[r.rid], j_ref[r.rid])
    assert stats.device_calls == j_stats.device_calls == 2 * len(groups)
    assert stats.generated_tokens == j_stats.generated_tokens
    assert stats.sim_time == pytest.approx(j_stats.sim_time, rel=1e-12)
    assert all(p.allocated == 0 for p in eng.blockman.pools.values())
    if case == "hybrid-mixed":       # both page types on the decode path
        _, kv_keep, pbs, *_ = eng.group_schedule(groups[0])
        assert ((kv_keep > 0) & (kv_keep < np.asarray(pbs))).any()


def test_engine_refuses_a_decode_that_outgrows_its_region(setup):
    """The JAX engine silently drops writes past a region's end; the port's
    engine raises before it runs the group, and leaks no blocks."""
    cfg, tp, *_ = setup
    reqs = request_trace(1024, n_requests=2, prompt_mean=40, gen_tokens=24,
                         seed=7)
    eng = HybridServeEngine(cfg, tp, mode="kv", kv_cap=64, act_cap=64,
                            device="cpu")
    with pytest.raises(CapacityError, match="KV"):
        eng.generate(reqs)
    assert all(p.allocated == 0 for p in eng.blockman.pools.values())
