"""The offload runtime over the int8 cache against the device-resident quant
engine and the JAX offload runtime.

The spill arena holds the int8 codes and float16 scales themselves, so a
spilled region round-trips losslessly: the spilled run's tokens, with or
without the CPU attention lane, EQUAL the device-resident quant engine's and
the JAX offload quant engine's (same numpy weights, same hardware numbers).
The link moves the quantized bytes (the reference's test_quant.py recipe)."""
import dataclasses
import functools

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_config as j_get_config
from repro.configs import offload as j_offload
from repro.core import costmodel as j_cm
from repro.core.quant import QuantConfig as JQuant
from repro.models import model as JM
from repro.serving import HybridServeEngine as JEngine
from repro_torch import params as P
from repro_torch.configs import get_config
from repro_torch.configs.offload import _tight
from repro_torch.core import costmodel as cm
from repro_torch.core.quant import QuantConfig
from repro_torch.data.pipeline import request_trace
from repro_torch.serving import HybridServeEngine

torch.set_num_threads(1)
# a 20 TFLOP/s spec with a 16 GB/s link splits each reduced prompt under
# quant and sends decode tokens to the ACT region
Q_MIXED = dataclasses.replace(cm.H100_SXM, name="h100-20tflops-16GBps",
                              flops=2e13, host_link_bw=16e9)
CAPS = dict(kv_cap=128, act_cap=128)


@functools.cache
def _setup(name):
    """The model's weights (the reference's, shared by both sides) and the
    trace, made once per model."""
    jcfg = j_get_config(name)
    jp = JM.init_params(jcfg, jax.random.PRNGKey(0))
    tp = P.from_numpy(jax.tree.map(np.asarray, jp), device="cpu")
    reqs = request_trace(1024, n_requests=3, prompt_mean=40, gen_tokens=6,
                         seed=7)
    return get_config(name), tp, jcfg, jp, reqs


@pytest.mark.parametrize("name", ["opt-6.7b-reduced", "yi-6b-reduced"])
def test_spilled_quant_tokens_match_device_and_jax(name):
    """Hybrid mode under the tight budget spills every group's int8 KV
    region: uploaded each step (kv_load > 0), or attended in place by the
    CPU lane (no kv_load, cpu busy).  Both give the device-resident quant
    tokens and the JAX offload quant engine's."""
    cfg, tp, jcfg, jp, reqs = _setup(name)
    q = QuantConfig()
    ref, _ = HybridServeEngine(cfg, tp, hw=Q_MIXED, quant=q, device="cpu",
                               **CAPS).generate(reqs)
    with JEngine(jcfg, jp, hw=j_cm.HardwareSpec(**dataclasses.asdict(Q_MIXED)),
                 offload=True, budget=j_offload._tight(jcfg), quant=JQuant(),
                 **CAPS) as j_eng:
        j_out, _ = j_eng.generate(reqs)
    for host_attn in (False, True):
        with HybridServeEngine(cfg, tp, hw=Q_MIXED, offload=True,
                               host_attn=host_attn, budget=_tight(cfg),
                               quant=q, device="cpu", **CAPS) as eng:
            out, stats = eng.generate(reqs)
        for r in reqs:
            np.testing.assert_array_equal(out[r.rid], ref[r.rid])
            np.testing.assert_array_equal(out[r.rid], j_out[r.rid])
        kv = sum(m.traffic["kv_load"] for m in eng.measured_steps)
        assert (kv == 0) == host_attn and (stats.measured_cpu_busy > 0) == host_attn
        assert eng.spill_kv_pool.allocated_blocks == 0
        eng.spill_kv_pool.check_invariants()
        assert all(p.allocated == 0 for p in eng.blockman.pools.values())


def test_spill_moves_quantized_bytes():
    """kv mode under the tight budget: the int8 arena is >= 1.8x smaller,
    and so are the KV bytes uploaded and stored back per run; the tokens
    equal the device-resident quant engine's."""
    cfg, tp, jcfg, jp, reqs = _setup("opt-6.7b-reduced")

    def run(quant):
        with HybridServeEngine(cfg, tp, mode="kv", offload=True,
                               budget=_tight(cfg), quant=quant, device="cpu",
                               **CAPS) as eng:
            out, _ = eng.generate(reqs)
        traffic = {k: sum(m.traffic[k] for m in eng.measured_steps)
                   for k in ("kv_load", "store")}
        return out, traffic, eng.spill_kv_pool.arena.numel()

    _, fp, fp_arena = run(None)
    out, q8, q8_arena = run(QuantConfig())
    assert q8["kv_load"] > 0 and q8["store"] > 0
    assert fp_arena / q8_arena >= 1.8
    assert fp["kv_load"] / q8["kv_load"] >= 1.8
    assert fp["store"] / q8["store"] >= 1.8
    dev, _ = HybridServeEngine(cfg, tp, mode="kv", quant=QuantConfig(),
                               device="cpu", **CAPS).generate(reqs)
    for r in reqs:
        np.testing.assert_array_equal(out[r.rid], dev[r.rid])
