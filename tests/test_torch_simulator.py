"""The generation simulator and the policy's last pieces equal the
reference's exactly.

``run_timeline``, ``simulate_step(s)`` with a ``StepConfig``,
``simulate_generation`` (the paper's Fig. 12-15 model: kv, act, hybrid,
token and nomb modes), ``request_block_split`` (Eq. 11) and
``policy_act_ratio`` are numpy on both sides: every float is compared for
equality, over every config in the registry, the port's hardware specs
(``H100_SXM`` included) and a seeded sweep of mini-batch specs."""
import dataclasses

import numpy as np
import pytest
import torch

from repro.configs import get_config as j_get_config
from repro.core import costmodel as j_cm
from repro.core import pipeline as j_pipe
from repro.core import policy as j_policy
from repro_torch.configs import REGISTRY, get_config
from repro_torch.core import costmodel as cm
from repro_torch.core import pipeline, policy

torch.set_num_threads(1)

HW = {"h100-sxm": cm.H100_SXM, "tpu-v5e": cm.TPU_V5E,
      "rtx4090-pcie4": cm.RTX4090}
MODES = ("kv", "act", "hybrid", "token", "nomb")
NAMES = sorted(REGISTRY)


def j_hw(hw):
    return j_cm.HardwareSpec(**dataclasses.asdict(hw))


def test_rtx4090_is_the_reference_spec():
    mine = dataclasses.asdict(cm.RTX4090)
    assert mine == {k: getattr(j_cm.RTX4090, k) for k in mine}


def _outcome(fn, *args, **kw):
    """fn's result, or the type of what it raised (the ssm family has no KV
    bytes to balance: both packages divide by zero)."""
    try:
        return fn(*args, **kw)
    except ArithmeticError as e:
        return type(e)


@pytest.mark.parametrize("hw", HW)
@pytest.mark.parametrize("name", NAMES)
def test_policy_act_ratio_and_block_split_equal_the_reference(name, hw):
    cfg, jcfg, h = get_config(name), j_get_config(name), HW[hw]
    for gen in (False, True):
        got = _outcome(policy.policy_act_ratio, cfg, h, generalized=gen)
        assert got == _outcome(j_policy.policy_act_ratio, jcfg, j_hw(h),
                               generalized=gen)
    assert policy.device_act_blocks(cfg, h, 0.5) == \
        j_policy.device_act_blocks(jcfg, j_hw(h), 0.5)
    if got is ZeroDivisionError:
        return
    alloc = policy.host_block_allocation(
        cfg, h, policy.device_act_blocks(cfg, h), generalized=True)
    jalloc = j_policy.HostAllocation(**dataclasses.asdict(alloc))
    for blocks in (0, 1, 7, 64, 1000):
        assert policy.request_block_split(alloc, blocks) == \
            j_policy.request_block_split(jalloc, blocks)
    empty = policy.HostAllocation(0, 0, 0, 0)
    assert policy.request_block_split(empty, 5) == (0, 5)


@pytest.mark.parametrize("name", NAMES)
def test_simulate_generation_equals_the_reference_in_every_mode(name):
    cfg, jcfg = get_config(name), j_get_config(name)
    # opt-6.7b on every spec at the default mini-batching; every config on
    # the H100 with two mini-batches of four and four decode steps
    runs = [(h, {}) for h in HW.values()] if name == "opt-6.7b" else \
        [(cm.H100_SXM, dict(minibatch_requests=4, gen=4))]
    for h, over in runs:
        for mode in MODES:
            kw = dict(dict(batch=8, prompt=512, gen=32, mode=mode,
                           act_ratio=0.4, recompute_ratio=0.25), **over)
            got = pipeline.simulate_generation(cfg, h, **kw)
            want = j_pipe.simulate_generation(jcfg, j_hw(h), **kw)
            assert dataclasses.asdict(got) == dataclasses.asdict(want), mode
    kw = dict(batch=8, prompt=128, gen=9, mode="hybrid", act_ratio=0.5,
              act_gpu_tokens=4096, minibatch_requests=3,
              weight_host_frac=0.25)
    assert dataclasses.asdict(pipeline.simulate_generation(
        cfg, cm.H100_SXM, **kw)) == dataclasses.asdict(
        j_pipe.simulate_generation(jcfg, j_hw(cm.H100_SXM), **kw))
    with pytest.raises(ValueError):
        pipeline.simulate_generation(cfg, cm.H100_SXM, batch=4, prompt=8,
                                     gen=2, mode="nope")


@pytest.mark.parametrize("seed", range(6))
def test_seeded_minibatch_sweep_equals_the_reference(seed):
    """Random mini-batch compositions (device ACT and KV, token
    recompute, host ACT and KV, the cpu lane) at a random StepConfig, each
    step through ``simulate_steps`` and ``simulate_step``."""
    rng = np.random.default_rng(seed)
    name = NAMES[seed % len(NAMES)]
    cfg, jcfg = get_config(name), j_get_config(name)
    h = list(HW.values())[seed % len(HW)]
    M = int(rng.integers(1, 4))
    fields = [f.name for f in dataclasses.fields(pipeline.MiniBatchSpec)]
    assert fields == [f.name for f in dataclasses.fields(j_pipe.MiniBatchSpec)]
    steps = [[pipeline.MiniBatchSpec(*(int(v) for v in
                                       rng.integers(0, 2000, len(fields))))
              for _ in range(M)] for _ in range(4)]
    jsteps = [[j_pipe.MiniBatchSpec(**dataclasses.asdict(m)) for m in st]
              for st in steps]
    sc = pipeline.StepConfig(weight_host_frac=float(rng.uniform(0, 1)),
                             prefetch_depth=int(rng.integers(0, 4)))
    jsc = j_pipe.StepConfig(**dataclasses.asdict(sc))
    got = pipeline.simulate_steps(cfg, h, steps, sc)
    want = j_pipe.simulate_steps(jcfg, j_hw(h), jsteps, jsc)
    assert [dataclasses.asdict(g) for g in got] == \
        [dataclasses.asdict(w) for w in want]
    assert dataclasses.asdict(pipeline.simulate_step(cfg, h, steps[0], sc)) \
        == dataclasses.asdict(j_pipe.simulate_step(jcfg, j_hw(h), jsteps[0],
                                                   jsc))
    assert pipeline.StepConfig() == pipeline.StepConfig(1.0, 2)


def test_run_timeline_equals_the_reference():
    rng = np.random.default_rng(3)
    lanes = ("pcie", "pcie_up", "gpu", "cpu")
    tasks = []
    for i in range(40):
        deps = tuple(int(d) for d in rng.integers(0, i, int(rng.integers(
            0, 3)))) if i else ()
        tasks.append(pipeline.LaneTask(lanes[int(rng.integers(4))],
                                       float(rng.uniform(0, 1)), deps,
                                       tag=("w", "kv", "gen", "")[i % 4]))
    got = pipeline.run_timeline(tasks)
    want = j_pipe.run_timeline([j_pipe.LaneTask(**dataclasses.asdict(t))
                                for t in tasks])
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert got.total > 0 and got.gpu_util <= 1
