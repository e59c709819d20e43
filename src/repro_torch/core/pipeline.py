"""Two-lane asynchronous pipeline model (paper Fig. 8/9) + generation sim.

A copy of ``repro.core.pipeline``: the engine reports what each decode step
would cost on the target hardware (``simulate_steps``), the offload
runtime's measured timelines share ``TimelineResult``, and
``simulate_generation`` is the paper's Fig. 12-15 model.  The "cpu" lane
prices host attention over spilled KV (the CPU attention lane).

The machine is modelled as two serialised lanes with double-buffered
hand-offs, exactly the structure HybridServe's engine schedules:

  PCIe lane:  [w(l+1) prefetch][KV load mb0][ACT load mb0][KV load mb1]...[store]
  GPU  lane:              [KV-gen mb0][fwd mb0][KV-gen mb1][fwd mb1]...

Dependencies: fwd(l, m) needs w(l), KV(l, m), KV-gen(l, m); KV-gen(l, m)
needs ACT(l, m); w(l+1) may prefetch as soon as the lane is free and the
double buffer allows (w buffer of l-1 freed by fwd(l-1) completion).

This is the same information the paper's own policy reasons with (T_PCIe vs
T_Computation); the simulator additionally resolves per-task overlap so
imbalance (Fig. 9) shows up as lane idle time.  ``simulate_generation``
sweeps the paper's modes:

  kv      — FlexGen-style: full KV on host (weights partially resident)
  act     — Activation-cache-only (HybridServe-Act-Cache)
  hybrid  — KV-Activation hybrid with a given ACT:KV token split
  token   — token-ID recomputation (full-layer forward for the recompute set)
  nomb    — DeepSpeed-like: no mini-batching (single batch, capped by memory)
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import numpy as np

from repro_torch.configs.base import ModelConfig
from repro_torch.core import costmodel as cm
from repro_torch.core import quant as Q


@dataclass
class LaneTask:
    lane: str                 # "pcie" | "pcie_up" | "gpu" | "cpu"
    dur: float
    deps: Tuple[int, ...] = ()
    tag: str = ""


@dataclass
class TimelineResult:
    total: float
    pcie_busy: float
    gpu_busy: float
    traffic: Dict[str, float]           # bytes by category
    # host-compute attention lane busy seconds; 0.0 when no token is
    # host-attended
    cpu_busy: float = 0.0
    finish: List[float] = field(default_factory=list)
    # busy seconds by task tag ("w"/"kv"/"act"/"gen"/"fwd"/"st"/"cpu")
    tag_busy: Dict[str, float] = field(default_factory=dict)
    # robustness events observed during the step ("watchdog_timeout",
    # "copy_retry", "sync_fallback", "arena_denied", ...), counted by name;
    # simulated steps are fault-free ({})
    events: Dict[str, int] = field(default_factory=dict)

    @property
    def faulted(self) -> bool:
        return bool(self.events)

    @property
    def gpu_util(self) -> float:
        return self.gpu_busy / self.total if self.total > 0 else 0.0

    @property
    def pcie_util(self) -> float:
        return self.pcie_busy / self.total if self.total > 0 else 0.0


def run_timeline(tasks: List[LaneTask]) -> TimelineResult:
    """Serialise tasks per lane in list order, honouring cross-lane deps.

    Lanes: "pcie" (host->device, loads), "pcie_up" (device->host, stores —
    PCIe is full duplex so stores never block loads), "gpu" (compute) and
    "cpu" (host-compute attention over spilled KV — runs on host cores, so
    it overlaps every other lane).
    """
    lane_free = {"pcie": 0.0, "pcie_up": 0.0, "gpu": 0.0, "cpu": 0.0}
    busy = {"pcie": 0.0, "pcie_up": 0.0, "gpu": 0.0, "cpu": 0.0}
    tag_busy: Dict[str, float] = {}
    finish: List[float] = [0.0] * len(tasks)
    traffic: Dict[str, float] = {}
    for i, t in enumerate(tasks):
        ready = max([finish[d] for d in t.deps], default=0.0)
        start = max(lane_free[t.lane], ready)
        end = start + t.dur
        lane_free[t.lane] = end
        busy[t.lane] += t.dur
        if t.tag:
            tag_busy[t.tag] = tag_busy.get(t.tag, 0.0) + t.dur
        finish[i] = end
    total = max(lane_free.values())
    return TimelineResult(total=total, pcie_busy=busy["pcie"],
                          gpu_busy=busy["gpu"], cpu_busy=busy["cpu"],
                          traffic=traffic, finish=finish, tag_busy=tag_busy)


# =============================================================================
# one generation step
# =============================================================================

@dataclass(frozen=True)
class MiniBatchSpec:
    """Token-level composition of one mini-batch at the current step."""
    n_requests: int
    kv_host_tokens: int       # context tokens held as KV on host (per layer)
    act_host_tokens: int      # context tokens held as ACT on host
    act_dev_tokens: int       # context tokens held as ACT on device
    kv_dev_tokens: int = 0    # context tokens held as KV on device
    tok_recompute_tokens: int = 0   # context tokens held as raw token IDs
    ctx_tokens: int = 0       # total context per request (for attention cost)
    # context tokens whose KV stays on host and is ATTENDED there by the cpu
    # lane — no PCIe load, no GPU regen; the partial-softmax merge folds the
    # result into the device lane's output.
    cpu_host_tokens: int = 0


@dataclass(frozen=True)
class StepConfig:
    weight_host_frac: float = 1.0    # fraction of weights streamed from host
    prefetch_depth: int = 2          # double buffering


def _run_timeline_arrays(tasks: List[LaneTask], n: int):
    """``run_timeline`` with every task duration an (n,) array — the same
    per-lane serialisation and cross-lane dep resolution, computed for n
    independent timelines at once.  -> (total, busy by lane, finish by task,
    busy by tag), all (n,)."""
    lanes = ("pcie", "pcie_up", "gpu", "cpu")
    lane_free = {ln: np.zeros(n) for ln in lanes}
    busy = {ln: np.zeros(n) for ln in lanes}
    tag_busy: Dict[str, np.ndarray] = {}
    finish: List[np.ndarray] = [np.zeros(n)] * len(tasks)
    for i, t in enumerate(tasks):
        ready = np.zeros(n)
        for d in t.deps:
            ready = np.maximum(ready, finish[d])
        start = np.maximum(lane_free[t.lane], ready)
        end = start + t.dur
        lane_free[t.lane] = end
        busy[t.lane] = busy[t.lane] + t.dur
        if t.tag:
            tag_busy[t.tag] = tag_busy.get(t.tag, np.zeros(n)) + t.dur
        finish[i] = end
    total = np.zeros(n)
    for ln in lanes:
        total = np.maximum(total, lane_free[ln])
    return total, busy, finish, tag_busy


def simulate_step(cfg: ModelConfig, hw: cm.HardwareSpec,
                  minibatches: List[MiniBatchSpec],
                  step_cfg: StepConfig = StepConfig(),
                  quant=None) -> TimelineResult:
    """One token-generation iteration across all layers x mini-batches."""
    return simulate_steps(cfg, hw, [minibatches], step_cfg, quant=quant)[0]


def simulate_steps(cfg: ModelConfig, hw: cm.HardwareSpec,
                   steps: List[List[MiniBatchSpec]],
                   step_cfg: StepConfig = StepConfig(),
                   quant=None) -> List[TimelineResult]:
    """One token-generation iteration per entry of ``steps``, vectorized.

    All steps must share the same mini-batch count (the task graph is
    structural); per-task durations are carried as (n_steps,) arrays so the
    timeline recurrence runs once instead of once per generated token.  The
    engine calls this with the precomputed store_act schedule's per-step token
    totals.  ``step_cfg`` sets the share of each layer's weights streamed
    from the host and the prefetch depth; ``quant`` prices KV/ACT loads, the
    host lane and the new-token store at the quantized bytes per token.
    """
    n = len(steps)
    if n == 0:
        return []
    M = len(steps[0])
    assert all(len(s) == M for s in steps), "steps must share minibatch count"
    eff = hw.flops * hw.mfu
    L = cfg.num_layers
    w_bytes = cm.layer_weight_bytes(cfg) * step_cfg.weight_host_frac
    t_w = np.full((n,), w_bytes / hw.host_link_bw)
    kvB = Q.kv_bytes_per_token(cfg, quant)
    actB = Q.act_bytes_per_token(cfg, quant)

    # (n, M) per-step spec fields
    f = lambda attr: np.array([[getattr(mb, attr) for mb in s] for s in steps],
                              float)
    kv_host = f("kv_host_tokens")
    act_host = f("act_host_tokens")
    act_dev = f("act_dev_tokens")
    tok_rec = f("tok_recompute_tokens")
    n_req = f("n_requests")
    ctx = f("ctx_tokens")
    cpu_host = f("cpu_host_tokens")
    t_cpu_tok = cm.cpu_attend_seconds_per_token(cfg, hw, quant=quant)

    tasks: List[LaneTask] = []          # dur as (n,) arrays
    idx: Dict[Tuple, int] = {}

    def add(key, lane, dur, deps=(), tag=""):
        tasks.append(LaneTask(lane, dur, tuple(idx[d] for d in deps if d in idx),
                              tag))
        idx[key] = len(tasks) - 1
        return idx[key]

    traffic = {"weights": np.zeros(n), "kv_load": np.zeros(n),
               "act_load": np.zeros(n), "store": np.zeros(n)}

    # task emission order = schedule order: layer-major; within a layer all
    # loads queue before compute so mini-batch m+1's transfers overlap mini-
    # batch m's compute (double buffering); stores ride the full-duplex
    # upstream direction and never block loads.
    for l in range(L):
        # weight prefetch for layer l (double buffered against l-depth fwd)
        dep = [("fwd", l - step_cfg.prefetch_depth, M - 1)]
        add(("w", l), "pcie", t_w, deps=dep, tag="w")
        traffic["weights"] += w_bytes
        kv_bw = hw.host_link_bw * hw.gather_eff     # scattered page gathers
        for m in range(M):
            kv_bytes = kv_host[:, m] * kvB
            act_bytes = act_host[:, m] * actB
            add(("kv", l, m), "pcie", kv_bytes / kv_bw,
                deps=[("fwd", l - step_cfg.prefetch_depth, m)], tag="kv")
            add(("act", l, m), "pcie", act_bytes / kv_bw,
                deps=[("fwd", l - step_cfg.prefetch_depth, m)], tag="act")
            traffic["kv_load"] += kv_bytes
            traffic["act_load"] += act_bytes
        for m in range(M):
            # GPU: KV-gen for ACT tokens (Eq. 7) ... or full-layer forward for
            # token-ID recomputation
            act_tokens = act_host[:, m] + act_dev[:, m]
            t_gen = (act_tokens * cm.kv_gen_flops_per_token(cfg)
                     / (hw.flops * hw.gen_mfu))
            t_gen = t_gen + (tok_rec[:, m] * cm.forward_flops_per_token(
                cfg, tok_rec[:, m]) / eff)
            add(("gen", l, m), "gpu", t_gen, deps=[("act", l, m)], tag="gen")

            # CPU: host attention over spilled KV tokens.  Needs the previous
            # layer's output (the query), overlaps this layer's KV-gen and
            # loads; the fwd below consumes its partial via the LSE merge.
            # No PCIe bytes.
            add(("cpu", l, m), "cpu", cpu_host[:, m] * t_cpu_tok,
                deps=[("fwd", l - 1, m)], tag="cpu")

            # GPU: forward for the new token of every request in the mb
            fwd_flops = n_req[:, m] * cm.forward_flops_per_token(cfg, ctx[:, m])
            add(("fwd", l, m), "gpu", fwd_flops / eff,
                deps=[("w", l), ("kv", l, m), ("gen", l, m), ("cpu", l, m)],
                tag="fwd")

            # PCIe upstream: store the new token's KV/ACT back to host
            st_bytes = n_req[:, m] * max(kvB, actB)
            add(("st", l, m), "pcie_up", st_bytes / hw.host_link_bw,
                deps=[("fwd", l, m)], tag="st")
            traffic["store"] += st_bytes

    total, busy, finish, tag_busy = _run_timeline_arrays(tasks, n)
    return [
        TimelineResult(
            total=float(total[s]), pcie_busy=float(busy["pcie"][s]),
            gpu_busy=float(busy["gpu"][s]), cpu_busy=float(busy["cpu"][s]),
            traffic={k: float(v[s]) for k, v in traffic.items()},
            finish=[float(fi[s]) for fi in finish],
            tag_busy={k: float(v[s]) for k, v in tag_busy.items()})
        for s in range(n)
    ]


# =============================================================================
# full-generation simulation (prefill + N decode steps)
# =============================================================================

@dataclass
class GenerationResult:
    throughput: float          # generated tokens / s (paper's metric)
    step_time: float           # mean decode-step latency
    prefill_time: float
    gpu_util: float
    traffic_per_step: Dict[str, float]
    minibatch_count: int


def _prefill_time(cfg: ModelConfig, hw: cm.HardwareSpec, batch: int,
                  prompt: int, step_cfg: StepConfig) -> float:
    """Prefill is compute/transfer max-overlap: weights stream once, prompt
    forward is batched."""
    eff = hw.flops * hw.mfu
    w = cfg.num_params() * cfg.bytes_per_param() * step_cfg.weight_host_frac
    flops = batch * prompt * cm.forward_flops_per_token(cfg, prompt) * cfg.num_layers
    return max(w / hw.host_link_bw, flops / eff)


def simulate_generation(cfg: ModelConfig, hw: cm.HardwareSpec, *,
                        batch: int, prompt: int, gen: int, mode: str,
                        act_ratio: float = 0.0, act_gpu_tokens: int = 0,
                        minibatch_requests: Optional[int] = None,
                        weight_host_frac: Optional[float] = None,
                        recompute_ratio: float = 0.0) -> GenerationResult:
    """Simulate `gen` decode steps; context grows from `prompt`.

    mode: kv | act | hybrid | token | nomb   (see module docstring)
    act_ratio: fraction of HOST context tokens held as ACT (hybrid mode)
    """
    usable_dev = hw.device_mem * 0.7            # minus staging buffers/runtime
    if mode in ("act", "hybrid"):
        # HybridServe: weights stream; device memory prioritises ACT blocks
        if weight_host_frac is None:
            weight_host_frac = 1.0
        if act_gpu_tokens == 0:
            per_tok = cfg.act_bytes_per_token() * cfg.num_layers
            act_gpu_tokens = int(usable_dev / per_tok)
    else:
        # FlexGen/DeepSpeed-style: resident weights take the device memory
        if weight_host_frac is None:
            w_total = cfg.num_params() * cfg.bytes_per_param()
            weight_host_frac = float(np.clip(1.0 - usable_dev / w_total, 0.0, 1.0))
    step_cfg = StepConfig(weight_host_frac=weight_host_frac)

    if minibatch_requests is None:
        minibatch_requests = batch if mode == "nomb" else max(1, batch // 4)

    n_mb = (batch + minibatch_requests - 1) // minibatch_requests
    times, utils = [], []
    traffic_acc: Dict[str, float] = {}
    # sample a few representative steps and integrate
    sample_steps = sorted(set([0, gen // 4, gen // 2, 3 * gen // 4, gen - 1]))
    for s in sample_steps:
        ctx = prompt + s
        mbs = []
        remaining = batch
        for m in range(n_mb):
            nr = min(minibatch_requests, remaining)
            remaining -= nr
            total_ctx = nr * ctx
            act_dev = min(act_gpu_tokens // max(n_mb, 1), total_ctx)
            rest = total_ctx - act_dev
            if mode in ("kv", "nomb"):
                spec = MiniBatchSpec(nr, rest, 0, act_dev, ctx_tokens=ctx)
            elif mode == "act":
                spec = MiniBatchSpec(nr, 0, rest, act_dev, ctx_tokens=ctx)
            elif mode == "hybrid":
                a = int(rest * act_ratio)
                spec = MiniBatchSpec(nr, rest - a, a, act_dev, ctx_tokens=ctx)
            elif mode == "token":
                t = int(rest * recompute_ratio)
                spec = MiniBatchSpec(nr, rest - t, 0, act_dev,
                                     tok_recompute_tokens=t, ctx_tokens=ctx)
            else:
                raise ValueError(mode)
            mbs.append(spec)
        res = simulate_step(cfg, hw, mbs, step_cfg)
        times.append(res.total)
        utils.append(res.gpu_util)
        for k, v in res.traffic.items():
            traffic_acc[k] = traffic_acc.get(k, 0.0) + v / len(sample_steps)

    step_time = float(np.mean(times))
    prefill = _prefill_time(cfg, hw, batch, prompt, step_cfg)
    total_time = prefill + step_time * gen
    thr = batch * gen / total_time
    return GenerationResult(throughput=thr, step_time=step_time,
                            prefill_time=prefill,
                            gpu_util=float(np.mean(utils)),
                            traffic_per_step=traffic_acc,
                            minibatch_count=n_mb)
