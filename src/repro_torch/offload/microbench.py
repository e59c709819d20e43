"""Weight-stream microbenchmark: stream-only vs compute-only vs overlapped
(counterpart of ``repro.offload.microbench``).

The offload runtime's reason to exist is that the copy stream hides weight
uploads behind KV-Gen + forward compute.  This harness measures the three
regimes on the same decode workload with the same stages:

  * ``stream_s``  — upload every (step, layer) weight shard back-to-back on
    the copy stream, no compute (the PCIe lane alone).
  * ``compute_s`` — run the layer-granular decode with all shards
    device-resident, no streaming (the compute lane alone).
  * ``overlap_s`` — the real executor loop: dispatch-ahead streaming
    overlapped with compute.

If the runtime overlaps at all, ``overlap_s < stream_s + compute_s``
(strictly) — the benchmark reports the saving, the median over the reps of
each rep's ``stream + compute - overlap`` (the three regimes of one rep run
back to back), and the achieved overlap efficiency, read from the
overlapped run's own timeline: the compute lane's busy time inside the copy
lane's busy intervals over the shorter lane's busy time (1.0 = the shorter
lane is fully hidden), the median over the reps.  Differences of separate
wall times would carry the noise of three runs into a ratio over the
shorter lane; the spans carry none of it, and a synchronous lane's spans
never overlap.

On the card each regime is timed by CUDA events: one on the compute stream
before it (the copy stream waits on it) and one after the compute stream
has waited for the copy stream, so both streams' work lies between them.
On the CPU the streamer's copies are synchronous ``copy_``s: nothing
overlaps, and the times are host times.  The reference's ``isolate=`` and
``attempts=`` are not kept: they re-ran the measurement in a subprocess
with XLA's CPU thread flags, so that a CPU core was left to play the copy
engine; the card has a copy engine of its own, and the CPU here has none to
free.
"""
from __future__ import annotations

import time
from typing import Callable, Dict, Optional

import numpy as np
import torch

from repro_torch.configs import get_config
from repro_torch.configs.base import ModelConfig, reduced
from repro_torch.models import model as M
from repro_torch.offload.executor import OffloadExecutor
from repro_torch.offload.host_pool import _to


def bench_config(num_layers: int = 6, d_model: int = 512) -> ModelConfig:
    """A uniform-family config sized so both lanes are tens of ms on CPU."""
    return reduced(get_config("opt-6.7b"), num_layers=num_layers,
                   d_model=d_model, num_heads=d_model // 32,
                   num_kv_heads=d_model // 32, d_ff=4 * d_model)


def _fresh_state(ex: OffloadExecutor, B: int, S: int, kv_cap: int,
                 act_cap: int, seed: int = 0):
    rng = np.random.default_rng(seed)
    tokens = rng.integers(0, ex.cfg.vocab_size, size=(B, S), dtype=np.int64)
    kv_keep = np.full((B,), min(S // 2 // 16 * 16, kv_cap), np.int32)
    last_pos = np.full((B,), S, np.int32)
    return ex.prefill_batched(tokens.astype(np.int32), kv_keep, last_pos,
                              kv_cap=kv_cap, act_cap=act_cap)


def _compute_only(ex: OffloadExecutor, cur, cache, sched, dev_layers):
    """The executor's decode loop with device-resident layer weights (no
    streaming): the same stages, in the same order."""
    cfg = ex.cfg
    keys = M.kv_planes(cache)
    sched_dev = torch.from_numpy(np.ascontiguousarray(sched)).to(ex.device)
    for s in range(sched.shape[0]):
        store = sched_dev[s]
        plan = M.hybrid_decode_begin(ex.resident, cfg, cur[:, None], cache,
                                     store, quant=ex.quant,
                                     any_act=bool(sched[s].any()))
        x = plan.x
        for l in range(cfg.num_layers):
            bufs = [cache[key][l] for key in keys]
            x = M._hybrid_layer_step(dev_layers[l], cfg, x, bufs[0], bufs[1],
                                     cache["act"][l], cache["kv_len"],
                                     cache["act_len"], store, plan.tables,
                                     plan.act_kv, M.plane_scales(bufs, None),
                                     plan.exact_own)
        lg = M.hybrid_decode_end(ex.resident, cfg, x, cache, store)
        cur = lg[:, -1].argmax(-1).int()
    return cur


def _timed(ex: OffloadExecutor, fn: Callable[[], object]) -> float:
    """Seconds of ``fn``'s work: CUDA events across both streams on the
    card, the host clock on the CPU."""
    if ex.device.type != "cuda":
        t0 = time.perf_counter()
        fn()
        return time.perf_counter() - t0
    compute = torch.cuda.current_stream(ex.device)
    copy = ex.streamer.copy_stream
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record(compute)
    copy.wait_event(start)
    fn()
    compute.wait_stream(copy)
    end.record(compute)
    end.synchronize()
    return start.elapsed_time(end) / 1e3


def _hidden_share(steps) -> float:
    """The compute lane's busy seconds inside the copy lane's busy intervals
    over the shorter lane's busy seconds, summed over the measured steps."""
    lanes = min(sum(m.pcie_busy for m in steps),
                sum(m.gpu_busy for m in steps))
    return sum(m.gpu_hidden for m in steps) / max(lanes, 1e-12)


def weight_stream_microbench(cfg: Optional[ModelConfig] = None, *,
                             B: int = 2, S: int = 64, kv_cap: int = 128,
                             act_cap: int = 128, n_steps: int = 6,
                             prefetch_depth: int = 1, reps: int = 3,
                             seed: int = 0, device="cuda") -> Dict[str, float]:
    """-> dict with stream_s / compute_s / overlap_s / saving_s /
    overlap_efficiency / weight_bytes_streamed / prefetch_depth.

    Each regime is measured ``reps`` times and the MIN reported: any other
    load only ever inflates a time.  ``saving_s`` and
    ``overlap_efficiency`` are medians over the reps of each rep's own
    (module docstring).  ``cfg`` defaults to ``bench_config()``, its
    weights drawn from ``seed`` on ``device``."""
    if cfg is None:
        cfg = bench_config()
    ex = OffloadExecutor(cfg, M.init_params(cfg, seed=seed, device=device),
                         prefetch_depth=prefetch_depth, device=device)
    Lc = cfg.num_layers
    sched = np.zeros((n_steps, B), bool)
    sched[:, ::2] = True                       # mixed KV/ACT appends
    schedule = [l for _ in range(n_steps) for l in range(Lc)]

    def stream_only():
        ex.streamer.begin(schedule)
        for i in range(len(schedule)):
            ex.streamer.acquire(i)
            ex.streamer.release(i)

    try:
        # warm every stage and the copy stream before any timing
        cur, cache = _fresh_state(ex, B, S, kv_cap, act_cap, seed)
        ex.decode_loop(cur, cache, sched)
        dev_layers = [_to(ex.pool.layer(l), ex.device) for l in range(Lc)]
        stream_ts, compute_ts, overlap_ts, hidden = [], [], [], []
        for _ in range(reps):
            stream_ts.append(_timed(ex, stream_only))
            cur, cache = _fresh_state(ex, B, S, kv_cap, act_cap, seed)
            compute_ts.append(_timed(ex, lambda: _compute_only(
                ex, cur, cache, sched, dev_layers)))
            cur, cache = _fresh_state(ex, B, S, kv_cap, act_cap, seed)
            ex.drain_timeline(None)
            overlap_ts.append(_timed(ex, lambda: ex.decode_loop(cur, cache,
                                                                sched)))
            hidden.append(_hidden_share(ex.drain_timeline("decode")))
        saving = np.median(np.asarray(stream_ts) + np.asarray(compute_ts)
                           - np.asarray(overlap_ts))
        return {
            "stream_s": float(np.min(stream_ts)),
            "compute_s": float(np.min(compute_ts)),
            "overlap_s": float(np.min(overlap_ts)),
            "saving_s": float(saving),
            "overlap_efficiency": float(np.median(hidden)),
            "weight_bytes_streamed": float(sum(ex.pool.layer_nbytes)
                                           * n_steps),
            "prefetch_depth": float(prefetch_depth),
        }
    finally:
        ex.close()

