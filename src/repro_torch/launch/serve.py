"""Serving launcher of the port: the HybridServe engine (or, with
``--continuous``, the continuous-batching server) on the card, or on the
CPU with ``--device cpu``.

  PYTHONPATH=src python -m repro_torch.launch.serve --arch opt-6.7b-reduced \\
      --device cpu --requests 8 --mode hybrid --verify
  PYTHONPATH=src python -m repro_torch.launch.serve --arch opt-6.7b --verify

The weights are the port's ``init_params`` at seed 0, or with ``--init
PATH`` those of a checkpoint written by either package (``{"params":
...}``).  Each run prints its wall-clock tokens/s, measured on the device it
ran on, beside the engine's simulated figure, which is priced on
``H100_SXM``.  ``--trace out.json`` writes a Chrome-trace file of the
request and lane spans; ``--snapshot`` prints the metrics snapshot.  One
device only: ``--mesh`` takes ``1,1`` and ``--explain-plan`` is refused
(the sharded serving plan is ROADMAP queue 1, item 5).
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch import checkpoint
from repro_torch.configs import get_config
from repro_torch.core.costmodel import H100_SXM
from repro_torch.data import request_trace
from repro_torch.launch.specs import params_shape
from repro_torch.models import model as M
from repro_torch.serving import HybridServeEngine, exact_reference_generate

SHARDED = "sharded serving waits for ROADMAP queue 1, item 5"


def device_name(device) -> str:
    dev = torch.device(device)
    return torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"


def _wall(device, fn):
    """-> (fn's result, seconds), the device's queue drained at both ends."""
    sync = torch.cuda.synchronize if torch.device(device).type == "cuda" \
        else (lambda: None)
    sync()
    t0 = time.perf_counter()
    out = fn()
    sync()
    return out, time.perf_counter() - t0


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--mode", default="hybrid", choices=["hybrid", "kv", "act"])
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--prompt-mean", type=int, default=64)
    ap.add_argument("--gen-tokens", type=int, default=16)
    ap.add_argument("--verify", action="store_true",
                    help="check token-exactness against the plain-KV reference")
    ap.add_argument("--continuous", action="store_true",
                    help="iteration-level continuous batching (Orca-style)")
    ap.add_argument("--chunk-steps", type=int, default=1,
                    help="decode iterations per call in the continuous "
                         "server (1 = the step server)")
    ap.add_argument("--mesh", default="1,1", metavar="DATA,MODEL",
                    help="serving mesh shape; only 1,1 (" + SHARDED + ")")
    ap.add_argument("--explain-plan", action="store_true",
                    help="refused: " + SHARDED)
    ap.add_argument("--trace", default=None, metavar="OUT.json",
                    help="record request-lifecycle + lane spans and export "
                         "a Chrome-trace/Perfetto JSON file")
    ap.add_argument("--snapshot", action="store_true",
                    help="print the unified metrics snapshot after the run")
    ap.add_argument("--init", default=None, metavar="PATH",
                    help="serve the params of this checkpoint")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    if args.mesh != "1,1" or args.explain_plan:
        ap.error(f"--mesh {args.mesh}"
                 + (" --explain-plan" if args.explain_plan else "")
                 + f": the port serves on one device; {SHARDED}")

    tracer, metrics = None, None
    if args.trace or args.snapshot:
        from repro_torch.obs import MetricsRegistry, Tracer
        metrics = MetricsRegistry()
        if args.trace:
            tracer = Tracer()

    cfg = get_config(args.arch)
    if args.init:
        params = checkpoint.restore(args.init, {"params": params_shape(cfg)},
                                    device=args.device)["params"]
    else:
        params = M.init_params(cfg, seed=0, device=args.device)
    reqs = request_trace(cfg.vocab_size, args.requests,
                         prompt_mean=args.prompt_mean,
                         gen_tokens=args.gen_tokens, seed=1)
    where = device_name(args.device)
    if args.continuous:
        from repro_torch.serving import ContinuousBatchingServer
        eng = ContinuousBatchingServer(cfg, params, slots=4,
                                       chunk_steps=args.chunk_steps,
                                       hw=H100_SXM, tracer=tracer,
                                       metrics=metrics, device=args.device)
        print(f"continuous batching: 4 slots, chunk_steps="
              f"{args.chunk_steps}, act_frac={eng.act_frac:.2f}")
        (out, stats), wall = _wall(args.device, lambda: eng.run(reqs))
        print(f"{stats.generated_tokens} tokens in {stats.steps} iterations, "
              f"{stats.device_calls} calls "
              f"({stats.dispatches_per_token:.2f}/token, {wall:.1f}s wall); "
              f"measured on {where}: {stats.generated_tokens / wall:.1f} tok/s; "
              f"simulated on {H100_SXM.name}: {stats.throughput:.1f} tok/s")
    else:
        eng = HybridServeEngine(cfg, params, mode=args.mode, hw=H100_SXM,
                                tracer=tracer, metrics=metrics,
                                device=args.device)
        print(f"engine: mode={args.mode} host ACT:KV ratio="
              f"{eng.alloc.act_blocks}:{eng.alloc.kv_blocks} "
              f"(act_frac={eng.act_frac:.2f})")
        (out, stats), wall = _wall(args.device, lambda: eng.generate(reqs))
        print(f"generated {stats.generated_tokens} tokens in {stats.steps} steps "
              f"({wall:.1f}s wall); measured on {where}: "
              f"{stats.generated_tokens / wall:.1f} tok/s")
        print(f"simulated on {eng.hw.name}: throughput={stats.sim_throughput:.1f} "
              f"tok/s gpu_util={stats.sim_gpu_util:.1%}")
        if stats.traffic:
            tr = {k: f"{v/2**20:.1f}MiB" for k, v in stats.traffic.items()}
            print(f"simulated PCIe traffic: {tr}")
    if args.verify:
        ref = exact_reference_generate(cfg, params, reqs, device=args.device)
        ok = all(np.array_equal(out[r.rid], ref[r.rid]) for r in reqs)
        print(f"token-exact vs full-KV reference: {ok}")
        assert ok
    _export_obs(args, eng, tracer)
    return out, stats


def _export_obs(args, eng, tracer):
    if tracer is not None:
        tracer.export(args.trace)
        print(f"trace: {len(tracer.events())} events -> {args.trace} "
              f"(open in https://ui.perfetto.dev)")
    if args.snapshot:
        snap = eng.snapshot()
        print("metrics snapshot:")
        for k in sorted(snap):
            print(f"  {k} = {snap[k]}")


if __name__ == "__main__":
    main()
