"""Serve a batched request trace with all three cache modes and compare the
simulated schedules on the paper's hardware (Fig. 12's experiment, reduced),
on the PyTorch port.

Runs on the card (the reduced config's float32 becomes OPT's float16 there)
unless given ``--device cpu``.

Run:  PYTHONPATH=src python examples/torch_serve_hybrid.py [--device cpu]
"""
import argparse

import numpy as np

from repro_torch.configs import get_config, reduced
from repro_torch.core import costmodel as cm
from repro_torch.data import request_trace
from repro_torch.models import model as M
from repro_torch.serving import HybridServeEngine, exact_reference_generate


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    full = get_config("opt-6.7b")
    # the kernels take float16 and bfloat16: on the card the reduced
    # config keeps OPT's float16 (float32 is its CPU exactness dtype)
    cfg = reduced(full, dtype=full.dtype) \
        if args.device.startswith("cuda") else reduced(full)
    print(f"{cfg.name} on {args.device} in {cfg.dtype}")
    params = M.init_params(cfg, seed=0, device=args.device)
    requests = request_trace(cfg.vocab_size, n_requests=8, prompt_mean=64,
                             gen_tokens=16, seed=11)
    reference = exact_reference_generate(cfg, params, requests,
                                         device=args.device)

    print(f"{'mode':8s} {'exact':6s} {'sim tok/s':>10s} {'gpu util':>9s} "
          f"{'kv MiB':>8s} {'act MiB':>8s}")
    for mode in ["kv", "act", "hybrid"]:
        eng = HybridServeEngine(cfg, params, mode=mode, hw=cm.RTX4090,
                                device=args.device)
        out, st = eng.generate(requests)
        exact = all(np.array_equal(out[r.rid], reference[r.rid])
                    for r in requests)
        print(f"{mode:8s} {str(exact):6s} {st.sim_throughput:10.1f} "
              f"{st.sim_gpu_util:9.1%} "
              f"{st.traffic.get('kv_load', 0) / 2**20:8.1f} "
              f"{st.traffic.get('act_load', 0) / 2**20:8.1f}")
        assert exact
    print("\nall modes produce identical tokens; hybrid balances the two "
          "lanes ✓")

    # the host-offload runtime: same tokens, but weights stream from pinned
    # host pools for real and the lane times are MEASURED, with the
    # simulator as the predictor
    with HybridServeEngine(cfg, params, mode="hybrid", hw=cm.RTX4090,
                           offload=True, device=args.device) as eng:
        out, st = eng.generate(requests)
        assert all(np.array_equal(out[r.rid], reference[r.rid])
                   for r in requests)
        w = sum(m.traffic["weights"] for m in eng.measured_steps)
        print(f"offload  True   measured {st.measured_gpu_util:9.1%} gpu "
              f"util, {w / 2**20:.0f} MiB weights streamed over "
              f"{eng.executor.streamer.uploads} uploads — token-exact ✓")


if __name__ == "__main__":
    main()
