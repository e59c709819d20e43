"""Continuous batching over the hybrid KV/ACT cache, on the PyTorch port:
requests arrive, are admitted into free decode slots between iterations,
finish and leave — all while every running request keeps the Algorithm-1
ACT:KV ratio and the output stays token-identical to offline decoding.

Runs on the card (the reduced config's float32 becomes OPT's float16 there)
unless given ``--device cpu``.

Run:  PYTHONPATH=src python examples/torch_continuous_batching.py [--device cpu]
"""
import argparse

import numpy as np

from repro_torch.configs import get_config, reduced
from repro_torch.data import request_trace
from repro_torch.models import model as M
from repro_torch.serving import ContinuousBatchingServer, exact_reference_generate


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
    requests = request_trace(cfg.vocab_size, 8, prompt_mean=48, gen_tokens=10,
                             seed=13)

    # chunk_steps=8: ONE call + ONE host sync per 8 iterations (instead of
    # per token), with arrivals coalesced into batched prefills at chunk
    # boundaries
    server = ContinuousBatchingServer(cfg, params, slots=3, kv_cap=128,
                                      act_cap=128, chunk_steps=8,
                                      device=args.device)
    out, stats = server.run(requests)
    ref = exact_reference_generate(cfg, params, requests, device=args.device)
    exact = all(np.array_equal(out[r.rid], ref[r.rid]) for r in requests)
    print(f"{len(requests)} requests through 3 slots in {stats.steps} "
          "iterations")
    print(f"{stats.device_calls} dispatches "
          f"({stats.dispatches_per_token:.2f}/token: {stats.chunks} chunks + "
          f"{stats.admission_batches} admission batches)")
    print(f"token-exact vs offline decode: {exact}")
    print(f"simulated throughput on {server.hw.name}: {stats.throughput:.0f} "
          "tok/s")
    print(f"TTFT mean {np.mean(list(stats.ttft.values())) * 1e3:.2f} ms, "
          f"TBT mean {np.mean(list(stats.tbt.values())) * 1e3:.2f} ms "
          "(simulated)")
    assert exact


if __name__ == "__main__":
    main()
