"""Device time of each pass of the two backward kernels, with their
diagnostics: where the time of ``flash_attention_bwd`` and ``ssd_scan_bwd``
goes on the card.

    python3 tools/bwd_passes.py [flash] [ssd]      (both by default)

Builds the kernels (``_build.build_all``), then times each pass by
``torch.profiler`` (device time per kernel name, the mean of 10 calls, 5 for
the SSD backward, after 3 warm-up calls), bfloat16 on random inputs:

- the flash backward (the Delta pre-pass, the main pass, the last pass) at
  opt-6.7b's, minitron-4b's, a ragged GQA, gemma3-1b's global and
  whisper-base's encoder shapes, each also with ``diag_no_dq_add`` (the main
  pass adds no dQ: what the dQ adds cost);
- the SSD backward (the state pass, the chunk pass, the last pass) at
  mamba2-2.7b's 4 x 1024 and jamba's h 256, each also with
  ``diag_bwd_no_state_stores`` (the state pass stores no state) and
  ``diag_bwd_chunk_loads_only`` (the chunk pass loads its tiles and
  computes nothing) and ``diag_bwd_chunk_compute_only`` (it loads its first
  two heads' tiles only and computes every head on them).

The diagnostics' outputs are not valid; only their times are read.  Prints
the card's name and power limit, then one line per case, and writes
``chiprun_out/bwd_passes.json``.  Needs one CUDA card (~1 min).
"""
from __future__ import annotations

import json
import subprocess
import sys
from pathlib import Path

import torch
from torch.profiler import ProfilerActivity, profile

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels.flash_attention import ops as FA  # noqa: E402
from repro_torch.kernels.ssd_scan import ops as SSD  # noqa: E402

# name -> (B, S, H, KVH, D, window, causal, Sk)
FLASH = {"opt-6.7b": (4, 512, 32, 32, 128, 0, True, 512),
         "minitron-4b": (4, 512, 24, 8, 128, 0, True, 512),
         "gqa_777": (2, 777, 8, 2, 64, 0, True, 777),
         "gemma3-1b_global": (4, 1024, 4, 1, 256, 0, True, 1024),
         "whisper_encoder": (4, 1500, 8, 8, 64, 0, False, 1500)}
SSD_SHAPES = {"mamba2-2.7b": (4, 1024, 80), "jamba_h256": (4, 1000, 256)}


def passes(fn, n: int) -> dict:
    """{kernel name: device µs a call} over n calls after 3 warm-ups."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
    out = {}
    for e in prof.key_averages():
        t = getattr(e, "self_device_time_total", 0)
        if t:
            name = e.key.split("::")[-1].split("<")[0]
            out[name] = out.get(name, 0.0) + t / n
    return out


def flash_cases(g) -> dict:
    out = {}
    for name, (B, S, H, KVH, D, W, causal, Sk) in FLASH.items():
        q, do = (torch.randn((B, S, H, D), generator=g, device="cuda",
                             dtype=torch.bfloat16) for _ in range(2))
        k, v = (torch.randn((B, Sk, KVH, D), generator=g, device="cuda",
                            dtype=torch.bfloat16) for _ in range(2))
        o, lse = FA.flash_attention_lse(q, k, v, W, causal)
        args = (q, k, v, o, lse, do)
        for label, flags in (("", 0), ("_no_dq_add", FA.FAULTS["diag_no_dq_add"])):
            out[name + label] = passes(lambda: FA._flash_attention_bwd(
                *args, window=W, causal=causal, flags=flags), 10)
            print(f"flash_attention_bwd {name}{label}: {out[name + label]}", flush=True)
    return out


def ssd_cases(g) -> dict:
    out = {}
    for name, (B, S, h) in SSD_SHAPES.items():
        n = SSD.BWD_SHAPE[1]
        x = torch.randn((B, S, h, 64), generator=g, device="cuda").bfloat16()
        Bc, Cc = (torch.randn((B, S, n), generator=g, device="cuda").bfloat16()
                  for _ in range(2))
        dt = torch.nn.functional.softplus(
            torch.randn((B, S, h), generator=g, device="cuda") - 4.0)
        A = -torch.linspace(1.0, 16.0, h, device="cuda")
        dy = torch.randn(x.shape, generator=g, device="cuda").bfloat16()
        dfin = torch.randn((B, h, 64, n), generator=g, device="cuda")
        for label, flags in (("", 0),
                             ("_no_state_stores", SSD.FAULTS["diag_bwd_no_state_stores"]),
                             ("_chunk_loads_only", SSD.FAULTS["diag_bwd_chunk_loads_only"]),
                             ("_chunk_compute_only",
                              SSD.FAULTS["diag_bwd_chunk_compute_only"])):
            out[name + label] = passes(lambda: SSD._ssd_scan_bwd(
                x, dt, A, Bc, Cc, dy, dfin, chunk=64, flags=flags), 5)
            print(f"ssd_scan_bwd {name}{label}: {out[name + label]}", flush=True)
    return out


def main() -> int:
    if not torch.cuda.is_available():
        print("bwd_passes: no CUDA device", file=sys.stderr)
        return 1
    which = set(sys.argv[1:]) or {"flash", "ssd"}
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    _build.build_all()
    g = torch.Generator(device="cuda").manual_seed(0)
    out = {"card": smi}
    if "flash" in which:
        out["flash_attention_bwd"] = flash_cases(g)
    if "ssd" in which:
        out["ssd_scan_bwd"] = ssd_cases(g)
    (ROOT / "chiprun_out").mkdir(exist_ok=True)
    (ROOT / "chiprun_out" / "bwd_passes.json").write_text(json.dumps(out, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
