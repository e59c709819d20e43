"""Why ``chip_smoke.py`` draws mamba2's dt biases as Mamba-2 inits them.

    python3 tools/mamba2_dt_init.py     # on one H100, from the repo's root

For each dt init, the reference's (dt_bias 0) and Mamba-2's (softplus(dt_bias)
log-uniform in ``MAMBA_DT_RANGE``), full-size mamba2-2.7b (random weights
from seed 0) over ``chip_smoke.py``'s two groups, teacher-forced with the
plain path's greedy tokens, reads the largest logit gap to the plain path
(``ssd_scan``'s plain version, chunk 64) of: the plain path at chunk 32 (the
same function, its float32 sums in another order: the spread any correct
scan may show), the kernel path, and the kernel called one chunk at a time
(the state not carried).  A limit can tell that fault apart only where it
reads well above the spread.  Prints one JSON line per init and writes
``chiprun_out/mamba2_dt_init.json``.
"""
from __future__ import annotations

import dataclasses
import json
import sys
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
import chip_smoke as CS  # noqa: E402


def read(dt_init: str) -> dict:
    cfg = CS.get_config(CS.MAMBA)
    params = CS.M.init_params(cfg, seed=0, device="cuda")
    bias = params["layers"]["ssd"]["dt_bias"]
    if dt_init == "mamba2":
        bias.copy_(CS.mamba_dt_bias(bias.shape,
                                    torch.Generator(device="cuda").manual_seed(0)))
    rng = np.random.default_rng(0)
    n, other = CS.MAMBA_STEPS, dataclasses.replace(cfg, ssm_chunk=32)
    gaps = {"plain_chunk32": 0.0, "kernel": 0.0, "state_not_carried": 0.0}
    for B, S in CS.MAMBA_GROUPS:
        toks = torch.from_numpy(rng.integers(0, cfg.vocab_size, (B, S))
                                .astype(np.int32)).cuda()
        runs = {}
        for name, scan, c in (("plain", CS.ssd_chunked_ref, cfg),
                              ("plain_chunk32", CS.ssd_chunked_ref, other),
                              ("kernel", CS._real_ssd_scan, cfg),
                              ("state_not_carried", CS.ssd_chunks, cfg)):
            CS.L.ssd_scan = scan
            try:
                if name == "plain":
                    gold, _ = CS.mamba_run(params, c, toks, n)
                runs[name] = CS.mamba_run(params, c, toks, n, gold)[1]
            finally:
                CS.L.ssd_scan = CS._real_ssd_scan
        for name in gaps:
            gaps[name] = max(gaps[name],
                             (runs[name] - runs["plain"]).abs().max().item())
    del params
    torch.cuda.empty_cache()
    return {"dt_init": dt_init, "dt_range": CS.MAMBA_DT_RANGE
            if dt_init == "mamba2" else None, "max_dlogit": gaps}


def main() -> int:
    if not torch.cuda.is_available():
        print("mamba2_dt_init: no CUDA device", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    smi = CS.phase_env({})
    out = {"card": smi, "reads": [read(i) for i in ("reference", "mamba2")]}
    for r in out["reads"]:
        print(json.dumps(r), flush=True)
    (ROOT / "chiprun_out").mkdir(exist_ok=True)
    (ROOT / "chiprun_out" / "mamba2_dt_init.json").write_text(
        json.dumps(out, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
