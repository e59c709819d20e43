"""Time ``kv_gen`` and ``ssd_scan`` and the paths that run them, in one checkout.

    python3 tools/ab_kernels.py [ROOT]     # on one H100; ROOT: a checkout of
                                           # the repo (default: this one)

Imports ROOT's ``chip_smoke.py`` (and with it ROOT's ``src/``), builds ROOT's
kernels and reads, through the public wrappers only, so that two checkouts
(a parent and its change) are measured alike:
  - per kernel row of ``chip_smoke.py`` (``kv_gen`` at yi-6b's and
    minitron-4b's serve shapes, int8, gemma3's K norm; ``ssd_scan`` at
    mamba2's two prefill shapes): the mean time per call by CUDA events over
    back-to-back calls, the wrapper's host time per call, and its kernels'
    device time (torch.profiler);
  - mamba2-2.7b's prefill wall time per group (``MAMBA_GROUPS``);
  - yi-6b hybrid ``generate`` over ``TRACE``: tokens/s after a warm-up, and
    a profiled run's device busy ms and ``kv_gen``'s share of it.
Prints the card (``nvidia-smi``) and one JSON line.  Compare two checkouts
only within one call, in turns: parent, change, change, parent.
"""
from __future__ import annotations

import gc
import json
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(sys.argv[1] if len(sys.argv) > 1 else Path(__file__).parents[1]).resolve()
sys.path.insert(0, str(ROOT))
import chip_smoke as CS  # noqa: E402


def kv_gen_case(B, n_act, d, KVH, hd=128, act_cap=512, dtype=torch.bfloat16,
                norm_type="rmsnorm", theta=5e6, q8=False, knorm=False):
    """``chip_smoke.check_kv_gen``'s inputs -> a call of the wrapper."""
    g = torch.Generator(device="cuda").manual_seed(2)
    rnd = lambda *shape, s=1.0, o=0.0: (torch.randn(
        shape, generator=g, device="cuda") * s + o).to(dtype)
    pool = rnd(B * act_cap // CS.PAGE, CS.PAGE, d, o=0.1)
    ln = norm_type == "layernorm"
    scale = rnd(d, s=0.1, o=1.0 if ln else 0.0)
    bias = rnd(d, s=0.2) if ln else None
    wk, wv = rnd(d, KVH, hd, s=d ** -0.5), rnd(d, KVH, hd, s=d ** -0.5)
    idx = (torch.arange(B, device="cuda")[:, None] * (act_cap // CS.PAGE)
           + torch.arange(n_act, device="cuda")[None]).reshape(-1).int()
    pos = torch.randint(0, 4096, (idx.numel(), CS.PAGE), generator=g, device="cuda")
    sin, cos = CS.L.rope_sin_cos(pos, hd, theta)
    sc = {}
    if q8:
        (pool,), sc = CS.q8_pools(act_pages=pool)
    kn = {"knorm": rnd(hd, s=0.3)} if knorm else {}
    return lambda: CS.kv_gen(pool, scale, bias, wk, wv, page_index=idx, sin=sin,
                             cos=cos, norm_type=norm_type,
                             eps=CS.L.NORM_EPS[norm_type], **sc, **kn)


def times(fn) -> dict:
    return {"ms": CS.time_ms(fn, 50), "host_us": CS.host_us(fn),
            "device_us": CS.device_us(fn)}


def kernels() -> dict:
    yi, gemma = CS.get_config("yi-6b"), CS.get_config(CS.GEMMA)
    shape, q8 = CS.serve_shape(yi), CS.serve_shape(yi, CS.QuantConfig())
    g_global, _ = CS.gemma_shapes()
    out = {
        "kv_gen_yi": times(kv_gen_case(shape["B"], shape["act_pages_bound"],
                                       yi.d_model, yi.num_kv_heads)),
        "kv_gen_minitron": times(kv_gen_case(
            shape["B"], shape["act_pages_bound"], 3072, 8, dtype=torch.float16,
            norm_type="layernorm", theta=1e4)),
        "kv_gen_q8": times(kv_gen_case(q8["B"], q8["act_pages_bound"], yi.d_model,
                                       yi.num_kv_heads, q8=True)),
        "kv_gen_qk_norm": times(kv_gen_case(
            g_global["B"], g_global["act_pages_bound"], gemma.d_model,
            gemma.num_kv_heads, hd=gemma.head_dim, act_cap=g_global["act_cap"],
            theta=gemma.rope_theta, knorm=True))}
    mamba = CS.get_config(CS.MAMBA)
    for B, S in CS.MAMBA_GROUPS:
        x, dt, A, Bc, Cc = CS.ssd_inputs(B, S, mamba, seed=S)
        out[f"ssd_scan_{B}x{S}"] = times(
            lambda: CS.ssd_scan(x, dt, A, Bc, Cc, chunk=mamba.ssm_chunk))
    return out


def mamba_prefill() -> dict:
    cfg = CS.get_config(CS.MAMBA)
    params = CS.M.init_params(cfg, seed=0, device="cuda")
    bias = params["layers"]["ssd"]["dt_bias"]
    bias.copy_(CS.mamba_dt_bias(bias.shape,
                                torch.Generator(device="cuda").manual_seed(0)))
    rng = np.random.default_rng(0)
    out = {}
    for B, S in CS.MAMBA_GROUPS:
        toks = torch.from_numpy(rng.integers(0, cfg.vocab_size, (B, S))
                                .astype(np.int32)).cuda()
        CS.mamba_run(params, cfg, toks, CS.MAMBA_STEPS)          # warm-up
        torch.cuda.synchronize()
        runs = []
        for _ in range(3):
            marks = []
            t0 = time.perf_counter()
            CS.mamba_run(params, cfg, toks, CS.MAMBA_STEPS, marks=marks)
            torch.cuda.synchronize()
            runs.append((marks[0][0] - t0) * 1e3)
        out[f"prefill_ms_{B}x{S}"] = runs
    del params
    return out


def yi_hybrid() -> dict:
    from torch.profiler import ProfilerActivity, profile
    cfg = CS.get_config("yi-6b")
    params = CS.M.init_params(cfg, seed=0, device="cuda")
    reqs = CS.request_trace(cfg.vocab_size, **CS.TRACE)
    eng = CS.HybridServeEngine(cfg, params, mode="hybrid", hw=CS.H100_SXM)
    eng.generate(reqs)                                           # warm-up
    torch.cuda.synchronize()
    tps = []
    for _ in range(3):
        t0 = time.perf_counter()
        _, stats = eng.generate(reqs)
        torch.cuda.synchronize()
        tps.append(stats.generated_tokens / (time.perf_counter() - t0))
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        eng.generate(reqs)
        torch.cuda.synchronize()
    busy = kv = 0.0
    for e in prof.events():
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue
        ms = e.time_range.elapsed_us() / 1e3
        busy += ms
        if any(k in e.name for k in ("kv_gen_kernel", "kv_norm_kernel",
                                     "kv_proj_kernel")):
            kv += ms
    del eng, params
    return {"tokens_per_s": tps, "device_busy_ms": busy, "kv_gen_ms": kv,
            "kv_gen_share": kv / busy}


def main() -> int:
    if not torch.cuda.is_available():
        print("ab_kernels: no CUDA device", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    smi = CS.phase_env({})
    t0 = time.perf_counter()
    CS._build.build_all()
    out = {"root": str(ROOT), "card": smi, "build_s": time.perf_counter() - t0,
           "kernels": kernels()}
    out.update(mamba_prefill())
    gc.collect()
    torch.cuda.empty_cache()
    out["yi_hybrid"] = yi_hybrid()
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
