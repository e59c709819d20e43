"""Chip smoke test of the PyTorch/CUDA port on one NVIDIA H100.

    python3 chip_smoke.py

Builds the port's CUDA kernels from this checkout (``nvcc``, sm_90a), holds
each kernel against its plain PyTorch version at the main path's shapes, then
serves full-width, full-depth opt-6.7b (random weights from a seed) through
``HybridServeEngine`` in hybrid and kv modes and checks the tokens against
``exact_reference_generate``.  One JSON line per phase; the line before the
last lists every kernel with its launches on the serve path, error, times and
bound; the last line is the device summary.  Any failure raises and the exit
code is non-zero.  Without a CUDA device, or outside a checkout of the repo,
it fails before printing any result.  Details also go to
``chiprun_out/chip_smoke.json``.
"""
from __future__ import annotations

import json
import math
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as F

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core.costmodel import H100_SXM  # noqa: E402
from repro_torch.data.pipeline import request_trace  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels.flash_attention.ops import flash_attention  # noqa: E402
from repro_torch.kernels.flash_attention.ref import flash_attention_ref  # noqa: E402
from repro_torch.kernels.hybrid_attention.ops import hybrid_paged_attention  # noqa: E402
from repro_torch.kernels.hybrid_attention.ref import hybrid_paged_attention_ref  # noqa: E402
from repro_torch.models import model as M  # noqa: E402
from repro_torch.serving import HybridServeEngine, exact_reference_generate  # noqa: E402

# H100 SXM data sheet: dense fp16
# tensor-core rate and HBM3 bandwidth, at the full 700 W power limit
PEAK_FP16_FLOPS = 989e12
PEAK_BYTES_PER_S = 3.35e12
PAGE = 16
# kernel vs plain version, both rounded to the dtype out of float32 sums: a
# few ulps at |o| <= 4 (float16's ulp is 2**-9 there), from summing in another
# order; bfloat16 keeps 3 fewer mantissa bits, so the same ulps are 8x wider
KERNEL_TOL = {torch.float16: 1e-2, torch.bfloat16: 8e-2}
# teacher-forced hybrid vs oracle logits: recomputed K/V and the two attention
# paths differ by float16 ulps (up to 2**-9 at |x| < 1) per layer; 32 residual
# layers and a 4096-deep unembedding keep the drift of unit-scale logits
# within a few hundredths, so 0.1 leaves headroom without hiding a wrong page
LOGIT_TOL = 0.1


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def time_ms(fn, iters: int) -> float:
    """Mean milliseconds per call on the card, by CUDA events, after a
    warm-up."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def bound(bytes_moved: float, ops: float):
    t_bytes, t_ops = bytes_moved / PEAK_BYTES_PER_S, ops / PEAK_FP16_FLOPS
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def phase_env(results):
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip().splitlines()[0]
    nvcc = subprocess.run([_build._nvcc(), "--version"], capture_output=True,
                          text=True, check=True).stdout.strip().splitlines()[-1]
    env = {"phase": "env", "nvidia_smi": smi, "torch": torch.__version__,
           "cuda": torch.version.cuda, "nvcc": nvcc,
           "device": torch.cuda.get_device_name(0)}
    print(smi, flush=True)
    emit(env)
    results["env"] = env
    return smi


def phase_build(results):
    t0 = time.perf_counter()
    per_kernel = _build.build_all(verbose=True)
    libs = {name: str(_build.load(name)._name) for name in _build.sources()}
    out = {"phase": "build", "seconds": time.perf_counter() - t0,
           "compiled": per_kernel, "libraries": libs}
    emit(out)
    results["build"] = out


def check_flash(B, S, H=32, KVH=32, D=128, dtype=torch.float16):
    g = torch.Generator(device="cuda").manual_seed(S)
    q = torch.randn((B, S, H, D), generator=g, device="cuda", dtype=dtype)
    k, v = (torch.randn((B, S, KVH, D), generator=g, device="cuda",
                        dtype=dtype) for _ in range(2))
    got = flash_attention(q, k, v)
    want = flash_attention_ref(q, k, v)
    torch.cuda.synchronize()
    err = (got.float() - want.float()).abs().max().item()
    # the library call reads (B, H, S, D) with K/V expanded to H heads, made
    # before the timing
    qt, kt, vt = (x.transpose(1, 2).repeat_interleave(H // x.shape[2], dim=1)
                  .contiguous() for x in (q, k, v))
    iters = 50 if S <= 256 else 10
    ms = time_ms(lambda: flash_attention(q, k, v), iters)
    plain_ms = time_ms(lambda: flash_attention_ref(q, k, v), iters)
    lib_ms = time_ms(lambda: F.scaled_dot_product_attention(
        qt, kt, vt, is_causal=True), iters)
    ops = 4.0 * B * H * D * S * (S + 1) / 2           # QK^T and PV, causal half
    nbytes = (2 * q.numel() + 2 * k.numel()) * q.element_size()
    bound_ms, by = bound(nbytes, ops)
    return {"shape": {"B": B, "S": S, "H": H, "KVH": KVH, "D": D},
            "dtype": str(dtype).removeprefix("torch."), "max_abs_err": err,
            "tol": KERNEL_TOL[dtype], "kernel_ms": ms, "plain_ms": plain_ms,
            "library_ms": lib_ms, "bound_ms": bound_ms, "bound_by": by}


def check_hybrid(B=4, KVH=32, G=1, D=128, d=4096, cap=512,
                 dtype=torch.float16, norm_type="layernorm"):
    g = torch.Generator(device="cuda").manual_seed(1)
    rnd = lambda *shape, s=1.0, o=0.0: (torch.randn(
        shape, generator=g, device="cuda") * s + o).to(dtype)
    k_pages = rnd(B * cap // PAGE, PAGE, KVH, D, s=0.5)
    v_pages = rnd(B * cap // PAGE, PAGE, KVH, D, s=0.5)
    act_pages = rnd(B * cap // PAGE, PAGE, d, o=0.1)
    q = rnd(B, KVH, G, D)
    scale = rnd(d, s=0.1, o=1.0 if norm_type == "layernorm" else 0.0)
    bias = rnd(d, s=0.2) if norm_type == "layernorm" else None  # non-zero
    wk, wv = rnd(d, KVH, D, s=d ** -0.5), rnd(d, KVH, D, s=d ** -0.5)
    kv_tok = torch.tensor([40, 17, 96, 0], dtype=torch.int32, device="cuda")
    act_tok = torch.tensor([24, 47, 16, 70], dtype=torch.int32, device="cuda")
    n_kv = int(((kv_tok + PAGE - 1) // PAGE).sum())
    n_act = int(((act_tok + PAGE - 1) // PAGE).sum())
    # tables as wide as the most pages a request uses, as the engine sizes them
    pages_bound = int(((kv_tok + PAGE - 1) // PAGE
                       + (act_tok + PAGE - 1) // PAGE).max())
    tables = M.hybrid_page_table(kv_tok, act_tok, cap, cap, pages_bound)
    args = (q, k_pages, v_pages, act_pages, scale, bias, wk, wv, *tables)
    run = lambda f: f(*args, norm_type=norm_type)
    got = run(hybrid_paged_attention)
    want = run(hybrid_paged_attention_ref)
    torch.cuda.synchronize()
    err = (got.float() - want.float()).abs().max().item()
    ms = time_ms(lambda: run(hybrid_paged_attention), 50)
    plain_ms = time_ms(lambda: run(hybrid_paged_attention_ref), 10)
    esz = q.element_size()
    n_norm = 2 if bias is not None else 1
    nbytes = esz * (2 * q.numel() + n_kv * PAGE * KVH * D * 2
                    + n_act * PAGE * d + 2 * d * KVH * D + n_norm * d) \
        + 3 * 4 * B * pages_bound
    kv_t, act_t = int(kv_tok.sum()), int(act_tok.sum())
    ops = KVH * G * (kv_t + act_t) * 4.0 * D + act_t * KVH * 4.0 * d * D
    bound_ms, by = bound(nbytes, ops)
    return {"shape": {"B": B, "KVH": KVH, "G": G, "D": D, "d_model": d,
                      "kv_cap": cap, "act_cap": cap, "kv_tokens": kv_tok.tolist(),
                      "act_tokens": act_tok.tolist(), "pages_bound": pages_bound},
            "dtype": str(dtype).removeprefix("torch."), "norm_type": norm_type,
            "max_abs_err": err, "tol": KERNEL_TOL[dtype], "kernel_ms": ms,
            "plain_ms": plain_ms, "library_ms": None, "bound_ms": bound_ms,
            "bound_by": by}


def phase_kernels(results):
    """The serve path's shapes first (float16, MHA, LayerNorm, G=1), then the
    other branches the wrappers accept: bfloat16, GQA flash, and the hybrid
    kernel's rmsnorm with G=4 query heads per KV head."""
    out = {"phase": "kernels",
           "flash_attention": [
               check_flash(4, 80), check_flash(1, 2048),
               check_flash(4, 80, H=32, KVH=8, dtype=torch.bfloat16)],
           "hybrid_paged_attention": [
               check_hybrid(),
               check_hybrid(KVH=8, G=4, dtype=torch.bfloat16,
                            norm_type="rmsnorm")]}
    emit(out)
    results["kernels"] = out
    bad = [(name, c["shape"], c["dtype"], c["max_abs_err"])
           for name in ("flash_attention", "hybrid_paged_attention")
           for c in out[name] if not c["max_abs_err"] <= c["tol"]]
    if bad:
        raise AssertionError(f"kernel disagrees with its plain version: {bad}")


def teacher_forced(eng, params, cfg, group, oracle):
    """Per-step logits of the hybrid path fed the oracle's tokens, and the
    oracle's own per-step logits.  -> (hybrid (B, n, V), oracle (B, n, V))."""
    toks, kv_keep, pbs, sched, bound_ = eng.group_schedule(group)
    n = sched.shape[1]
    dev = lambda a: torch.from_numpy(np.asarray(a, np.int32)).cuda()
    gold = torch.from_numpy(np.stack([oracle[r.rid] for r in group])).cuda()
    lg, cache = M.hybrid_prefill_batched(params, cfg, dev(toks), eng.kv_cap,
                                         eng.act_cap, dev(kv_keep), dev(pbs))
    hyb = [lg[:, -1]]
    s_dev = torch.from_numpy(sched).cuda()
    for s in range(n - 1):
        lg, cache = M.hybrid_decode_step(params, cfg, gold[:, s:s + 1].int(),
                                         cache, s_dev[:, s], pages_bound=bound_)
        hyb.append(lg[:, -1])
    ora = []
    for i, r in enumerate(group):
        pb = pbs[i]
        lg, c = M.prefill(params, cfg, dev(toks[i:i + 1, :pb]), max_len=pb + n + 8)
        steps = [lg[:, -1]]
        for s in range(n - 1):
            lg, c = M.decode_step(params, cfg, gold[i:i + 1, s:s + 1].int(), c)
            steps.append(lg[:, -1])
        ora.append(torch.cat(steps, 0))
    return torch.stack(hyb, 1), torch.stack(ora, 0)


def phase_serve(results, smi):
    cfg = get_config("opt-6.7b")
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = M.init_params(cfg, seed=0, device="cuda")
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    reqs = request_trace(cfg.vocab_size, n_requests=4, prompt_mean=48,
                         gen_tokens=12, seed=7)
    out = {"phase": "serve", "card": smi, "model": cfg.name,
           "layers": cfg.num_layers, "d_model": cfg.d_model,
           "vocab_padded": M.pad_vocab(cfg.vocab_size), "dtype": cfg.dtype,
           "init_s": init_s, "prompt_lens": [len(r.prompt) for r in reqs]}

    eng = HybridServeEngine(cfg, params, mode="hybrid", hw=H100_SXM)
    groups = eng.plan_groups(reqs)
    splits = []
    for g in groups:
        _, kv_keep, pbs, _, _ = eng.group_schedule(g)
        splits += [{"rid": r.rid, "kv": int(k), "act": int(p - k)}
                   for r, k, p in zip(g, kv_keep, pbs)]
    out.update(act_frac=eng.act_frac, splits=splits, groups=len(groups))
    if not any(s["kv"] > 0 and s["act"] > 0 for s in splits):
        raise AssertionError(f"no request holds both KV and ACT tokens: {splits}")

    eng.generate(reqs)                                   # warm-up
    torch.cuda.synchronize()
    # the counted main-path run: counts start at 0 here
    flash_attention.launches = hybrid_paged_attention.launches = 0
    t0 = time.perf_counter()
    hyb, stats = eng.generate(reqs)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {"flash_attention": flash_attention.launches,
                "hybrid_paged_attention": hybrid_paged_attention.launches}
    steps = sum(max(r.max_new_tokens for r in g) for g in groups)
    want = {"flash_attention": cfg.num_layers * len(groups),
            "hybrid_paged_attention": cfg.num_layers * steps}
    if launches != want:
        raise AssertionError(f"launches {launches}, expected {want}")
    if any(p.allocated for p in eng.blockman.pools.values()):
        raise AssertionError("leaked blocks after the hybrid run")
    out.update(launches=launches, device_calls=stats.device_calls,
               hybrid_wall_s=wall, hybrid_tokens_per_s=stats.generated_tokens / wall)

    kv_eng = HybridServeEngine(cfg, params, mode="kv", hw=H100_SXM)
    kv_eng.generate(reqs)                                # warm-up
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    kv_out, kv_stats = kv_eng.generate(reqs)
    torch.cuda.synchronize()
    kv_wall = time.perf_counter() - t0
    out.update(kv_wall_s=kv_wall,
               kv_tokens_per_s=kv_stats.generated_tokens / kv_wall)
    if any(p.allocated for p in kv_eng.blockman.pools.values()):
        raise AssertionError("leaked blocks after the kv run")

    # no host sync inside the decode loop
    g0 = groups[0]
    toks, kv_keep, pbs, sched, bound_ = eng.group_schedule(g0)
    dev = lambda a: torch.from_numpy(np.asarray(a, np.int32)).cuda()
    lg, cache = M.hybrid_prefill_batched(params, cfg, dev(toks), eng.kv_cap,
                                         eng.act_cap, dev(kv_keep), dev(pbs))
    cur = lg[:, -1].argmax(-1).int()
    sched_dev = torch.from_numpy(np.ascontiguousarray(sched.T)).cuda()
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        loop_toks, _ = M.hybrid_decode_loop(params, cfg, cur, cache, sched_dev,
                                            pages_bound=bound_)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    loop_toks = loop_toks.cpu().numpy()
    for i, r in enumerate(g0):
        if not np.array_equal(loop_toks[i, :r.max_new_tokens], hyb[r.rid]):
            raise AssertionError(f"request {r.rid}: sync-checked loop differs")
    out["decode_loop_host_syncs"] = 0

    oracle = exact_reference_generate(cfg, params, reqs)
    exact, min_margin, max_dlogit = 0, math.inf, 0.0
    for g in groups:
        h_lg, o_lg = teacher_forced(eng, params, cfg, g, oracle)
        max_dlogit = max(max_dlogit, (h_lg - o_lg).abs().max().item())
        top2 = o_lg.topk(2, dim=-1).values
        margins = (top2[..., 0] - top2[..., 1]).cpu().numpy()     # (B, n)
        min_margin = min(min_margin, float(margins.min()))
        for i, r in enumerate(g):
            for name, got in (("hybrid", hyb), ("kv", kv_out)):
                diff = np.nonzero(got[r.rid] != oracle[r.rid])[0]
                if diff.size and margins[i, diff[0]] >= LOGIT_TOL:
                    raise AssertionError(
                        f"{name} request {r.rid} diverges at step {diff[0]} "
                        f"where the oracle's margin is {margins[i, diff[0]]}")
            exact += bool(np.array_equal(hyb[r.rid], oracle[r.rid]))
    if max_dlogit > LOGIT_TOL:
        raise AssertionError(f"teacher-forced logits differ by {max_dlogit}")
    out.update(exact_requests=exact, n_requests=len(reqs),
               kv_exact_requests=sum(bool(np.array_equal(kv_out[r.rid],
                                                         oracle[r.rid]))
                                     for r in reqs),
               max_teacher_forced_dlogit=max_dlogit, logit_tol=LOGIT_TOL,
               min_oracle_margin=min_margin,
               max_memory_allocated=torch.cuda.max_memory_allocated())
    emit(out)
    results["serve"] = out
    return launches, {"hybrid": eng, "kv": kv_eng}, reqs


def kernel_group(name: str) -> str:
    if "hybrid_attn_kernel" in name:
        return "hybrid_paged_attention"
    if "flash_fwd_kernel" in name:
        return "flash_attention"
    if any(w in name.lower() for w in ("gemm", "gemv", "cutlass", "xmma", "nvjet")):
        return "matmul (cuBLAS)"
    return "other (norms, elementwise, indexing, argmax)"


def phase_profile(results, smi, engines, reqs):
    """Per mode: device time by kernel over one warm ``generate`` of the trace
    (torch.profiler kernel events), the device's busy and idle share of the
    wall-clock window, and the kernels that took the most device time."""
    from torch.profiler import ProfilerActivity, profile
    out = {"phase": "profile", "card": smi}
    for mode, eng in engines.items():
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            eng.generate(reqs)
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3
        by_group, by_name = {}, {}
        for e in prof.events():
            if e.device_type != torch.autograd.DeviceType.CUDA:
                continue
            ms = e.time_range.elapsed_us() / 1e3
            g = kernel_group(e.name)
            by_group[g] = by_group.get(g, 0.0) + ms
            n, t = by_name.get(e.name, (0, 0.0))
            by_name[e.name] = (n + 1, t + ms)
        busy = sum(by_group.values())
        top = sorted(by_name.items(), key=lambda kv: -kv[1][1])[:8]
        out[mode] = {
            "wall_ms": wall_ms, "device_events": sum(n for n, _ in by_name.values()),
            "device_busy_ms": busy,
            "device_idle_share": 1.0 - busy / wall_ms if by_name else None,
            "device_ms_by_kernel": dict(sorted(by_group.items(),
                                               key=lambda kv: -kv[1])),
            "top_kernels": [{"name": name[:90], "calls": n, "ms": t}
                            for name, (n, t) in top]}
    emit(out)
    results["profile"] = out


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    results = {}
    smi = phase_env(results)
    phase_build(results)
    phase_kernels(results)
    launches, engines, reqs = phase_serve(results, smi)
    phase_profile(results, smi, engines, reqs)
    k = results["kernels"]
    rows = []
    for name, cases, src, tpu in (
            ("flash_attention", k["flash_attention"],
             "src/repro_torch/kernels/flash_attention/csrc/flash_attention.cu",
             "src/repro/kernels/flash_attention/kernel.py:84"),
            ("hybrid_paged_attention", k["hybrid_paged_attention"],
             "src/repro_torch/kernels/hybrid_attention/csrc/hybrid_attention.cu",
             "src/repro/kernels/hybrid_attention/kernel.py:165")):
        c = cases[0]                      # the serve path's own shape first
        rows.append({"name": name, "route": "cuda", "source": src,
                     "replaces": tpu, "launches": launches[name],
                     "max_abs_err": c["max_abs_err"], "tol": c["tol"],
                     "ms": c["kernel_ms"], "kernel_ms": c["kernel_ms"],
                     "plain_ms": c["plain_ms"],
                     "bound_ms": c["bound_ms"], "bound_by": c["bound_by"],
                     "library_ms": c["library_ms"]})
    out_dir = ROOT / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    (out_dir / "chip_smoke.json").write_text(json.dumps(results, indent=1))
    emit({"kernels": rows})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
