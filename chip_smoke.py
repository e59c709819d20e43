"""Chip smoke test of the PyTorch/CUDA port on one NVIDIA H100.

    python3 chip_smoke.py

Builds the port's CUDA kernels from this checkout (``nvcc``, sm_90a), holds
each kernel against its plain PyTorch version at the main paths' shapes, then
serves two models at full width and full depth (random weights from a seed)
through ``HybridServeEngine`` in hybrid and kv modes and checks the tokens
against ``exact_reference_generate``: opt-6.7b (learned positions; the fused
hybrid kernel recomputes ACT pages' K/V) and then yi-6b (RoPE, GQA, SwiGLU;
the ``kv_gen`` kernel recomputes them, the hybrid kernel's second-pool mode
attends).  Each path runs with the launch counts set to 0 just before it and
read just after.  One JSON line per phase; the line before the last lists
every kernel with its launches on its serve path, error, times and bound; the
last line is the device summary.  Any failure raises and the exit code is
non-zero.  Without a CUDA device, or outside a checkout of the repo, it fails
before printing any result.  Details also go to ``chiprun_out/chip_smoke.json``.
"""
from __future__ import annotations

import gc
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
from repro_torch.kernels.hybrid_attention.ops import (  # noqa: E402
    hybrid_paged_attention, hybrid_paged_attention_two_pool)
from repro_torch.kernels.hybrid_attention.ref import (  # noqa: E402
    hybrid_paged_attention_ref, hybrid_paged_attention_two_pool_ref)
from repro_torch.kernels.kv_gen.ops import kv_gen  # noqa: E402
from repro_torch.kernels.kv_gen.ref import kv_gen_ref  # noqa: E402
from repro_torch.models import layers as L  # noqa: E402
from repro_torch.models import model as M  # noqa: E402
from repro_torch.serving import HybridServeEngine, exact_reference_generate  # noqa: E402
from repro_torch.serving.util import bucket  # noqa: E402

# H100 SXM data sheet: dense fp16
# tensor-core rate and HBM3 bandwidth, at the full 700 W power limit
PEAK_FP16_FLOPS = 989e12
PEAK_BYTES_PER_S = 3.35e12
PAGE = 16
# kernel vs plain version: each output is a float32 sum, taken in another
# order, rounded to the dtype, and the fused kernel and kv_gen round the
# recomputed K/V on the way where the plain versions do; the two differ by a
# few ulps of the largest output, so the limit is 4 ulps of the dtype at
# max|plain| (float16 keeps 10 mantissa bits, bfloat16 7)
TOL_ULPS = 4
MANTISSA_BITS = {torch.float16: 10, torch.bfloat16: 7}
# teacher-forced hybrid vs oracle logits: recomputed K/V and the two attention
# paths differ by float16 ulps (up to 2**-9 at |x| < 1) per layer; 32 residual
# layers and a 4096-deep unembedding keep the drift of unit-scale logits
# within a few hundredths, so 0.1 leaves headroom without hiding a wrong page
LOGIT_TOL = 0.1
# bfloat16 (yi-6b): unit-RMS final rows against a d**-0.5 unembedding give
# logits of about N(0, 1).  Each of the 32 layers rounds its residual update,
# attention output and recomputed K/V to bfloat16 (2**-9 relative) in another
# order than the oracle, so the final row drifts as a random walk of
# sqrt(32) * 2**-9 * (about 3 roundings) ~ 3% of its scale; the largest of
# 64000 x 4 x 12 logit deviations is ~4.5 sigma of that, ~0.13.  The limit is
# twice that.  A wrong route must fail it: the serve phase also reads the
# gap with the ACT keys left unrotated and rotated one position late, and
# fails unless both readings exceed the limit.
LOGIT_TOL_BY_DTYPE = {"float16": LOGIT_TOL, "bfloat16": 0.25}
TRACE = dict(n_requests=4, prompt_mean=48, gen_tokens=12, seed=7)
# kernel -> (its source, the TPU kernel it replaces)
_HYBRID = ("src/repro_torch/kernels/hybrid_attention/csrc/hybrid_attention.cu",
           "src/repro/kernels/hybrid_attention/kernel.py:165")
KERNELS = {
    "flash_attention": (
        "src/repro_torch/kernels/flash_attention/csrc/flash_attention.cu",
        "src/repro/kernels/flash_attention/kernel.py:84"),
    "hybrid_paged_attention": _HYBRID,
    "hybrid_paged_attention_two_pool": _HYBRID,
    "kv_gen": ("src/repro_torch/kernels/kv_gen/csrc/kv_gen.cu",
               "src/repro/kernels/kv_gen/kernel.py:46"),
}
# the launch counters, one per kernel wrapper
COUNTERS = {"flash_attention": flash_attention,
            "hybrid_paged_attention": hybrid_paged_attention,
            "hybrid_paged_attention_two_pool": hybrid_paged_attention_two_pool,
            "kv_gen": kv_gen}


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


def kernel_tol(*want) -> tuple[float, float]:
    """-> (limit, max|want|): TOL_ULPS ulps of the dtype at the largest
    output of the plain version."""
    top = max(w.float().abs().max().item() for w in want)
    ulp = 2.0 ** (math.floor(math.log2(top)) - MANTISSA_BITS[want[0].dtype])
    return TOL_ULPS * ulp, top


def drop_last_page(act_tok):
    """A planted fault: each request's ACT tokens without its last page."""
    return torch.where(act_tok > 0, (act_tok - 1) // PAGE * PAGE, 0).int()


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
    tol, top = kernel_tol(want)
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
            "tol": tol, "max_abs_out": top, "kernel_ms": ms,
            "plain_ms": plain_ms, "library_ms": lib_ms, "bound_ms": bound_ms,
            "bound_by": by}


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
    args = (q, k_pages, v_pages, act_pages, scale, bias, wk, wv)
    run = lambda f, tabs=tables: f(*args, *tabs, norm_type=norm_type)
    got = run(hybrid_paged_attention)
    want = run(hybrid_paged_attention_ref)
    faulty = run(hybrid_paged_attention, M.hybrid_page_table(
        kv_tok, drop_last_page(act_tok), cap, cap, pages_bound))
    torch.cuda.synchronize()
    err = (got.float() - want.float()).abs().max().item()
    fault_err = (faulty.float() - want.float()).abs().max().item()
    tol, top = kernel_tol(want)
    ms = time_ms(lambda: run(hybrid_paged_attention), 50)
    plain_ms = time_ms(lambda: run(hybrid_paged_attention_ref), 10)
    esz = q.element_size()
    n_norm = 2 if bias is not None else 1
    kv_t, act_t = int(kv_tok.sum()), int(act_tok.sum())
    # each valid token's K/V or checkpoint read once (not whole pages)
    nbytes = esz * (2 * q.numel() + kv_t * KVH * D * 2 + act_t * d
                    + 2 * d * KVH * D + n_norm * d) + 3 * 4 * B * pages_bound
    ops = KVH * G * (kv_t + act_t) * 4.0 * D + act_t * KVH * 4.0 * d * D
    bound_ms, by = bound(nbytes, ops)
    return {"shape": {"B": B, "KVH": KVH, "G": G, "D": D, "d_model": d,
                      "kv_cap": cap, "act_cap": cap, "kv_tokens": kv_tok.tolist(),
                      "act_tokens": act_tok.tolist(), "pages_bound": pages_bound},
            "dtype": str(dtype).removeprefix("torch."), "norm_type": norm_type,
            "max_abs_err": err, "tol": tol, "max_abs_out": top,
            "fault_err_last_act_page_dropped": fault_err, "kernel_ms": ms,
            "plain_ms": plain_ms, "library_ms": None, "bound_ms": bound_ms,
            "bound_by": by}


def serve_shape(cfg) -> dict:
    """The shapes the yi serve path gives its decode kernels: the engine's
    plan of the trace's first group at its last decode step (the widest),
    computed on the host without weights."""
    eng = HybridServeEngine(cfg, None, mode="hybrid", hw=H100_SXM)
    reqs = request_trace(cfg.vocab_size, **TRACE)
    _, kv_keep, pbs, sched, pages_bound, act_bound = \
        eng.group_schedule(eng.plan_groups(reqs)[0])
    return {"B": len(pbs), "act_cap": eng.act_cap, "kv_cap": eng.kv_cap,
            "kv_tokens": (kv_keep + (~sched).sum(1)).tolist(),
            "act_tokens": (np.asarray(pbs) - kv_keep + sched.sum(1)).tolist(),
            "pages_bound": pages_bound, "act_pages_bound": act_bound}


def check_kv_gen(B, n_act, d, KVH, hd=128, act_cap=512, dtype=torch.bfloat16,
                 norm_type="rmsnorm", theta=5e6):
    """kv_gen over each of B requests' first ``n_act`` ACT pages, read in
    place from a pool of ``act_cap`` tokens per request, with RoPE at
    scattered positions."""
    g = torch.Generator(device="cuda").manual_seed(2)
    rnd = lambda *shape, s=1.0, o=0.0: (torch.randn(
        shape, generator=g, device="cuda") * s + o).to(dtype)
    pool = rnd(B * act_cap // PAGE, PAGE, d, o=0.1)
    ln = norm_type == "layernorm"
    scale = rnd(d, s=0.1, o=1.0 if ln else 0.0)
    bias = rnd(d, s=0.2) if ln else None                  # non-zero
    wk, wv = rnd(d, KVH, hd, s=d ** -0.5), rnd(d, KVH, hd, s=d ** -0.5)
    idx = (torch.arange(B, device="cuda")[:, None] * (act_cap // PAGE)
           + torch.arange(n_act, device="cuda")[None]).reshape(-1).int()
    N = idx.numel()
    pos = torch.randint(0, 4096, (N, PAGE), generator=g, device="cuda")
    sin, cos = L.rope_sin_cos(pos, hd, theta)
    eps = L.NORM_EPS[norm_type]
    run = lambda f: f(pool, scale, bias, wk, wv, page_index=idx, sin=sin,
                      cos=cos, norm_type=norm_type, eps=eps)
    got, want = run(kv_gen), run(kv_gen_ref)
    torch.cuda.synchronize()
    err = max((a.float() - b.float()).abs().max().item()
              for a, b in zip(got, want))
    tol, top = kernel_tol(*want)
    # the library call: one GEMM of the normed rows against [wk | wv],
    # normed and gathered before the timing ("GEMM only")
    a = L.layer_norm(pool[idx.long()], scale, bias, eps) if ln \
        else L.rms_norm(pool[idx.long()], scale, eps)
    a = a.reshape(N * PAGE, d)
    w = torch.cat([wk.reshape(d, -1), wv.reshape(d, -1)], 1)
    ms = time_ms(lambda: run(kv_gen), 50)
    plain_ms = time_ms(lambda: run(kv_gen_ref), 10)
    lib_ms = time_ms(lambda: torch.matmul(a, w), 50)
    esz, M = pool.element_size(), N * PAGE
    nbytes = esz * (M * d + 2 * d * KVH * hd + (2 if ln else 1) * d
                    + 2 * M * KVH * hd) + 4 * (N + 2 * M * hd // 2)
    ops = 4.0 * M * d * KVH * hd + 5.0 * M * d + 3.0 * M * KVH * hd
    bound_ms, by = bound(nbytes, ops)
    return {"shape": {"pages": N, "B": B, "act_pages_per_request": n_act,
                      "d_model": d, "KVH": KVH, "hd": hd, "act_cap": act_cap,
                      "rope_theta": theta},
            "dtype": str(dtype).removeprefix("torch."), "norm_type": norm_type,
            "max_abs_err": err, "tol": tol, "max_abs_out": top, "kernel_ms": ms,
            "plain_ms": plain_ms, "library_ms": lib_ms,
            "library": "torch.matmul of the normed rows against [wk|wv], "
                       "GEMM only", "bound_ms": bound_ms, "bound_by": by}


def check_two_pool(shape, KVH=4, G=8, D=128, dtype=torch.bfloat16):
    """The hybrid kernel's second-pool mode at the yi serve path's last-step
    tables: KV pages of (B, kv_cap) regions, ACT entries in a scratch pool of
    ``act_pages_bound`` pages per request."""
    g = torch.Generator(device="cuda").manual_seed(3)
    B, kv_cap, n_act = shape["B"], shape["kv_cap"], shape["act_pages_bound"]
    rnd = lambda *sh: (torch.randn(sh, generator=g, device="cuda") * 0.5).to(dtype)
    k_pages, v_pages = rnd(B * kv_cap // PAGE, PAGE, KVH, D), \
        rnd(B * kv_cap // PAGE, PAGE, KVH, D)
    ak, av = rnd(B * n_act, PAGE, KVH, D), rnd(B * n_act, PAGE, KVH, D)
    q = rnd(B, KVH, G, D)
    kv_tok, act_tok = (torch.tensor(shape[k], dtype=torch.int32, device="cuda")
                       for k in ("kv_tokens", "act_tokens"))
    table = lambda act: M.hybrid_page_table(kv_tok, act, kv_cap, n_act * PAGE,
                                            shape["pages_bound"])
    args = (q, k_pages, v_pages, ak, av, *table(act_tok))
    got = hybrid_paged_attention_two_pool(*args)
    want = hybrid_paged_attention_two_pool_ref(*args)
    faulty = hybrid_paged_attention_two_pool(*args[:5],
                                             *table(drop_last_page(act_tok)))
    torch.cuda.synchronize()
    err = (got.float() - want.float()).abs().max().item()
    fault_err = (faulty.float() - want.float()).abs().max().item()
    tol, top = kernel_tol(want)
    # the library call: scaled_dot_product_attention over the same K/V,
    # gathered into (B, H, S, D) with K/V expanded to the H query heads and
    # a mask of the valid tokens, made before the timing
    kv_t, act_t = kv_tok.long(), act_tok.long()
    S = int((kv_t + act_t).max())
    kd = torch.zeros((B, S, KVH, D), dtype=dtype, device="cuda")
    vd = torch.zeros_like(kd)
    for b in range(B):
        nk, na = int(kv_t[b]), int(act_t[b])
        pk = k_pages.view(B, -1, KVH, D)[b, :nk]
        pv = v_pages.view(B, -1, KVH, D)[b, :nk]
        kd[b, :nk], vd[b, :nk] = pk, pv
        kd[b, nk:nk + na] = ak.view(B, -1, KVH, D)[b, :na]
        vd[b, nk:nk + na] = av.view(B, -1, KVH, D)[b, :na]
    mask = (torch.arange(S, device="cuda")[None] < (kv_t + act_t)[:, None])
    mask = mask[:, None, None, :]
    qt = q.reshape(B, KVH * G, 1, D)
    kt, vt = (x.transpose(1, 2).repeat_interleave(G, dim=1).contiguous()
              for x in (kd, vd))
    lib = F.scaled_dot_product_attention(qt, kt, vt, attn_mask=mask)
    lib_err = (lib.reshape(B, KVH, G, D).float() - want.float()).abs().max().item()
    ms = time_ms(lambda: hybrid_paged_attention_two_pool(*args), 50)
    plain_ms = time_ms(lambda: hybrid_paged_attention_two_pool_ref(*args), 10)
    lib_ms = time_ms(lambda: F.scaled_dot_product_attention(
        qt, kt, vt, attn_mask=mask), 50)
    esz = q.element_size()
    n_tok = int((kv_t + act_t).sum())     # each valid token's K/V read once
    nbytes = esz * (2 * q.numel() + n_tok * KVH * D * 2) \
        + 3 * 4 * B * shape["pages_bound"]
    ops = KVH * G * n_tok * 4.0 * D
    bound_ms, by = bound(nbytes, ops)
    return {"shape": dict(shape, KVH=KVH, G=G, D=D),
            "dtype": str(dtype).removeprefix("torch."), "max_abs_err": err,
            "tol": tol, "max_abs_out": top,
            "fault_err_last_act_page_dropped": fault_err,
            "library_err": lib_err, "kernel_ms": ms,
            "plain_ms": plain_ms, "library_ms": lib_ms, "bound_ms": bound_ms,
            "bound_by": by}


def phase_kernels(results):
    """Per kernel, the serve path's shapes first: opt-6.7b's (float16, MHA,
    LayerNorm, G=1), then yi-6b's (bfloat16, G=8: flash prefill, kv_gen and
    the second-pool mode at the engine's planned shapes), then other
    branches the wrappers accept: GQA flash at G=4, the fused kernel's
    rmsnorm, and kv_gen at minitron-4b's widths with a LayerNorm bias."""
    yi = get_config("yi-6b")
    shape = serve_shape(yi)
    bf16 = torch.bfloat16
    out = {"phase": "kernels", "yi_serve_shape": shape,
           "flash_attention": [
               check_flash(4, 80), check_flash(1, 2048),
               check_flash(4, 80, H=32, KVH=8, dtype=bf16),
               check_flash(4, 80, H=32, KVH=4, dtype=bf16),
               check_flash(1, 2048, H=32, KVH=4, dtype=bf16)],
           "hybrid_paged_attention": [
               check_hybrid(),
               check_hybrid(KVH=8, G=4, dtype=bf16, norm_type="rmsnorm")],
           "hybrid_paged_attention_two_pool": [check_two_pool(shape)],
           "kv_gen": [
               check_kv_gen(shape["B"], shape["act_pages_bound"], yi.d_model,
                            yi.num_kv_heads),
               check_kv_gen(shape["B"], shape["act_pages_bound"], 3072, 8,
                            dtype=torch.float16, norm_type="layernorm",
                            theta=1e4)]}
    emit(out)
    results["kernels"] = out
    bad = [(name, c["shape"], c["dtype"], c["max_abs_err"], c["tol"])
           for name in KERNELS for c in out[name]
           if not c["max_abs_err"] <= c["tol"]]
    if bad:
        raise AssertionError(f"kernel disagrees with its plain version: {bad}")
    # the limit must catch a planted fault: the hybrid kernels given tables
    # that leave out each request's last ACT page
    blind = [(name, c["shape"], c["fault_err_last_act_page_dropped"], c["tol"])
             for name in ("hybrid_paged_attention",
                          "hybrid_paged_attention_two_pool") for c in out[name]
             if not c["fault_err_last_act_page_dropped"] > c["tol"]]
    if blind:
        raise AssertionError(f"the limit passes a dropped ACT page: {blind}")


def forced_logits(eng, params, cfg, group, gold):
    """Per-step logits of the engine's decode path over ``group`` fed the
    oracle's tokens ``gold`` (B, n) -> (B, n, V)."""
    toks, kv_keep, pbs, sched, bound_, act_bound = eng.group_schedule(group)
    dev = lambda a: torch.from_numpy(np.asarray(a, np.int32)).cuda()
    lg, cache = M.hybrid_prefill_batched(params, cfg, dev(toks), eng.kv_cap,
                                         eng.act_cap, dev(kv_keep), dev(pbs))
    out = [lg[:, -1]]
    s_dev = torch.from_numpy(sched).cuda()
    for s in range(gold.shape[1] - 1):
        lg, cache = M.hybrid_decode_step(params, cfg, gold[:, s:s + 1].int(),
                                         cache, s_dev[:, s], pages_bound=bound_,
                                         act_pages_bound=act_bound)
        out.append(lg[:, -1])
    return torch.stack(out, 1)


def oracle_logits(params, cfg, prompt, gold):
    """The oracle's own per-step logits fed its tokens ``gold`` (n,) ->
    (n, V).  The prompt is padded to its bucket with its last token, as
    ``exact_reference_generate`` pads it."""
    padded = np.full(bucket(len(prompt)), prompt[-1], np.int32)
    padded[:len(prompt)] = prompt
    toks = torch.from_numpy(padded).cuda()[None]
    n = gold.shape[0]
    lg, c = M.prefill(params, cfg, toks, max_len=toks.shape[1] + n + 8)
    steps = [lg[:, -1]]
    for s in range(n - 1):
        lg, c = M.decode_step(params, cfg, gold[None, s:s + 1].int(), c)
        steps.append(lg[:, -1])
    return torch.cat(steps, 0)


def check_tokens(engines, outs, params, cfg, reqs, logit_tol):
    """Each mode's tokens and teacher-forced logits against the oracle's.
    A mode's logit gap must stay within ``logit_tol``, and a request may
    leave the oracle's tokens only at a step where the oracle's top-2 margin
    is within ``logit_tol`` and within twice the mode's own gap at that step
    (no smaller gap can swap the top two).  -> per-mode readings."""
    oracle = exact_reference_generate(cfg, params, reqs)
    gold = {r.rid: torch.from_numpy(oracle[r.rid]).cuda() for r in reqs}
    ora = {r.rid: oracle_logits(params, cfg, r.prompt, gold[r.rid]) for r in reqs}
    margin = {}
    for rid, lg in ora.items():
        top2 = lg.topk(2, dim=-1).values
        margin[rid] = (top2[:, 0] - top2[:, 1]).cpu().numpy()
    out = {"min_oracle_margin": float(min(m.min() for m in margin.values()))}
    for mode, eng in engines.items():
        gap, exact, diverged = 0.0, 0, []
        for g in eng.plan_groups(reqs):
            lg = forced_logits(eng, params, cfg, g,
                               torch.stack([gold[r.rid] for r in g]))
            for i, r in enumerate(g):
                step_gap = (lg[i] - ora[r.rid]).abs().amax(-1).cpu().numpy()
                gap = max(gap, float(step_gap.max()))
                diff = np.nonzero(outs[mode][r.rid] != oracle[r.rid])[0]
                if not diff.size:
                    exact += 1
                    continue
                s, m = int(diff[0]), float(margin[r.rid][diff[0]])
                diverged.append({"rid": r.rid, "step": s, "oracle_margin": m,
                                 "step_gap": float(step_gap[s])})
                if not (m <= logit_tol and m <= 2 * step_gap[s]):
                    raise AssertionError(f"{mode} request {r.rid} diverges: "
                                         f"{diverged[-1]}")
        if gap > logit_tol:
            raise AssertionError(f"{mode} teacher-forced logits differ by {gap}")
        out[mode] = {"exact_requests": exact, "max_teacher_forced_dlogit": gap,
                     "diverged": diverged}
    return out, gold, ora


def fault_gaps(eng, params, cfg, group, gold, ora, logit_tol):
    """Teacher-forced logit gaps of the RoPE hybrid route with a planted
    fault in the recomputed ACT keys: left unrotated, or rotated one
    position late.  Each must exceed ``logit_tol``, or the limit could not
    tell a wrong route from a sound one."""
    real = M._act_kv

    def unrotated(*a):
        x = real(*a)
        return x._replace(sin=torch.zeros_like(x.sin), cos=torch.ones_like(x.cos))

    def late(cfg_, cache, ctx, n_act):
        return real(cfg_, dict(cache, act_pos=cache["act_pos"] + 1), ctx, n_act)

    gold_g = torch.stack([gold[r.rid] for r in group])
    want = torch.stack([ora[r.rid] for r in group])
    gaps = {}
    for name, fault in (("act_k_unrotated", unrotated),
                        ("act_k_one_position_late", late)):
        M._act_kv = fault
        try:
            lg = forced_logits(eng, params, cfg, group, gold_g)
        finally:
            M._act_kv = real
        gaps[name] = (lg - want).abs().max().item()
    if not all(g > logit_tol for g in gaps.values()):
        raise AssertionError(f"the logit limit {logit_tol} passes a wrong "
                             f"route: {gaps}")
    return gaps


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    else:
        yield tree


def reset_counts() -> None:
    for fn in COUNTERS.values():
        fn.launches = 0


def read_counts() -> dict:
    return {name: fn.launches for name, fn in COUNTERS.items()}


def phase_serve(results, smi, name):
    """Serve the trace at full width and depth in hybrid and kv modes; check
    launches per prefill and per decode step, host syncs in the decode loop,
    leaked blocks and tokens against the oracle."""
    cfg = get_config(name)
    rope = cfg.pos_type == "rope"
    hybrid_kernel = "hybrid_paged_attention_two_pool" if rope \
        else "hybrid_paged_attention"
    logit_tol = LOGIT_TOL_BY_DTYPE[cfg.dtype]
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = M.init_params(cfg, seed=0, device="cuda")
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    reqs = request_trace(cfg.vocab_size, **TRACE)
    out = {"phase": "serve", "card": smi, "model": cfg.name,
           "layers": cfg.num_layers, "d_model": cfg.d_model,
           "heads": cfg.num_heads, "kv_heads": cfg.num_kv_heads,
           "pos_type": cfg.pos_type, "vocab_padded": M.pad_vocab(cfg.vocab_size),
           "dtype": cfg.dtype, "params": sum(
               t.numel() for t in _leaves(params)),
           "init_s": init_s, "prompt_lens": [len(r.prompt) for r in reqs]}

    eng = HybridServeEngine(cfg, params, mode="hybrid", hw=H100_SXM)
    groups = eng.plan_groups(reqs)
    splits = []
    for g in groups:
        _, kv_keep, pbs, *_ = eng.group_schedule(g)
        splits += [{"rid": r.rid, "kv": int(k), "act": int(p - k)}
                   for r, k, p in zip(g, kv_keep, pbs)]
    out.update(act_frac=eng.act_frac, splits=splits, groups=len(groups))
    if not all(s["kv"] > 0 and s["act"] > 0 for s in splits):
        raise AssertionError(f"a request lacks KV or ACT tokens: {splits}")

    def expected(engine, act: bool) -> dict:
        """Launches of one generate: a flash launch per layer and prefill
        (one per group), a hybrid (and, for RoPE with ACT pages, a kv_gen)
        launch per layer and decode step.  Each mode plans its own groups."""
        plan = engine.plan_groups(reqs)
        steps = sum(max(r.max_new_tokens for r in g) for g in plan)
        want = {k: 0 for k in COUNTERS}
        want["flash_attention"] = cfg.num_layers * len(plan)
        want[hybrid_kernel] = cfg.num_layers * steps
        if rope and act:
            want["kv_gen"] = cfg.num_layers * steps
        return want

    want = expected(eng, act=True)
    eng.generate(reqs)                                   # warm-up
    torch.cuda.synchronize()
    reset_counts()               # the counted main-path run: counts start at 0
    t0 = time.perf_counter()
    hyb, stats = eng.generate(reqs)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = read_counts()
    if launches != want:
        raise AssertionError(f"hybrid launches {launches}, expected {want}")
    if any(p.allocated for p in eng.blockman.pools.values()):
        raise AssertionError("leaked blocks after the hybrid run")
    out.update(launches=launches, device_calls=stats.device_calls,
               hybrid_wall_s=wall, hybrid_tokens_per_s=stats.generated_tokens / wall)

    kv_eng = HybridServeEngine(cfg, params, mode="kv", hw=H100_SXM)
    kv_eng.generate(reqs)                                # warm-up
    torch.cuda.synchronize()
    reset_counts()
    t0 = time.perf_counter()
    kv_out, kv_stats = kv_eng.generate(reqs)
    torch.cuda.synchronize()
    kv_wall = time.perf_counter() - t0
    kv_launches = read_counts()
    want_kv = expected(kv_eng, act=False)   # no ACT page: kv_gen never runs
    if kv_launches != want_kv:
        raise AssertionError(f"kv launches {kv_launches}, expected {want_kv}")
    out.update(kv_launches=kv_launches, kv_groups=len(kv_eng.plan_groups(reqs)),
               kv_wall_s=kv_wall,
               kv_tokens_per_s=kv_stats.generated_tokens / kv_wall)
    if any(p.allocated for p in kv_eng.blockman.pools.values()):
        raise AssertionError("leaked blocks after the kv run")

    # no host sync inside the decode loop
    g0 = groups[0]
    toks, kv_keep, pbs, sched, bound_, act_bound = eng.group_schedule(g0)
    dev = lambda a: torch.from_numpy(np.asarray(a, np.int32)).cuda()
    lg, cache = M.hybrid_prefill_batched(params, cfg, dev(toks), eng.kv_cap,
                                         eng.act_cap, dev(kv_keep), dev(pbs))
    cur = lg[:, -1].argmax(-1).int()
    sched_dev = torch.from_numpy(np.ascontiguousarray(sched.T)).cuda()
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        loop_toks, _ = M.hybrid_decode_loop(params, cfg, cur, cache, sched_dev,
                                            pages_bound=bound_,
                                            act_pages_bound=act_bound)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    loop_toks = loop_toks.cpu().numpy()
    for i, r in enumerate(g0):
        if not np.array_equal(loop_toks[i, :r.max_new_tokens], hyb[r.rid]):
            raise AssertionError(f"request {r.rid}: sync-checked loop differs")
    out["decode_loop_host_syncs"] = 0

    tokens, gold, ora = check_tokens({"hybrid": eng, "kv": kv_eng},
                                     {"hybrid": hyb, "kv": kv_out},
                                     params, cfg, reqs, logit_tol)
    out.update(tokens, n_requests=len(reqs), logit_tol=logit_tol,
               exact_requests=tokens["hybrid"]["exact_requests"],
               kv_exact_requests=tokens["kv"]["exact_requests"],
               max_teacher_forced_dlogit=tokens["hybrid"]["max_teacher_forced_dlogit"])
    if rope:
        out["fault_dlogit"] = fault_gaps(eng, params, cfg, groups[0], gold,
                                         ora, logit_tol)
    out["max_memory_allocated"] = torch.cuda.max_memory_allocated()
    emit(out)
    results[f"serve {name}"] = out
    return launches, {"hybrid": eng, "kv": kv_eng}, reqs


def kernel_group(name: str) -> str:
    if "hybrid_attn_kernel" in name:
        return "hybrid_paged_attention"
    if "flash_fwd_kernel" in name:
        return "flash_attention"
    if "kv_gen_kernel" in name:
        return "kv_gen"
    if any(w in name.lower() for w in ("gemm", "gemv", "cutlass", "xmma", "nvjet")):
        return "matmul (cuBLAS)"
    return "other (norms, elementwise, indexing, argmax)"


def phase_profile(results, smi, name, engines, reqs):
    """Per mode: device time by kernel over one warm ``generate`` of the trace
    (torch.profiler kernel events), the device's busy and idle share of the
    wall-clock window, and the kernels that took the most device time."""
    from torch.profiler import ProfilerActivity, profile
    out = {"phase": "profile", "card": smi, "model": name}
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
            "top_kernels": [{"name": n_[:90], "calls": n, "ms": t}
                            for n_, (n, t) in top]}
    emit(out)
    results[f"profile {name}"] = out


def serve_path(results, smi, name) -> dict:
    """Serve and profile one model, then free its weights, so that peak
    device memory is one model's.  -> its hybrid run's launch counts."""
    launches, engines, reqs = phase_serve(results, smi, name)
    phase_profile(results, smi, name, engines, reqs)
    del engines
    gc.collect()
    torch.cuda.empty_cache()
    return launches


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
    by_path = {name: serve_path(results, smi, name)
               for name in ("opt-6.7b", "yi-6b")}
    # each kernel's launches on the serve path that carries it: the fused
    # hybrid kernel on OPT's, the second-pool mode and kv_gen on yi's;
    # flash_attention runs on both and reports OPT's, with both beside it
    path_of = {"flash_attention": "opt-6.7b",
               "hybrid_paged_attention": "opt-6.7b",
               "hybrid_paged_attention_two_pool": "yi-6b", "kv_gen": "yi-6b"}
    k = results["kernels"]
    rows = []
    for name, (src, tpu) in KERNELS.items():
        c = k[name][0]                    # the serve path's own shape first
        rows.append({"name": name, "route": "cuda", "source": src,
                     "replaces": tpu, "path": path_of[name],
                     "launches": by_path[path_of[name]][name],
                     "launches_by_path": {p: n[name] for p, n in by_path.items()},
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
