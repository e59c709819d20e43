"""Hardware spec + cost functions + sampling-based linear regression (§4.3).

A copy of ``repro.core.costmodel`` (the port imports nothing from the JAX
package) with one addition: ``H100_SXM``, the port's default target.
``scale_for_shards`` prices a tensor-parallel group as one aggregate
machine; the inter-chip terms are left to the slice that uses them.
``quant=`` prices the host link's and the host lane's bytes by the quantized
block layout (``core.quant``); ``cpu=`` adds the host-attention lane.  The
online refit (``LaneSample``, ``fit_samples``, ``damp_fit``, ``ewma_refit``)
is the adaptive controller's.

The paper profiles ``T_kv_gen`` and ``T_load_kv`` on the target machine and
fits linear functions (R² = 0.99, Fig. 11).  We do the same: the "profiler"
samples an analytic machine model, and the policy consumes only the fitted
linear coefficients — exactly the information the paper's policy has.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Callable, Sequence, Tuple

import numpy as np

from repro_torch.configs.base import ModelConfig
from repro_torch.core.quant import act_bytes_per_token, kv_bytes_per_token


@dataclass(frozen=True)
class HardwareSpec:
    name: str
    flops: float            # peak dense FLOP/s (bf16/fp16)
    hbm_bw: float           # device-memory bandwidth, B/s
    host_link_bw: float     # host <-> device interconnect, B/s
    device_mem: float       # device memory capacity, bytes
    host_mem: float         # host memory capacity, bytes
    mfu: float = 0.45       # achievable fraction of peak for dense matmuls
    # KV-gen runs skinny per-block (16-token) GEMMs; its achievable fraction
    # of peak is far below the batched forward's (paper Fig. 6 breakdown).
    gen_mfu: float = 0.25
    # Scattered paged-block gathers (16-token KV/ACT pages strewn across host
    # memory) reach a fraction of the streaming DMA bandwidth; weight streams
    # are contiguous and get the full link.  Measured fractions for pinned
    # scatter-gather DMA land near 0.4-0.6 on PCIe 4.0.
    gather_eff: float = 0.5
    # Host-side cost of one dispatch plus its blocking sync, serialized on
    # the serving critical path: the tax the continuous-batching server
    # amortizes over ``chunk_steps`` iterations and adds to its sim_time.
    dispatch_overhead: float = 40e-6
    # Host-compute attention lane: peak host FLOP/s across all cores and host
    # DRAM bandwidth.  Like ``host_mem`` these describe the ONE shared host.
    # Defaults are a mid-range server CPU (~32 cores AVX-512, 8-ch DDR).
    host_flops: float = 2e12
    host_dram_bw: float = 150e9
    # Achievable fraction of host peak for the decode-attention GEMV shape
    # (bandwidth-bound, numpy single-stream): far below the device's mfu.
    host_mfu: float = 0.25


# The paper's evaluation machine (RTX 4090 on PCIe 4.0); its figures'
# examples price their schedules on it.
RTX4090 = HardwareSpec(
    name="rtx4090-pcie4",
    flops=330e12,
    hbm_bw=1008e9,
    host_link_bw=32e9,
    device_mem=24 * 2**30,
    host_mem=882 * 2**30,
    mfu=0.5,
    gen_mfu=0.25,
    gather_eff=0.4,
)

# The reproduction target: one TPU v5e chip, host offload over PCIe DMA.
TPU_V5E = HardwareSpec(
    name="tpu-v5e",
    flops=197e12,
    hbm_bw=819e9,
    host_link_bw=32e9,
    device_mem=16 * 2**30,
    host_mem=512 * 2**30,
    mfu=0.5,
)

# The port's target: one NVIDIA H100 SXM (NVIDIA data sheet: 989 TFLOP/s
# dense fp16, 3.35 TB/s HBM3, 80 GB, PCIe Gen5 x16 at 64 GB/s each way).
# ``host_mem`` is an assumption (a 512 GiB-DRAM host), not a measured value,
# and so are the host-lane terms: the data sheet names no host, so they keep
# the defaults' mid-range server CPU (2 TFLOP/s, 150 GB/s DRAM, 0.25 of peak).
H100_SXM = HardwareSpec(
    name="h100-sxm",
    flops=989e12,
    hbm_bw=3.35e12,
    host_link_bw=64e9,
    device_mem=80 * 2**30,
    host_mem=512 * 2**30,
    mfu=0.5,
    host_flops=2e12,
    host_dram_bw=150e9,
    host_mfu=0.25,
)


def scale_for_shards(hw: HardwareSpec, shards: int) -> HardwareSpec:
    """The aggregate machine a ``shards``-way tensor-parallel serving group
    presents to the policy stack.  Compute, HBM bandwidth, device memory and
    the host link scale with the model axis (each shard owns its lanes and
    loads its 1/N slice of every block); host memory, the host-compute terms
    and the per-call dispatch overhead do not (one shared host; a call is
    paid once however many positions take part).  ``shards=1`` returns
    ``hw`` itself."""
    if shards < 1:
        raise ValueError(f"shards={shards}: at least 1")
    if shards == 1:
        return hw
    return dataclasses.replace(
        hw,
        name=f"{hw.name}-x{shards}",
        flops=hw.flops * shards,
        hbm_bw=hw.hbm_bw * shards,
        host_link_bw=hw.host_link_bw * shards,
        device_mem=hw.device_mem * shards,
    )


# =============================================================================
# analytic per-operation costs (seconds)
# =============================================================================

def layer_weight_bytes(cfg: ModelConfig) -> int:
    """Weight BYTES of ONE decoder block (the paper's T_load_w granularity)."""
    n = (cfg.num_params() - cfg.vocab_size * cfg.d_model *
         (1 if cfg.tie_embeddings else 2)) // max(cfg.num_layers, 1)
    return n * cfg.bytes_per_param()


def t_load_w(cfg: ModelConfig, hw: HardwareSpec) -> float:
    return layer_weight_bytes(cfg) / hw.host_link_bw


def kv_gen_flops_per_token(cfg: ModelConfig) -> float:
    """Eq. 7: A_c @ [W_K W_V] per layer per token (+RoPE, negligible)."""
    return 2.0 * cfg.d_model * (2 * cfg.kv_dim)


def attn_flops_per_token(cfg: ModelConfig, ctx: int) -> float:
    """Decode-attention FLOPs per layer for one new token over ctx keys."""
    return 2.0 * 2 * ctx * cfg.q_dim


def cpu_attend_seconds_per_token(cfg: ModelConfig, hw: HardwareSpec,
                                 quant=None) -> float:
    """Host-attention cost per SPILLED CONTEXT TOKEN per layer.

    One context token costs ``attn_flops_per_token(cfg, 1)`` MACs on the
    host cores and one KV row read out of host DRAM; the lane runs at
    whichever roofline binds.  Quantized arenas read fewer bytes but pay
    the same FLOPs.
    """
    t_flops = attn_flops_per_token(cfg, 1) / (hw.host_flops * hw.host_mfu)
    t_bytes = kv_bytes_per_token(cfg, quant) / hw.host_dram_bw
    return max(t_flops, t_bytes)


def forward_flops_per_token(cfg: ModelConfig, ctx: int) -> float:
    """Per-layer per-token decode forward (QKV+proj+FFN+attention)."""
    d, f = cfg.d_model, cfg.d_ff
    gated = cfg.ffn_type.startswith("gated")
    proj = 2.0 * d * (cfg.q_dim + 2 * cfg.kv_dim) + 2.0 * cfg.q_dim * d
    if cfg.is_moe:
        ffn = 2.0 * (3 if gated else 2) * d * f * cfg.moe_top_k
    else:
        ffn = 2.0 * (3 if gated else 2) * d * f if f else 0.0
    return proj + ffn + attn_flops_per_token(cfg, ctx)


def make_cost_fns(cfg: ModelConfig, hw: HardwareSpec, quant=None, cpu=False):
    """-> (t_kv_gen(n_tokens), t_load_kv(n_tokens), t_load_act(n_tokens)),
    plus ``t_cpu_attend(n_tokens)`` as a fourth element when ``cpu=True``
    (the host-attention lane).

    Per layer, batch-aggregate token counts (matching Algorithm 1's units:
    "#blocks" scaled by BLOCK_TOKENS happens at the caller).  ``quant``
    reprices the two link lanes by the quantized bytes per token; the
    KV-Gen lane is untouched, so Algorithm 1's split re-balances.
    """
    eff_gen = hw.flops * hw.gen_mfu

    def t_kv_gen(n):                     # GPU lane (skinny per-block GEMMs)
        return np.asarray(n, float) * kv_gen_flops_per_token(cfg) / eff_gen

    kv_bw = hw.host_link_bw * hw.gather_eff
    kvB = kv_bytes_per_token(cfg, quant)
    actB = act_bytes_per_token(cfg, quant)

    def t_load_kv(n):                    # PCIe lane (scattered block gather)
        return np.asarray(n, float) * kvB / kv_bw

    def t_load_act(n):                   # PCIe lane (half-size block gather)
        return np.asarray(n, float) * actB / kv_bw

    if not cpu:
        return t_kv_gen, t_load_kv, t_load_act

    cpuB = cpu_attend_seconds_per_token(cfg, hw, quant=quant)

    def t_cpu_attend(n):                 # CPU lane (host flash attention)
        return np.asarray(n, float) * cpuB

    return t_kv_gen, t_load_kv, t_load_act, t_cpu_attend


# =============================================================================
# sampling-based linear regression (paper Fig. 11)
# =============================================================================

@dataclass(frozen=True)
class LinearFit:
    slope: float
    intercept: float
    r2: float

    def __call__(self, n):
        return self.slope * np.asarray(n, float) + self.intercept

    def inverse(self, t):
        """Smallest n with fit(n) >= t (clamped at 0)."""
        if self.slope <= 0:
            return 0.0
        return max(0.0, (float(t) - self.intercept) / self.slope)


def fit_linear(fn: Callable, ns: Sequence[float], noise: float,
               seed: int) -> LinearFit:
    """Least-squares fit of fn over sample points ``ns`` with relative
    noise, mimicking real profiling jitter — R² lands near the paper's 0.99."""
    ns = np.asarray(ns, float)
    ts = np.asarray([float(fn(n)) for n in ns])
    if noise > 0.0:
        rng = np.random.default_rng(seed)
        ts = ts * (1.0 + noise * rng.standard_normal(ts.shape))
    A = np.stack([ns, np.ones_like(ns)], axis=1)
    coef, *_ = np.linalg.lstsq(A, ts, rcond=None)
    pred = A @ coef
    ss_res = float(np.sum((ts - pred) ** 2))
    ss_tot = float(np.sum((ts - ts.mean()) ** 2))
    r2 = 1.0 - ss_res / ss_tot if ss_tot > 0 else 1.0
    return LinearFit(slope=float(coef[0]), intercept=float(coef[1]), r2=r2)


# token counts the profiler samples, and its relative jitter (R² near 0.99)
SAMPLE_TOKENS = (256, 1024, 4096, 16384, 65536)
PROFILE_NOISE = 0.02


def profile_cost_fns(cfg: ModelConfig, hw: HardwareSpec, quant=None,
                     cpu: bool = False) -> Tuple[LinearFit, ...]:
    """The paper's sampling step: returns (fit_kv_gen, fit_load_kv), plus
    ``fit_cpu_attend`` as a third element when ``cpu=True``."""
    fns = make_cost_fns(cfg, hw, quant=quant, cpu=cpu)
    fits = (fit_linear(fns[0], SAMPLE_TOKENS, PROFILE_NOISE, seed=1),
            fit_linear(fns[1], SAMPLE_TOKENS, PROFILE_NOISE, seed=2))
    if cpu:
        fits += (fit_linear(fns[3], SAMPLE_TOKENS, PROFILE_NOISE, seed=3),)
    return fits


# =============================================================================
# online refit (the adaptive controller's feedback)
# =============================================================================

@dataclass(frozen=True)
class LaneSample:
    """One measured lane observation: ``seconds`` spent on ``n_tokens``
    (per layer, batch-aggregate: the units the fits are in)."""
    n_tokens: float
    seconds: float


def fit_samples(samples: Sequence[LaneSample],
                fallback: LinearFit) -> LinearFit:
    """Least squares over measured (n_tokens, seconds) pairs.

    Sets that cannot pin down both coefficients (fewer than two points, or
    all at one n) estimate the slope through ``fallback``'s intercept; with
    no usable sample the fallback is returned unchanged."""
    pts = [(float(s.n_tokens), float(s.seconds)) for s in samples
           if s.n_tokens > 0 and s.seconds > 0 and np.isfinite(s.seconds)]
    if not pts:
        return fallback
    ns = np.array([p[0] for p in pts])
    ts = np.array([p[1] for p in pts])
    if len(pts) < 2 or float(ns.max() - ns.min()) < 1e-9:
        slope = max(float(((ts - fallback.intercept) / ns).mean()), 0.0)
        return LinearFit(slope=slope, intercept=fallback.intercept, r2=0.0)
    A = np.stack([ns, np.ones_like(ns)], axis=1)
    coef, *_ = np.linalg.lstsq(A, ts, rcond=None)
    pred = A @ coef
    ss_res = float(np.sum((ts - pred) ** 2))
    ss_tot = float(np.sum((ts - ts.mean()) ** 2))
    r2 = 1.0 - ss_res / ss_tot if ss_tot > 0 else 1.0
    return LinearFit(slope=float(coef[0]), intercept=float(coef[1]), r2=r2)


def damp_fit(fit: LinearFit, prior: LinearFit, damping: float,
             intercept_scale_tokens: float = 256.0) -> LinearFit:
    """Clamp a refit into the trust region around the analytic prior: the
    slope within a factor ``damping`` (>= 1) of the prior's, the intercept
    within an additive band sized by the prior's cost at
    ``intercept_scale_tokens``.  The prior lies inside its own region, which
    makes the analytic allocation a fixed point of the controller."""
    assert damping >= 1.0
    lo, hi = prior.slope / damping, prior.slope * damping
    slope = float(np.clip(fit.slope, min(lo, hi), max(lo, hi)))
    band = (damping - 1.0) * (abs(prior.intercept)
                              + abs(prior.slope) * intercept_scale_tokens)
    intercept = float(np.clip(fit.intercept, prior.intercept - band,
                              prior.intercept + band))
    return LinearFit(slope=slope, intercept=intercept, r2=fit.r2)


def ewma_refit(current: LinearFit, prior: LinearFit,
               samples: Sequence[LaneSample], *, alpha: float,
               damping: float,
               intercept_scale_tokens: float = 256.0) -> LinearFit:
    """Exponentially weighted online refit with the analytic fit as prior:
    the least-squares fit of the samples blended into ``current`` with
    weight ``alpha``, then clamped by ``damp_fit`` around ``prior``.
    Samples that match ``current`` leave it unchanged."""
    fitted = fit_samples(samples, fallback=current)
    blended = LinearFit(
        slope=(1.0 - alpha) * current.slope + alpha * fitted.slope,
        intercept=(1.0 - alpha) * current.intercept + alpha * fitted.intercept,
        r2=fitted.r2)
    return damp_fit(blended, prior, damping, intercept_scale_tokens)
