"""Chip smoke test of the PyTorch/CUDA port on one NVIDIA H100.

    python3 chip_smoke.py

Builds the port's CUDA kernels from this checkout (``nvcc``, sm_90a; the
machine code of the flash kernel, the fused hybrid tile kernel, ``kv_gen``'s
projection and ``ssd_scan``'s Gram and scan passes must hold Hopper's
tensor-core ``HGMMA``),
holds each kernel against its plain PyTorch version at the main paths'
shapes, then serves two models at full width and full depth (random weights
from a seed) through ``HybridServeEngine`` in hybrid and kv modes and checks
the tokens against ``exact_reference_generate``: opt-6.7b (learned
positions; the fused hybrid kernel recomputes ACT pages' K/V) and then yi-6b
(RoPE, GQA, SwiGLU; the ``kv_gen`` kernel recomputes them, the hybrid
kernel's second-pool mode attends).  Then gemma3-1b (5:1 sliding window, q/k norm, head_dim 256, MQA)
runs its windowed hybrid path, ``hybrid_prefill`` -> ``hybrid_decode_loop``:
the flash kernel's window mode in prefill, rings and global layers through
the second-pool mode at head_dim 256, ``kv_gen`` with the K norm, checked
against the plain ``prefill`` + ``decode_loop`` with three planted faults;
then gemma3-27b the same way at full width and depth (62 layers, G = 2,
head_dim 128, W = 1024, prompts of 2024 and 1017 tokens; ``kv_gen``'s K
norm at head_dim 128).  Then mamba2-2.7b (64 SSD layers, no attention) runs
``prefill`` -> ``decode_loop``: each layer's prefill scan through the
``ssd_scan`` kernel, decode in plain torch, checked against the same path
with the plain scan, with three planted faults; then jamba-1.5-large-398b
(the hybrid family: SSD layers and a NoPE attention layer per period, MoE
every second layer) at full width, cut to one period of 4 layers, through
``prefill`` -> ``decode_loop`` (flash and ``ssd_scan`` in prefill), held
under the MoE rule to the same path on the kernels' plain versions, with
two planted faults.  Then the MoE models at full width, their depth
cut to what one card holds (dbrx-132b at 4 of 40 layers, grok-1-314b at 2
of 64): the engine in hybrid and kv modes (the MoE dispatch inside the
sync-checked decode loop), hybrid held to kv mode of the same group and to
the oracle where the group's prefill dropped no real token's pair, each
prefill's dropped pairs printed, two planted faults in the dispatch; dbrx
also streamed from pinned host memory and through the server.  Last, the
frontend models at full width and depth through ``prefill`` ->
``decode_loop``: whisper-base (the flash kernel's non-causal mode in its
encoder and cross attention; cross-KV, and cross-ACT, whose decode
recomputes every layer's cross K/V from one encoder checkpoint in the fused
hybrid kernel, held to cross-KV, with a planted fault) and qwen2-vl-2b
(M-RoPE, 256 patches before the text, held to the same path on the plain
flash).  Then training: minitron-4b (4 x 512 tokens), gemma3-1b (4 x 1024,
its local layers' window crossed), whisper-base (4 x 448 tokens over 1500
frames), qwen2-vl-2b (256 patches and 512 tokens a row) and mamba2-2.7b
(4 x 1024), each at full width and depth, and jamba's 8-layer period at
reduced width (4 x 1024), take five ``make_train_step`` steps (remat,
AdamW), their attention on the flash kernel with the lse output and the
hand-written backward in the forward's mode (``flash_attention_bwd``:
causal, sliding window, non-causal, head_dim 256, held in the kernels
phase against its plain version with four planted faults), their SSD
layers on ``ssd_scan`` with its hand-written backward (``ssd_scan_bwd``,
held in the kernels phase at mamba2's and jamba's shapes with two planted
faults), step 1's loss and every gradient leaf held to the same step on
the plain attention and SSD scan; and the serve CLI
(``repro_torch.launch.serve``) serves opt-6.7b with ``--verify``.  Then
the six example twins (``examples/torch_*.py``) run in process with their
reference's asserts, each with the launch counts set to 0 before it and
the kernels it must launch read after; the offload microbenchmark times
stream only, compute only and overlapped at opt-6.7b's full width (4
layers) and must save time; and the dry run's one-card fit check
(``repro_torch.launch.dryrun``) covers every config and shape on ``meta``,
must report the depth cuts this script runs as fitting, and measures three
steps on the card: resident argument bytes within 1% of the dry run's,
each peak under the card's memory.  After
each of OPT's and yi's device-resident
serves has freed its weights, an offload phase serves it again with its
layer weights in pinned host memory, streamed to the card over a CUDA copy stream (``HybridServeEngine(offload=
True)``): prefetch depth 1 and 0, the KV region resident or spilled to the
host arena, and spilled with the CPU attention lane, whose device partial is
the hybrid kernel's ``return_lse`` mode; the copy stream's overlap is read
from the timeline's spans, against a planted fault.  The int8 cache
(``QuantConfig()``) runs beside each: its kernel modes held against their
plain versions (with planted faults), the device-resident serve in hybrid
and kv modes against the q8 oracle, and the spilled and CPU-lane offload
runs.  After each of OPT's and yi's engine serves, the continuous-batching
server (``ContinuousBatchingServer``) serves an open-loop trace of twelve
requests on the same weights: chunks of 1 and 8 steps, int8, pool pressure
(preemption, demotion to ACT, resume), streamed weights and the CPU lane,
each chunk under the sync check, with tokens (each run's allowance from a
teacher-forced run of the same server schedule), counters, leaks, launches
and three planted faults checked.  After each of OPT's and yi's engine
serves, the shard phase serves the same trace tensor-parallel on the same
weights (``make_shard_plan`` over ``make_test_mesh``: every position of
the mesh on this one card): OPT on 1x2 and 2x2 meshes, yi on 1x2, each
position's attention on the kernels at its own head counts (each such key
held by a kernels-phase row), each position's resident bytes against its
spec's, teacher-forced logits against the 1x1 kernel run under the rule
max(0.25, 2 x that run's own gap to the oracle), two planted faults (a
``wo`` partial dropped, KV-Gen on a position's own d_model slice); OPT's
server with 4 slots and its offload executor (two weight lanes) on 1x2 as
well.  Beside them (``SHARD_LEGS``): the int8 cache on 1x2 for both (held
to the single-device int8 run at the leg's own schedule; layer 0's codes
and scales bit-equal to it; on yi a planted fault, each position's ACT
slice quantized against its own scale), OPT's offload executor with the
CPU lane on 1x2 over the first group, yi on 1x8 teacher-forced on the
first group (each position's 4 query heads over their one KV head of 4
replicated), and in the MoE phase dbrx on 1x2, expert parallel, its
routes replayed from the single-device run (a ``wo`` partial dropped as
the planted fault).  Each path runs with the launch counts set to 0
just before it and read just after.  One JSON line per
phase; the line before the last lists every kernel with its launches on its
path, error, times and bound; the last line is the device summary.  Any
failure raises and the exit code is non-zero.  Without a CUDA device, or
outside a checkout of the repo, it fails before printing any result.
Details also go to ``chiprun_out/chip_smoke.json``.
"""
from __future__ import annotations

import contextlib
import ctypes
import dataclasses
import functools
import gc
import io
import json
import math
import re
import runpy
import subprocess
import sys
import time
import warnings
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import torch
import torch.nn.functional as F

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))
from repro_torch.configs import (ASSIGNED, SHAPES, InputShape,  # noqa: E402
                                 applicable, get_config, reduced)
from repro_torch.configs.offload import (OffloadBudget, _tight,  # noqa: E402
                                         offload_budget)
from repro_torch.core.controller import (ControllerConfig,  # noqa: E402
                                         HybridCacheController)
from repro_torch.core.costmodel import H100_SXM, scale_for_shards  # noqa: E402
from repro_torch.core.quant import QuantConfig, kv_bytes_per_token  # noqa: E402
from repro_torch.data.pipeline import (DataConfig, lm_batches,  # noqa: E402
                                       open_loop_trace, request_trace)
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels.flash_attention import ops as FA  # noqa: E402
from repro_torch.kernels.flash_attention.ops import flash_attention  # noqa: E402
from repro_torch.kernels.flash_attention.ref import (  # noqa: E402
    flash_attention_bwd_ref, flash_attention_ref)
from repro_torch.kernels.hybrid_attention.ops import (  # noqa: E402
    hybrid_paged_attention, hybrid_paged_attention_two_pool)
from repro_torch.kernels.hybrid_attention.ref import (  # noqa: E402
    hybrid_paged_attention_ref, hybrid_paged_attention_two_pool_ref)
from repro_torch.kernels.kv_gen.ops import FAULTS as KV_GEN_FAULTS  # noqa: E402
from repro_torch.kernels.kv_gen.ops import _kv_gen, kv_gen  # noqa: E402
from repro_torch.kernels.kv_gen.ref import kv_gen_ref  # noqa: E402
from repro_torch.kernels.ssd_scan import ops as SSD  # noqa: E402
from repro_torch.kernels.ssd_scan import ref as SSD_REF  # noqa: E402
from repro_torch.kernels.ssd_scan.ops import FAULTS as SSD_FAULTS  # noqa: E402
from repro_torch.kernels.ssd_scan.ops import _ssd_scan, ssd_scan  # noqa: E402
from repro_torch.kernels.ssd_scan.ref import (ssd_chunked_ref,  # noqa: E402
                                              ssd_scan_bwd_ref)
from repro_torch.models import layers as L  # noqa: E402
from repro_torch.models import model as M  # noqa: E402
from repro_torch.models import quantized_cache as QC  # noqa: E402
from repro_torch.models import sharded as SHD  # noqa: E402
from repro_torch.models.quant_ops import dequantize, quantize  # noqa: E402
from repro_torch.obs import (DriftMonitor, MetricsRegistry, Tracer,  # noqa: E402
                             assert_single_rooted, validate_chrome_trace)
from repro_torch.offload import (HostWeightPool, host_flash_attention,  # noqa: E402
                                 merge_partials_torch)
from repro_torch.offload.host_attn import QuantPlane  # noqa: E402
from repro_torch.offload.microbench import (  # noqa: E402
    weight_stream_microbench)
from repro_torch.offload.timeline import MeasuredTimeline  # noqa: E402
from repro_torch.serving import (ContinuousBatchingServer,  # noqa: E402
                                 HybridServeEngine, exact_reference_generate)
from repro_torch.serving import scheduler as SCHED  # noqa: E402
from repro_torch.serving.util import bucket  # noqa: E402
from repro_torch.launch import serve as SERVE_CLI  # noqa: E402
from repro_torch.launch import dryrun as DRY  # noqa: E402
from repro_torch.launch import specs as SPECS  # noqa: E402
from repro_torch.launch.mesh import make_test_mesh  # noqa: E402
from repro_torch.sharding import collectives as COLL  # noqa: E402
from repro_torch.sharding import make_shard_plan  # noqa: E402
from repro_torch.optim import adamw  # noqa: E402

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
# return_lse's (m, l) against the plain version, float32: m is a max of
# scores and l a sum of exp(s - m), each score a float32 dot product of q
# with a key the fused kernel recomputes and rounds to the cache dtype in
# another summation order than the plain version (a float16 ulp flip moves a
# unit-scale score by ~1e-4).  The limit is 2**-10 relative (absolute below
# 1); dropping one ACT page moves l by several percent and must fail it.
LSE_RTOL = 2.0 ** -10
# int8 cache, hybrid mode, teacher-forced against the q8 oracle (the plain
# int8 KV cache, models/quantized_cache.py): both carry int8 error of one
# kind, absmax codes with one float16 scale per row (the oracle on K/V rows;
# the hybrid cache on K/V rows and on ACT rows, whose error reaches K/V
# through the norm and projection at the same relative size).  So the hybrid
# path's gap to the fp oracle is about the q8 oracle's own gap to it, and by
# the triangle inequality its gap to the q8 oracle is within about twice the
# q8 oracle's gap to the fp oracle (measured in the same run, fed the fp
# oracle's tokens), plus the kernels' rounding drift, which the fp limit
# bounds: limit = QUANT_GAP_FACTOR * gap(q8, fp) + LOGIT_TOL_BY_DTYPE.  On an
# NVIDIA H100 80GB HBM3 at 700 W the hybrid gap read 1.06 (opt-6.7b) and 1.00
# (yi-6b) times gap(q8, fp).  The K/V scales read one token row off must exceed the limit.  The ACT
# scales ignored cannot, and are read but not held to it: a per-row factor in
# front of the norm cancels but for eps and rounding.
QUANT_GAP_FACTOR = 2.0
# the reference's documented bound on per-token agreement of quant decode with
# the fp oracle (tests/test_quant.py MIN_AGREEMENT)
MIN_AGREEMENT = 0.6
TRACE = dict(n_requests=4, prompt_mean=48, gen_tokens=12, seed=7)
# kernel -> (its source, the TPU kernel it replaces)
_HYBRID = ("src/repro_torch/kernels/hybrid_attention/csrc/hybrid_attention.cu",
           "src/repro/kernels/hybrid_attention/kernel.py:165")
_BWD = ("src/repro_torch/kernels/flash_attention/csrc/flash_attention_bwd.cuh",
        "src/repro/models/layers.py:276")
KERNELS = {
    "flash_attention": (
        "src/repro_torch/kernels/flash_attention/csrc/flash_attention.cu",
        "src/repro/kernels/flash_attention/kernel.py:84"),
    "hybrid_paged_attention": _HYBRID,
    "hybrid_paged_attention_two_pool": _HYBRID,
    "kv_gen": ("src/repro_torch/kernels/kv_gen/csrc/kv_gen.cu",
               "src/repro/kernels/kv_gen/kernel.py:46"),
    "hybrid_paged_attention_return_lse": _HYBRID,
    "hybrid_paged_attention_two_pool_return_lse": _HYBRID,
    # the int8 modes (kernel.py:100-103 and :121-124 dequantize; kv_gen takes
    # the ACT dequant of the norm hoist on the RoPE route)
    "hybrid_paged_attention_q8": _HYBRID,
    "hybrid_paged_attention_two_pool_q8": _HYBRID,
    "kv_gen_q8": ("src/repro_torch/kernels/kv_gen/csrc/kv_gen.cu",
                  "src/repro/kernels/hybrid_attention/kernel.py:100"),
    "hybrid_paged_attention_return_lse_q8": _HYBRID,
    "hybrid_paged_attention_two_pool_return_lse_q8": _HYBRID,
    # the gemma3 path's modes: the flash kernel's sliding window (kernel.py
    # :47-48 skip, :62-63 mask), the second-pool mode at head_dim 256, and
    # kv_gen at head_dim 256 with the K norm epilogue
    "flash_attention_window": (
        "src/repro_torch/kernels/flash_attention/csrc/flash_attention.cu",
        "src/repro/kernels/flash_attention/kernel.py:84"),
    "hybrid_paged_attention_two_pool_hd256": _HYBRID,
    "kv_gen_qk_norm": ("src/repro_torch/kernels/kv_gen/csrc/kv_gen.cu",
                       "src/repro/kernels/kv_gen/kernel.py:46"),
    # mamba2's prefill: the chunked SSD scan, with the final state it hands
    # to decode
    "ssd_scan": ("src/repro_torch/kernels/ssd_scan/csrc/ssd_scan.cu",
                 "src/repro/kernels/ssd_scan/kernel.py:61"),
    # whisper's path: the flash kernel's non-causal mode (kernel.py:47 skips
    # and :61 masks only when causal), the encoder's self attention and the
    # decoder's cross attention over the frames; the fused mode over the
    # cross-ACT checkpoint (ACT pages only, enc_norm as its norm)
    "flash_attention_noncausal": (
        "src/repro_torch/kernels/flash_attention/csrc/flash_attention.cu",
        "src/repro/kernels/flash_attention/kernel.py:84"),
    "hybrid_paged_attention_cross_act": _HYBRID,
    # the training path's attention gradient: no Pallas kernel, the
    # counterpart of the reference's custom VJP (XLA), whose backward it
    # computes from the forward's lse
    "flash_attention_bwd": _BWD,
    # its modes on the windowed and encdec families' training: the sliding
    # window (the reference's _tile_mask, layers.py:115-123), head_dim 256
    # (D split in two column parts), non-causal with keys of their own
    # length (the encoder and the cross attention)
    "flash_attention_bwd_window": _BWD,
    "flash_attention_bwd_hd256": _BWD,
    "flash_attention_bwd_noncausal": _BWD,
    # the SSD layers' gradient on the ssm and hybrid families' training: no
    # Pallas kernel, the counterpart of XLA's autodiff of ``ssd_chunked``
    "ssd_scan_bwd": ("src/repro_torch/kernels/ssd_scan/csrc/ssd_scan_bwd.cuh",
                     "src/repro/models/layers.py:497"),
}
# the launch counters: (kernel wrapper, its counter); the return_lse and
# int8 rows count the launches of that mode on the same wrappers
COUNTERS = {"flash_attention": (flash_attention, "launches"),
            "hybrid_paged_attention": (hybrid_paged_attention, "launches"),
            "hybrid_paged_attention_two_pool": (
                hybrid_paged_attention_two_pool, "launches"),
            "kv_gen": (kv_gen, "launches"),
            "hybrid_paged_attention_return_lse": (
                hybrid_paged_attention, "lse_launches"),
            "hybrid_paged_attention_two_pool_return_lse": (
                hybrid_paged_attention_two_pool, "lse_launches"),
            "hybrid_paged_attention_q8": (hybrid_paged_attention, "q8_launches"),
            "hybrid_paged_attention_two_pool_q8": (
                hybrid_paged_attention_two_pool, "q8_launches"),
            "kv_gen_q8": (kv_gen, "q8_launches"),
            "hybrid_paged_attention_return_lse_q8": (
                hybrid_paged_attention, "lse_q8_launches"),
            "hybrid_paged_attention_two_pool_return_lse_q8": (
                hybrid_paged_attention_two_pool, "lse_q8_launches"),
            "flash_attention_window": (flash_attention, "window_launches"),
            "hybrid_paged_attention_two_pool_hd256": (
                hybrid_paged_attention_two_pool, "hd256_launches"),
            "kv_gen_qk_norm": (kv_gen, "knorm_launches"),
            "ssd_scan": (ssd_scan, "launches"),
            "flash_attention_noncausal": (flash_attention,
                                          "noncausal_launches"),
            "flash_attention_bwd": (flash_attention, "bwd_launches"),
            "flash_attention_bwd_window": (flash_attention,
                                           "bwd_window_launches"),
            "flash_attention_bwd_hd256": (flash_attention, "bwd_hd256_launches"),
            "flash_attention_bwd_noncausal": (flash_attention,
                                              "bwd_noncausal_launches"),
            "ssd_scan_bwd": (ssd_scan, "bwd_launches")}
# the kernel rows that a counter of another row counts on their own path:
# on whisper's cross-ACT run every fused launch is a cross-ACT one
COUNTED_AS = {"hybrid_paged_attention_cross_act": "hybrid_paged_attention"}
GEMMA = "gemma3-1b"
# the gemma path's groups (requests, prompt length): group 1's prompt is no
# page multiple, longer than the window, so the window mask and the rings'
# wrap act in prefill; group 2's rings wrap at its 8th decode step
GEMMA_GROUPS = ((4, 1000), (2, 505))
GEMMA_STEPS = 12
# gemma's checkpoints carry trained, non-zero q/k norm scales; the random
# weights draw them N(0, GEMMA_QK_NORM_STD) so that the K norm weighs on the
# keys as it does there (at its zero init it only divides by an RMS near 1).
# At 0.5 the K norm left out of kv_gen moved the logits by 0.19, under the
# 0.25 limit, so no limit could have told it apart; at 1.0 it moves them by
# ~1.2 (NVIDIA H100 80GB HBM3, 700 W)
GEMMA_QK_NORM_STD = 1.0
MAMBA = "mamba2-2.7b"
# the mamba2 path's groups (requests, prompt length), one length each, as the
# reference's prefill takes: group 1's last chunk is ragged (1000 = 15 x 64
# + 40), group 2's prompt is a chunk multiple
MAMBA_GROUPS = ((4, 1000), (2, 512))
MAMBA_STEPS = 12
# ssd_scan's final state against the plain version's, relative to the
# largest plain state entry: both sum a chunk's 64 float32 products in
# another order and take exp() of the same cumulative sums (CUDA's expf
# against torch's, within 2 ulps), a relative difference of a few 1e-7 that
# the 16 chunks' decay does not grow.  The limit, 2**-13, leaves two orders
# of headroom; the state taken before the last chunk moves it by O(1)
SSD_STATE_RTOL = 2.0 ** -13
# mamba2's checkpoints carry trained dt biases; Mamba-2's own init
# (arXiv:2405.21060, as its reference code draws them) sets softplus(dt_bias)
# log-uniform in [1e-3, 1e-1], so that heads remember hundreds of tokens.
# The random weights draw them so.  At the reference's init (dt_bias 0, dt
# ~ 0.7, a memory of a few tokens) the plain path's own spread (below) is
# as large as the gap of a state not carried across chunks, so no limit
# could tell that fault apart (tools/mamba2_dt_init.py reads both)
MAMBA_DT_RANGE = (1e-3, 1e-1)
# mamba2's logit limit.  The bfloat16 rule's 0.25 was derived for 32 layers
# of attention; mamba2 rounds 64 layers' outputs to bfloat16, each from a
# 1000-token scan whose state sums long runs of products.  On the card the
# plain path itself at chunk 32 against chunk 64 (the same function, its
# float32 sums in another order) differs by about as much as the kernel
# does, ~0.27: 0.25 sits at the floor any second float32 order reaches.  So
# the limit is the larger of 0.25 and twice that spread, read in the same
# run; the planted faults (a state not carried, a conv cache one token late,
# a zero state) read 5-7, far above it
MAMBA_SPREAD_CHUNK = 32
# gemma3-27b at full width and depth (62 layers: 10 periods of 5 local and a
# global layer, 2 local tail layers; d 5376, 32 heads over 16 KV heads,
# head_dim 128, W = 1024; ~54 GB in bfloat16) through gemma3-1b's path.  Its
# groups are gemma3-1b's scaled to its window: group 1's prompt is no page
# multiple and longer than W (2024 = 2 W - 24), so the window mask and the
# rings' wrap act in prefill; group 2's rings wrap at its 8th decode step
# (1017 = W - 7).  At gemma3-1b's 1000 tokens a 1024-token window masks
# nothing, and the prefill's window fault could not show
GEMMA27 = "gemma3-27b"
# gemma's logit limit.  The bfloat16 rule's 0.25 was derived for 32 layers,
# and gemma3-1b's 26 stay under it.  Past 32 layers (gemma3-27b's 62) the
# limit is, as mamba2's, the larger of 0.25 and twice the plain path's own
# spread, read in the same run: the plain path against itself with its prefill
# attention summed in another float32 order, an online softmax over key
# chunks of GEMMA_SPREAD_CHUNKS[0].  The plain version takes each row whole;
# a chunked online softmax is the same function with its sums and its
# exponentials' maxima taken in another order, as mamba2's chunk-32 scan
# is.  Its second chunk is the flash kernel's own tile of 64 keys, read
# beside it and not used in the limit.  gemma3-1b's spread is read too
GEMMA_SPREAD_CHUNKS = (32, 64)
GEMMA27_GROUPS = ((4, 2024), (2, 1017))
# jamba-1.5-large-398b at full width.  One period of its 8 layers holds 4
# MoE layers of 16 x 3 x 8192 x 24576 x 2 B = 19.33 GB of experts each,
# ~89.2 GB with the rest against the card's 85.5 GB, and the reference builds
# whole periods only (n_per = num_layers // attn_period).  So the card runs
# one period of 4 layers (attn_period 4): SSD-dense, SSD-MoE, attention
# (NoPE, dense FFN), SSD-MoE, every slot kind of jamba's period, ~44.9 GB.
# Its traffic is mamba2's groups and steps, so that the scan does real work
JAMBA = "jamba-1.5-large-398b"
JAMBA_CUT = dict(attn_period=4, num_layers=4)
# trained attention is peaked; at the random init's unit-scale queries the
# scores over 1000 keys spread by ~1, the softmax is near uniform, the
# attention slot's output is a mean of hundreds of values, and a fault in
# its scores moves the logits little: on the CPU at the reduced width in
# bfloat16, RoPE in the NoPE slot moved them by 0.19 at 4 x 1000 tokens,
# against the 0.25 limit.  As whisper's ``ln_x``, the random weights set the
# attention slot's ``ln1`` scale to JAMBA_ATTN_LN_SCALE (its scores then
# spread by its square, whatever the width), so that a few keys carry each
# query: there, at scales 2 and 4, the fault read 1.28 and 1.66
JAMBA_ATTN_LN_SCALE = 2.0
# the frontend models: whisper-base (encoder-decoder, cross-KV and cross-ACT)
# and qwen2-vl-2b (M-RoPE, patch embeddings before the text), each through
# prefill -> decode_loop at full width and depth: one group of 4 requests of
# a 48-token prompt (qwen2-vl's after its 256 patches), 12 decode tokens
WHISPER, QWEN = "whisper-base", "qwen2-vl-2b"
FRONTEND_GROUP = (4, 48)
FRONTEND_STEPS = 12
# the cross-ACT cache against cross-KV: 2·L·KVH·D/d_model = 12x fewer bytes
# at whisper-base's widths, 11.97x with the checkpoint padded to whole pages
MIN_CROSS_RATIO = 11.9
# trained whisper's cross attention is peaked (it aligns the text with a few
# frames); at the random init's unit-scale queries the scores over 1500
# frames spread by ~1, the softmax is near uniform, the cross attention's
# output is a mean of ~500 values, and a fault in its keys moves the logits
# little: on the CPU at full width in bfloat16 (the fused kernel's plain
# version) the next layer's wk moved them by 0.33, against the 0.25 limit.
# The random weights set ln_x's scale to WHISPER_LN_X_SCALE, so the scores
# spread by that factor and a few frames carry each query, as in a trained
# model: there, at scales 2 and 4, the fault read 0.93 and 2.24, and
# cross-ACT's own gap to cross-KV 0.018 and 0.035
WHISPER_LN_X_SCALE = 4.0
# the earlier designs' kernel times on an NVIDIA H100 80GB HBM3 at 700.00 W
# (kv_gen: one block per 32-row tile and head on WMMA, its norm per column
# block; ssd_scan: one block per (request, head), float32 on the CUDA cores),
# printed beside each row's time: (name, its first shapes' key) -> ms
BEFORE_REDESIGN_MS = {("kv_gen", 4096): 0.0847, ("kv_gen", 3072): 0.0650,
                      ("kv_gen_q8", 4096): 0.0981,
                      ("kv_gen_qk_norm", 1152): 0.0610,
                      ("ssd_scan", 1000): 2.930, ("ssd_scan", 512): 0.844}


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


def host_us(fn, iters: int = 200) -> float:
    """Mean host microseconds per call, without waiting for the card: where
    it is above the card's time, back-to-back calls are bound by the host
    and ``time_ms`` reads the host's rate."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    took = (time.perf_counter() - t0) / iters * 1e6
    torch.cuda.synchronize()
    return took


def device_us(fn, iters: int = 20) -> float:
    """Mean device microseconds per call: the kernels one call runs, summed
    from torch.profiler's device events over ``iters`` calls, whatever the
    host's rate of calls."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    return sum(e.time_range.elapsed_us() for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA) / iters


def kernel_tol(*want) -> tuple[float, float]:
    """-> (limit, max|want|): TOL_ULPS ulps of the dtype at the largest
    output of the plain version."""
    top = max(w.float().abs().max().item() for w in want)
    ulp = 2.0 ** (math.floor(math.log2(top)) - MANTISSA_BITS[want[0].dtype])
    return TOL_ULPS * ulp, top


def drop_last_page(act_tok):
    """A planted fault: each request's ACT tokens without its last page."""
    return torch.where(act_tok > 0, (act_tok - 1) // PAGE * PAGE, 0).int()


def scales_row_off(sc: dict) -> dict:
    """A planted fault of the int8 modes: every scale sidecar read one token
    row off (row r takes row r-1's scale)."""
    return {k: torch.roll(s.view(-1, *s.shape[2:]), 1, 0).view_as(s)
            for k, s in sc.items()}


def q8_pools(**pools):
    """int8 codes and float16 scales of each named pool ("k_pages", ...),
    quantized as the cache stores them.  -> ([codes, in order], {"k_scales":
    scales, ...})."""
    codes, scales = [], {}
    for name, t in pools.items():
        c, scales[name.removesuffix("_pages") + "_scales"] = quantize(t)
        codes.append(c)
    return codes, scales


def q8_bytes(n_kv_rows: int, n_act_rows: int, KVH: int, D: int, d: int) -> int:
    """Bytes of int8 cache rows with their float16 scales: K and V rows of
    KVH x D codes and KVH scales each, ACT rows of d codes and one scale."""
    return n_kv_rows * 2 * KVH * (D + 2) + n_act_rows * (d + 2)


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


def tensor_cores(lib: str) -> dict:
    """Per kernel function of a built library, whether its machine code
    holds Hopper's warpgroup tensor-core product (``HGMMA`` in ``cuobjdump
    -sass``): {mangled name: bool}."""
    cuobjdump = Path(_build._nvcc()).parent / "cuobjdump"
    sass = subprocess.run([str(cuobjdump), "-sass", lib], capture_output=True,
                          text=True, check=True).stdout
    out, name = {}, None
    for line in sass.splitlines():
        m = re.match(r"\s*Function : (\S+)", line)
        if m:
            name = m.group(1)
            out[name] = False
        elif name is not None and "HGMMA" in line:
            out[name] = True
    return out


# the kernel functions that must run their products on the tensor cores:
# (library, part of the mangled name); every instantiation of each
HGMMA_KERNELS = (("flash_attention", "flash_fwd_kernel"),
                 ("flash_attention", "flash_bwd_kernel"),
                 ("hybrid_attention", "fused_tile_kernel"),
                 ("kv_gen", "kv_proj_kernel"),
                 ("ssd_scan", "ssd_gram_kernel"),
                 ("ssd_scan", "ssd_scan_bf16_kernel"),
                 ("ssd_scan", "ssd_scan_tf32_kernel"),
                 ("ssd_scan", "ssd_bwd_state_kernel"),
                 ("ssd_scan", "ssd_bwd_chunk_kernel"))
# the build's ptxas report ({kernel<args>: registers, spills}), kept for the
# kernel rows that print their design's registers beside their times
PTXAS = {}


def kernel_symbol(line: str):
    """(kernel name, template arguments) of the mangled ``<length><name>
    _kernel I...E`` symbol in a ptxas line, or None: the name is the
    ``length`` characters after its length prefix.  Where a digit run in an
    anonymous namespace's hash also reads as a length that ends at the same
    ``_kernel``, the shortest such name is the kernel's own."""
    found = []
    for m in re.finditer(r"(?<!\d)(\d+)(?=[a-z_])", line):
        start = m.end()
        name = line[start:start + int(m.group(1))]
        if name.endswith("_kernel"):
            args = re.match(r"(I.*?E)Ev", line[start + len(name):])
            if args:
                found.append((len(name), name, args.group(1)))
    return min(found)[1:] if found else None


def ptxas_report(log: str) -> dict:
    """Registers and spill bytes per kernel instantiation, from the
    ``-Xptxas -v`` lines of the build log."""
    short = (("13__nv_bfloat16", "bf16,"), ("6__half", "f16,"), ("S1_", "T,"),
             ("Li", ""), ("E", ""), ("a", "int8,"))
    out, name = {}, None
    for line in log.splitlines():
        sym = kernel_symbol(line)
        if sym and ("Compiling entry" in line or "Function properties" in line):
            args = sym[1][1:]
            for a, b in short:
                args = args.replace(a, b)
            name = f"{sym[0]}<{args.rstrip(',')}>"
        m = re.search(r"(\d+) bytes spill stores", line)
        if m and name:
            out.setdefault(name, {})["spill_store_bytes"] = int(m.group(1))
        m = re.search(r"Used (\d+) registers", line)
        if m and name:
            out.setdefault(name, {})["registers"] = int(m.group(1))
    return out


def phase_build(results):
    t0 = time.perf_counter()
    log = io.StringIO()
    with contextlib.redirect_stdout(log):
        per_kernel = _build.build_all(verbose=True)
    print(log.getvalue(), flush=True)
    libs = {name: str(_build.load(name)._name) for name in _build.sources()}
    sass = {name: tensor_cores(lib) for name, lib in libs.items()}
    hgmma = {f"{lib}:{fn}": [has for name, has in sass[lib].items() if fn in name]
             for lib, fn in HGMMA_KERNELS}
    out = {"phase": "build", "seconds": time.perf_counter() - t0,
           "compiled": per_kernel, "libraries": libs,
           "tensor_cores": {lib: any(per.values()) for lib, per in sass.items()},
           "hgmma_by_kernel": {k: {"instantiations": len(v), "with_hgmma": sum(v)}
                               for k, v in hgmma.items()},
           "ptxas": ptxas_report(log.getvalue())}
    PTXAS.update(out["ptxas"])
    emit(out)
    results["build"] = out
    bad = [k for k, v in hgmma.items() if not v or not all(v)]
    if bad:
        raise AssertionError(f"kernel functions without HGMMA in their machine "
                             f"code (not on the tensor cores): {bad}, "
                             f"{out['hgmma_by_kernel']}")


def check_flash(B, S, H=32, KVH=32, D=128, dtype=torch.float16, window=0,
                causal=True, Sk=None):
    """The flash kernel, causal, sliding-window (``window`` > 0) or
    non-causal (``causal=False``, keys of their own length ``Sk``, S by
    default), against its plain version.  Planted faults: the window mode
    run without its window; the non-causal mode run causal (Sk = S), or
    with its ragged last key tile dropped (Sk != S, a 64-key multiple
    short)."""
    Sk = S if Sk is None else Sk
    g = torch.Generator(device="cuda").manual_seed(S + Sk)
    q = torch.randn((B, S, H, D), generator=g, device="cuda", dtype=dtype)
    k, v = (torch.randn((B, Sk, KVH, D), generator=g, device="cuda",
                        dtype=dtype) for _ in range(2))
    run = lambda f, *kv: f(q, *(kv or (k, v)), causal=causal, window=window)
    got = run(flash_attention)
    want = flash_attention_ref(q, k, v, window, causal)
    faults = {}
    if window and window < S:       # a window over every key cuts nothing
        faults["fault_err_no_window"] = (flash_attention(q, k, v).float()
                                         - want.float()).abs().max().item()
    if not causal and Sk == S:
        faults["fault_err_causal_mask"] = (flash_attention(q, k, v).float()
                                           - want.float()).abs().max().item()
    elif not causal:
        cut = (Sk - 1) // 64 * 64
        faults["fault_err_last_key_tile_dropped"] = (
            run(flash_attention, k[:, :cut].contiguous(),
                v[:, :cut].contiguous()).float() - want.float()
        ).abs().max().item()
    torch.cuda.synchronize()
    err = (got.float() - want.float()).abs().max().item()
    tol, top = kernel_tol(want)
    # the library call reads (B, H, S, D) with K/V expanded to H heads, and
    # in the window mode a boolean band mask, made before the timing
    qt, kt, vt = (x.transpose(1, 2).repeat_interleave(H // x.shape[2], dim=1)
                  .contiguous() for x in (q, k, v))
    i = torch.arange(S, device="cuda")
    band = (i[None] <= i[:, None]) & (i[None] > i[:, None] - window)
    lib = (lambda: F.scaled_dot_product_attention(qt, kt, vt, attn_mask=band)) \
        if window else (lambda: F.scaled_dot_product_attention(
            qt, kt, vt, is_causal=causal))
    iters = 50 if S * Sk <= 256 * 256 else 10
    ms = time_ms(lambda: run(flash_attention), iters)
    plain_ms = time_ms(lambda: run(flash_attention_ref), iters)
    lib_ms = time_ms(lib, iters)
    # QK^T and PV over the (query, key) pairs the mask keeps
    pairs = S * Sk if not causal else \
        sum(min(n + 1, window) if window else n + 1 for n in range(S))
    ops = 4.0 * B * H * D * pairs
    nbytes = (2 * q.numel() + 2 * k.numel()) * q.element_size()
    bound_ms, by = bound(nbytes, ops)
    return {"shape": {"B": B, "S": S, "Sk": Sk, "H": H, "KVH": KVH, "D": D,
                      "window": window, "causal": causal},
            "dtype": str(dtype).removeprefix("torch."), "max_abs_err": err,
            "tol": tol, "max_abs_out": top, **faults, "kernel_ms": ms,
            **({} if causal else {
                "kernel_host_us": host_us(lambda: run(flash_attention)),
                "kernel_device_us": device_us(lambda: run(flash_attention))}),
            "plain_ms": plain_ms, "library_ms": lib_ms,
            "library": "F.scaled_dot_product_attention"
                       + (", boolean band mask" if window else
                          ", is_causal" if causal else ", is_causal=False"),
            "bound_ms": bound_ms, "bound_by": by}


# the backward kernel's shapes, (B, S, H, KVH, D) and the mode, at the
# training batches: minitron-4b's (G = 3), opt-6.7b's (MHA, G = 1), yi-6b's
# (G = 8), an edge, D = 64 at a ragged 2 x 777 with G = 4, qwen2-vl-2b's
# (G = 6, 256 patches and 512 tokens a row) (the causal mode,
# "flash_attention_bwd"); gemma3-1b's local layer (W 512, D 256, G 4) and
# gemma3-27b's (W 1024, D 128, G 2; checked here only: 27.0 B params x (2 +
# 2 + 8) bytes of weights, gradients and AdamW moments do not fit one card)
# ("_window"); gemma3-1b's global layer ("_hd256"); whisper-base's encoder
# (1500 frames each way) and its cross attention (448 tokens over the 1500
# frames) ("_noncausal"); all bfloat16 (the models'), then minitron's and
# the cross attention's shapes again in float16 (the kernel's other dtype)
BWD_SHAPES = {
    "flash_attention_bwd": (dict(B=4, S=512, H=24, KVH=8, D=128),
                            dict(B=4, S=512, H=32, KVH=32, D=128),
                            dict(B=4, S=512, H=32, KVH=4, D=128),
                            dict(B=2, S=777, H=8, KVH=2, D=64),
                            dict(B=4, S=768, H=12, KVH=2, D=128),
                            dict(B=4, S=512, H=24, KVH=8, D=128,
                                 dtype=torch.float16)),
    "flash_attention_bwd_window": (
        dict(B=4, S=1024, H=4, KVH=1, D=256, window=512),
        dict(B=1, S=2048, H=32, KVH=16, D=128, window=1024)),
    "flash_attention_bwd_hd256": (dict(B=4, S=1024, H=4, KVH=1, D=256),),
    "flash_attention_bwd_noncausal": (
        dict(B=4, S=1500, H=8, KVH=8, D=64, causal=False),
        dict(B=4, S=448, Sk=1500, H=8, KVH=8, D=64, causal=False),
        dict(B=4, S=448, Sk=1500, H=8, KVH=8, D=64, causal=False,
             dtype=torch.float16)),
}


# the backward kernels' times before this design (ms, bf16, NVIDIA H100
# 80GB HBM3 at 700 W): the first designs' chip_smoke.py rows, flash's
# (PR 26) keyed by (B, S, Sk, H, KVH, D, window, causal), the SSD scan's
# (PR 27) by (B, S, h)
BWD_BEFORE_MS = {(4, 512, 512, 24, 8, 128, 0, True): 0.3206,
                 (4, 512, 512, 32, 32, 128, 0, True): 0.3512,
                 (4, 512, 512, 32, 4, 128, 0, True): 0.5841,
                 (2, 777, 777, 8, 2, 64, 0, True): 0.2579,
                 (4, 768, 768, 12, 2, 128, 0, True): 0.6225,
                 (4, 1024, 1024, 4, 1, 256, 512, True): 0.4262,
                 (1, 2048, 2048, 32, 16, 128, 1024, True): 0.8315,
                 (4, 1024, 1024, 4, 1, 256, 0, True): 0.7112,
                 (4, 1500, 1500, 8, 8, 64, 0, False): 0.4917,
                 (4, 448, 1500, 8, 8, 64, 0, False): 0.1712,
                 (4, 1024, 80): 3.3994, (4, 1000, 80): 3.4058,
                 (4, 1000, 256): 9.1674}


def design(lib: str, kernels, smem_fn: str, smem_args) -> dict:
    """A kernel row's design facts: registers and spill bytes of each
    instantiation named in ``kernels`` (from the build's ptxas report) and
    the dynamic shared memory its C library reports for ``smem_args``."""
    fn = getattr(_build.load(lib), smem_fn)
    fn.argtypes, fn.restype = [ctypes.c_int], ctypes.c_int
    return {"ptxas": {k: v for k, v in PTXAS.items()
                      if any(k.startswith(n + "<") for n in kernels)},
            "dynamic_smem_bytes": [fn(a) for a in smem_args]}


def library_bwd_ms(q, k, v, do, window=0, causal=True):
    """SDPA (GQA) forward + backward less its forward, in the same mode
    (causal, a boolean band mask for the window, or ``is_causal=False``):
    the library call's time for the same gradients, on (B, H, S, D) copies
    made before the timing.  Device time (the profiler's kernel events):
    the two host timings it would otherwise subtract carry autograd's host
    time, which moved this difference 0.17-0.75 ms between calls at one
    shape.  K/V are expanded to H heads where the build's SDPA takes no
    ``enable_gqa`` with these arguments."""
    qt, kt, vt, dot = (x.transpose(1, 2).contiguous() for x in (q, k, v, do))
    G = q.shape[2] // k.shape[2]
    mode = dict(is_causal=causal)
    if window:
        i = torch.arange(q.shape[1], device=q.device)
        mode = dict(attn_mask=(i[None] <= i[:, None])
                    & (i[None] > i[:, None] - window))
    try:
        leaves = [x.requires_grad_(True) for x in (qt, kt, vt)]
        fwd = lambda: F.scaled_dot_product_attention(*leaves, **mode,
                                                     enable_gqa=True)
        torch.autograd.grad(fwd(), leaves, dot)
    except (TypeError, RuntimeError):  # a torch without enable_gqa here
        kt, vt = (x.repeat_interleave(G, 1) for x in (kt, vt))
        leaves = [x.detach().requires_grad_(True) for x in (qt, kt, vt)]
        fwd = lambda: F.scaled_dot_product_attention(*leaves, **mode)
    both = lambda: torch.autograd.grad(fwd(), leaves, dot)
    return (device_us(both) - device_us(fwd)) / 1e3


def check_flash_bwd(B, S, H, KVH, D, dtype=torch.bfloat16, window=0,
                    causal=True, Sk=None):
    """The backward kernel against ``flash_attention_bwd_ref`` on the same
    inputs, in its mode: causal, with a sliding ``window``, or non-causal
    (``causal=False``) over keys of their own length ``Sk`` (S by default).
    q, k, v and dO are random, o and lse come from the forward kernel in the
    same mode (its lse held to the plain version's too).  Each of dq, dk, dv
    is held to TOL_ULPS ulps at its own largest plain value; the row's error
    and limit are those of the output nearest its limit.  Planted faults
    (each must put some output above its limit), where the mode has what
    they break: the causal mask left out, dK/dV not summed over the group
    (G > 1), the window left out, the keys cut at Sq (Sk > S), and the
    non-causal gradient taken in the causal mode (Sk = S)."""
    Sk = S if Sk is None else Sk
    g = torch.Generator(device="cuda").manual_seed(S * H + D + Sk + window)
    q, do = (torch.randn((B, S, H, D), generator=g, device="cuda", dtype=dtype)
             for _ in range(2))
    k, v = (torch.randn((B, Sk, KVH, D), generator=g, device="cuda",
                        dtype=dtype) for _ in range(2))
    o, lse = FA.flash_attention_lse(q, k, v, window, causal)
    # the lse output changes no bit of the forward's output
    same_out = torch.equal(o, flash_attention(q, k, v, causal=causal,
                                              window=window))
    _, lse_ref = flash_attention_ref(q, k, v, window, causal, return_lse=True)
    lse_err = (lse - lse_ref).abs().max().item()
    lse_tol = LSE_RTOL * max(1.0, lse_ref.abs().max().item())
    args = (q, k, v, o, lse, do)
    mode = dict(window=window, causal=causal)
    got = FA.flash_attention_bwd(*args, **mode)
    again = FA.flash_attention_bwd(*args, **mode)
    want = flash_attention_bwd_ref(*args, window, causal)
    torch.cuda.synchronize()
    # dK and dV are summed in a fixed order (held); dQ by float32 adds in no
    # fixed order (read)
    same = [torch.equal(a, b) for a, b in zip(got, again)]
    del again

    def ratios(out):
        errs = [(a.float() - b.float()).abs().max().item()
                for a, b in zip(out, want)]
        return [e / kernel_tol(w)[0] for e, w in zip(errs, want)], errs

    r, errs = ratios(got)
    tols = [kernel_tol(w)[0] for w in want]
    worst = max(range(3), key=lambda i: r[i])
    planted = [f for f, on in (("no_causal_mask", causal),
                               ("no_group_sum", H > KVH),
                               ("no_window", window > 0),
                               ("sk_as_sq", Sk > S)) if on]
    faults = {f"fault_ratio_{f}": max(ratios(FA._flash_attention_bwd(
        *args, **mode, flags=FA.FAULTS[f]))[0]) for f in planted}
    if not causal and Sk == S:
        # no flag breaks this mode's mask: the gradient taken causal
        faults["fault_ratio_taken_causal"] = max(ratios(
            FA._flash_attention_bwd(*args))[0])
    iters = 20
    run = lambda: FA.flash_attention_bwd(*args, **mode)
    ms = time_ms(run, iters)
    plain_ms = time_ms(lambda: flash_attention_bwd_ref(*args, window, causal),
                       5)
    lib_ms = library_bwd_ms(q, k, v, do, window, causal)
    # five products (the scores recomputed, dV, dP, dQ, dK) over the pairs
    # the mask keeps; q, k, v, o, dO and lse read once, dq, dk, dv written
    # once
    pairs = S * Sk if not causal else \
        sum(min(n + 1, window) if window else n + 1 for n in range(S))
    ops = 10.0 * B * H * D * pairs
    nbytes = (4 * q.numel() + 4 * k.numel()) * q.element_size() + 4 * lse.numel()
    bound_ms, by = bound(nbytes, ops)
    return {"shape": {"B": B, "S": S, "Sk": Sk, "H": H, "KVH": KVH, "D": D,
                      "window": window, "causal": causal},
            "dtype": str(dtype).removeprefix("torch."),
            "max_abs_err": errs[worst], "tol": tols[worst],
            "binding_output": "d" + "qkv"[worst],
            "errors": dict(zip(("dq", "dk", "dv"), errs)),
            "limits": dict(zip(("dq", "dk", "dv"), tols)),
            "lse_err": lse_err, "lse_tol": lse_tol,
            "out_bitwise_equal_without_lse": same_out, **faults,
            "dk_dv_bit_equal_two_launches": same[1] and same[2],
            "dq_bit_equal_two_launches": same[0],
            "kernel_ms": ms, "kernel_ms_before_redesign": BWD_BEFORE_MS.get(
                (B, S, Sk, H, KVH, D, window, causal))
            if dtype == torch.bfloat16 else None,
            "kernel_host_us": host_us(run),
            "kernel_device_us": device_us(run), "plain_ms": plain_ms,
            "design": design("flash_attention", ["flash_bwd_kernel"],
                             "flash_attention_bwd_smem", [D]),
            "library_ms": lib_ms,
            "library": "F.scaled_dot_product_attention("
                       + ("boolean band mask" if window else
                          "is_causal" if causal else "is_causal=False")
                       + ", GQA) forward + backward less forward, device time",
            "bound_ms": bound_ms, "bound_by": by, "ops": ops, "bytes": nbytes}


def bwd_c_entry_refusals(dims=(32, 96, 512)) -> dict:
    """The backward's C entry called past the wrapper's check, at head_dims
    it has no instantiation for: {D: (its return code, whether its outputs
    and scratch kept their sentinel)}.  Each must return an error and
    launch nothing."""
    lib, fn = _build.entry("flash_attention", "flash_attention_bwd",
                           FA._BWD_ARGTYPES)
    out = {}
    for D in dims:
        B, S, H = 1, 64, 2
        q = torch.randn((B, S, H, D), device="cuda", dtype=torch.bfloat16)
        lse = torch.zeros((B, H, S), device="cuda")
        dq, dk, dv = (torch.full_like(q, 7.0) for _ in range(3))
        acc = torch.full(q.shape, 7.0, device="cuda")
        delta = torch.full((B, H, S), 7.0, device="cuda")
        part = torch.full((2, B, S, H, D), 7.0, device="cuda")
        dev = q.device.index
        with _build.on_device(dev):
            err = fn(*(t.data_ptr() for t in (q, q, q, q, lse, q, dq, dk, dv,
                                              acc, delta, part)),
                     B, S, S, H, H, D, 0, 1, FA.DTYPES[q.dtype], 0,
                     _build.current_stream(dev))
        torch.cuda.synchronize()
        out[D] = (int(err), all(bool((t == 7.0).all())
                                for t in (dq, dk, dv, acc, delta, part)))
    return out


# the fused mode's hand-picked tables (uneven splits, an empty KV region),
# kept for its fp rows and the rmsnorm branch; pages_bound is the most pages
# a request uses (6 KV + 1 ACT), as the engine sizes its tables
HAND_SHAPE = {"B": 4, "kv_cap": 512, "act_cap": 512,
              "kv_tokens": [40, 17, 96, 0], "act_tokens": [24, 47, 16, 70],
              "pages_bound": 7}
# the fused mode's edges for its tiles of four table entries: request 0's
# first tile holds 2 KV and 2 ACT entries, request 1 holds no token at all,
# request 2's first tile is KV only and its second one ACT page of one
# token, request 3 runs into a third tile; 9 entries are no tile multiple
EDGE_SHAPE = {"B": 4, "kv_cap": 256, "act_cap": 256,
              "kv_tokens": [17, 0, 64, 40], "act_tokens": [30, 0, 1, 81],
              "pages_bound": 9}
# the fused rows' ms per launch with the earlier design (one block per
# (head, request) projecting on the CUDA cores), as this script measured them
# on an NVIDIA H100 80GB HBM3 at 700 W (PERF.md section 6), printed beside
# this run's as "kernel_ms_before_tiles"
BEFORE_TILES_MS = {"hand_f16": 4.125, "hand_bf16_rmsnorm_g4": 2.465,
                 "opt_q8": 2.555, "hand_bf16_rmsnorm_g4_q8": 2.830,
                 "lse_fp": (3.252, 3.265), "lse_q8": (2.545, 2.554)}


def check_hybrid(shape=HAND_SHAPE, KVH=32, G=1, D=128, d=4096,
                 dtype=torch.float16, norm_type="layernorm", q8=False,
                 before_ms=None):
    """The fused mode at ``shape``'s tables (a serve path's, see
    ``serve_shape``); ``q8``: its int8 mode, the pools quantized as the
    cache stores them, and the fp mode over the same values timed beside
    it.  Records the wrapper's host time per call and the three kernels'
    device time beside the time per launch, and ``before_ms``, the row's time
    before the tile design."""
    g = torch.Generator(device="cuda").manual_seed(1)
    rnd = lambda *shape, s=1.0, o=0.0: (torch.randn(
        shape, generator=g, device="cuda") * s + o).to(dtype)
    B, kv_cap, act_cap = shape["B"], shape["kv_cap"], shape["act_cap"]
    pages_bound = shape["pages_bound"]
    k_pages = rnd(B * kv_cap // PAGE, PAGE, KVH, D, s=0.5)
    v_pages = rnd(B * kv_cap // PAGE, PAGE, KVH, D, s=0.5)
    act_pages = rnd(B * act_cap // PAGE, PAGE, d, o=0.1)
    q = rnd(B, KVH, G, D)
    scale = rnd(d, s=0.1, o=1.0 if norm_type == "layernorm" else 0.0)
    bias = rnd(d, s=0.2) if norm_type == "layernorm" else None  # non-zero
    wk, wv = rnd(d, KVH, D, s=d ** -0.5), rnd(d, KVH, D, s=d ** -0.5)
    kv_tok, act_tok = (torch.tensor(shape[k], dtype=torch.int32, device="cuda")
                       for k in ("kv_tokens", "act_tokens"))
    tables = M.hybrid_page_table(kv_tok, act_tok, kv_cap, act_cap, pages_bound)
    fp_args = (q, k_pages, v_pages, act_pages, scale, bias, wk, wv)
    sc = {}
    if q8:
        (k_pages, v_pages, act_pages), sc = q8_pools(
            k_pages=k_pages, v_pages=v_pages, act_pages=act_pages)
    args = (q, k_pages, v_pages, act_pages, scale, bias, wk, wv)
    run = lambda f, tabs=tables, sc=sc: f(*args, *tabs, norm_type=norm_type,
                                          **sc)
    got = run(hybrid_paged_attention)
    want = run(hybrid_paged_attention_ref)
    faulty = run(hybrid_paged_attention, M.hybrid_page_table(
        kv_tok, drop_last_page(act_tok), kv_cap, act_cap, pages_bound))
    faults = {"fault_err_last_act_page_dropped":
              (faulty.float() - want.float()).abs().max().item()}
    if q8:
        faulty = run(hybrid_paged_attention, sc=scales_row_off(sc))
        faults["fault_err_scales_row_off"] = \
            (faulty.float() - want.float()).abs().max().item()
    torch.cuda.synchronize()
    err = (got.float() - want.float()).abs().max().item()
    tol, top = kernel_tol(want)
    ms = time_ms(lambda: run(hybrid_paged_attention), 50)
    plain_ms = time_ms(lambda: run(hybrid_paged_attention_ref), 10)
    fp_ms = time_ms(lambda: hybrid_paged_attention(
        *fp_args, *tables, norm_type=norm_type), 50) if q8 else None
    esz = q.element_size()
    n_norm = 2 if bias is not None else 1
    kv_t, act_t = int(kv_tok.sum()), int(act_tok.sum())
    # each valid token's K/V or checkpoint read once (not whole pages)
    rows = q8_bytes(kv_t, act_t, KVH, D, d) if q8 \
        else esz * (kv_t * KVH * D * 2 + act_t * d)
    nbytes = rows + esz * (2 * q.numel() + 2 * d * KVH * D + n_norm * d) \
        + 3 * 4 * B * pages_bound
    ops = KVH * G * (kv_t + act_t) * 4.0 * D + act_t * KVH * 4.0 * d * D
    bound_ms, by = bound(nbytes, ops)
    return {"shape": dict(shape, KVH=KVH, G=G, D=D, d_model=d),
            "dtype": str(dtype).removeprefix("torch."), "norm_type": norm_type,
            "int8": q8, "max_abs_err": err, "tol": tol, "max_abs_out": top,
            **faults, "kernel_ms": ms, "kernel_ms_before_tiles": before_ms,
            "kernel_host_us": host_us(lambda: run(hybrid_paged_attention)),
            "kernel_device_us": device_us(lambda: run(hybrid_paged_attention)),
            "fp_kernel_ms_same_values": fp_ms,
            "plain_ms": plain_ms, "library_ms": None,
            "library": "none: no one PyTorch call norms, projects and attends",
            "bound_ms": bound_ms, "bound_by": by}


def check_cross_act(cfg, B=4, dtype=torch.bfloat16):
    """The fused mode at the encdec model's cross-ACT shape: each request's
    checkpoint of F frames (``M.enc_act_len`` rows, the padding zeros) as
    its ACT pages, tables of ACT pages only (``M.cross_page_table``: every
    page full but the last), a one-page KV pool no entry reads, LayerNorm
    with a bias (``enc_norm``), ``xattn.wk``/``wv`` (d, KVH, D).  Planted
    faults: ``enc_norm``'s scale and bias left out (a checkpoint normed
    otherwise than the encoder's output), and each request's table pointing
    at the next request's pages."""
    g = torch.Generator(device="cuda").manual_seed(2)
    rnd = lambda *shape, s=1.0, o=0.0: (torch.randn(
        shape, generator=g, device="cuda") * s + o).to(dtype)
    F_, d, KVH, D = cfg.enc_seq_len, cfg.d_model, cfg.num_kv_heads, cfg.head_dim
    G = cfg.num_heads // KVH
    act = rnd(B, M.enc_act_len(cfg), d, o=0.1)
    act[:, F_:] = 0
    pool = act.view(-1, PAGE, d)
    q = rnd(B, KVH, G, D)
    scale, bias = rnd(d, s=0.1, o=1.0), rnd(d, s=0.2)
    wk, wv = rnd(d, KVH, D, s=d ** -0.5), rnd(d, KVH, D, s=d ** -0.5)
    no_kv = torch.zeros((1, PAGE, KVH, D), dtype=dtype, device="cuda")
    tables = M.cross_page_table(B, F_, "cuda")
    run = lambda f, sc=scale, bi=bias, tabs=tables: f(
        q, no_kv, no_kv, pool, sc, bi, wk, wv, *tabs, norm_type=cfg.norm_type,
        eps=L.NORM_EPS[cfg.norm_type])
    got = run(hybrid_paged_attention)
    want = run(hybrid_paged_attention_ref)
    other = (tables[0] + tables[0].shape[1]) % (B * tables[0].shape[1])
    faults = {
        "fault_err_enc_norm_weights_left_out": run(
            hybrid_paged_attention, torch.ones_like(scale),
            torch.zeros_like(bias)),
        "fault_err_next_requests_pages": run(
            hybrid_paged_attention, tabs=(other.int(), *tables[1:]))}
    torch.cuda.synchronize()
    faults = {k: (f.float() - want.float()).abs().max().item()
              for k, f in faults.items()}
    err = (got.float() - want.float()).abs().max().item()
    tol, top = kernel_tol(want)
    ms = time_ms(lambda: run(hybrid_paged_attention), 50)
    plain_ms = time_ms(lambda: run(hybrid_paged_attention_ref), 10)
    esz = q.element_size()
    # each frame's checkpoint row read once, the weights and norm once, q
    # read and o written, the three tables; LN and the projection of every
    # frame to K and V, then QK^T and PV
    nbytes = esz * (B * F_ * d + 2 * q.numel() + 2 * d * KVH * D + 2 * d) \
        + 3 * 4 * tables[0].numel()
    ops = B * F_ * KVH * 4.0 * d * D + B * KVH * G * F_ * 4.0 * D
    bound_ms, by = bound(nbytes, ops)
    return {"shape": {"B": B, "F": F_, "pages": tables[0].shape[1], "KVH": KVH,
                      "G": G, "D": D, "d_model": d},
            "dtype": str(dtype).removeprefix("torch."),
            "norm_type": cfg.norm_type, "max_abs_err": err, "tol": tol,
            "max_abs_out": top, **faults, "kernel_ms": ms,
            "kernel_host_us": host_us(lambda: run(hybrid_paged_attention)),
            "kernel_device_us": device_us(lambda: run(hybrid_paged_attention)),
            "plain_ms": plain_ms, "library_ms": None,
            "library": "none: no one PyTorch call norms, projects and attends",
            "bound_ms": bound_ms, "bound_by": by}


def serve_shape(cfg, quant=None, hw=H100_SXM) -> dict:
    """The shapes a serve path gives its decode kernels: the hybrid engine's
    plan (``quant``: the int8 engine's, whose Algorithm 1 splits otherwise;
    ``hw``: a sharded engine prices ``scale_for_shards``) of the trace's
    first group at its last decode step (the widest), computed on the host
    without weights.  On the fused route of an int8 cache the tables leave
    out that step's ACT-bound tokens' own rows (their exact K/V are merged
    after the kernel)."""
    eng = HybridServeEngine(cfg, None, mode="hybrid", hw=hw, quant=quant)
    reqs = request_trace(cfg.vocab_size, **TRACE)
    toks, kv_keep, pbs, sched, pages_bound, act_bound = \
        eng.group_schedule(eng.plan_groups(reqs)[0])
    act = np.asarray(pbs) - kv_keep + sched.sum(1)
    if quant is not None and cfg.pos_type != "rope":
        act = act - sched[:, -1]
    return {"B": len(pbs), "act_cap": eng.act_cap, "kv_cap": eng.kv_cap,
            "kv_tokens": (kv_keep + (~sched).sum(1)).tolist(),
            "act_tokens": act.tolist(), "pages_bound": pages_bound,
            "act_pages_bound": act_bound, "int8_plan": quant is not None,
            "prefill_len": int(toks.shape[1])}


def check_kv_gen(B, n_act, d, KVH, hd=128, act_cap=512, dtype=torch.bfloat16,
                 norm_type="rmsnorm", theta=5e6, q8=False, knorm=False):
    """kv_gen over each of B requests' first ``n_act`` ACT pages, read in
    place from a pool of ``act_cap`` tokens per request, with RoPE at
    scattered positions; ``q8``: its int8 mode over the pool quantized as
    the cache stores it, with two planted faults: each request's last page
    index pointing at the page before it, and the codes one token row off
    (their scales in place).  A scale one row off is read but not held to
    the limit: a per-row factor in front of the norm cancels but for eps and
    rounding, so no limit on the output can see it, and it changes the
    answer by no more than rounding does.  ``knorm``: the K norm epilogue
    (gemma3) with a non-zero scale, and the kernel run without it as the
    planted fault."""
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
    sc, fp_pool = {}, pool
    if q8:
        (pool,), sc = q8_pools(act_pages=pool)
    kn = {"knorm": rnd(hd, s=0.3)} if knorm else {}
    run = lambda f, ix=idx, sc=sc, pages=pool, kn=kn: f(
        pages, scale, bias, wk, wv, page_index=ix, sin=sin, cos=cos,
        norm_type=norm_type, eps=eps, **sc, **kn)
    got, want = run(kv_gen), run(kv_gen_ref)
    faults = {"fault_err_last_slice_dropped": max(
        (a.float() - b.float()).abs().max().item() for a, b in zip(
            run(lambda *a, **kw: _kv_gen(
                *a, **kw, flags=KV_GEN_FAULTS["drop_last_slice"])), want))}
    if knorm:
        faults["fault_err_no_knorm"] = max(
            (a.float() - b.float()).abs().max().item()
            for a, b in zip(run(kv_gen, kn={}), want))
    if q8:
        last = idx.view(B, n_act).clone()
        last[:, -1] -= 1 if n_act > 1 else -1
        shifted = torch.roll(pool.view(-1, d), 1, 0).view_as(pool)
        for name, out in (("fault_err_last_page_dropped",
                           run(kv_gen, ix=last.view(-1))),
                          ("fault_err_codes_row_off", run(kv_gen, pages=shifted)),
                          ("scales_row_off_err_cancelled_by_norm",
                           run(kv_gen, sc=scales_row_off(sc)))):
            faults[name] = max((a.float() - b.float()).abs().max().item()
                               for a, b in zip(out, want))
    torch.cuda.synchronize()
    err = max((a.float() - b.float()).abs().max().item()
              for a, b in zip(got, want))
    tol, top = kernel_tol(*want)
    # the library call: one GEMM of the normed rows against [wk | wv],
    # dequantized (int8), normed and gathered before the timing ("GEMM only")
    rows = pool[idx.long()]
    deq = (lambda: dequantize(rows, sc["act_scales"][idx.long()], dtype)) \
        if q8 else None
    if q8:
        rows = deq()
    a = L.layer_norm(rows, scale, bias, eps) if ln else L.rms_norm(rows, scale, eps)
    # (the K norm, like RoPE, is an epilogue the GEMM-only call leaves out)
    a = a.reshape(N * PAGE, d)
    w = torch.cat([wk.reshape(d, -1), wv.reshape(d, -1)], 1)
    ms = time_ms(lambda: run(kv_gen), 50)
    name = "kv_gen_qk_norm" if knorm else "kv_gen_q8" if q8 else "kv_gen"
    host, device = host_us(lambda: run(kv_gen)), device_us(lambda: run(kv_gen))
    plain_ms = time_ms(lambda: run(kv_gen_ref), 10)
    fp_ms = time_ms(lambda: run(kv_gen, sc={}, pages=fp_pool), 50) if q8 else None
    lib_ms = time_ms(lambda: torch.matmul(a, w), 50)
    dequant_ms = time_ms(deq, 50) if q8 else None
    esz, M = wk.element_size(), N * PAGE
    act_bytes = M * (d + 2) if q8 else esz * M * d
    nbytes = act_bytes + esz * (2 * d * KVH * hd + (2 if ln else 1) * d
                                + 2 * M * KVH * hd) + 4 * (N + 2 * M * hd // 2)
    ops = 4.0 * M * d * KVH * hd + 5.0 * M * d + (6.0 if knorm else 3.0) \
        * M * KVH * hd
    nbytes += esz * hd if knorm else 0
    bound_ms, by = bound(nbytes, ops)
    return {"shape": {"pages": N, "B": B, "act_pages_per_request": n_act,
                      "d_model": d, "KVH": KVH, "hd": hd, "act_cap": act_cap,
                      "rope_theta": theta, "knorm": knorm},
            "dtype": str(dtype).removeprefix("torch."), "norm_type": norm_type,
            "int8": q8, "max_abs_err": err, "tol": tol, "max_abs_out": top,
            **faults, "kernel_ms": ms,
            "kernel_ms_before_redesign": BEFORE_REDESIGN_MS.get((name, d)),
            "kernel_host_us": host, "kernel_device_us": device,
            "fp_kernel_ms_same_values": fp_ms,
            "plain_ms": plain_ms, "library_ms": lib_ms,
            "library": "torch.matmul of the normed rows against [wk|wv], "
                       "GEMM only" + (", rows dequantized beforehand" if q8 else ""),
            "dequant_ms": dequant_ms, "bound_ms": bound_ms, "bound_by": by}


def check_two_pool(shape, KVH=4, G=8, D=128, dtype=torch.bfloat16, q8=False):
    """The hybrid kernel's second-pool mode at a serve path's last-step
    tables: KV pages of (B, kv_cap) regions, ACT entries in a scratch pool of
    ``act_pages_bound`` pages per request (none: a local layer's rings, W =
    kv_cap); ``q8``: the KV pools in int8."""
    g = torch.Generator(device="cuda").manual_seed(3)
    B, kv_cap, n_act = shape["B"], shape["kv_cap"], shape["act_pages_bound"]
    rnd = lambda *sh: (torch.randn(sh, generator=g, device="cuda") * 0.5).to(dtype)
    k_pages, v_pages = rnd(B * kv_cap // PAGE, PAGE, KVH, D), \
        rnd(B * kv_cap // PAGE, PAGE, KVH, D)
    ak, av = rnd(B * n_act, PAGE, KVH, D), rnd(B * n_act, PAGE, KVH, D)
    q = rnd(B, KVH, G, D)
    sc, deq, fp_kv = {}, None, (k_pages, v_pages)
    if q8:
        (k_pages, v_pages), sc = q8_pools(k_pages=k_pages, v_pages=v_pages)
        deq = lambda: (dequantize(k_pages, sc["k_scales"], dtype),
                       dequantize(v_pages, sc["v_scales"], dtype))
    kv_tok, act_tok = (torch.tensor(shape[k], dtype=torch.int32, device="cuda")
                       for k in ("kv_tokens", "act_tokens"))
    table = lambda act: M.hybrid_page_table(kv_tok, act, kv_cap, n_act * PAGE,
                                            shape["pages_bound"])
    args = (q, k_pages, v_pages, ak, av, *table(act_tok))
    got = hybrid_paged_attention_two_pool(*args, **sc)
    want = hybrid_paged_attention_two_pool_ref(*args, **sc)
    if n_act:
        faulty = hybrid_paged_attention_two_pool(
            *args[:5], *table(drop_last_page(act_tok)), **sc)
        fault = "fault_err_last_act_page_dropped"
    else:           # KV pages only (a ring): drop each request's last page
        faulty = hybrid_paged_attention_two_pool(*args[:5], *M.hybrid_page_table(
            drop_last_page(kv_tok), act_tok, kv_cap, 0, shape["pages_bound"]),
            **sc)
        fault = "fault_err_last_kv_page_dropped"
    faults = {fault: (faulty.float() - want.float()).abs().max().item()}
    if q8:
        faulty = hybrid_paged_attention_two_pool(*args, **scales_row_off(sc))
        faults["fault_err_scales_row_off"] = \
            (faulty.float() - want.float()).abs().max().item()
    torch.cuda.synchronize()
    err = (got.float() - want.float()).abs().max().item()
    tol, top = kernel_tol(want)
    # the library call: scaled_dot_product_attention over the same K/V
    # (int8: dequantized beforehand, that time beside it), gathered into
    # (B, H, S, D) with K/V expanded to the H query heads and a mask of the
    # valid tokens, made before the timing
    kv_t, act_t = kv_tok.long(), act_tok.long()
    S = int((kv_t + act_t).max())
    kd = torch.zeros((B, S, KVH, D), dtype=dtype, device="cuda")
    vd = torch.zeros_like(kd)
    kf, vf = deq() if q8 else (k_pages, v_pages)
    for b in range(B):
        nk, na = int(kv_t[b]), int(act_t[b])
        pk = kf.view(B, -1, KVH, D)[b, :nk]
        pv = vf.view(B, -1, KVH, D)[b, :nk]
        kd[b, :nk], vd[b, :nk] = pk, pv
        kd[b, nk:nk + na] = ak.view(B, n_act * PAGE, KVH, D)[b, :na]
        vd[b, nk:nk + na] = av.view(B, n_act * PAGE, KVH, D)[b, :na]
    mask = (torch.arange(S, device="cuda")[None] < (kv_t + act_t)[:, None])
    mask = mask[:, None, None, :]
    qt = q.reshape(B, KVH * G, 1, D)
    kt, vt = (x.transpose(1, 2).repeat_interleave(G, dim=1).contiguous()
              for x in (kd, vd))
    lib = F.scaled_dot_product_attention(qt, kt, vt, attn_mask=mask)
    live = (kv_t + act_t > 0)[:, None, None, None]      # SDPA: NaN on no key
    lib_err = torch.where(live, lib.reshape(B, KVH, G, D).float() - want.float(),
                          0.0).abs().max().item()
    ms = time_ms(lambda: hybrid_paged_attention_two_pool(*args, **sc), 50)
    plain_ms = time_ms(lambda: hybrid_paged_attention_two_pool_ref(*args, **sc),
                       10)
    fp_ms = time_ms(lambda: hybrid_paged_attention_two_pool(
        q, *fp_kv, *args[3:]), 50) if q8 else None
    lib_ms = time_ms(lambda: F.scaled_dot_product_attention(
        qt, kt, vt, attn_mask=mask), 50)
    kernel = lambda: hybrid_paged_attention_two_pool(*args, **sc)
    library = lambda: F.scaled_dot_product_attention(qt, kt, vt, attn_mask=mask)
    host = {"kernel_host_us": host_us(kernel), "library_host_us": host_us(library),
            "kernel_device_us": device_us(kernel),
            "library_device_us": device_us(library)}
    esz = q.element_size()
    n_kv, n_act_t = int(kv_t.sum()), int(act_t.sum())  # each valid K/V read once
    rows = q8_bytes(n_kv, 0, KVH, D, 0) if q8 else esz * n_kv * KVH * D * 2
    nbytes = rows + esz * (2 * q.numel() + n_act_t * KVH * D * 2) \
        + 3 * 4 * B * shape["pages_bound"]
    ops = KVH * G * (n_kv + n_act_t) * 4.0 * D
    bound_ms, by = bound(nbytes, ops)
    return {"shape": dict(shape, KVH=KVH, G=G, D=D),
            "dtype": str(dtype).removeprefix("torch."), "int8": q8,
            "max_abs_err": err, "tol": tol, "max_abs_out": top, **faults,
            "library_err": lib_err, "kernel_ms": ms, **host,
            "fp_kernel_ms_same_values": fp_ms,
            "plain_ms": plain_ms, "library_ms": lib_ms,
            "library": "F.scaled_dot_product_attention"
                       + (", K/V dequantized beforehand" if q8 else ""),
            "dequant_ms": time_ms(deq, 50) if q8 else None,
            "bound_ms": bound_ms, "bound_by": by}


def lse_err(got, want) -> float:
    """max |got - want| / max(1, |want|): relative, absolute below 1."""
    return ((got.float() - want.float()).abs()
            / want.float().abs().clamp_min(1.0)).max().item()


def check_lse(mode, shape, KVH, G, D=128, d=4096, dtype=torch.float16,
              q8=False, before_ms=(None, None)):
    """The hybrid kernel's return_lse mode (``mode`` "fused" or
    "two_pool") against the plain version, in two cases built from a serve
    path's last-step tables: first the CPU lane's device partial, the
    tables the host-attend path launches it with (the new token's own row
    as a one-token KV page of a small pool, then the ACT pages; odd
    requests' new token is ACT-bound, even ones' KV-bound: the last row of
    its KV region), then the same attention over all pages.  In each, o
    within the 4-ulp limit, m and l within LSE_RTOL, and l must fail
    LSE_RTOL with each request's last ACT page dropped.  Then the CPU lane's
    merge: the first case's partial merged with ``host_flash_attention``
    over the other KV rows equals the second case's output, within the
    4-ulp limit.  ``q8``: the int8 mode, the KV pools (and the fused mode's
    ACT pool) quantized as the cache stores them, the host partial over the
    int8 arena; l must also fail LSE_RTOL with the scales one row off.
    ``before_ms``: each case's time before the fused tile design.
    -> [the device partial's case, the all-pages case]."""
    g = torch.Generator(device="cuda").manual_seed(4)
    rnd = lambda *sh, s=0.5, o=0.0: (torch.randn(
        sh, generator=g, device="cuda") * s + o).to(dtype)
    fused = mode == "fused"
    B, cap, n_act = shape["B"], shape["kv_cap"], shape["act_pages_bound"]
    act_stride = shape["act_cap"] if fused else n_act * PAGE
    k_pages, v_pages = (rnd(B * cap // PAGE, PAGE, KVH, D) for _ in range(2))
    q = rnd(B, KVH, G, D, s=1.0)
    if q8:
        (k_pages, v_pages), region_sc = q8_pools(k_pages=k_pages, v_pages=v_pages)
    if fused:
        ap = rnd(B * act_stride // PAGE, PAGE, d, s=1.0, o=0.1)
        act_sc = {}
        if q8:
            (ap,), act_sc = q8_pools(act_pages=ap)
        scale, bias = rnd(d, s=0.1, o=1.0), rnd(d, s=0.2)    # bias non-zero
        wk, wv = rnd(d, KVH, D, s=d ** -0.5), rnd(d, KVH, D, s=d ** -0.5)
        run = lambda f, kp, vp, tabs, **kw: f(
            q, kp, vp, ap, scale, bias, wk, wv, *tabs,
            norm_type="layernorm", **kw)
        kernel, plain = hybrid_paged_attention, hybrid_paged_attention_ref
    else:
        ak, av = rnd(B * n_act, PAGE, KVH, D), rnd(B * n_act, PAGE, KVH, D)
        act_sc = {}
        run = lambda f, kp, vp, tabs, **kw: f(q, kp, vp, ak, av, *tabs, **kw)
        kernel = hybrid_paged_attention_two_pool
        plain = hybrid_paged_attention_two_pool_ref
    kv_tok, act_tok = (torch.tensor(shape[k], dtype=torch.int32, device="cuda")
                       for k in ("kv_tokens", "act_tokens"))
    # the CPU lane's split of the same attention
    store = torch.arange(B, device="cuda") % 2 == 1
    own = (~store & (kv_tok > 0)).int()
    ar, last = torch.arange(B, device="cuda"), (kv_tok - 1).clamp(min=0).long()
    region_k, region_v = (x.view(B, cap, KVH, D) for x in (k_pages, v_pages))
    own_k, own_v = (torch.zeros((B, PAGE, KVH, D), dtype=k_pages.dtype,
                                device="cuda") for _ in range(2))
    own_k[:, 0], own_v[:, 0] = region_k[ar, last], region_v[ar, last]
    own_sc = {}
    if q8:                  # the own row's scales, copied as its codes are
        for key, t in region_sc.items():
            own_sc[key] = torch.zeros((B, PAGE, KVH, 1), dtype=t.dtype,
                                      device="cuda")
            own_sc[key][:, 0] = t.view(B, cap, KVH, 1)[ar, last]
    n_act_req = int(((act_tok + PAGE - 1) // PAGE).max())
    cases = {"cpu_lane_device_partial": (own_k, own_v, own, PAGE, 1 + n_act_req,
                                         own_sc),
             "all_pages": (k_pages, v_pages, kv_tok, cap, shape["pages_bound"],
                           region_sc if q8 else {})}
    out, outputs = [], []
    esz = q.element_size()
    stats = 2 * 4 * B * KVH * G                        # m and l, float32
    for (case, (kp, vp, kv_t, kv_cap, width, kv_sc)), before in zip(
            cases.items(), before_ms):
        table = lambda act: M.hybrid_page_table(kv_t, act, kv_cap, act_stride,
                                                width)
        tabs = table(act_tok)
        sc = dict(kv_sc, **act_sc)
        got = run(kernel, kp, vp, tabs, return_lse=True, **sc)
        want = run(plain, kp, vp, tabs, return_lse=True, **sc)
        faulty = run(kernel, kp, vp, table(drop_last_page(act_tok)),
                     return_lse=True, **sc)
        faults = {"fault_l_err_last_act_page_dropped": lse_err(faulty[2], want[2])}
        if q8:
            faulty = run(kernel, kp, vp, tabs, return_lse=True,
                         **scales_row_off(sc))
            faults["fault_l_err_scales_row_off"] = lse_err(faulty[2], want[2])
        torch.cuda.synchronize()
        outputs.append(got)
        tol, top = kernel_tol(want[0])
        c = {"case": case,
             "shape": dict(shape, KVH=KVH, G=G, D=D, mode=mode,
                           kv_tokens=kv_t.tolist(), kv_cap=kv_cap,
                           pages_bound=width, **({"d_model": d} if fused else {})),
             "dtype": str(dtype).removeprefix("torch."), "int8": q8,
             "max_abs_err": (got[0].float() - want[0].float()).abs().max().item(),
             "tol": tol, "max_abs_out": top,
             "m_err": lse_err(got[1], want[1]), "l_err": lse_err(got[2], want[2]),
             "lse_tol": LSE_RTOL,
             "m_range": [want[1].min().item(), want[1].max().item()],
             "l_range": [want[2].min().item(), want[2].max().item()], **faults}
        c["kernel_ms"] = time_ms(lambda: run(kernel, kp, vp, tabs,
                                             return_lse=True, **sc), 50)
        c["kernel_ms_before_tiles"] = before
        c["kernel_host_us"] = host_us(lambda: run(kernel, kp, vp, tabs,
                                                  return_lse=True, **sc))
        c["kernel_device_us"] = device_us(lambda: run(kernel, kp, vp, tabs,
                                                      return_lse=True, **sc))
        c["plain_ms"] = time_ms(lambda: run(plain, kp, vp, tabs,
                                            return_lse=True, **sc), 10)
        c["library_ms"], c["library"] = None, \
            "none: no one PyTorch call norms, projects and attends"
        if not fused:
            kf, vf = (dequantize(x, kv_sc[n], dtype) if q8 else x
                      for x, n in ((kp, "k_scales"), (vp, "v_scales")))
            c["library_ms"], c["library"], c["library_device_us"] = \
                lse_library(q, kf.view(B, kv_cap, KVH, D),
                            vf.view(B, kv_cap, KVH, D), ak, av, kv_t, act_tok)
            if q8:
                c["library"] += ", K/V dequantized beforehand"
                c["dequant_ms"] = time_ms(lambda: [dequantize(
                    x, kv_sc[n], dtype) for x, n in ((kp, "k_scales"),
                                                     (vp, "v_scales"))], 50)
        kv_n, act_n = int(kv_t.sum()), int(act_tok.sum())
        tables = 3 * 4 * B * width
        if fused:    # each valid token's K/V or checkpoint read once
            rows = q8_bytes(kv_n, act_n, KVH, D, d) if q8 \
                else esz * (kv_n * KVH * D * 2 + act_n * d)
            nbytes = rows + esz * (2 * q.numel() + 2 * d * KVH * D + 2 * d) \
                + tables + stats
            ops = KVH * G * (kv_n + act_n) * 4.0 * D + act_n * KVH * 4.0 * d * D
        else:
            rows = q8_bytes(kv_n, 0, KVH, D, 0) if q8 \
                else esz * kv_n * KVH * D * 2
            nbytes = rows + esz * (2 * q.numel() + act_n * KVH * D * 2) \
                + tables + stats
            ops = KVH * G * (kv_n + act_n) * 4.0 * D
        c["bound_ms"], c["bound_by"] = bound(nbytes, ops)
        out.append(c)
    (o_d, m_d, l_d), full = outputs
    hk, hv = region_k.cpu(), region_v.cpu()
    if q8:                  # the CPU lane reads the int8 arena
        hk, hv = (QuantPlane(x, region_sc[n].view(B, cap, KVH, 1).cpu(), dtype)
                  for x, n in ((hk, "k_scales"), (hv, "v_scales")))
    o_h, m_h, l_h = host_flash_attention(
        q.float().cpu().numpy(), hk, hv, (kv_tok - own).cpu().numpy())[:3]
    merged = merge_partials_torch(o_d.float(), m_d, l_d, *(
        torch.from_numpy(a).cuda() for a in (o_h, m_h, l_h)))[0].to(dtype)
    out[1].update(merge_err=(merged.float() - full[0].float()).abs().max().item(),
                  merge_store_act=store.tolist())
    return out


def lse_library(q, region_k, region_v, ak, av, kv_tok, act_tok):
    """-> (ms, what, device us): one PyTorch call that returns attention and
    its log-sum-exp over the same K/V, gathered dense (expanded to the query
    heads, padded to 16 tokens, masked by an additive bias), made before
    the timing; (None, why, None) if this build has none that takes
    them."""
    B, KVH, G, D = q.shape
    S = -(-int((kv_tok + act_tok).max()) // PAGE) * PAGE
    kd = torch.zeros((B, S, KVH, D), dtype=q.dtype, device="cuda")
    vd = torch.zeros_like(kd)
    for b in range(B):
        nk, na = int(kv_tok[b]), int(act_tok[b])
        kd[b, :nk], vd[b, :nk] = region_k[b, :nk], region_v[b, :nk]
        kd[b, nk:nk + na] = ak.view(B, -1, KVH, D)[b, :na]
        vd[b, nk:nk + na] = av.view(B, -1, KVH, D)[b, :na]
    valid = torch.arange(S, device="cuda")[None] < (kv_tok + act_tok)[:, None]
    bias = torch.zeros((B, KVH * G, 1, S), dtype=q.dtype, device="cuda")
    bias.masked_fill_(~valid[:, None, None, :], float("-inf"))
    qt = q.reshape(B, KVH * G, 1, D)
    kt, vt = (x.transpose(1, 2).repeat_interleave(G, dim=1).contiguous()
              for x in (kd, vd))
    call = lambda: torch.ops.aten._scaled_dot_product_efficient_attention(
        qt, kt, vt, bias, True)
    try:
        call()
        return time_ms(call, 50), ("torch.ops.aten._scaled_dot_product_"
                                   "efficient_attention, compute_log_sumexp"), \
            device_us(call)
    except Exception as e:                      # noqa: BLE001
        return None, f"none: {type(e).__name__}: {str(e)[:160]}", None


def gemma_plan(B: int, S: int, n: int = GEMMA_STEPS) -> dict:
    """One gemma group's hybrid plan: kv_keep = S // 2; store_act alternating
    over the requests (even ones ACT-bound) at every step, as the
    reference's windowed hybrid test has it (no Algorithm-1 pricing exists
    for this family); both regions the page multiple that covers S + n; the
    page bounds of the last step, the widest."""
    sched = np.tile(np.arange(B) % 2 == 0, (n, 1))             # (steps, B)
    kv_keep = S // 2
    cap = -(-(S + n) // PAGE) * PAGE
    kv_tok = kv_keep + (~sched).sum(0)
    act_tok = S - kv_keep + sched.sum(0)
    act_pages = -(-act_tok // PAGE)
    return {"B": B, "S": S, "kv_keep": kv_keep, "sched": sched,
            "kv_cap": cap, "act_cap": cap, "kv_tokens": kv_tok.tolist(),
            "act_tokens": act_tok.tolist(),
            "pages_bound": int((-(-kv_tok // PAGE) + act_pages).max()),
            "act_pages_bound": int(act_pages.max())}


def gemma_shapes(name=GEMMA, groups=GEMMA_GROUPS):
    """A gemma path's decode kernel shapes: a global layer's second-pool
    tables at group 1's last step, and a local layer's rings (W tokens, all
    live: KV pages only)."""
    cfg = get_config(name)
    plan = gemma_plan(*groups[0])
    W = cfg.sliding_window
    B = plan["B"]
    ring = {"B": B, "kv_cap": W, "act_cap": 0, "kv_tokens": [W] * B,
            "act_tokens": [0] * B, "pages_bound": W // PAGE,
            "act_pages_bound": 0}
    return {k: v for k, v in plan.items() if k != "sched"}, ring


def two_pool_edges(yi_shape):
    """Second-pool tables at the split plan's edges: yi's serve shape with
    request 1 holding no token yet; every live page inside one split
    (B * KVH = 128 gives three splits of 8 entries, and each request's 7 KV
    pages and 1 ACT page fill the first); gemma's global table of short
    contexts, 64 entries wide and mostly empty (type 2)."""
    empty = dict(yi_shape, **{k: [0 if b == 1 else n
                                  for b, n in enumerate(yi_shape[k])]
                              for k in ("kv_tokens", "act_tokens")})
    one_split = {"B": 8, "kv_cap": 128, "act_cap": 16, "kv_tokens": [100] * 8,
                 "act_tokens": [10] * 8, "pages_bound": 24,
                 "act_pages_bound": 1}
    gemma_short = {"B": 4, "kv_cap": 1024, "act_cap": 1024,
                   "kv_tokens": [100, 17, 260, 33], "act_tokens": [20, 40, 0, 16],
                   "pages_bound": 64, "act_pages_bound": 32}
    return empty, one_split, gemma_short


def mamba_dt_bias(shape, g):
    """dt biases as Mamba-2 inits them: softplus^-1 of a log-uniform draw
    in ``MAMBA_DT_RANGE``."""
    lo, hi = (math.log(v) for v in MAMBA_DT_RANGE)
    dt0 = torch.exp(torch.rand(shape, generator=g, device="cuda") * (hi - lo)
                    + lo)
    return dt0 + torch.log(-torch.expm1(-dt0))


def draw_dt_biases(params) -> None:
    """Every SSD layer's dt bias drawn as Mamba-2 inits it
    (``mamba_dt_bias``, a generator seeded 0 per stack), in place."""
    stacks = [params["layers"]] if "layers" in params else \
        [params["periods"][k] for k in ("ssd_dense", "ssd_moe")
         if k in params["periods"]]
    for stack in stacks:
        bias = stack["ssd"]["dt_bias"]
        bias.copy_(mamba_dt_bias(bias.shape, torch.Generator(
            device=bias.device).manual_seed(0)))


def ssd_inputs(B, S, cfg, seed=0, dtype=torch.bfloat16):
    """ssd_scan's inputs as mamba2's prefill gives them: x, B and C slices of
    one SiLU'd conv output (``dtype``, the model's bfloat16 by default; x
    read through its strides), dt softplus'ed in float32 around the path's
    biases, A = -linspace(1, 16) as the model inits it."""
    h, p, n = cfg.ssm_num_heads, cfg.ssm_head_dim, cfg.ssm_state_size
    g = torch.Generator(device="cuda").manual_seed(seed)
    xbc = F.silu(torch.randn((B, S, h * p + 2 * n), generator=g,
                             device="cuda")).to(dtype)
    x, Bc, Cc = torch.split(xbc, [h * p, n, n], dim=-1)
    dt = F.softplus(torch.randn((B, S, h), generator=g, device="cuda")
                    + mamba_dt_bias((h,), g))
    A = -torch.linspace(1.0, 16.0, h, device="cuda")
    return x.reshape(B, S, h, p), dt, A, Bc, Cc


def ssd_chunks(x, dt, A, Bc, Cc, *, chunk: int):
    """A planted fault: ssd_scan called on each chunk apart, from a zero
    state each (the state not carried).  -> (y, the last chunk's state)."""
    ys, state = [], None
    for c0 in range(0, x.shape[1], chunk):
        c1 = c0 + chunk
        y, state = ssd_scan(x[:, c0:c1], dt[:, c0:c1].contiguous(), A,
                            Bc[:, c0:c1], Cc[:, c0:c1], chunk=chunk)
        ys.append(y)
    return torch.cat(ys, 1), state


def rel_err(got, want) -> float:
    return ((got.float() - want.float()).abs().max()
            / want.float().abs().max()).item()


def check_ssd_scan(B, S, cfg, dtype=torch.bfloat16):
    """ssd_scan against its plain version at one of mamba2's prefill shapes:
    y under the 4-ulp limit, the final state under ``SSD_STATE_RTOL``.
    Planted faults: the kernel called one chunk at a time (the state not
    carried; read on y), the final state taken before the last chunk (the
    ragged one where S is no chunk multiple; read on the state), and each
    chunk handed the previous chunk's C B^T (read on y).  Read, not held:
    the kernel without its lo pieces.  ``dtype``: bfloat16 (the model's;
    16-bit products) or float16 (TF32 products)."""
    chunk = cfg.ssm_chunk
    x, dt, A, Bc, Cc = ssd_inputs(B, S, cfg, seed=S, dtype=dtype)
    y, state = ssd_scan(x, dt, A, Bc, Cc, chunk=chunk)
    want_y, want_state = ssd_chunked_ref(x, dt, A, Bc, Cc, chunk=chunk)
    y_nc, _ = ssd_chunks(x, dt, A, Bc, Cc, chunk=chunk)
    last = (S - 1) // chunk * chunk
    _, state_early = ssd_scan(x[:, :last], dt[:, :last].contiguous(), A,
                              Bc[:, :last], Cc[:, :last], chunk=chunk)
    y_lag, _ = _ssd_scan(x, dt, A, Bc, Cc, chunk=chunk,
                         flags=SSD_FAULTS["previous_chunk_gram"])
    y_nolo, state_nolo = _ssd_scan(x, dt, A, Bc, Cc, chunk=chunk,
                                   flags=SSD_FAULTS["drop_lo_terms"])
    torch.cuda.synchronize()
    tol, top = kernel_tol(want_y)
    run = lambda: ssd_scan(x, dt, A, Bc, Cc, chunk=chunk)
    ms = time_ms(run, 10)
    plain_ms = time_ms(lambda: ssd_chunked_ref(x, dt, A, Bc, Cc, chunk=chunk), 10)
    h, p, n = x.shape[2], x.shape[3], Bc.shape[-1]
    # the chunk products over each chunk's real rows c: C B^T (c x c x n),
    # its product with x (c x c x p), C state^T and the state update
    # (c x n x p each), per (request, head)
    rows = [min(chunk, S - c0) for c0 in range(0, S, chunk)]
    ops = 2.0 * B * h * sum(c * c * n + c * c * p + 2 * c * n * p for c in rows)
    nbytes = (2 * x.numel() * x.element_size() + dt.numel() * 4 + A.numel() * 4
              + 2 * B * S * n * Bc.element_size() + state.numel() * 4)
    bound_ms, by = bound(nbytes, ops)
    return {"shape": {"B": B, "S": S, "h": h, "p": p, "n": n, "chunk": chunk},
            "dtype": str(dtype).removeprefix("torch."),
            "max_abs_err": (y.float() - want_y.float())
            .abs().max().item(), "tol": tol, "max_abs_out": top,
            "state_rel_err": rel_err(state, want_state),
            "state_rtol": SSD_STATE_RTOL,
            "fault_err_state_not_carried": (y_nc.float() - want_y.float())
            .abs().max().item(),
            "fault_state_rel_err_before_last_chunk": rel_err(state_early,
                                                             want_state),
            "fault_err_previous_chunk_gram": (y_lag.float() - want_y.float())
            .abs().max().item(),
            # read, not held: the hi pieces alone, one rounding per operand
            "diag_state_rel_err_without_lo_terms": rel_err(state_nolo, want_state),
            "diag_max_abs_err_without_lo_terms": (y_nolo.float() - want_y.float())
            .abs().max().item(),
            "finite": bool(torch.isfinite(y).all() and torch.isfinite(state)
                           .all()),
            "kernel_ms": ms,
            "kernel_ms_before_redesign": BEFORE_REDESIGN_MS.get(("ssd_scan", S))
            if dtype == torch.bfloat16 and cfg.name == MAMBA else None,
            "kernel_host_us": host_us(run, 50), "kernel_device_us": device_us(run),
            "plain_ms": plain_ms, "library_ms": None,
            "library": "none: no single PyTorch call computes the chunked "
                       "scan with its carried state",
            "bound_ms": bound_ms, "bound_by": by, "ops": ops, "bytes": nbytes}


def check_ssd_scan_bwd(B, S, cfg, dtype=torch.bfloat16):
    """The SSD scan's backward kernel against ``ssd_scan_bwd_ref`` on the
    same inputs (``ssd_inputs``: the model's strided slices, Mamba-2's dt
    init), a random dy and a random final-state cotangent.  Each of dx, ddt,
    dA, dB, dC is held to its own limit (``SSD_STATE_RTOL`` for the
    float32 ones, ``TOL_ULPS`` ulps for the rest); the row's error and limit
    are those of the output nearest its limit.  Planted faults (each must
    put some output above its limit): the state's cotangent not carried
    across chunks, dB and dC taken from one head."""
    chunk = cfg.ssm_chunk
    x, dt, A, Bc, Cc = ssd_inputs(B, S, cfg, seed=S + 7, dtype=dtype)
    g = torch.Generator(device="cuda").manual_seed(S + 11)
    dy = torch.randn(x.shape, generator=g, device="cuda").to(dtype)
    dfinal = torch.randn((B, x.shape[2], x.shape[3], Bc.shape[-1]),
                         generator=g, device="cuda")
    args = (x, dt, A, Bc, Cc, dy, dfinal)
    got = SSD.ssd_scan_bwd(*args, chunk=chunk)
    again = SSD.ssd_scan_bwd(*args, chunk=chunk)
    want = ssd_scan_bwd_ref(*args, chunk=chunk)
    torch.cuda.synchronize()
    # every sum in a fixed order: two launches give the same bits
    same = all(torch.equal(a, b) for a, b in zip(got, again))
    del again
    # dx, dB and dC are float32 sums rounded once to the dtype (dB and dC
    # summed over the heads): TOL_ULPS ulps at the output's largest plain
    # value; ddt and dA stay float32, sums over the chunk's rows and the
    # state's entries (dA also over requests and chunks) in another order:
    # the forward's state limit, relative to the largest plain value
    names = ("dx", "ddt", "dA", "dB", "dC")
    tols = [SSD_STATE_RTOL * w.float().abs().max().item()
            if w.dtype == torch.float32 else kernel_tol(w)[0] for w in want]

    def ratios(out):
        errs = [(a.float() - b.float()).abs().max().item()
                for a, b in zip(out, want)]
        return [e / t for e, t in zip(errs, tols)], errs

    r, errs = ratios(got)
    worst = max(range(5), key=lambda i: r[i])
    faults = {f"fault_ratio_{f}": max(ratios(SSD._ssd_scan_bwd(
        *args, chunk=chunk, flags=SSD_FAULTS[f]))[0])
        for f in ("bwd_state_not_carried", "bwd_heads_not_summed")}
    run = lambda: SSD.ssd_scan_bwd(*args, chunk=chunk)
    ms = time_ms(run, 5)
    plain_ms = time_ms(lambda: ssd_scan_bwd_ref(*args, chunk=chunk), 2)
    h, p, n = x.shape[2], x.shape[3], Bc.shape[-1]
    # per request and chunk of c real rows, multiply-adds: per head, dy x^T
    # and dx's intra term (c x c x p each) and c x p x n each for dx's, dC's
    # and dB's state terms, the new dS and the state pass; once for all the
    # heads (B and C are one group), C B^T and the intra terms of dC and dB
    # (c x c x n each: the heads' c x c weights summed before the product);
    # the inputs (x, dt, B, C, dy, the final state's cotangent) read once,
    # dx, ddt, dA, dB, dC written once
    rows = [min(chunk, S - c0) for c0 in range(0, S, chunk)]
    ops = 2.0 * B * sum(h * (2 * c * c * p + 5 * c * p * n) + 3 * c * c * n
                        for c in rows)
    es = x.element_size()
    nbytes = (3 * x.numel() * es + 2 * dt.numel() * 4 + 2 * A.numel() * 4
              + 4 * B * S * n * es + dfinal.numel() * 4)
    bound_ms, by = bound(nbytes, ops)
    return {"shape": {"B": B, "S": S, "h": h, "p": p, "n": n, "chunk": chunk},
            "dtype": str(dtype).removeprefix("torch."),
            "max_abs_err": errs[worst], "tol": tols[worst],
            "binding_output": names[worst],
            "errors": dict(zip(names, errs)), "limits": dict(zip(names, tols)),
            "ratios": dict(zip(names, r)), **faults,
            "finite": all(bool(torch.isfinite(t).all()) for t in got),
            "bit_equal_two_launches": same,
            "kernel_ms": ms, "kernel_ms_before_redesign": BWD_BEFORE_MS.get(
                (B, S, x.shape[2])) if dtype == torch.bfloat16 else None,
            "kernel_host_us": host_us(run, 10),
            "kernel_device_us": device_us(run, 5), "plain_ms": plain_ms,
            "head_groups": SSD_REF.head_groups(
                B, -(-S // chunk), x.shape[2],
                torch.cuda.get_device_properties(0).multi_processor_count),
            "design": design("ssd_scan", ["ssd_bwd_state_kernel",
                                          "ssd_bwd_chunk_kernel"],
                             "ssd_scan_bwd_smem", [0, 1]),
            "library_ms": None,
            "library": "none: no single PyTorch call computes the scan's "
                       "gradient",
            "bound_ms": bound_ms, "bound_by": by, "ops": ops, "bytes": nbytes}


def ssd_bwd_c_entry_refusals(shapes=((32, 128, 64), (64, 64, 64),
                                     (64, 128, 32))) -> dict:
    """The SSD backward's C entry called past the wrapper's check at (p, n,
    chunk) it was not built for: {shape: (its return code, whether its
    outputs and scratch kept their sentinel)}.  Each must return an error
    and launch nothing."""
    lib, fn = _build.entry("ssd_scan", "ssd_scan_bwd", SSD._BWD_ARGTYPES)
    out = {}
    for p, n, chunk in shapes:
        b, s, h = 1, 64, 2
        x = torch.zeros((b, s, h, p), device="cuda", dtype=torch.bfloat16)
        bc = torch.zeros((b, s, n), device="cuda", dtype=torch.bfloat16)
        dt = torch.zeros((b, s, h), device="cuda")
        A = torch.zeros((h,), device="cuda")
        outs = [torch.full_like(x, 7.0), torch.full_like(dt, 7.0),
                torch.full_like(A, 7.0), torch.full_like(bc, 7.0),
                torch.full_like(bc, 7.0),
                torch.full((4, b, 1, h, n, p), 7.0, device="cuda",
                           dtype=x.dtype),
                torch.full((2, b, s, 1, n), 7.0, device="cuda"),
                torch.full((b, 1, h), 7.0, device="cuda")]
        dev = x.device.index
        with _build.on_device(dev):
            err = fn(x.data_ptr(), dt.data_ptr(), A.data_ptr(), bc.data_ptr(),
                     bc.data_ptr(), x.data_ptr(), None,
                     *(t.data_ptr() for t in outs), b, s, h, p, n, chunk, 1,
                     x.stride(0), x.stride(1), bc.stride(0), bc.stride(1),
                     bc.stride(0), bc.stride(1), SSD.DTYPES[x.dtype], 0,
                     _build.current_stream(dev))
        torch.cuda.synchronize()
        out[f"{p},{n},{chunk}"] = (int(err), all(bool((t == 7.0).all())
                                                 for t in outs))
    return out


def card_reduced(name):
    """``name``'s ``-reduced`` config as the twins run it on the card, in
    the full config's dtype."""
    full = get_config(name)
    return reduced(full, dtype=full.dtype)


def twin_specs() -> list:
    """(row list, check, its arguments) at each kernel shape the example
    twins launch (``launch_keys``; head_dim 32 but train_lm's 64):
    quickstart's reduced OPT (float16) flash prefill and fused decode at its
    engine's plan (``serve_shape``: the same trace); arch_zoo's (B 2, S 32,
    and qwen2-vl's patches) in each family's modes at its reduced widths
    and dtype: causal, windowed (the window covers the prompt, so each
    window also runs at a length it cuts, for its planted fault), whisper's
    non-causal encoder, the SSD scan (mamba2's and jamba's widths agree);
    long_context_ssm's SSD scan at B 1, S 64; train_lm's yi-100m forward
    and backward (B 8, S 256, bfloat16)."""
    opt = card_reduced("opt-6.7b")
    ow = dict(H=opt.num_heads, KVH=opt.num_kv_heads, D=opt.head_dim,
              dtype=M.torch_dtype(opt))
    osh = serve_shape(opt)
    specs = [("flash_attention", check_flash, dict(B=osh["B"],
                                                   S=osh["prefill_len"], **ow)),
             ("hybrid_paged_attention", check_hybrid, dict(
                 shape=osh, KVH=opt.num_kv_heads, G=1, D=opt.head_dim,
                 d=opt.d_model, dtype=M.torch_dtype(opt),
                 norm_type=opt.norm_type))]
    B, S = 2, 32
    for name in ASSIGNED:
        c = card_reduced(name)
        if c.ssm_state_size:
            specs.append(("ssd_scan", check_ssd_scan, dict(B=B, S=S, cfg=c)))
        if c.arch_type == "ssm":
            continue
        w = dict(H=c.num_heads, KVH=c.num_kv_heads, D=c.head_dim,
                 dtype=M.torch_dtype(c))
        S_ = S + (c.frontend_tokens if c.frontend == "vision_stub" else 0)
        if c.is_encoder_decoder:
            specs.append(("flash_attention_noncausal", check_flash,
                          dict(B=B, S=c.enc_seq_len, causal=False, **w)))
        if c.sliding_window:
            specs += [("flash_attention_window", check_flash,
                       dict(B=B, S=n, window=c.sliding_window, **w))
                      for n in (S_, 2 * c.sliding_window + 37)]
        specs.append(("flash_attention", check_flash, dict(B=B, S=S_, **w)))
    specs.append(("ssd_scan", check_ssd_scan,
                  dict(B=1, S=64, cfg=card_reduced(MAMBA))))
    lm = dict(B=8, S=256, H=12, KVH=4, D=64, dtype=torch.bfloat16)
    return specs + [("flash_attention", check_flash, lm),
                    ("flash_attention_bwd", check_flash_bwd, lm)]


def spec_key(kind, kw) -> tuple:
    """The ``launch_keys`` key a twin or shard spec's row holds (its int8
    and ``return_lse`` modes by the row list's name and ``q8``)."""
    dt = str(kw.get("dtype", torch.bfloat16)).removeprefix("torch.")
    q8, lse = bool(kw.get("q8")), "return_lse" in kind
    if kind == "ssd_scan":
        c = kw["cfg"]
        return ("ssd", c.ssm_num_heads, c.ssm_head_dim, c.ssm_state_size,
                c.ssm_chunk, str(M.torch_dtype(c)).removeprefix("torch."))
    if kind.startswith("hybrid_paged_attention_two_pool"):
        return ("two_pool", kw["KVH"], kw["G"], kw["D"], dt, q8, lse)
    if kind.startswith("hybrid_paged_attention_return_lse"):
        dt = str(kw.get("dtype", torch.float16)).removeprefix("torch.")
        return ("hybrid", kw["KVH"], kw["G"], kw["D"], kw["d"], dt,
                "layernorm", q8, True)
    if kind.startswith("hybrid_paged_attention"):
        return ("hybrid", kw["KVH"], kw["G"], kw["D"], kw["d"], dt,
                kw["norm_type"], q8, False)
    if kind.startswith("kv_gen"):
        return ("kv_gen", kw["KVH"], kw["hd"], kw["d"], dt, kw["norm_type"],
                False, q8)
    mode = (kw["H"], kw["KVH"], kw["D"], dt, kw.get("window", 0),
            kw.get("causal", True))
    return ("flash_bwd" if kind == "flash_attention_bwd" else "flash",) + mode


def twin_kernel_rows(specs=None, tag="twin_key") -> dict:
    """Each spec's row (default ``twin_specs``), by its row list, tagged
    with the key it holds (``tag``); one row per (list, key, batch,
    length)."""
    rows, seen = {}, set()
    for kind, check, kw in twin_specs() if specs is None else specs:
        key = spec_key(kind, kw)
        at = (kind, key, kw.get("B"), kw.get("S"))
        if at in seen:
            continue
        seen.add(at)
        got = check(**kw)                   # check_lse: a row per case
        for row in got if isinstance(got, list) else [got]:
            rows.setdefault(kind, []).append(dict(row, **{tag: list(key)}))
    return rows


# the shard phase: each model's meshes (data, model), the server's and the
# offload executor's runs (the whole trace) on OPT's first (1x2)
SHARD_MESHES = {"opt-6.7b": ((1, 2), (2, 2)), "yi-6b": ((1, 2),)}
SHARD_SERVER = dict(slots=4, kv_cap=512, act_cap=512, chunk_steps=4)
SHARD_LIMIT = 0.25
SHARD_FAULTS = ("wo_partial_dropped", "kv_gen_on_own_d_slice")
# the legs of item 5.2.1-5.2.3 beside them (each on its model's serve
# weights): the int8 cache on 1x2 (yi's with the planted ACT scale fault:
# each position quantizing against its own slice's scale), OPT's offload
# executor with the CPU lane on 1x2 over the serve trace's first group, yi
# on 1x8 (4 query heads a position over the one KV head they share, of 4
# replicated) teacher-forced on the first group, and dbrx at its serve
# cut on 1x2 (expert parallel, 8 of 16 experts a position; the ``wo``
# fault)
SHARD_LEGS = {"opt-6.7b": ("1x2 int8", "1x2 cpu lane"),
              "yi-6b": ("1x2 int8", "1x8"),
              "dbrx-132b": ("1x2",)}
SHARD_INT8_FAULT = "act_scale_of_own_slice"


def leg_mesh(leg: str) -> tuple:
    return tuple(int(x) for x in leg.split()[0].split("x"))


def shard_specs() -> list:
    """(row list, check, its arguments) at each per-position kernel key of
    the shard phase: at each mesh's model axis, each position's attended
    head counts (``Layout.cfg_l``), d_model whole (the ACT rows are
    gathered before KV-Gen), at the sharded engine's plan of the trace
    (``serve_shape`` priced on ``scale_for_shards``; the int8 legs' at the
    int8 engine's), the int8 and ``return_lse`` modes where a leg runs
    them.  One row per key; the 2x2 mesh's positions run the 1x2 keys."""
    specs, keys = [], set()

    def add(kind, check, kw):
        key = (kind, spec_key(kind, kw))
        if key not in keys:
            keys.add(key)
            specs.append((kind, check, kw))

    legs = [(name, f"{m[0]}x{m[1]}") for name, ms in SHARD_MESHES.items()
            for m in ms]
    legs += [(name, leg) for name, ls in SHARD_LEGS.items() for leg in ls]
    for name, leg in legs:
        cfg = moe_config(name) if name in MOE_LAYERS else get_config(name)
        plan = make_shard_plan(cfg, make_test_mesh(*leg_mesh(leg),
                                                   device="meta"))
        cl = SHD.Layout(plan).cfg_l
        H, KVH = cl.num_heads, cl.num_kv_heads
        q8 = leg.endswith("int8")
        sh = serve_shape(cfg, QuantConfig() if q8 else None,
                         hw=scale_for_shards(H100_SXM, plan.shard_factor))
        dt = M.torch_dtype(cfg)
        add("flash_attention", check_flash,
            dict(B=sh["B"], S=sh["prefill_len"], H=H, KVH=KVH,
                 D=cfg.head_dim, dtype=dt))
        sfx = "_q8" if q8 else ""
        if cfg.pos_type == "rope":
            add("hybrid_paged_attention_two_pool" + sfx, check_two_pool,
                dict(shape=sh, KVH=KVH, G=H // KVH, D=cfg.head_dim, dtype=dt,
                     q8=q8))
            add("kv_gen" + sfx, check_kv_gen,
                dict(B=sh["B"], n_act=sh["act_pages_bound"], d=cfg.d_model,
                     KVH=KVH, hd=cfg.head_dim, act_cap=sh["act_cap"],
                     dtype=dt, norm_type=cfg.norm_type, theta=cfg.rope_theta,
                     q8=q8))
            continue
        add("hybrid_paged_attention" + sfx, check_hybrid,
            dict(shape=sh, KVH=KVH, G=H // KVH, D=cfg.head_dim,
                 d=cfg.d_model, dtype=dt, norm_type=cfg.norm_type, q8=q8))
        if q8 or leg.endswith("cpu lane"):
            # the int8 step's exact-row merge, or the CPU lane's device
            # partial: the fused return_lse mode
            add("hybrid_paged_attention_return_lse" + sfx, check_lse,
                dict(mode="fused", shape=sh, KVH=KVH, G=H // KVH,
                     D=cfg.head_dim, d=cfg.d_model, dtype=dt, q8=q8))
    return specs


def phase_kernels(results):
    """Per kernel, the serve path's shapes first: opt-6.7b's (float16, MHA,
    LayerNorm, G=1), then yi-6b's (bfloat16, G=8: flash prefill, kv_gen and
    the second-pool mode at the engine's planned shapes), then other
    branches the wrappers accept: GQA flash at G=4, the fused kernel's
    rmsnorm, and kv_gen at minitron-4b's widths with a LayerNorm bias.  The
    int8 modes run at the int8 engine's plans, which split otherwise.  Then
    gemma3-1b's (bfloat16, MQA with G = 4, head_dim 256): the flash kernel
    causal and in its window mode at group 1's prompt, the second-pool mode
    at a global layer's tables and at a local layer's rings, and kv_gen with
    the K norm.  Last, ssd_scan at both of mamba2's prefill shapes
    (bfloat16, h = 80, P = 64, N = 128), the ragged one first, and once in
    float16.  Beyond the
    serve shapes: flash at a ragged GQA length (2 x 777, H = 8, KVH = 2,
    causal and window 100) and at D = 64, and the second-pool mode at the
    split plan's edges (``two_pool_edges``).  The second-pool rows also
    record the wrapper's host time per call and the kernels' device time, each
    beside the library call's.  Last, the flash backward at the training
    shapes of each of its modes (``BWD_SHAPES``: causal, window, head_dim
    256, non-causal), with the forward's lse output in the same mode.  jamba's
    prefill shapes (its cut, ``jamba_config``): flash at B 4, S 1000, H 64
    over 8 KV heads, D 128, no rotation, and ``ssd_scan`` at h 256; and
    gemma3-27b's (G = 2, head_dim 128, W = 1024): flash causal and in its
    window mode at group 1's prompt, the second-pool mode at a global
    layer's tables and at a local layer's rings, ``kv_gen`` with the K norm
    at head_dim 128; each appended last to its kernel's rows.  Last, the SSD
    scan's backward at mamba2's training rows, a ragged length and jamba's
    heads (bfloat16), the ragged length in float16, and its C entry's
    refusals.  Then, appended last to their lists, the example twins'
    shapes (``twin_specs``: head_dim 32, train_lm's 64), each row tagged
    with the key it holds (``twin_key``; ``twin_keys`` lists them); the
    examples phase fails if a twin calls a kernel at any other key."""
    yi, opt = get_config("yi-6b"), get_config("opt-6.7b")
    mamba = get_config(MAMBA)
    gemma = get_config(GEMMA)
    g_global, g_ring = gemma_shapes()
    gB, gS = GEMMA_GROUPS[0]
    gw = dict(H=gemma.num_heads, KVH=gemma.num_kv_heads, D=gemma.head_dim,
              dtype=torch.bfloat16)
    shape, opt_shape = serve_shape(yi), serve_shape(opt)
    tp_empty, tp_one_split, g_short = two_pool_edges(shape)
    yi_q8, opt_q8 = serve_shape(yi, QuantConfig()), serve_shape(opt, QuantConfig())
    bf16 = torch.bfloat16
    dbrx, grok = moe_config("dbrx-132b"), moe_config("grok-1-314b")
    m_shape, g_shape = serve_shape(dbrx), serve_shape(grok)
    wh, qw = get_config(WHISPER), get_config(QWEN)
    wB, wS = FRONTEND_GROUP
    wkw = dict(H=wh.num_heads, KVH=wh.num_kv_heads, D=wh.head_dim, dtype=bf16,
               causal=False)
    jamba, g27 = jamba_config(), get_config(GEMMA27)
    jB, jS = MAMBA_GROUPS[0]
    g27_global, g27_ring = gemma_shapes(GEMMA27, GEMMA27_GROUPS)
    g27B, g27S = GEMMA27_GROUPS[0]
    g27w = dict(H=g27.num_heads, KVH=g27.num_kv_heads, D=g27.head_dim,
                dtype=bf16)
    m_kv_gen = lambda sh, c: check_kv_gen(
        sh["B"], sh["act_pages_bound"], c.d_model, c.num_kv_heads,
        hd=c.head_dim, act_cap=sh["act_cap"], norm_type=c.norm_type,
        theta=c.rope_theta)
    out = {"phase": "kernels", "yi_serve_shape": shape,
           "yi_serve_shape_q8": yi_q8, "opt_serve_shape_q8": opt_q8,
           "flash_attention": [
               check_flash(4, 80), check_flash(1, 2048),
               check_flash(4, 80, H=32, KVH=8, dtype=bf16),
               check_flash(4, 80, H=32, KVH=4, dtype=bf16),
               check_flash(1, 2048, H=32, KVH=4, dtype=bf16),
               check_flash(gB, gS, **gw),
               check_flash(2, 777, H=8, KVH=2, dtype=bf16),
               check_flash(4, 512, H=8, KVH=8, D=64),
               check_flash(wB, qw.frontend_tokens + wS, H=qw.num_heads,
                           KVH=qw.num_kv_heads, dtype=bf16),
               check_flash(m_shape["B"], m_shape["prefill_len"],
                           H=dbrx.num_heads, KVH=dbrx.num_kv_heads,
                           dtype=bf16),
               check_flash(jB, jS, H=jamba.num_heads, KVH=jamba.num_kv_heads,
                           D=jamba.head_dim, dtype=bf16),
               check_flash(g27B, g27S, **g27w)],
           "hybrid_paged_attention": [
               check_hybrid(before_ms=BEFORE_TILES_MS["hand_f16"]),
               check_hybrid(KVH=8, G=4, dtype=bf16, norm_type="rmsnorm",
                            before_ms=BEFORE_TILES_MS["hand_bf16_rmsnorm_g4"]),
               check_hybrid(EDGE_SHAPE, KVH=4, G=8, D=64, d=2048, dtype=bf16),
               check_hybrid(EDGE_SHAPE, KVH=4, G=8, D=64, d=2048,
                            norm_type="rmsnorm")],
           "hybrid_paged_attention_two_pool": [
               check_two_pool(shape), check_two_pool(tp_empty),
               check_two_pool(tp_one_split, KVH=16, G=2),
               check_two_pool(m_shape, KVH=dbrx.num_kv_heads,
                              G=dbrx.num_heads // dbrx.num_kv_heads)]
           + [check_two_pool(g, KVH=g27.num_kv_heads,
                             G=g27.num_heads // g27.num_kv_heads,
                             D=g27.head_dim) for g in (g27_global, g27_ring)],
           "kv_gen": [
               check_kv_gen(shape["B"], shape["act_pages_bound"], yi.d_model,
                            yi.num_kv_heads),
               check_kv_gen(shape["B"], shape["act_pages_bound"], 3072, 8,
                            dtype=torch.float16, norm_type="layernorm",
                            theta=1e4),
               m_kv_gen(m_shape, dbrx), m_kv_gen(g_shape, grok)],
           "hybrid_paged_attention_return_lse":
               check_lse("fused", opt_shape, KVH=32, G=1,
                         before_ms=BEFORE_TILES_MS["lse_fp"]),
           "hybrid_paged_attention_two_pool_return_lse":
               check_lse("two_pool", shape, KVH=4, G=8, dtype=bf16),
           "hybrid_paged_attention_q8": [
               check_hybrid(opt_q8, q8=True,
                            before_ms=BEFORE_TILES_MS["opt_q8"]),
               check_hybrid(EDGE_SHAPE, KVH=4, G=8, D=64, d=2048, q8=True),
               check_hybrid(KVH=8, G=4, dtype=bf16, norm_type="rmsnorm",
                            before_ms=BEFORE_TILES_MS["hand_bf16_rmsnorm_g4_q8"],
                            q8=True)],
           "hybrid_paged_attention_two_pool_q8": [check_two_pool(yi_q8, q8=True)],
           "kv_gen_q8": [check_kv_gen(yi_q8["B"], yi_q8["act_pages_bound"],
                                      yi.d_model, yi.num_kv_heads, q8=True)],
           "hybrid_paged_attention_return_lse_q8":
               check_lse("fused", opt_q8, KVH=32, G=1, q8=True,
                         before_ms=BEFORE_TILES_MS["lse_q8"]),
           "hybrid_paged_attention_two_pool_return_lse_q8":
               check_lse("two_pool", yi_q8, KVH=4, G=8, dtype=bf16, q8=True),
           "flash_attention_window": [
               check_flash(gB, gS, window=gemma.sliding_window, **gw),
               check_flash(2, 777, H=8, KVH=2, dtype=bf16, window=100),
               check_flash(g27B, g27S, window=g27.sliding_window, **g27w)],
           "hybrid_paged_attention_two_pool_hd256": [
               check_two_pool(g, KVH=gemma.num_kv_heads,
                              G=gemma.num_heads // gemma.num_kv_heads,
                              D=gemma.head_dim)
               for g in (g_global, g_ring, g_short)],
           "kv_gen_qk_norm": [
               check_kv_gen(g_global["B"], g_global["act_pages_bound"],
                            gemma.d_model, gemma.num_kv_heads, hd=gemma.head_dim,
                            act_cap=g_global["act_cap"], theta=gemma.rope_theta,
                            knorm=True),
               check_kv_gen(g27_global["B"], g27_global["act_pages_bound"],
                            g27.d_model, g27.num_kv_heads, hd=g27.head_dim,
                            act_cap=g27_global["act_cap"], theta=g27.rope_theta,
                            knorm=True)],
           "ssd_scan": [check_ssd_scan(B, S, mamba) for B, S in MAMBA_GROUPS]
           + [check_ssd_scan(*MAMBA_GROUPS[1], mamba, dtype=torch.float16),
              check_ssd_scan(jB, jS, jamba)],
           # whisper's encoder (F frames each way) and its cross attention
           # (the prompt over the F frames); the fused mode over its
           # checkpoint
           "flash_attention_noncausal": [
               check_flash(wB, wh.enc_seq_len, **wkw),
               check_flash(wB, wS, Sk=wh.enc_seq_len, **wkw)],
           "hybrid_paged_attention_cross_act": [check_cross_act(wh, B=wB)],
           **{name: [check_flash_bwd(**sh) for sh in shapes]
              for name, shapes in BWD_SHAPES.items()},
           "flash_attention_bwd_c_entry_refusals": bwd_c_entry_refusals(),
           # the SSD backward at mamba2's training rows (4 x 1024), a ragged
           # length (4 x 1000) and jamba's full-width heads (h 256)
           "ssd_scan_bwd": [check_ssd_scan_bwd(4, 1024, mamba),
                            check_ssd_scan_bwd(4, 1000, mamba),
                            check_ssd_scan_bwd(jB, jS, jamba),
                            check_ssd_scan_bwd(4, 1000, mamba,
                                               dtype=torch.float16)],
           "ssd_scan_bwd_c_entry_refusals": ssd_bwd_c_entry_refusals(),
           "gemma_serve_shapes": {"global": g_global, "ring": g_ring},
           "opt_serve_shape": opt_shape,
           "moe_serve_shapes": {"dbrx-132b": m_shape, "grok-1-314b": g_shape},
           "gemma27_serve_shapes": {"global": g27_global, "ring": g27_ring}}
    # the example twins' shapes (``twin_specs``), appended last to their
    # lists and held below as every row is; ``own``: the rows before them
    own = {n: list(v) for n, v in out.items() if isinstance(v, list)}
    for name, rows in twin_kernel_rows().items():
        out[name] += rows
    out["twin_keys"] = sorted({tuple(c["twin_key"]) for name in KERNELS
                               for c in out[name] if "twin_key" in c})
    # the shard phase's per-position keys (``shard_specs``), appended last;
    # the shard phase fails if a position calls a kernel at any other key
    for name, rows in twin_kernel_rows(shard_specs(), "shard_key").items():
        out[name] += rows
    out["shard_keys"] = sorted({tuple(c["shard_key"]) for name in KERNELS
                                for c in out[name] if "shard_key" in c})
    emit(out)
    results["kernels"] = out
    # jamba's and gemma3-27b's shapes: the rows appended last
    for name, rows in (("flash_attention", own["flash_attention"][-2:]),
                       ("ssd_scan", own["ssd_scan"][-1:]),
                       ("flash_attention_window",
                        own["flash_attention_window"][-1:]),
                       ("hybrid_paged_attention_two_pool",
                        out["hybrid_paged_attention_two_pool"][-2:]),
                       ("kv_gen_qk_norm", out["kv_gen_qk_norm"][-1:])):
        for c in rows:
            print(f"new shape {name} {c['dtype']} {c['shape']}: "
                  f"{c['kernel_ms']} ms, device {c.get('kernel_device_us')} "
                  f"us, bound {c['bound_ms']} ms ({c['bound_by']}), plain "
                  f"{c['plain_ms']} ms, library {c['library_ms']} ms, error "
                  f"{c['max_abs_err']} (limit {c['tol']}), faults "
                  f"{ {k: v for k, v in c.items() if k.startswith('fault')} }",
                  flush=True)
    for name in KERNELS:
        for c in out[name]:
            if "shard_key" in c:
                print(f"shard key {name} {c['dtype']} {c['shape']}: "
                      f"{c['kernel_ms']} ms, host {c.get('kernel_host_us')} us,"
                      f" device {c.get('kernel_device_us')} us, bound "
                      f"{c['bound_ms']} ms ({c['bound_by']}), plain "
                      f"{c['plain_ms']} ms, library {c['library_ms']} ms, "
                      f"error {c['max_abs_err']} (limit {c['tol']}), faults "
                      f"{ {k: v for k, v in c.items() if k.startswith('fault')} }",
                      flush=True)
    # the MoE models' shapes: the last flash and second-pool rows, the last
    # two kv_gen rows (dbrx's layernorm with its bias, grok's rmsnorm)
    for name, c in (("flash_attention", own["flash_attention"][-1]),
                    ("hybrid_paged_attention_two_pool",
                     out["hybrid_paged_attention_two_pool"][-1])):
        print(f"moe shape {name} {c['dtype']} {c['shape']}: {c['kernel_ms']} "
              f"ms, bound {c['bound_ms']} ms, library {c['library_ms']} ms, "
              f"error {c['max_abs_err']} (limit {c['tol']})", flush=True)
    for name in ("hybrid_paged_attention", "hybrid_paged_attention_q8",
                 "hybrid_paged_attention_return_lse",
                 "hybrid_paged_attention_return_lse_q8"):
        for c in out[name]:
            sh = c["shape"]
            print(f"{name} {c['dtype']} B={sh['B']} KVH={sh['KVH']} G={sh['G']} "
                  f"D={sh['D']} d={sh['d_model']} {c.get('case', '')}: "
                  f"{c['kernel_ms']} ms [before the tiles: "
                  f"{c['kernel_ms_before_tiles']}], host "
                  f"{c['kernel_host_us']} us, device {c['kernel_device_us']} us, "
                  f"bound {c['bound_ms']} ms", flush=True)
    for name in ("flash_attention_noncausal", "hybrid_paged_attention_cross_act"):
        for c in out[name]:
            print(f"{name} {c['dtype']} {c['shape']}: {c['kernel_ms']} ms, "
                  f"host {c['kernel_host_us']} us, device "
                  f"{c['kernel_device_us']} us, bound {c['bound_ms']} ms "
                  f"({c['bound_by']}), plain {c['plain_ms']} ms, library "
                  f"{c['library_ms']} ms, error {c['max_abs_err']} (limit "
                  f"{c['tol']}), faults "
                  f"{ {k: v for k, v in c.items() if k.startswith('fault')} }",
                  flush=True)
    for name, c in ((name, c) for name in BWD_SHAPES for c in out[name]):
        print(f"{name} {c['dtype']} {c['shape']}: "
              f"{c['kernel_ms']} ms, host {c['kernel_host_us']} us, device "
              f"{c['kernel_device_us']} us, bound {c['bound_ms']} ms "
              f"({c['bound_by']}), plain {c['plain_ms']} ms, library "
              f"{c['library_ms']} ms, errors {c['errors']} (limits "
              f"{c['limits']}), lse error {c['lse_err']} (limit "
              f"{c['lse_tol']}), faults (error / limit) "
              f"{ {k: v for k, v in c.items() if k.startswith('fault')} }, "
              f"before the redesign {c['kernel_ms_before_redesign']} ms, "
              f"dK/dV bit-equal in two launches "
              f"{c['dk_dv_bit_equal_two_launches']} (dQ "
              f"{c['dq_bit_equal_two_launches']}), design {c['design']}",
              flush=True)
    for c in out["ssd_scan_bwd"]:
        print(f"ssd_scan_bwd {c['dtype']} {c['shape']}: {c['kernel_ms']} ms "
              f"[before the redesign: {c['kernel_ms_before_redesign']}], "
              f"host {c['kernel_host_us']} us, device {c['kernel_device_us']} "
              f"us, bound {c['bound_ms']} ms ({c['bound_by']}), plain "
              f"{c['plain_ms']} ms, errors {c['errors']} (limits "
              f"{c['limits']}), faults (error / limit) "
              f"{ {k: v for k, v in c.items() if k.startswith('fault')} }, "
              f"bit-equal in two launches {c['bit_equal_two_launches']}, "
              f"head groups {c['head_groups']}, design {c['design']}",
              flush=True)
    for name in ("kv_gen", "kv_gen_q8", "kv_gen_qk_norm", "ssd_scan"):
        for c in out[name]:
            print(f"{name} {c['dtype']} {c['shape']}: {c['kernel_ms']} ms "
                  f"[before the redesign: {c['kernel_ms_before_redesign']}], "
                  f"host {c['kernel_host_us']} us, device "
                  f"{c['kernel_device_us']} us, bound {c['bound_ms']} ms, "
                  f"error {c['max_abs_err']} (limit {c['tol']})", flush=True)
    bad = [(name, c["shape"], c["dtype"], c["max_abs_err"], c["tol"])
           for name in KERNELS for c in out[name]
           if not c["max_abs_err"] <= c["tol"]]
    if bad:
        raise AssertionError(f"kernel disagrees with its plain version: {bad}")
    # the limit must catch each planted fault: the hybrid kernels given
    # tables that leave out each request's last ACT page, kv_gen given each
    # request's page before its last in place of its last, and the int8
    # modes given their scales one token row off
    blind = [(name, c["shape"], key, c[key], c["tol"])
             for name in KERNELS for c in out[name] for key in c
             if key.startswith("fault_err_") and not c[key] > c["tol"]]
    if blind:
        raise AssertionError(f"the limit passes a planted fault: {blind}")
    ssd = out["ssd_scan"]
    bad = [(c["shape"], c["state_rel_err"], c["finite"]) for c in ssd
           if not (c["state_rel_err"] <= SSD_STATE_RTOL and c["finite"])]
    if bad:
        raise AssertionError(f"ssd_scan's final state disagrees with its "
                             f"plain version: {bad}")
    blind = [(c["shape"], c["fault_state_rel_err_before_last_chunk"])
             for c in ssd if not c["fault_state_rel_err_before_last_chunk"]
             > SSD_STATE_RTOL]
    if blind:
        raise AssertionError(f"the state limit passes a planted fault: {blind}")
    bwd = [c for name in BWD_SHAPES for c in out[name]]
    bad = [(c["shape"], c["lse_err"], c["lse_tol"],
            c["out_bitwise_equal_without_lse"]) for c in bwd
           if not (c["lse_err"] <= c["lse_tol"]
                   and c["out_bitwise_equal_without_lse"])]
    if bad:
        raise AssertionError(f"the flash kernel's lse disagrees with its "
                             f"plain version: {bad}")
    bad = {D: r for D, r in out["flash_attention_bwd_c_entry_refusals"].items()
           if r[0] == 0 or not r[1]}
    if bad:
        raise AssertionError(f"the backward's C entry ran at a head_dim it "
                             f"was not built for: {bad}")
    blind = [(c["shape"], key, c[key]) for c in bwd for key in c
             if key.startswith("fault_ratio_") and not c[key] > 1.0]
    if blind:
        raise AssertionError(f"the backward's limit passes a planted fault: "
                             f"{blind}")
    bad = [c["shape"] for c in bwd if not c["dk_dv_bit_equal_two_launches"]]
    if bad:
        raise AssertionError(f"the flash backward's dK/dV differ between two "
                             f"launches on the same inputs: {bad}")
    ssd_bwd = out["ssd_scan_bwd"]
    bad = [(c["shape"], c["ratios"], c["finite"],
            c["bit_equal_two_launches"]) for c in ssd_bwd
           if not (max(c["ratios"].values()) <= 1.0 and c["finite"]
                   and c["bit_equal_two_launches"])]
    bad += [(k, r) for k, r in out["ssd_scan_bwd_c_entry_refusals"].items()
            if r[0] == 0 or not r[1]]
    blind = [(c["shape"], key, c[key]) for c in ssd_bwd for key in c
             if key.startswith("fault_ratio_") and not c[key] > 1.0]
    if bad or blind:
        raise AssertionError(f"ssd_scan_bwd: outputs over their limits or a "
                             f"C entry that ran at a shape it was not built "
                             f"for {bad}; planted faults under the limits "
                             f"{blind}")
    lse = [c for name in KERNELS if "return_lse" in name for c in out[name]]
    bad = [(c["case"], c["shape"], c["m_err"], c["l_err"]) for c in lse
           if not (c["m_err"] <= LSE_RTOL and c["l_err"] <= LSE_RTOL)]
    bad += [(c["case"], c["shape"], c["merge_err"], c["tol"]) for c in lse
            if c["case"] == "all_pages" and not c["merge_err"] <= c["tol"]]
    if bad:
        raise AssertionError(f"return_lse disagrees with its plain version "
                             f"or the merge: {bad}")
    blind = [(c["case"], c["shape"], key, c[key]) for c in lse for key in c
             if key.startswith("fault_l_err_") and not c[key] > LSE_RTOL]
    if blind:
        raise AssertionError(f"the l limit passes a planted fault: {blind}")


def forced_logits(eng, params, cfg, group, gold):
    """Per-step logits of the engine's decode path over ``group`` fed the
    oracle's tokens ``gold`` (B, n) -> (B, n, V)."""
    toks, kv_keep, pbs, sched, bound_, act_bound = eng.group_schedule(group)
    dev = lambda a: torch.from_numpy(np.asarray(a, np.int32)).cuda()
    lg, cache = M.hybrid_prefill_batched(params, cfg, dev(toks), eng.kv_cap,
                                         eng.act_cap, kv_keep, pbs,
                                         quant=eng.quant)
    out = [lg[:, -1]]
    s_dev = torch.from_numpy(sched).cuda()
    for s in range(gold.shape[1] - 1):
        lg, cache = M.hybrid_decode_step(params, cfg, gold[:, s:s + 1].int(),
                                         cache, s_dev[:, s], pages_bound=bound_,
                                         act_pages_bound=act_bound,
                                         quant=eng.quant,
                                         any_act=bool(sched[:, s].any()))
        out.append(lg[:, -1])
    return torch.stack(out, 1)


def offload_step_gaps(eng, reqs, gold, ora) -> dict:
    """Teacher-forced logit gaps of an offload engine's own path (for the
    host-attend engine, the CPU lane's merge included): one ``generate``
    with the model's prefill and decode end stages wrapped, so that each
    records its logits and hands the executor the oracle's next token in
    place of its argmax.  -> {rid: per-step max |logit - oracle's|}."""
    real_pre, real_end = M.hybrid_prefill_end, M.hybrid_decode_end
    plan = eng.plan_groups(reqs)
    feed = [torch.stack([gold[r.rid] for r in g]) for g in plan]
    seen = []                      # per group, the logits of each step

    def forced(lg):
        steps, want = seen[-1], feed[len(seen) - 1]
        steps.append(lg[:, -1].float())
        nxt = want[:, min(len(steps), want.shape[1]) - 1]
        return F.one_hot(nxt.long(), lg.shape[-1]).to(lg.dtype)[:, None]

    def prefill_end(*a, **kw):
        lg, cache = real_pre(*a, **kw)
        seen.append([])
        return forced(lg), cache

    M.hybrid_prefill_end = prefill_end
    M.hybrid_decode_end = lambda *a, **kw: forced(real_end(*a, **kw))
    try:
        eng.generate(reqs)
    finally:
        M.hybrid_prefill_end, M.hybrid_decode_end = real_pre, real_end
    gaps = {}
    for g, want, steps in zip(plan, feed, seen):
        lg = torch.stack(steps[:want.shape[1]], 1)
        for i, r in enumerate(g):
            gaps[r.rid] = (lg[i] - ora[r.rid]).abs().amax(-1).cpu().numpy()
    return gaps


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
    rule = {"oracle": oracle, "margin": margin, "logit_tol": logit_tol}
    for mode, eng in engines.items():
        gap, step_gaps = 0.0, {}
        for g in eng.plan_groups(reqs):
            lg = forced_logits(eng, params, cfg, g,
                               torch.stack([gold[r.rid] for r in g]))
            for i, r in enumerate(g):
                step_gaps[r.rid] = (lg[i] - ora[r.rid]).abs().amax(-1).cpu().numpy()
                gap = max(gap, float(step_gaps[r.rid].max()))
        if gap > logit_tol:
            raise AssertionError(f"{mode} teacher-forced logits differ by {gap}")
        rule[mode] = step_gaps
        out[mode] = dict(exactness(rule, mode, outs[mode], reqs),
                         max_teacher_forced_dlogit=gap)
    return out, gold, ora, rule


def exactness(rule, mode, outs, reqs) -> dict:
    """The exactness rule for ``outs``, a run of ``mode``'s path: a request
    may leave the oracle's tokens only at a step where the oracle's top-2
    margin is within the logit limit and within twice that mode's own
    teacher-forced gap at that step."""
    exact, diverged = 0, []
    for r in reqs:
        diff = np.nonzero(outs[r.rid] != rule["oracle"][r.rid])[0]
        if not diff.size:
            exact += 1
            continue
        s, m = int(diff[0]), float(rule["margin"][r.rid][diff[0]])
        step_gap = float(rule[mode][r.rid][s])
        diverged.append({"rid": r.rid, "step": s, "oracle_margin": m,
                         "step_gap": step_gap})
        if not (m <= rule["logit_tol"] and m <= 2 * step_gap):
            raise AssertionError(f"{mode} request {r.rid} diverges: "
                                 f"{diverged[-1]}")
    return {"exact_requests": exact, "diverged": diverged}


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
    for fn, attr in COUNTERS.values():
        setattr(fn, attr, 0)


def read_counts() -> dict:
    return {name: getattr(fn, attr) for name, (fn, attr) in COUNTERS.items()}


def expected_launches(eng, reqs) -> dict:
    """Launches of one ``generate`` of ``eng``: a flash launch per layer and
    prefill (one per group); per layer and decode step a hybrid launch, and
    a kv_gen launch in a RoPE model's hybrid mode.  A host-attend run
    launches return_lse on every step of the groups that spill.  Under
    quant each of those is an int8 launch too, and the fused route's other
    steps are return_lse launches where the schedule binds a token to the
    ACT region (its exact row's merge), plain ones elsewhere.  Each engine
    plans its own groups."""
    cfg = eng.cfg
    L, rope = cfg.num_layers, cfg.pos_type == "rope"
    hk = "hybrid_paged_attention_two_pool" if rope else "hybrid_paged_attention"
    plan = eng.plan_groups(reqs)
    steps = lse = 0
    for g in plan:
        sched = eng.group_schedule(g)[3]
        steps += sched.shape[1]
        if eng.host_attn and spills(eng, g):
            lse += sched.shape[1]
        elif eng.quant is not None and not rope:
            lse += int(sched.any(0).sum())
    want = {k: 0 for k in COUNTERS}
    want["flash_attention"] = L * len(plan)
    want[hk] = L * steps
    kv_gen_runs = rope and eng.mode == "hybrid"
    want["kv_gen"] = L * steps if kv_gen_runs else 0
    want[hk + "_return_lse"] = L * lse
    if eng.quant is not None:
        want[hk + "_q8"] = L * steps
        want["kv_gen_q8"] = want["kv_gen"]
        want[hk + "_return_lse_q8"] = L * lse
    return want


def q8_generate(params, cfg, prompt, n: int, gold=None):
    """The q8 oracle over one request, its prompt padded as
    ``exact_reference_generate`` pads it: greedy, or fed the tokens ``gold``
    (n,).  -> (tokens (n,) numpy, per-step logits (n, V))."""
    padded = np.full(bucket(len(prompt)), prompt[-1], np.int32)
    padded[:len(prompt)] = prompt
    toks = torch.from_numpy(padded).cuda()[None]
    S = toks.shape[1]
    lg, cache = QC.prefill_q8(params, cfg, toks, S + n + 8)
    out, steps = [], [lg[:, -1]]
    for s in range(n):
        cur = lg[:, -1].argmax(-1).int() if gold is None else gold[s:s + 1].int()
        out.append(cur)
        if s < n - 1:
            lg, cache = QC.decode_step_q8(params, cfg, cur[:, None], cache,
                                          bound=S + s + 1)
            steps.append(lg[:, -1])
    return torch.cat(out).cpu().numpy(), torch.cat(steps, 0)


def step_gaps(eng, params, cfg, reqs, gold, want) -> dict:
    """{rid: per-step max |logit - want's|} of ``eng``'s decode path fed
    ``gold``'s tokens, over all of its groups."""
    gaps = {}
    for g in eng.plan_groups(reqs):
        lg = forced_logits(eng, params, cfg, g,
                           torch.stack([gold[r.rid] for r in g]))
        for i, r in enumerate(g):
            gaps[r.rid] = (lg[i] - want[r.rid]).abs().amax(-1).cpu().numpy()
    return gaps


def first_divergence(outs, rule, reqs) -> dict:
    """{rid: (the first position where ``outs`` leave the fp oracle's
    tokens, the oracle's top-2 logit margin there)} over the requests that
    leave them."""
    got = {}
    for r in reqs:
        diff = np.flatnonzero(outs[r.rid] != rule["oracle"][r.rid])
        if diff.size:
            p = int(diff[0])
            got[r.rid] = (p, float(rule["margin"][r.rid][p]))
    return got


def agreement(outs, oracle, reqs) -> float:
    """Mean per-token agreement of ``outs`` with ``oracle`` over requests."""
    return float(np.mean([np.mean(outs[r.rid] == oracle[r.rid]) for r in reqs]))


def decode_launches(params, cfg, eng, group, quant, all_kv=False) -> int:
    """CUDA kernels launched by the first hybrid decode step of ``group``
    (the profiler's count), with the cache in ``quant``'s format;
    ``all_kv``: every token of the step KV-bound instead (a step of kv mode,
    or of hybrid mode with no ACT-bound token)."""
    from torch.profiler import ProfilerActivity, profile
    toks, kv_keep, pbs, sched, bound_, act_bound = eng.group_schedule(group)
    dev = lambda a: torch.from_numpy(np.asarray(a, np.int32)).cuda()
    lg, cache = M.hybrid_prefill_batched(params, cfg, dev(toks), eng.kv_cap,
                                         eng.act_cap, kv_keep, pbs,
                                         quant=quant)
    tok = lg[:, -1].argmax(-1).int()[:, None]
    store_np = np.zeros_like(sched[:, 0]) if all_kv else sched[:, 0].copy()
    store = torch.from_numpy(store_np).cuda()
    step = lambda: M.hybrid_decode_step(params, cfg, tok, cache, store,
                                        pages_bound=bound_,
                                        act_pages_bound=act_bound, quant=quant,
                                        any_act=bool(store_np.any()))
    step()                                                # warm-up
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        step()
        torch.cuda.synchronize()
    return sum(e.device_type == torch.autograd.DeviceType.CUDA
               for e in prof.events())


def phase_serve_quant(results, smi, cfg, params, reqs, fp):
    """Serve the trace again with the int8 cache (``QuantConfig()``) in
    hybrid and kv modes: launches (the int8 modes counted), leaks, host
    syncs in the decode loop, the cache regions' device bytes against fp,
    the kv mode's tokens against the q8 oracle under the fp exactness rule,
    the hybrid mode's agreement with the fp oracle and its teacher-forced
    gap to the q8 oracle under the derived limit, and the planted faults.
    ``fp``: the fp oracle's rule, tokens and logits.  -> (the hybrid run's
    launch counts, {mode: tokens}, the q8 oracle's rule and the limit)."""
    rule, gold, ora = fp
    q = QuantConfig()
    logit_tol = LOGIT_TOL_BY_DTYPE[cfg.dtype]
    dev = lambda a: torch.from_numpy(np.asarray(a, np.int32)).cuda()
    out = {"phase": "serve_quant", "card": smi, "model": cfg.name,
           "quant": str(q), "logit_tol": logit_tol}
    engines = {m: HybridServeEngine(cfg, params, mode=m, hw=H100_SXM, quant=q)
               for m in ("hybrid", "kv")}
    outs, launches = {}, {}
    for mode, eng in engines.items():
        want = expected_launches(eng, reqs)
        eng.generate(reqs)                               # warm-up
        torch.cuda.synchronize()
        reset_counts()
        t0 = time.perf_counter()
        outs[mode], stats = eng.generate(reqs)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches[mode] = read_counts()
        if launches[mode] != want:
            raise AssertionError(f"quant {mode} launches {launches[mode]}, "
                                 f"expected {want}")
        if any(p.allocated for p in eng.blockman.pools.values()):
            raise AssertionError(f"leaked blocks after the quant {mode} run")
        splits = []
        for g in eng.plan_groups(reqs):
            _, kv_keep, pbs, sched, *_ = eng.group_schedule(g)
            splits += [{"rid": r.rid, "kv": int(k), "act": int(p - k),
                        "act_bound_steps": int(n)}
                       for r, k, p, n in zip(g, kv_keep, pbs, sched.sum(1))]
        out[mode] = {"launches": launches[mode], "wall_s": wall,
                     "tokens_per_s": stats.generated_tokens / wall,
                     "act_frac": eng.act_frac, "splits": splits,
                     "groups": len(eng.plan_groups(reqs)),
                     "blocks": eng.blockman.explain()}

    # no host sync inside the quantized decode loop; the cache's device bytes
    eng = engines["hybrid"]
    g0 = eng.plan_groups(reqs)[0]
    toks, kv_keep, pbs, sched, bound_, act_bound = eng.group_schedule(g0)
    region_bytes = {}
    for label, quant in (("fp", None), ("int8", q)):
        lg, cache = M.hybrid_prefill_batched(params, cfg, dev(toks), eng.kv_cap,
                                             eng.act_cap, kv_keep, pbs,
                                             quant=quant)
        region_bytes[label] = sum(cache[k].numel() * cache[k].element_size()
                                  for k in M.region_planes(cache))
    cur = lg[:, -1].argmax(-1).int()
    sched_dev = torch.from_numpy(np.ascontiguousarray(sched.T)).cuda()
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        loop_toks, _ = M.hybrid_decode_loop(params, cfg, cur, cache, sched_dev,
                                            pages_bound=bound_,
                                            act_pages_bound=act_bound, quant=q,
                                            any_act=sched.any(0))
    finally:
        torch.cuda.set_sync_debug_mode(0)
    loop_toks = loop_toks.cpu().numpy()
    for i, r in enumerate(g0):
        if not np.array_equal(loop_toks[i, :r.max_new_tokens], outs["hybrid"][r.rid]):
            raise AssertionError(f"request {r.rid}: sync-checked quant loop differs")
    del cache
    ratio = region_bytes["fp"] / region_bytes["int8"]
    out.update(decode_loop_host_syncs=0, region_bytes=region_bytes,
               region_bytes_fp_over_int8=ratio)
    if ratio < 1.8:
        raise AssertionError(f"the int8 cache is only {ratio}x smaller")
    # the device launches one decode step adds under quant (the quantize
    # ops at the cache writes, the ACT-bound row's merge or scratch write),
    # with the first step's schedule and with every token KV-bound
    out["decode_step_launches"] = {
        label + ("_all_kv_bound" if all_kv else ""):
            decode_launches(params, cfg, eng, g0, quant, all_kv)
        for all_kv in (False, True) for label, quant in (("fp", None), ("int8", q))}

    # the q8 oracle: greedy, and fed the fp oracle's tokens
    q8 = {r.rid: q8_generate(params, cfg, r.prompt, r.max_new_tokens)
          for r in reqs}
    q8_gold = {rid: torch.from_numpy(t).cuda() for rid, (t, _) in q8.items()}
    q8_lg = {rid: lg for rid, (_, lg) in q8.items()}
    gap_q8_fp = max((q8_generate(params, cfg, r.prompt, r.max_new_tokens,
                                 gold[r.rid])[1] - ora[r.rid]).abs().max().item()
                    for r in reqs)
    margin = {}
    for rid, lg in q8_lg.items():
        top2 = lg.topk(2, dim=-1).values
        margin[rid] = (top2[:, 0] - top2[:, 1]).cpu().numpy()
    q8_rule = {"oracle": {rid: t for rid, (t, _) in q8.items()},
               "margin": margin, "logit_tol": logit_tol}
    limit = QUANT_GAP_FACTOR * gap_q8_fp + logit_tol
    out.update(q8_agreement_with_fp_oracle=agreement(q8_rule["oracle"],
                                                     rule["oracle"], reqs),
               gap_q8_oracle_vs_fp_oracle=gap_q8_fp, hybrid_gap_limit=limit)

    # kv mode: the q8 oracle's tokens under the fp exactness rule
    q8_rule["kv"] = step_gaps(engines["kv"], params, cfg, reqs, q8_gold, q8_lg)
    gap = max(float(g.max()) for g in q8_rule["kv"].values())
    out["kv"].update(exactness(q8_rule, "kv", outs["kv"], reqs),
                     max_teacher_forced_dlogit_vs_q8=gap)
    if gap > logit_tol:
        raise AssertionError(f"quant kv teacher-forced logits differ from the "
                             f"q8 oracle's by {gap}")

    # hybrid mode: agreement with the fp oracle, gap to the q8 oracle
    q8_rule["hybrid"] = step_gaps(eng, params, cfg, reqs, q8_gold, q8_lg)
    gap = max(float(g.max()) for g in q8_rule["hybrid"].values())
    agree = agreement(outs["hybrid"], rule["oracle"], reqs)
    out["hybrid"].update(agreement_with_fp_oracle=agree,
                         max_teacher_forced_dlogit_vs_q8=gap,
                         equal_to_q8_oracle=sum(np.array_equal(
                             outs["hybrid"][r.rid], q8_rule["oracle"][r.rid])
                             for r in reqs))
    if agree < MIN_AGREEMENT:
        raise AssertionError(f"quant hybrid agrees with the fp oracle on "
                             f"{agree} of its tokens")
    if gap > limit:
        raise AssertionError(f"quant hybrid teacher-forced logits differ from "
                             f"the q8 oracle's by {gap}, limit {limit}")

    # planted faults in the regions' scale sidecars, read by the same gap
    real = M.region_scales

    def kv_row_off(cache, i):
        ks, vs, as_ = real(cache, i)
        return torch.roll(ks, 1, 1), torch.roll(vs, 1, 1), as_

    def act_ignored(cache, i):
        ks, vs, as_ = real(cache, i)
        return ks, vs, torch.ones_like(as_)

    faults = {}
    for label, fault in (("kv_scales_row_off", kv_row_off),
                         ("act_scales_ignored", act_ignored)):
        M.region_scales = fault
        try:
            faults[label] = max(float(g.max()) for g in step_gaps(
                eng, params, cfg, g0, q8_gold, q8_lg).values())
        finally:
            M.region_scales = real
    out["hybrid"]["fault_dlogit_vs_q8"] = faults
    emit(out)
    results[f"serve_quant {cfg.name}"] = out
    if not faults["kv_scales_row_off"] > limit:
        raise AssertionError(f"the limit {limit} passes K/V scales one row "
                             f"off: {faults}")
    return launches["hybrid"], engines["hybrid"], outs, \
        (q8_rule, q8_gold, q8_lg, limit)


def phase_serve(results, smi, name):
    """Serve the trace at full width and depth in hybrid and kv modes; check
    launches per prefill and per decode step, host syncs in the decode loop,
    leaked blocks and tokens against the oracle."""
    cfg = get_config(name)
    rope = cfg.pos_type == "rope"
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

    want = expected_launches(eng, reqs)
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
    want_kv = expected_launches(kv_eng, reqs)  # no ACT page: no kv_gen
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
                                         eng.act_cap, kv_keep, pbs)
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

    tokens, gold, ora, rule = check_tokens({"hybrid": eng, "kv": kv_eng},
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
    q8_launches, q8_eng, q8_outs, q8_oracle = phase_serve_quant(
        results, smi, cfg, params, reqs, (rule, gold, ora))
    outs = {"hybrid": hyb, "kv": kv_out, "hybrid_q8": q8_outs["hybrid"]}
    return ({"fp": launches, "int8": q8_launches},
            {"hybrid": eng, "kv": kv_eng, "hybrid_q8": q8_eng}, reqs, outs,
            (rule, gold, ora), q8_oracle, params)


def meminfo() -> dict:
    """The host's MemTotal and MemAvailable, bytes."""
    out = {}
    for line in Path("/proc/meminfo").read_text().splitlines():
        key = line.split(":")[0]
        if key in ("MemTotal", "MemAvailable"):
            out[key] = int(line.split()[1]) * 1024
    return out


def spills(eng, group) -> bool:
    """Whether the offload engine spills ``group``'s KV region: its KV
    blocks at the end of its decode exceed the device KV pool."""
    _, kv_keep, _, sched, *_ = eng.group_schedule(group)
    need = int(np.sum(-(-(kv_keep + (~sched).sum(1)) // PAGE)))
    return need > eng.budget.dev_kv_blocks(eng.cfg)


# the offload phase's overlap check: depth 1 hides at least this share of its
# compute under the weight copies (a layer's compute is ~2-9% of its copy, so
# an overlapping stream hides nearly all of it, a serial one none)
MIN_HIDDEN_SHARE = 0.5
OVERLAP_FAULT = "hybrid_d1_copies_on_compute_stream"


def offload_run(eng, reqs, label, layer_bytes):
    """One counted ``generate`` of an offload engine (``label`` names a
    spilled run with "spill"): launches, uploads, slots in use, peak device
    memory below the layer weights' bytes, spill, the CPU lane, leaks, and
    the timeline's lanes.  -> (tokens, launches, expected launches, run,
    checks)."""
    L = eng.cfg.num_layers
    host_attn, depth = eng.host_attn, eng.budget.prefetch_depth
    plan = eng.plan_groups(reqs)
    steps = sum(max(r.max_new_tokens for r in g) for g in plan)
    want = expected_launches(eng, reqs)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counts()
    t0 = time.perf_counter()
    toks, stats = eng.generate(reqs)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = read_counts()
    peak = torch.cuda.max_memory_allocated()
    st, ms = eng.executor.streamer, eng.measured_steps
    spilled = sum(m.traffic["kv_load"] for m in ms) > 0
    w_s = sum(m.tag_busy.get("w", 0.0) for m in ms)
    run = {"groups": len(plan), "decode_steps": steps, "wall_s": wall,
           "spilled_groups": sum(spills(eng, g) for g in plan),
           "tokens_per_s": stats.generated_tokens / wall,
           "launches": launches, "uploads": st.uploads,
           "bytes_uploaded": st.bytes_uploaded,
           "peak_resident_slots": st.peak_resident,
           "max_memory_allocated": peak,
           "step_s_mean": float(np.mean([m.total for m in ms])),
           "pcie_busy_s_mean": float(np.mean([m.pcie_busy for m in ms])),
           "gpu_busy_s_mean": float(np.mean([m.gpu_busy for m in ms])),
           # the share of the gpu lane's busy time inside the pcie lane's
           # busy intervals, from the timeline's own spans
           "gpu_hidden_share": sum(m.gpu_hidden for m in ms)
           / sum(m.gpu_busy for m in ms),
           "cpu_busy_s_mean": float(np.mean([m.cpu_busy for m in ms])),
           "kv_upload_s_mean": float(np.mean([m.tag_busy.get("kv", 0.0)
                                              for m in ms])),
           "store_s_mean": float(np.mean([m.tag_busy.get("st", 0.0)
                                          for m in ms])),
           "weights_h2d_GBps": sum(m.traffic["weights"] for m in ms)
           / w_s / 1e9,
           "gpu_idle_share": 1.0 - sum(m.gpu_busy for m in ms)
           / sum(m.total for m in ms),
           "measured_time_s": stats.measured_time,
           "spilled": spilled, "arena_denials": eng.arena_denials,
           "blocking_syncs": eng.executor.blocking_syncs,
           "device_calls": stats.device_calls,
           # KV bytes uploaded per request and decode step of the groups
           # that spill (each uploads its region every step)
           "kv_upload_bytes_per_request_step": sum(
               m.traffic["kv_load"] for m in ms) / max(1, sum(
                   len(g) * max(r.max_new_tokens for r in g)
                   for g in plan if spills(eng, g)))}
    checks = {
        "launches": launches == want,
        "uploads": st.uploads == L * sum(1 + max(r.max_new_tokens
                                                 for r in g) for g in plan),
        "bytes_uploaded": st.bytes_uploaded == st.uploads * layer_bytes,
        "peak_resident": st.peak_resident <= depth + 1,
        "weights_never_resident": peak < L * layer_bytes,
        "spill": spilled == ("spill" in label and not host_attn),
        "host_lane_ran": (stats.measured_cpu_busy > 0) == host_attn,
        "no_leaked_blocks": not any(p.allocated for p in
                                    eng.blockman.pools.values()),
        "no_arena_blocks": eng.spill_kv_pool.allocated_blocks == 0,
        "lane_healthy": eng.executor.lane_health == "healthy"}
    return toks, launches, want, run, checks


def phase_offload(results, smi, name, reqs, resident_outs, oracle, q8_oracle):
    """Serve ``name`` again with its layer weights in pinned host memory
    (the same seed's weights), streamed over the copy stream: hybrid at
    prefetch depth 1, 0, 0 and 1 again (an A-B-B-A order, so that a drift
    of the link's rate within the call falls on both depths alike) and kv
    at depth 1 under the default 16 GiB budget (KV resident), hybrid under
    the tight budget (two layers of weights and two KV blocks: the KV
    region spills to the host arena), and spilled with the CPU attention
    lane.  Checks tokens (the non-host-attend runs equal the
    device-resident engine's; the host-attend run keeps the oracle rule
    with its own teacher-forced gap), uploads against the schedule, slots
    in use, peak device memory below the layer weights' bytes, leaks,
    launches, and the overlap, read from the timeline's spans: depth 1 hides
    at least half of its compute under the weight copies, and more than depth
    0 does, and a depth-1 run with its copies on the compute stream (a
    planted fault) fails that.  Then the int8 cache, hybrid
    under the tight budget: spilled (its tokens equal the device-resident
    quant engine's, its KV uploads per request and step at least 1.8x
    smaller than the fp spilled run's) and with the CPU lane (agreement with
    the fp oracle, and its own teacher-forced gap to the q8 oracle under the
    quant limit).  For OPT, ``phase_telemetry_offload`` runs on the same
    pinned weights.  -> the host-attend runs' launch counts, fp and int8,
    and the telemetry runs', {run: ...}."""
    rule, gold, ora = oracle
    q8_rule, q8_gold, q8_lg, q8_limit = q8_oracle
    cfg = get_config(name)
    L = cfg.num_layers
    out = {"phase": "offload", "card": smi, "model": cfg.name,
           "host_mem_available_before_pinning": meminfo()["MemAvailable"]}
    t0 = time.perf_counter()
    params = M.init_params(cfg, seed=0, device="cuda")
    pool = HostWeightPool(cfg, params, device="cuda")
    torch.cuda.synchronize()
    out["init_and_pin_s"] = time.perf_counter() - t0
    del params
    gc.collect()
    torch.cuda.empty_cache()
    layer_bytes = pool.layer_nbytes[0]
    out.update(pinned=pool.pinned, layer_weight_bytes=layer_bytes,
               layer_weights_total_bytes=L * layer_bytes,
               host_mem_available_after_pinning=meminfo()["MemAvailable"],
               resident_tree_bytes=sum(t.numel() * t.element_size()
                                       for t in _leaves(pool.resident)))
    if not pool.pinned:
        raise AssertionError("layer weights are not in pinned host memory")
    roomy = lambda mode, depth: dict(mode=mode,
                                     budget=OffloadBudget(16 * 2**30, depth))
    runs = {"hybrid_d1": roomy("hybrid", 1), "hybrid_d0": roomy("hybrid", 0),
            "hybrid_d0_again": roomy("hybrid", 0),
            "hybrid_d1_again": roomy("hybrid", 1), "kv_d1": roomy("kv", 1),
            "hybrid_spill": dict(mode="hybrid", budget=_tight(cfg)),
            "hybrid_spill_host_attn": dict(mode="hybrid", budget=_tight(cfg),
                                           host_attn=True),
            "hybrid_spill_q8": dict(mode="hybrid", budget=_tight(cfg),
                                    quant=QuantConfig()),
            "hybrid_spill_host_attn_q8": dict(mode="hybrid", budget=_tight(cfg),
                                              host_attn=True,
                                              quant=QuantConfig()),
            # the overlap check's planted fault: depth 1 with its weight
            # copies on the compute stream, so each waits for the compute
            # enqueued before it and hides none
            OVERLAP_FAULT: roomy("hybrid", 1)}
    ha_launches = {}
    for label, kw in runs.items():
        eng = HybridServeEngine(cfg, pool, hw=H100_SXM, offload=True, **kw)
        if label == OVERLAP_FAULT:
            eng.executor.streamer.copy_stream = torch.cuda.current_stream()
        mode, host_attn = kw["mode"], kw.get("host_attn", False)
        q8 = kw.get("quant") is not None
        toks, launches, want, run, checks = offload_run(eng, reqs, label,
                                                        layer_bytes)
        if q8:
            run["agreement_with_fp_oracle"] = agreement(toks, rule["oracle"], reqs)
            checks["agreement"] = run["agreement_with_fp_oracle"] >= MIN_AGREEMENT
        if not host_attn:
            resident = resident_outs[mode + ("_q8" if q8 else "")]
            same = [r.rid for r in reqs
                    if np.array_equal(toks[r.rid], resident[r.rid])]
            run["equal_to_device_resident"] = len(same)
            if len(same) != len(reqs):
                raise AssertionError(f"offload {label}: tokens differ from the "
                                     f"device-resident {mode} engine's")
            if not q8:
                run.update(exactness(rule, mode, toks, reqs))
        elif q8:    # the CPU lane over the int8 arena: its own gap to q8
            gaps = offload_step_gaps(eng, reqs, q8_gold, q8_lg)
            gap = max(float(g.max()) for g in gaps.values())
            run.update(max_teacher_forced_dlogit_vs_q8=gap, limit=q8_limit)
            if gap > q8_limit:
                raise AssertionError(f"offload {label}: teacher-forced logits "
                                     f"differ from the q8 oracle's by {gap}")
        else:   # the CPU lane's merge is its own path: read its own gap
            rule = dict(rule, **{label: offload_step_gaps(eng, reqs, gold, ora)})
            gap = max(float(g.max()) for g in rule[label].values())
            run.update(exactness(rule, label, toks, reqs),
                       max_teacher_forced_dlogit=gap)
            if gap > rule["logit_tol"]:
                raise AssertionError(f"offload {label}: teacher-forced logits "
                                     f"differ by {gap}")
        run["checks"] = checks
        out[label] = run
        eng.close()
        del eng
        if not all(checks.values()):
            raise AssertionError(f"offload {label} failed {checks}: {run}, "
                                 f"expected launches {want}")
        if host_attn:
            ha_launches["int8" if q8 else "fp"] = launches
    # OPT's engine-side telemetry runs, on the same pinned weights
    tel_launches = (phase_telemetry_offload(results, smi, cfg, pool, reqs,
                                            resident_outs, rule, out)
                    if cfg.pos_type != "rope" else {})
    # depth 1 against depth 0, each the mean of its two runs.  The overlap is
    # read from the timeline's spans: the share of the gpu lane's busy time
    # that lies inside the pcie lane's busy intervals.  Depth 1 must hide at
    # least half its compute, and more than depth 0 does; the planted fault
    # (copies on the compute stream) must fail that.  The wall-clock proxies
    # the check used before (a step's time beyond its copies, and whole step
    # times) are still printed: they mix in host work between steps and the
    # link's rate, and at OPT's and yi's ~10-20 ms of compute a step they
    # leave the factor little margin.
    step = {d: float(np.mean([out[f"hybrid_{d}{x}"]["step_s_mean"]
                              for x in ("", "_again")])) for d in ("d1", "d0")}
    exposed = {d: float(np.mean([out[f"hybrid_{d}{x}"]["step_s_mean"]
                                 - out[f"hybrid_{d}{x}"]["pcie_busy_s_mean"]
                                 for x in ("", "_again")])) for d in ("d1", "d0")}
    hidden = {d: float(np.mean([out[f"hybrid_{d}{x}"]["gpu_hidden_share"]
                                for x in ("", "_again")])) for d in ("d1", "d0")}
    fault = out[OVERLAP_FAULT]["gpu_hidden_share"]
    overlaps = lambda h1: h1 >= MIN_HIDDEN_SHARE and h1 > hidden["d0"]
    per_row = {k: out[f"hybrid_spill{k}"]["kv_upload_bytes_per_request_step"]
               for k in ("", "_q8")}
    out.update(step_s=step, depth1_over_depth0_step=step["d1"] / step["d0"],
               step_beyond_copies_s=exposed,
               depth1_over_depth0_beyond_copies=exposed["d1"] / exposed["d0"],
               gpu_hidden_share=hidden, min_hidden_share=MIN_HIDDEN_SHARE,
               fault_gpu_hidden_share_copies_on_compute_stream=fault,
               kv_upload_fp_over_int8=per_row[""] / per_row["_q8"])
    emit(out)
    results[f"offload {name}"] = out
    del pool
    if not out["kv_upload_fp_over_int8"] >= 1.8:
        raise AssertionError(f"the int8 spill uploads only "
                             f"{out['kv_upload_fp_over_int8']}x fewer KV bytes")
    if not overlaps(hidden["d1"]):
        raise AssertionError(f"depth 1 hides {hidden['d1']} of its compute "
                             f"under the weight copies, depth 0 {hidden['d0']}: "
                             "the copy stream does not overlap compute")
    if overlaps(fault):
        raise AssertionError(f"the overlap check passes a planted fault: copies "
                             f"on the compute stream hide {fault} of the compute")
    return ha_launches, tel_launches


# ----------------------------------------------------------- scheduler phase
# the continuous-batching server's traffic: twelve open-loop requests of 64 to
# 447 prompt tokens and 16 or 32 new ones, arriving over the first 32 steps,
# through four slots with 512-token regions
SCHED_TRACE = dict(seed=17, prompt_lo=64, prompt_hi=448,
                   max_new_choices=(16, 32), arrival_hi=32)
SCHED_REQUESTS = 12
SCHED_SERVER = dict(slots=4, kv_cap=512, act_cap=512)
# the pressure run's pools: 28 host KV blocks and none on the device.  The
# server's block accounting does not depend on the tokens, so it was sized
# on the host (the server with its decode and admission stubbed): with this
# trace at S = 8, opt-6.7b's run preempts 4 requests, each demoted to ACT
# checkpoints and resumed
SCHED_PRESSURE = dict(host_kv_blocks=28, dev_kv_blocks=0)
# the offload runs stream every layer's weights each step (~0.25 s a step for
# opt-6.7b at ~54 GB/s, ~0.32 s with the CPU lane), so they serve the first
# four requests of the trace (96 tokens, 40 steps; the whole trace's 96 steps
# would take 25-30 s a run); so do their device-resident twin (profiled:
# the device's idle share), the planted faults, and the q8 oracle (~1.5 s a
# request) that the int8 run's teacher-forced gap and its limit are read on
SCHED_SUBSET = 4
ACT_BOUND_FAULT = "act_bound_one_page_short"
SCALES_FAULT = "admission_without_scale_planes"
FREEZE_FAULT = "inactive_lengths_advance"


class ChunkCheck:
    """``M.hybrid_decode_chunk`` wrapped for one device-resident run: each
    call runs under ``torch.cuda.set_sync_debug_mode("error")`` (no host sync
    inside a chunk), is counted (its steps, the steps that bind a token to
    the ACT region, the steps whose tables hold an ACT page), and is then
    held, from the device's lengths, to the masking contract (an active
    slot's lengths advance by one region a step, an inactive slot's stay
    frozen) and to the bounds' (they cover every slot active in the chunk,
    as its lengths end)."""

    def __init__(self):
        self.real = M.hybrid_decode_chunk
        self.calls = self.steps = self.any_act_steps = self.act_page_steps = 0
        self.length_faults = self.bound_faults = 0

    def __call__(self, params, cfg, cur, cache, store, active, *, pages_bound,
                 act_pages_bound, quant, any_act):
        kv0, act0 = cache["kv_len"].clone(), cache["act_len"].clone()
        on = store & active
        kv_end = kv0 + (active & ~on).sum(0).int()
        act_end = act0 + on.sum(0).int()
        ran = active.any(0)
        torch.cuda.set_sync_debug_mode("error")
        try:
            out = self.real(params, cfg, cur, cache, store, active,
                            pages_bound=pages_bound,
                            act_pages_bound=act_pages_bound, quant=quant,
                            any_act=any_act)
        finally:
            torch.cuda.set_sync_debug_mode(0)
        S = store.shape[0]
        self.calls += 1
        self.steps += S
        self.any_act_steps += int(np.sum(any_act))
        self.act_page_steps += S if act_pages_bound > 0 else 0
        cache = out[2]
        if not (torch.equal(cache["kv_len"], kv_end)
                and torch.equal(cache["act_len"], act_end)):
            self.length_faults += 1
        kv_pages = pages_bound - act_pages_bound
        if (int(cache["act_len"][ran].max()) > act_pages_bound * PAGE
                or int(cache["kv_len"][ran].max()) > kv_pages * PAGE):
            self.bound_faults += 1
        return out


class ForcedRun:
    """One server run teacher-forced with an oracle's tokens ``gold`` (rid ->
    (n,) tensor): each admission's first token and every chunk's fed tokens
    are the oracle's, so the run keeps the server's own admission batches,
    chunk bounds and store schedules (they follow lengths, not tokens) while
    each position's logits are read against the oracle's ``ora`` (rid ->
    (n, V)).  Install with ``patch(srv)``; ``gaps()`` -> {rid: (n,) max
    |Δlogit| per position}.  ``act_short`` plants the bound fault: each
    chunk's tables one ACT page short of what its active slots hold as it
    starts, and ``bound_faults`` counts the chunks whose device lengths then
    outgrow the bound.  ``ora`` None (an offload server): nothing is forced,
    the run's own logits are kept (``gold`` gives the lengths only) and
    ``gaps(ora)`` reads them against an oracle fed the run's tokens."""

    def __init__(self, srv, gold, ora, act_short: bool = False):
        self.srv, self.act_short, self.force = srv, act_short, ora is not None
        self.gold = {rid: g.cpu().numpy() for rid, g in gold.items()}
        if self.force:
            rids = sorted(ora)
            self.off = dict(zip(rids, np.cumsum([0] + [len(ora[r])
                                                       for r in rids])))
            self.ora = torch.cat([ora[r] for r in rids]).float()
        self.real_prefill, self.real_admit = (M.hybrid_prefill_batched,
                                              srv._admit_batch)
        self.rows: list = []        # (rids, positions, gaps tensor)
        self.calls = self.bound_faults = 0
        self._lg = None

    @contextlib.contextmanager
    def patch(self):
        self.srv._admit_batch = self.admit_batch
        ex = self.srv.executor
        chunk = (patched(M, "hybrid_decode_chunk", self.chunk) if ex is None
                 else patched(ex, "decode_chunk",
                              self.offload_chunk(ex.decode_chunk)))
        try:
            with patched(M, "hybrid_prefill_batched", self.prefill), chunk:
                yield self
        finally:
            del self.srv._admit_batch

    def record(self, rows, lg, rids, pos):
        if not self.force:
            self.rows.append((rids, pos, lg[rows].float()))
            return
        idx = torch.tensor([self.off[r] + p for r, p in zip(rids, pos)],
                           device=lg.device)
        self.rows.append((rids, pos, (lg[rows].float() - self.ora[idx])
                          .abs().amax(-1)))

    def prefill(self, *a, **kw):
        lg, new = self.real_prefill(*a, **kw)
        self._lg = lg[:, -1]
        return lg, new

    def admit_batch(self, assignments, stats):
        self.real_admit(assignments, stats)
        slots = [i for i, _, _ in assignments]
        rids = [r.rid for _, r, _ in assignments]
        pos = [len(self.srv.slots[i].generated) for i in slots]
        self.record(list(range(len(slots))), self._lg, rids, pos)
        for i, r, p in zip(slots, rids, pos):
            if self.force:
                self.srv._cur_tok[i] = self.gold[r][p]

    def fed(self, S, B):
        """The chunk's fed tokens (S + 1, B) from each slot's position, the
        slots' rids and those positions."""
        rid = [st.rid for st in self.srv.slots]
        pos0 = [len(st.generated) for st in self.srv.slots]
        fed = np.zeros((S + 1, B), np.int32)
        for b in range(B):
            if rid[b] >= 0:
                g = self.gold[rid[b]]
                fed[:, b] = g[np.minimum(pos0[b] + np.arange(S + 1), len(g) - 1)]
        return fed, rid, pos0

    def record_step(self, act_np, s, lg, rid, pos0):
        rows = [b for b in range(lg.shape[0]) if act_np[s, b]
                and pos0[b] + s + 1 < len(self.gold[rid[b]])]
        if rows:
            self.record(rows, lg[:, -1], [rid[b] for b in rows],
                        [pos0[b] + s + 1 for b in rows])

    def offload_chunk(self, real):
        """The offload executor's ``decode_chunk`` fed the oracle's tokens:
        each step's logits recorded, the oracle's next token handed back in
        place of their argmax."""
        def chunk(cur, cache, store_sched, active_sched, **kw):
            act_np = np.asarray(active_sched, bool)
            fed, rid, pos0 = self.fed(*act_np.shape)
            fed_d = torch.from_numpy(fed).cuda()
            step = iter(range(act_np.shape[0]))
            real_end = M.hybrid_decode_end

            def end(*a, **k):
                lg = real_end(*a, **k)
                s = next(step)
                self.record_step(act_np, s, lg, rid, pos0)
                return lg if not self.force else F.one_hot(
                    fed_d[s + 1].long(), lg.shape[-1]).to(lg.dtype)[:, None]

            with patched(M, "hybrid_decode_end", end):
                got = real(cur, cache, store_sched, active_sched, **kw)
            self.calls += 1
            return got
        return chunk

    def chunk(self, params, cfg, cur, cache, store, active, *, pages_bound,
              act_pages_bound, quant, any_act):
        S, B = store.shape
        act_np = active.cpu().numpy()
        fed, rid, pos0 = self.fed(S, B)
        ran = torch.from_numpy(act_np.any(0)).cuda()
        if self.act_short:
            need = -(-int(cache["act_len"][ran].max()) // PAGE)
            if need < 1:
                raise AssertionError("the fault's chunk holds no ACT page")
            pages_bound -= act_pages_bound - (need - 1)
            act_pages_bound = need - 1
        fed_d = torch.from_numpy(fed).cuda()
        toks = []
        for s in range(S):
            a = active[s]
            kv_len, act_len = cache["kv_len"], cache["act_len"]
            lg, cache = M.hybrid_decode_step(
                params, cfg, fed_d[s][:, None], cache, store[s] & a,
                pages_bound=pages_bound, act_pages_bound=act_pages_bound,
                quant=quant, any_act=bool(any_act[s]))
            M._freeze_inactive(cache, a, kv_len, act_len)
            toks.append(torch.where(a, fed_d[s], -1))
            self.record_step(act_np, s, lg, rid, pos0)
        self.calls += 1
        if self.act_short and \
                int(cache["act_len"][ran].max()) > act_pages_bound * PAGE:
            self.bound_faults += 1
        return torch.stack(toks, 1), fed_d[S], cache

    def gaps(self, ora=None) -> dict:
        out = {rid: np.full(len(g), np.nan) for rid, g in self.gold.items()}
        for rids, pos, g in self.rows:       # a resume's prefill overwrites
            if ora is not None:              # the kept logits, read now
                g = torch.stack([(row - ora[r][p].float()).abs().amax()
                                 for r, p, row in zip(rids, pos, g)])
            for r, p, v in zip(rids, pos, g.cpu().numpy()):
                out[r][p] = v
        if any(np.isnan(g).any() for g in out.values()):
            raise AssertionError("the forced run left positions unread")
        return out


def sched_forced(cfg, params, reqs, arrivals, S, gold, ora, act_short=False,
                 **kw):
    """One ``ForcedRun`` of the server as ``sched_serve`` configures it, on
    ``reqs`` and the oracle ``gold``/``ora`` restricted to them.  -> the
    ``ForcedRun`` (its ``gaps()`` read)."""
    srv = ContinuousBatchingServer(cfg, params, chunk_steps=S, hw=H100_SXM,
                                   **SCHED_SERVER, **kw)
    forced = ForcedRun(srv, {r.rid: gold[r.rid] for r in reqs},
                       {r.rid: ora[r.rid] for r in reqs}, act_short)
    with forced.patch():
        srv.run(reqs, arrival_steps=arrivals)
    srv.close()
    forced.gap = forced.gaps()
    forced.max_gap = max(float(g.max()) for g in forced.gap.values())
    return forced


@contextlib.contextmanager
def patched(module, name, value):
    real = getattr(module, name)
    setattr(module, name, value)
    try:
        yield
    finally:
        setattr(module, name, real)


def scatter_without_scales(cache, new, slot_idx):
    """The admission scatter with the int8 scale planes left out (a planted
    fault): the new rows' codes land in the slots, their scales do not."""
    for key in ("k", "v", "act"):
        cache[key][:, slot_idx] = new[key]
    for key in ("act_pos", "kv_len", "act_len"):
        cache[key][slot_idx] = new[key]


def freeze_nothing(cache, active, kv_len, act_len):
    """``M._freeze_inactive`` as a planted fault: inactive slots' lengths
    advance with the active ones'."""


def sched_oracle(params, cfg, reqs, logit_tol):
    """The fp oracle of the scheduler's trace in one pass per request:
    ``exact_reference_generate``'s plain prefill and greedy decode, each
    step's logits kept (the oracle fed its own tokens), and their top-2
    margins.  -> (rule, gold, ora)."""
    oracle, ora, margin = {}, {}, {}
    for r in reqs:
        padded = np.full(bucket(len(r.prompt)), r.prompt[-1], np.int32)
        padded[:len(r.prompt)] = r.prompt
        toks = torch.from_numpy(padded).cuda()[None]
        lg, c = M.prefill(params, cfg, toks,
                          max_len=toks.shape[1] + r.max_new_tokens + 8)
        steps, cur = [], []
        for s in range(r.max_new_tokens):
            steps.append(lg[:, -1])
            cur.append(lg[:, -1].argmax(-1).int())
            if s < r.max_new_tokens - 1:
                lg, c = M.decode_step(params, cfg, cur[-1][:, None], c)
        ora[r.rid] = torch.cat(steps, 0)
        oracle[r.rid] = torch.cat(cur).cpu().numpy()
        top2 = ora[r.rid].topk(2, dim=-1).values
        margin[r.rid] = (top2[:, 0] - top2[:, 1]).cpu().numpy()
    gold = {rid: torch.from_numpy(t).cuda() for rid, t in oracle.items()}
    return {"oracle": oracle, "margin": margin, "logit_tol": logit_tol}, \
        gold, ora


def sched_launches(cfg, stats, check, quant, host_attn=False) -> dict:
    """Launches of one server run: a flash launch per layer and admission
    batch, a hybrid launch per layer and executed step (and on the RoPE
    route a ``kv_gen`` launch on the steps whose tables hold an ACT page);
    the int8 run's modes and, on the fused route, a ``return_lse`` launch
    on the steps that bind a token to the ACT region (its exact row's
    merge); the host-attend run's hybrid launches are all ``return_lse``.
    ``check``: the run's ``ChunkCheck`` (None: an offload run, whose tables
    always hold an ACT page)."""
    L, rope = cfg.num_layers, cfg.pos_type == "rope"
    hk = "hybrid_paged_attention_two_pool" if rope else "hybrid_paged_attention"
    steps = stats.steps
    act_steps = check.act_page_steps if check is not None else steps
    lse = steps if host_attn else \
        check.any_act_steps if quant is not None and not rope else 0
    want = {k: 0 for k in COUNTERS}
    want["flash_attention"] = L * stats.admission_batches
    want[hk] = L * steps
    want["kv_gen"] = L * act_steps if rope else 0
    want[hk + "_return_lse"] = L * lse
    if quant is not None:
        want[hk + "_q8"] = L * steps
        want["kv_gen_q8"] = want["kv_gen"]
        want[hk + "_return_lse_q8"] = L * lse
    return want


def sched_leak_free(srv) -> bool:
    return (not any(s.active for s in srv.slots) and not srv.parked
            and not srv.blockman.tables
            and not any(p.allocated for p in srv.blockman.pools.values()))


def sched_serve(cfg, params, reqs, arrivals, S, check=None, hook=None,
                **kw):
    """One server run with the launch counts set to 0 before it and read
    after; ``hook(srv)``, when given, a context the run goes through.
    -> (server, tokens, stats, launches, wall s)."""
    srv = ContinuousBatchingServer(cfg, params, chunk_steps=S, hw=H100_SXM,
                                   **SCHED_SERVER, **kw)
    torch.cuda.synchronize()
    reset_counts()
    t0 = time.perf_counter()
    with contextlib.ExitStack() as stack:
        if check is not None:
            stack.enter_context(patched(M, "hybrid_decode_chunk", check))
        if hook is not None:
            stack.enter_context(hook(srv))
        out, stats = srv.run(reqs, arrival_steps=arrivals)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = read_counts()
    srv.close()
    return srv, out, stats, launches, wall


def sched_stats(stats, wall) -> dict:
    return {"wall_s": wall, "tokens_per_s": stats.generated_tokens / wall,
            "generated_tokens": stats.generated_tokens, "steps": stats.steps,
            "chunks": stats.chunks, "admission_batches": stats.admission_batches,
            "admitted": stats.admitted, "device_calls": stats.device_calls,
            "host_syncs": stats.host_syncs,
            "dispatches_per_token": stats.dispatches_per_token,
            "host_syncs_per_token": stats.host_syncs / stats.generated_tokens,
            "sim_time_s": stats.sim_time}


def phase_scheduler(results, smi, cfg, params):
    """The continuous-batching server on the card, at full width and depth,
    over ``SCHED_TRACE``.  opt-6.7b: S = 1 and 8, S = 8 under int8, under
    pool pressure (preemption, demotion to ACT, resume), and on the first
    ``SCHED_SUBSET`` requests device-resident (profiled), with the weights
    streamed (``offload=True``, depth 1) and with the CPU lane
    (``host_attn=True``); yi-6b: S = 8, and S = 8 int8 with the CPU lane on
    the subset.  Every device-resident chunk runs under the sync check and
    is held to the masking and bound contracts.  Checks tokens (the fp rule
    against the oracle, each run's allowance read from a ``ForcedRun`` of
    the same server on the same schedule; int8 against the q8 oracle under
    the int8 rule; the offload run equal to the device-resident server's),
    counters (one call and one readback per admission batch and per chunk;
    S = 8 under half of S = 1's calls per token), leaks, launches, and
    planted faults (admission without the int8 scale planes, chunks one ACT
    page short, which must move the teacher-forced logits past the limit,
    inactive slots' lengths advancing), each of which must fail.  Prints
    tokens/s per run, the profiled run's device idle share, and the offload
    runs' step times.  OPT's CPU-lane run is traced (``Tracer`` and
    ``MetricsRegistry``; the telemetry phase reads its trace).
    -> ({run label: launches}, what the telemetry phase compares with: the
    oracle rule, the device-resident subset's tokens, the runs, the traced
    run's tracer)."""
    name = cfg.name
    rope = cfg.pos_type == "rope"
    logit_tol = LOGIT_TOL_BY_DTYPE[cfg.dtype]
    t_phase = time.perf_counter()
    stage_s = {}

    def stage(label, t0):
        stage_s[label] = time.perf_counter() - t0
        return time.perf_counter()

    reqs, arrivals = open_loop_trace(cfg.vocab_size, SCHED_REQUESTS,
                                     **SCHED_TRACE)
    sub, sub_arr = reqs[:SCHED_SUBSET], arrivals[:SCHED_SUBSET]
    out = {"phase": "scheduler", "card": smi, "model": name,
           "prompt_lens": [len(r.prompt) for r in reqs],
           "max_new": [r.max_new_tokens for r in reqs], "arrivals": arrivals,
           "subset": SCHED_SUBSET, **SCHED_SERVER}
    t0 = time.perf_counter()
    rule, gold, ora = sched_oracle(params, cfg, reqs, logit_tol)
    t0 = stage("oracle", t0)
    probe = ContinuousBatchingServer(cfg, params, hw=H100_SXM, **SCHED_SERVER)
    out["act_frac"] = probe.act_frac
    if probe.act_frac <= 0:
        raise AssertionError(f"{name}: the server keeps no ACT tokens")
    del probe
    runs, launches, faults, forced_gap = {}, {}, {}, {}
    out.update(max_teacher_forced_dlogit=forced_gap, logit_tol=logit_tol)

    def forced(label, S, rs=reqs, ar=arrivals, **kw):
        """The fp rule's allowance for the run ``label``: its teacher-forced
        gaps through the server's own admissions, bounds and schedules,
        held within the logit limit."""
        f = sched_forced(cfg, params, rs, ar, S, gold, ora, **kw)
        rule[label], forced_gap[label] = f.gap, f.max_gap
        if f.max_gap > logit_tol:
            raise AssertionError(f"{name} scheduler {label}: teacher-forced "
                                 f"logits differ by {f.max_gap}")
        return f

    def record(label, srv, toks, stats, got, wall, want, check=None,
               resident=True):
        run = sched_stats(stats, wall)
        run["launches"] = got
        checks = {"launches": got == want, "no_leaks": sched_leak_free(srv),
                  "tokens_generated": stats.generated_tokens == sum(
                      r.max_new_tokens for r in reqs if r.rid in toks)}
        if resident:
            checks["one_call_per_batch_and_chunk"] = \
                stats.device_calls == stats.admission_batches + stats.chunks
            checks["one_readback_per_call"] = \
                stats.host_syncs == stats.device_calls
        if check is not None:
            run.update(chunk_calls=check.calls, any_act_steps=check.any_act_steps)
            checks["chunks_checked"] = check.calls == stats.chunks
            checks["lengths_frozen"] = check.length_faults == 0
            checks["bounds_cover_lengths"] = check.bound_faults == 0
        run["checks"] = checks
        runs[label] = run
        print(f"scheduler {name} {label}: {run['tokens_per_s']:.2f} tokens/s, "
              f"{stats.dispatches_per_token:.4f} calls/token ({smi})",
              flush=True)
        if not all(checks.values()):
            raise AssertionError(f"scheduler {name} {label} failed {checks}: "
                                 f"{run}, expected launches {want}")

    def resident_run(label, S, rs=reqs, ar=arrivals, quant=None, **kw):
        check = ChunkCheck()
        srv, toks, stats, got, wall = sched_serve(cfg, params, rs, ar, S,
                                                  check, quant=quant, **kw)
        record(label, srv, toks, stats, got, wall,
               sched_launches(cfg, stats, check, quant), check)
        return srv, toks

    # OPT: S = 1 then 8, compared within the call (host times vary between
    # calls by more than S moves them)
    for S in ((1, 8) if not rope else (8,)):
        forced(f"S{S}", S)
        _, toks = resident_run(f"S{S}", S)
        runs[f"S{S}"].update(exactness(rule, f"S{S}", toks, reqs))
        launches["fp" if S == 8 else "fp_S1"] = runs[f"S{S}"]["launches"]
        t0 = stage(f"S{S}", t0)
    if not rope:
        ratio = runs["S8"]["dispatches_per_token"] / \
            runs["S1"]["dispatches_per_token"]
        out["dispatches_per_token_S8_over_S1"] = ratio
        out["tokens_per_s_S8_over_S1"] = \
            runs["S8"]["tokens_per_s"] / runs["S1"]["tokens_per_s"]
        if not ratio < 0.5:
            raise AssertionError(f"{name}: S = 8 issues {ratio} of S = 1's "
                                 "calls per token")

    # planted faults on the subset, each of which must fail
    if rope:
        # the fault must show in the logits: the teacher-forced gap on the
        # subset's schedule past the limit, where the sound run's stays in it
        clean = forced("S8_subset", 8, sub, sub_arr)
        bad = sched_forced(cfg, params, sub, sub_arr, 8, gold, ora,
                           act_short=True)
        faults[ACT_BOUND_FAULT] = (
            "failed" if bad.max_gap > logit_tol and bad.bound_faults
            else "passed") + (
            f": teacher-forced gap {bad.max_gap} (sound {clean.max_gap}, "
            f"limit {logit_tol}); {bad.bound_faults} of {bad.calls} chunks' "
            "bounds short")
    else:
        check = ChunkCheck()
        with patched(M, "_freeze_inactive", freeze_nothing):
            sched_serve(cfg, params, sub, sub_arr, 8, check)
        faults[FREEZE_FAULT] = (f"failed: {check.length_faults} of "
                                f"{check.calls} chunks broke the lengths"
                                if check.length_faults else "passed")
    t0 = stage("faults_fp", t0)

    if not rope:
        # the int8 cache against the q8 oracle: agreement with the fp oracle,
        # and the path's teacher-forced gap to the q8 oracle (on the subset:
        # the q8 oracle decodes ~1.5 s a request) within the limit
        q = QuantConfig()
        q8 = {r.rid: q8_generate(params, cfg, r.prompt, r.max_new_tokens)
              for r in sub}
        q8_gold = {rid: torch.from_numpy(t).cuda() for rid, (t, _) in q8.items()}
        q8_oracle = {rid: t for rid, (t, _) in q8.items()}
        gap_q8_fp = max((q8_generate(params, cfg, r.prompt, r.max_new_tokens,
                                     gold[r.rid])[1] - ora[r.rid]).abs().max()
                        .item() for r in sub)
        limit = QUANT_GAP_FACTOR * gap_q8_fp + logit_tol
        t0 = stage("q8_oracle", t0)
        srv, toks = resident_run("S8_int8", 8, quant=q)
        launches["int8"] = runs["S8_int8"]["launches"]
        q8_gap = sched_forced(cfg, params, sub, sub_arr, 8, q8_gold,
                              {rid: lg for rid, (_, lg) in q8.items()},
                              quant=q).max_gap
        agree = agreement(toks, rule["oracle"], reqs)
        runs["S8_int8"].update(
            act_frac=srv.act_frac, agreement_with_fp_oracle=agree,
            equal_to_q8_oracle=sum(np.array_equal(toks[r.rid], q8_oracle[r.rid])
                                   for r in sub),
            max_teacher_forced_dlogit_vs_q8=q8_gap, limit=limit,
            gap_q8_oracle_vs_fp_oracle=gap_q8_fp)
        if agree < MIN_AGREEMENT or q8_gap > limit:
            raise AssertionError(f"{name} scheduler int8: agreement {agree}, "
                                 f"gap to the q8 oracle {q8_gap}, limit {limit}")
        with patched(SCHED, "scatter_rows", scatter_without_scales):
            _, toks, *_ = sched_serve(cfg, params, sub, sub_arr, 8, quant=q)
        agree_f = agreement(toks, rule["oracle"], sub)
        faults[SCALES_FAULT] = (f"failed: agreement {agree_f}"
                                if agree_f < MIN_AGREEMENT else
                                f"passed: agreement {agree_f}")
        t0 = stage("int8", t0)

        # pool pressure: preemption demotes to ACT and resumes
        forced("S8_pressure", 8, **SCHED_PRESSURE)
        srv, toks = resident_run("S8_pressure", 8, **SCHED_PRESSURE)
        rs = srv.recovery_stats
        runs["S8_pressure"].update(
            recovery=rs.as_dict(),
            **exactness(rule, "S8_pressure", toks, reqs))
        launches["fp_pressure"] = runs["S8_pressure"]["launches"]
        if not (rs.preemptions >= 1 and rs.preempt_to_act >= 1
                and rs.resumes == rs.preemptions):
            raise AssertionError(f"{name} pressure run: {rs}")
        t0 = stage("pressure", t0)

        # the subset device-resident; the offload runs' tokens must equal
        # its (its profile was cut to keep the script's time)
        resident = dict(resident_run("S8_subset", 8, sub, sub_arr)[1])
        # the CPU-lane run's allowance: the device-resident path's forced
        # gaps on the same schedule (the subset at S = 8)
        forced("S8_subset", 8, sub, sub_arr)
        t0 = stage("profiled_subset", t0)

    # streamed weights on the subset
    off_runs = ({"S8_offload": dict(offload=True),
                 "S8_offload_host_attn": dict(offload=True, host_attn=True,
                                              tracer=Tracer(),
                                              metrics=MetricsRegistry())}
                if not rope else
                {"S8_offload_host_attn_int8": dict(offload=True, host_attn=True,
                                                   quant=QuantConfig())})
    for label, kw in off_runs.items():
        srv, toks, stats, got, wall = sched_serve(cfg, params, sub, sub_arr, 8,
                                                  **kw)
        q8 = kw.get("quant")
        record(label, srv, toks, stats, got, wall,
               sched_launches(cfg, stats, None, q8, kw.get("host_attn", False)),
               resident=False)
        ms = srv.measured_steps
        run = runs[label]
        run.update(step_s_mean=float(np.mean([m.total for m in ms])),
                   pcie_busy_s_mean=float(np.mean([m.pcie_busy for m in ms])),
                   gpu_busy_s_mean=float(np.mean([m.gpu_busy for m in ms])),
                   cpu_busy_s_mean=float(np.mean([m.cpu_busy for m in ms])),
                   gpu_idle_share=1.0 - sum(m.gpu_busy for m in ms)
                   / sum(m.total for m in ms),
                   measured_steps=len(ms),
                   blocking_syncs=srv.executor.blocking_syncs)
        print(f"scheduler {name} {label}: step {run['step_s_mean']:.4f} s, "
              f"pcie {run['pcie_busy_s_mean']:.4f} s, gpu "
              f"{run['gpu_busy_s_mean']:.4f} s ({smi})", flush=True)
        launches[label.replace("S8_", "")] = got
        if q8 is not None:
            agree = agreement(toks, rule["oracle"], sub)
            run["agreement_with_fp_oracle"] = agree
            if agree < MIN_AGREEMENT:
                raise AssertionError(f"{name} {label}: agreement {agree}")
        elif kw.get("host_attn"):
            run.update(exactness(rule, "S8_subset", toks, sub))
        else:
            same = sum(np.array_equal(toks[r.rid], resident[r.rid]) for r in sub)
            run["equal_to_device_resident"] = same
            if same != len(sub):
                raise AssertionError(f"{name} {label}: tokens differ from the "
                                     "device-resident server's")
        if len(ms) != stats.steps:
            raise AssertionError(f"{name} {label}: {len(ms)} measured steps of "
                                 f"{stats.steps}")
        del srv
        gc.collect()
        t0 = stage(label, t0)
    out.update(runs=runs, faults=faults, stage_s=stage_s,
               phase_s=time.perf_counter() - t_phase)
    emit(out)
    results[f"scheduler {name}"] = out
    held = [k for k, v in faults.items() if not v.startswith("failed")]
    if held:
        raise AssertionError(f"{name} scheduler: planted faults pass: {faults}")
    ctx = {"rule": rule, "gold": gold, "ora": ora, "runs": runs, "sub": sub,
           "sub_arr": sub_arr,
           "resident": resident if not rope else None,
           "tracers": {label: kw["tracer"] for label, kw in off_runs.items()
                       if "tracer" in kw}}
    return launches, ctx


# ----------------------------------------------------------- telemetry phase
class AdmitSyncs:
    """``ContinuousBatchingServer._admit`` under
    ``set_sync_debug_mode("warn")``: every stream sync it makes (an upload
    from pageable memory, a readback) warns; each is counted, with the line
    that made it.  The one readback of the first tokens is the counted host
    sync."""

    def __init__(self):
        self.calls = self.syncs = 0
        self.sites: dict = {}
        self.real = ContinuousBatchingServer._admit

    def patch(self):
        return patched(ContinuousBatchingServer, "_admit",
                       lambda srv, *a, **kw: self.admit(srv, *a, **kw))

    def admit(self, srv, *a, **kw):
        torch.cuda.synchronize()
        with warnings.catch_warnings(record=True) as seen:
            warnings.simplefilter("always")
            torch.cuda.set_sync_debug_mode("warn")
            try:
                got = self.real(srv, *a, **kw)
            finally:
                torch.cuda.set_sync_debug_mode(0)
        self.calls += 1
        for w in seen:
            if "synchroniz" in str(w.message):
                self.syncs += 1
                site = f"{Path(w.filename).name}:{w.lineno}"
                self.sites[site] = self.sites.get(site, 0) + 1
        return got


# the controller's runs on the card update after every chunk (group) so that
# the few chunks of the subset make several updates
TELEMETRY_CTL = dict(update_every=1)
RECORD_SYNC_FAULT = "lane_spans_synchronised_as_recorded"
GPU_X4_FAULT = "measured_compute_lane_x4"


def fit_row(f) -> dict:
    return {"slope_s_per_token_layer": f.slope, "intercept_s": f.intercept,
            "r2": f.r2}


def controller_report(ctl, cfg, quant) -> dict:
    """The controller's prior and refit fits per lane (the load lane's slope
    also as the rates it implies: the gather rate, bytes per token over the
    slope, and the link, that rate over the spec's gather efficiency, beside
    the spec's link), its ACT fraction per update, and the drift monitor's
    per-lane summary."""
    kv_b = kv_bytes_per_token(cfg, quant)
    fits = {}
    for lane, prior, fit in (("gen", ctl.prior_gen, ctl.fit_gen),
                             ("load", ctl.prior_load, ctl.fit_load),
                             ("cpu", ctl.prior_cpu, ctl.fit_cpu)):
        if prior is None:
            continue
        row = {"prior": fit_row(prior), "refit": fit_row(fit),
               "slope_over_prior": fit.slope / prior.slope,
               "samples": len({"gen": ctl._gen, "load": ctl._load,
                               "cpu": ctl._cpu}[lane])}
        if lane == "load":
            for key, f in (("prior", prior), ("refit", fit)):
                row[key]["gather_GBps"] = kv_b / f.slope / 1e9
                row[key]["link_GBps"] = kv_b / f.slope / ctl.hw.gather_eff / 1e9
            row["spec_link_GBps"] = ctl.hw.host_link_bw / 1e9
        fits[lane] = row
    drift = ctl.drift.summary() if ctl.drift is not None else None
    return {"fits": fits, "frac_history": list(ctl.frac_history),
            "target_act_fraction": ctl.target_allocation().act_fraction,
            "updates": ctl.updates, "migrated_blocks": ctl.migrated_blocks,
            "faulted_skipped": ctl.faulted_skipped,
            "alloc": dataclasses.asdict(ctl.alloc), "drift": drift}


def print_controller(label, rep, smi) -> None:
    for lane, row in rep["fits"].items():
        link = (f", link {row['prior']['link_GBps']:.2f} -> "
                f"{row['refit']['link_GBps']:.2f} GB/s (spec "
                f"{row['spec_link_GBps']:.0f})" if lane == "load" else "")
        print(f"telemetry {label} {lane}: slope "
              f"{row['prior']['slope_s_per_token_layer']:.4g} -> "
              f"{row['refit']['slope_s_per_token_layer']:.4g} s/token/layer "
              f"(x{row['slope_over_prior']:.3f}, {row['samples']} samples), "
              f"intercept {row['prior']['intercept_s']:.4g} -> "
              f"{row['refit']['intercept_s']:.4g} s{link} ({smi})", flush=True)
    d = rep["drift"] or {}
    print(f"telemetry {label}: act fraction "
          f"{[round(f, 4) for f in rep['frac_history']]}, updates "
          f"{rep['updates']}, migrated {rep['migrated_blocks']} blocks, "
          f"faulted skipped {rep['faulted_skipped']}, drift "
          f"{ {k: round(v, 3) for k, v in d.get('rel', {}).items()} } "
          f"flagged {d.get('flagged')} ({smi})", flush=True)


def trace_checks(tracer, rids, require, path=None) -> dict:
    """Export (to ``path`` when given), validate and read one trace: every
    request single-rooted with ``require``; -> the trace's counts."""
    data = tracer.to_chrome()
    if path is not None:
        path.write_text(json.dumps(data))
        data = json.loads(path.read_text())
    validate_chrome_trace(data)
    for rid in rids:
        assert_single_rooted(data, rid, require=require)
    ev = data["traceEvents"]
    spans = lambda name: [e for e in ev if e["ph"] == "X" and e["name"] == name]
    chunks, mirrors = spans("chunk"), spans("mirror")
    lanes = sorted({e["name"] for e in ev if e["ph"] == "X"
                    and e.get("cat", "").startswith("lane:")})
    out = {"events": len(ev), "lane_span_names": lanes,
           "chunk_spans": len(chunks), "mirror_spans": len(mirrors)}
    if mirrors:
        # the host-mirror pull, a link span of its own: its share of the
        # chunk spans it falls in
        pull = sum(m["dur"] for m in mirrors)
        chunk = sum(c["dur"] for c in chunks)
        inside = sum(any(c["ts"] <= m["ts"] and m["ts"] + m["dur"]
                         <= c["ts"] + c["dur"] + 1e-3 for c in chunks)
                     for m in mirrors)
        out.update(mirror_ms_mean=pull / len(mirrors) / 1e3,
                   mirror_share_of_chunks=pull / chunk,
                   mirror_inside_a_chunk=inside,
                   mirror_bytes_mean=float(np.mean([m["args"]["nbytes"]
                                                    for m in mirrors])))
    return out


def phase_telemetry(results, smi, cfg, params, sched):
    """The tracer, the metrics registry and the adaptive controller on the
    card, on the weights already loaded (``sched``: the scheduler phase's
    context).  Tracing invariance: the S = 8 server over the subset, device
    resident, with and without ``Tracer()`` + ``MetricsRegistry()``: the same
    tokens, calls, readbacks, admission batches and every kernel's
    launches; its exported trace (``chiprun_out/``) validates with every
    request single-rooted.  The engine's device-resident decode runs traced
    under ``set_sync_debug_mode("error")``; the server's admission makes
    one stream sync each, its counted readback (``AdmitSyncs``).  The
    controller on measured timelines: the server with streamed weights and
    ``adaptive=True`` (OPT: two-way; yi: int8 with the CPU lane,
    three-way), traced, against its non-adaptive twin of the scheduler
    phase (calls, readbacks, launches), tokens under that twin's rule (int8
    also a teacher-forced run within the q8 oracle's limit), leak-free, at
    least two updates, no degraded step fitted.  The
    CPU-lane runs' host-mirror pull is a link span of its own: its share of
    the chunks is printed.  -> {run label: launches}."""
    name = cfg.name
    rope = cfg.pos_type == "rope"
    t_phase = time.perf_counter()
    out_dir = ROOT / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    sub, sub_arr, runs = sched["sub"], sched["sub_arr"], sched["runs"]
    rids = [r.rid for r in sub]
    out = {"phase": "telemetry", "card": smi, "model": name}
    launches, checks = {}, {}

    # tracing invariance, device resident: untraced, traced, untraced (the
    # first run of a shape pays a warm-up the others do not)
    # the traced run's admissions (prefill, uploads, scatter, first tokens)
    # under the sync check: one stream sync each, its counted readback
    pair, admit = {}, AdmitSyncs()
    for label, kw in (("S8_subset_untraced", {}),
                      ("S8_subset_traced", dict(tracer=Tracer(),
                                                metrics=MetricsRegistry())),
                      ("S8_subset_untraced_again", {})):
        # each chunk under the sync check and the masking contract
        check = ChunkCheck()
        srv, toks, stats, got, wall = sched_serve(
            cfg, params, sub, sub_arr, 8, check,
            hook=(lambda _: admit.patch()) if "tracer" in kw else None, **kw)
        checks[f"{label}_chunks_checked"] = \
            check.calls == stats.chunks and not (check.length_faults
                                                 or check.bound_faults)
        pair[label] = (srv, toks, stats, got, wall, kw.get("tracer"))
        launches[label] = got
        out[label] = dict(sched_stats(stats, wall), launches=got,
                          wall_ms_per_token=1e3 * wall / stats.generated_tokens)
    (_, t0_, s0, l0, _, _), (srv1, t1_, s1, l1, _, tracer), \
        (_, t2_, s2, l2, _, _) = pair.values()
    checks["traced_tokens_equal"] = all(
        np.array_equal(t0_[r], t1_[r]) and np.array_equal(t2_[r], t1_[r])
        for r in rids)
    for f in ("device_calls", "host_syncs", "admission_batches", "chunks"):
        checks[f"traced_{f}_equal"] = \
            getattr(s0, f) == getattr(s1, f) == getattr(s2, f)
    checks["traced_launches_equal"] = l0 == l1 == l2
    checks["traced_leak_free"] = sched_leak_free(srv1)
    out["server_trace"] = trace_checks(
        tracer, rids, ("prefill", "complete"),
        out_dir / f"trace_{name}_server.json")
    snap = srv1.snapshot()
    out["snapshot_keys"] = len(snap)
    checks["snapshot_ttft"] = snap["ttft_s"]["count"] == len(sub)
    print(f"telemetry {name}: wall ms per token untraced "
          f"{out['S8_subset_untraced']['wall_ms_per_token']:.3f}, traced "
          f"{out['S8_subset_traced']['wall_ms_per_token']:.3f}, untraced "
          f"{out['S8_subset_untraced_again']['wall_ms_per_token']:.3f} "
          f"({smi})", flush=True)

    out["admission_syncs"] = {"admissions": admit.calls,
                              "syncs": admit.syncs, "sites": admit.sites}
    checks["admission_one_sync_each"] = \
        admit.calls == s1.admission_batches > 0 and admit.syncs == admit.calls

    # the engine's device-resident decode, traced, under the sync check
    reqs = request_trace(cfg.vocab_size, **TRACE)
    real_loop = M.hybrid_decode_loop

    def checked_loop(*a, **kw):
        torch.cuda.set_sync_debug_mode("error")
        try:
            return real_loop(*a, **kw)
        finally:
            torch.cuda.set_sync_debug_mode(0)

    eng_runs = {}
    for label, kw in (("engine_untraced", {}),
                      ("engine_traced", dict(tracer=Tracer(),
                                             metrics=MetricsRegistry()))):
        eng = HybridServeEngine(cfg, params, hw=H100_SXM, **kw)
        torch.cuda.synchronize()
        reset_counts()
        with patched(M, "hybrid_decode_loop", checked_loop):
            toks, stats = eng.generate(reqs)
        torch.cuda.synchronize()
        launches[label] = read_counts()
        out[label] = {"launches": launches[label],
                      "device_calls": stats.device_calls}
        eng_runs[label] = (eng, toks, stats, kw.get("tracer"))
    (_, e0, es0, _), (eng1, e1, es1, etr) = eng_runs.values()
    checks["engine_traced_tokens_equal"] = all(
        np.array_equal(e0[r.rid], e1[r.rid]) for r in reqs)
    checks["engine_traced_calls_equal"] = es0.device_calls == es1.device_calls
    checks["engine_traced_launches_equal"] = \
        launches["engine_untraced"] == launches["engine_traced"] == \
        expected_launches(eng1, reqs)
    out["engine_trace"] = trace_checks(etr, [r.rid for r in reqs],
                                       ("admit", "complete"))
    out["engine_decode_host_syncs"] = 0
    del eng_runs, eng1

    # the controller on the card's measured lane timelines
    adaptive = ({"S8_offload_adaptive": ("S8_offload", dict(offload=True))}
                if not rope else
                {"S8_offload_host_attn_int8_adaptive": (
                    "S8_offload_host_attn_int8",
                    dict(offload=True, host_attn=True, quant=QuantConfig()))})
    for label, (twin, kw) in adaptive.items():
        tracer = Tracer()
        kept = {}                 # the int8 run's own logits, kept

        def keep(srv):
            kept["run"] = ForcedRun(srv, {r.rid: torch.zeros(
                r.max_new_tokens, dtype=torch.int32) for r in sub}, None)
            return kept["run"].patch()

        srv, toks, stats, got, wall = sched_serve(
            cfg, params, sub, sub_arr, 8, adaptive=True,
            ctl=ControllerConfig(**TELEMETRY_CTL), tracer=tracer,
            metrics=MetricsRegistry(),
            hook=keep if kw.get("quant") is not None else None, **kw)
        ctl = srv.controller
        rep = controller_report(ctl, cfg, kw.get("quant"))
        ref = runs[twin]
        run = dict(sched_stats(stats, wall), controller=rep, twin=twin,
                   launches=got,
                   trace=trace_checks(tracer, rids, ("prefill", "complete")))
        launches[label] = got
        checks[f"{label}_calls_equal_twin"] = \
            stats.device_calls == ref["device_calls"]
        checks[f"{label}_syncs_equal_twin"] = \
            stats.host_syncs == ref["host_syncs"]
        checks[f"{label}_launches_equal_twin"] = got == ref["launches"]
        checks[f"{label}_leak_free"] = sched_leak_free(srv)
        checks[f"{label}_updates"] = ctl.updates >= 2
        checks[f"{label}_faulted_skipped"] = ctl.faulted_skipped == 0
        if kw.get("quant") is not None:
            # held as the scheduler phase's int8 run is: agreement with the
            # fp oracle, and a teacher-forced gap to the q8 oracle within the
            # limit (its logits at each position against the q8 oracle's fed
            # the run's own tokens; the limit from the q8 oracle fed the fp
            # oracle's); beside them the non-adaptive twin's agreement and
            # where each request first leaves the fp oracle, with the
            # oracle's top-2 margin there
            q8_fp = {r.rid: q8_generate(params, cfg, r.prompt,
                                        r.max_new_tokens,
                                        sched["gold"][r.rid])[1] for r in sub}
            gap_q8_fp = max((q8_fp[r] - sched["ora"][r]).abs().max().item()
                            for r in rids)
            limit = QUANT_GAP_FACTOR * gap_q8_fp + \
                LOGIT_TOL_BY_DTYPE[cfg.dtype]
            q8_own = {r.rid: q8_generate(
                params, cfg, r.prompt, r.max_new_tokens,
                torch.from_numpy(toks[r.rid]).cuda())[1] for r in sub}
            max_gap = max(float(g.max())
                          for g in kept["run"].gaps(q8_own).values())
            run.update(
                agreement_with_fp_oracle=agreement(toks, sched["rule"]["oracle"],
                                                   sub),
                twin_agreement_with_fp_oracle=ref["agreement_with_fp_oracle"],
                first_divergence=first_divergence(toks, sched["rule"], sub),
                max_teacher_forced_dlogit_vs_q8=max_gap, limit=limit,
                gap_q8_oracle_vs_fp_oracle=gap_q8_fp)
            checks[f"{label}_agreement"] = \
                run["agreement_with_fp_oracle"] >= MIN_AGREEMENT
            checks[f"{label}_forced_gap_vs_q8"] = max_gap <= limit
            print(f"telemetry {name} {label}: agreement with the fp oracle "
                  f"{run['agreement_with_fp_oracle']:.4f} (non-adaptive twin "
                  f"{run['twin_agreement_with_fp_oracle']:.4f}); first "
                  f"divergence (position, fp margin) "
                  f"{run['first_divergence']}; teacher-forced gap to the q8 "
                  f"oracle {max_gap:.4f}, limit {limit:.4f} ({smi})",
                  flush=True)
        else:
            # the refit moves the split mid-run: the fp rule, with the
            # device-resident subset's teacher-forced gaps as allowance
            run.update(exactness(sched["rule"], "S8_subset", toks, sub))
            run["equal_to_device_resident"] = sum(
                np.array_equal(toks[r], sched["resident"][r]) for r in rids)
        if kw.get("host_attn"):
            checks[f"{label}_mirror_spans"] = \
                run["trace"]["mirror_spans"] == stats.chunks == \
                run["trace"]["mirror_inside_a_chunk"]
        out[label] = run
        print_controller(f"{name} {label}", rep, smi)
        srv.close()
        del srv
        gc.collect()

    # OPT's CPU-lane run of the scheduler phase was traced: its mirror pull
    if "S8_offload_host_attn" in sched["tracers"]:
        tr = trace_checks(sched["tracers"]["S8_offload_host_attn"], rids,
                          ("prefill", "complete"),
                          out_dir / f"trace_{name}_server_host_attn.json")
        out["S8_offload_host_attn_trace"] = tr
        checks["host_attn_mirror_spans"] = \
            tr["mirror_spans"] == runs["S8_offload_host_attn"]["chunks"] == \
            tr["mirror_inside_a_chunk"]
    cpu_lane = {"S8_offload_host_attn": out.get("S8_offload_host_attn_trace"),
                "S8_offload_host_attn_int8_adaptive":
                    out.get("S8_offload_host_attn_int8_adaptive", {}).get("trace")}
    for label, tr in cpu_lane.items():
        if tr:
            print(f"telemetry {name} {label}: mirror pull "
                  f"{tr['mirror_ms_mean']:.3f} ms a chunk, "
                  f"{tr['mirror_share_of_chunks']:.4f} of the chunks ({smi})",
                  flush=True)
    out.update(checks=checks, phase_s=time.perf_counter() - t_phase)
    emit(out)
    results[f"telemetry {name}"] = out
    if not all(checks.values()):
        raise AssertionError(f"telemetry {name} failed "
                             f"{[k for k, v in checks.items() if not v]}")
    return launches


REAL_RECORD = MeasuredTimeline.record


def record_synchronised(self, lane, tag, start, end, nbytes=0, shard=0):
    """``MeasuredTimeline.record`` with the reference's record-time tracer
    hook carried over literally (a planted fault): each span's CUDA events
    are synchronised as the span is recorded, to hand the tracer host
    seconds at once."""
    for t in (start, end):
        if not isinstance(t, (int, float)):
            t.synchronize()
    REAL_RECORD(self, lane, tag, start, end, nbytes, shard)


def gpu_lane_x4(res):
    """A measured step with its compute lane four times as long (a planted
    fault): the gpu lane's busy time and its spans' seconds."""
    tb = {k: 4.0 * v if k in ("fwd", "gen") else v
          for k, v in res.tag_busy.items()}
    return dataclasses.replace(res, tag_busy=tb, gpu_busy=4.0 * res.gpu_busy)


def phase_telemetry_offload(results, smi, cfg, pool, reqs, resident_outs,
                            rule, offload_runs):
    """The controller on the offload engine's measured timelines, inside the
    offload phase (its pinned weights): the engine with ``adaptive=True``
    under the tight budget (the KV region spills, so the link's KV loads
    feed the load lane) calls ``generate`` twice on the trace, the second
    call on the refit split; tokens equal the device-resident engine's,
    calls and blocking syncs the non-adaptive spilled run's (the second
    call, on the refit split, holds the fp rule against the oracle), at
    least two updates, no degraded step fitted.  Two planted faults must
    fail: the reference's record-time tracer hook carried over literally
    (each span's events synchronised as recorded) must break the depth-1
    overlap check or the sync count, and the same observations replayed
    with the measured compute lane scaled x4 (regeneration priced dearer)
    must move the target ACT fraction below the sound replay's by more than
    the controller's deadband.  -> {run label: launches}."""
    name = cfg.name
    t_phase = time.perf_counter()
    out = {"phase": "telemetry_offload", "card": smi, "model": name}
    launches, checks, faults = {}, {}, {}
    twin = offload_runs["hybrid_spill"]
    eng = HybridServeEngine(cfg, pool, hw=H100_SXM, offload=True,
                            budget=_tight(cfg), adaptive=True,
                            ctl=ControllerConfig(**TELEMETRY_CTL))
    seen = []                         # the controller's observations
    real_observe = eng.controller.observe

    def observe(results_, kv, act, sim=None, cpu_tokens=None):
        seen.append((list(results_), list(kv), list(act), list(sim)))
        return real_observe(results_, kv, act, sim=sim, cpu_tokens=cpu_tokens)

    eng.controller.observe = observe
    start = eng.alloc
    calls = []
    for i in range(2):
        b0 = eng.executor.blocking_syncs
        torch.cuda.synchronize()
        reset_counts()
        toks, stats = eng.generate(reqs)
        torch.cuda.synchronize()
        got = read_counts()
        launches[f"engine_spill_adaptive_call{i + 1}"] = got
        calls.append({"act_frac": eng.act_frac,
                      "device_calls": stats.device_calls,
                      "blocking_syncs": eng.executor.blocking_syncs - b0,
                      "launches_equal_twin": got == twin["launches"]})
        calls[-1]["equal_to_device_resident"] = sum(
            np.array_equal(toks[r.rid], resident_outs["hybrid"][r.rid])
            for r in reqs)
        if i == 0:
            checks["call1_tokens_equal_device_resident"] = \
                calls[-1]["equal_to_device_resident"] == len(reqs)
        else:
            calls[-1].update(exactness(rule, "hybrid", toks, reqs))
        checks[f"call{i + 1}_calls_equal_twin"] = \
            stats.device_calls == twin["device_calls"]
        checks[f"call{i + 1}_syncs_equal_twin"] = \
            calls[-1]["blocking_syncs"] == twin["blocking_syncs"]
        checks[f"call{i + 1}_launches_equal_twin"] = got == twin["launches"]
    ctl = eng.controller
    rep = controller_report(ctl, cfg, None)
    checks["updates"] = ctl.updates >= 2
    checks["faulted_skipped"] = ctl.faulted_skipped == 0
    checks["leak_free"] = not any(p.allocated for p in
                                  eng.blockman.pools.values()) \
        and eng.spill_kv_pool.allocated_blocks == 0
    out["engine_spill_adaptive"] = {"calls": calls, "controller": rep,
                                    "act_frac_start": start.act_fraction}
    print_controller(f"{name} engine_spill_adaptive", rep, smi)
    eng.close()
    del eng
    gc.collect()

    # planted fault 1: the record-time hook, at depth 1 (roomy budget)
    eng = HybridServeEngine(cfg, pool, hw=H100_SXM, offload=True,
                            budget=OffloadBudget(16 * 2**30, 1),
                            tracer=Tracer())
    with patched(MeasuredTimeline, "record", record_synchronised):
        eng.generate(reqs)
    ms = eng.measured_steps
    share = sum(m.gpu_hidden for m in ms) / sum(m.gpu_busy for m in ms)
    sound = offload_runs["hybrid_d1"]
    syncs_differ = eng.executor.blocking_syncs != sound["blocking_syncs"]
    out[RECORD_SYNC_FAULT] = {"gpu_hidden_share": share,
                              "sound_gpu_hidden_share":
                                  sound["gpu_hidden_share"],
                              "blocking_syncs": eng.executor.blocking_syncs,
                              "step_s_mean": float(np.mean([m.total
                                                            for m in ms]))}
    faults[RECORD_SYNC_FAULT] = (
        "failed" if share < MIN_HIDDEN_SHARE or syncs_differ else "passed") + \
        f": depth 1 hides {share:.4f} of its compute (sound " \
        f"{sound['gpu_hidden_share']:.4f}, limit {MIN_HIDDEN_SHARE})"
    eng.close()
    del eng
    gc.collect()

    # planted fault 2: the same observations, the compute lane x4, replayed
    def replay(fault):
        targets = []
        c = HybridCacheController(cfg, H100_SXM, start,
                                  ctl.n_act_gpu_blocks,
                                  fits=(ctl.prior_gen, ctl.prior_load),
                                  generalized=False,
                                  ctl=ControllerConfig(**TELEMETRY_CTL),
                                  drift=DriftMonitor())
        for res, kv, act, sim in seen:
            c.observe([gpu_lane_x4(r) for r in res] if fault else res, kv,
                      act, sim=sim)
            c.alloc = c.update()
            targets.append(c.target_allocation().act_fraction)
        return c, targets

    sound_c, sound_t = replay(False)
    bad_c, bad_t = replay(True)
    out[GPU_X4_FAULT] = {
        label: {"frac_history": c.frac_history, "targets": t,
                "fit_gen": fit_row(c.fit_gen),
                "gen_slope_over_prior": c.fit_gen.slope / c.prior_gen.slope,
                "drift": c.drift.summary()}
        for label, c, t in (("sound", sound_c, sound_t),
                            ("fault", bad_c, bad_t))}
    checks["replay_equals_the_run"] = sound_c.frac_history == ctl.frac_history
    # regeneration four times dearer: fewer ACT blocks than the sound target
    moved = bad_t[-1] < sound_t[-1] - ctl.ctl.deadband_frac
    faults[GPU_X4_FAULT] = ("failed" if moved else "passed") + \
        f": target act fraction {bad_t[-1]:.4f} (sound {sound_t[-1]:.4f}, " \
        f"deadband {ctl.ctl.deadband_frac}); gen slope x" \
        f"{out[GPU_X4_FAULT]['fault']['gen_slope_over_prior']:.3f} of the " \
        f"prior (sound x" \
        f"{out[GPU_X4_FAULT]['sound']['gen_slope_over_prior']:.3f}); gpu " \
        f"drift {bad_c.drift.drift('gpu'):.3f} (sound " \
        f"{sound_c.drift.drift('gpu'):.3f})"
    out.update(checks=checks, faults=faults,
               phase_s=time.perf_counter() - t_phase)
    emit(out)
    results[f"telemetry_offload {name}"] = out
    print(f"telemetry {name} faults: {faults} ({smi})", flush=True)
    if not all(checks.values()):
        raise AssertionError(f"telemetry offload {name} failed "
                             f"{[k for k, v in checks.items() if not v]}")
    held = [k for k, v in faults.items() if not v.startswith("failed")]
    if held:
        raise AssertionError(f"telemetry {name}: planted faults pass: {faults}")
    return launches


def kernel_group(name: str) -> str:
    if any(k in name for k in ("fused_norm_kernel", "fused_tile_kernel",
                               "fused_combine_kernel")):
        return "hybrid_paged_attention"
    if "split_attn_kernel" in name or "split_combine_kernel" in name:
        return "hybrid_paged_attention_two_pool"
    if "flash_fwd_kernel" in name:
        return "flash_attention"
    if "flash_bwd_" in name:
        return "flash_attention_bwd"
    if "kv_norm_kernel" in name or "kv_proj_kernel" in name:
        return "kv_gen"
    if "ssd_bwd_" in name:
        return "ssd_scan_bwd"
    if "ssd_gram_kernel" in name or "ssd_scan_" in name:
        return "ssd_scan"
    if any(w in name.lower() for w in ("gemm", "gemv", "cutlass", "xmma", "nvjet")):
        return "matmul (cuBLAS)"
    return "other (norms, elementwise, indexing, argmax)"


def phase_profile(results, smi, name, engines, reqs, runs=None):
    """Per mode: device time by kernel over one warm ``generate`` of the trace
    (torch.profiler kernel events), the device's busy and idle share of the
    wall-clock window, and the kernels that took the most device time.
    ``runs``: {mode: callable} to profile in place of the engines' runs.
    The device alone is traced: nothing reads the host's operator events,
    and a long run's take the profiler tens of seconds to collect."""
    from torch.profiler import ProfilerActivity, profile
    t_phase = time.perf_counter()
    out = {"phase": "profile", "card": smi, "model": name}
    activities = [ProfilerActivity.CUDA]
    if runs is None:
        runs = {mode: (lambda e=eng: e.generate(reqs))
                for mode, eng in engines.items()}
    for mode, run in runs.items():
        torch.cuda.synchronize()
        with profile(activities=activities) as prof:
            t0 = time.perf_counter()
            run()
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
            "device_share_by_kernel": {g: ms / busy for g, ms in by_group.items()}
            if busy else {},
            "top_kernels": [{"name": n_[:90], "calls": n, "ms": t}
                            for n_, (n, t) in top]}
        print(f"profile {name} {mode}: device busy {busy} ms of {wall_ms} ms; "
              + ", ".join(f"{g} {by_group[g] / busy:.4f}" for g in
                          ("kv_gen", "ssd_scan") if g in by_group), flush=True)
    out["seconds"] = time.perf_counter() - t_phase
    emit(out)
    results[f"profile {name}"] = out


def attention_in_chunks(q, k, v, causal=True, window=0,
                        chunk=GEMMA_SPREAD_CHUNKS[0]):
    """The plain prefill attention in another float32 order: an online
    softmax over key chunks of ``chunk`` (the blockwise attention of the
    reference's ``_bw_attn_fwd``, in torch), the output rounded to q.dtype.
    The gemma phase's spread runs the plain path's prefill on it."""
    B, Sq, H, D = q.shape
    Sk, KVH = k.shape[1], k.shape[2]
    qf = q.reshape(B, Sq, KVH, H // KVH, D).float() / math.sqrt(D)
    m = torch.full(qf.shape[:-1], -math.inf, device=q.device)
    l, acc = torch.zeros_like(m), torch.zeros_like(qf)
    i = torch.arange(Sq, device=q.device)[:, None]
    for c0 in range(0, Sk, chunk):
        s = torch.einsum("bqhgd,bkhd->bqhgk", qf, k[:, c0:c0 + chunk].float())
        j = torch.arange(c0, c0 + s.shape[-1], device=q.device)[None]
        if causal:
            keep = (j <= i) & ((j > i - window) if window else True)
            s = s.masked_fill(~keep[None, :, None, None, :], -math.inf)
        m_new = torch.maximum(m, s.amax(-1))
        base = torch.where(torch.isinf(m_new), 0.0, m_new)
        p = torch.exp(s - base[..., None])
        fade = torch.exp(m - base)
        l = l * fade + p.sum(-1)
        acc = acc * fade[..., None] + torch.einsum(
            "bqhgk,bkhd->bqhgd", p, v[:, c0:c0 + chunk].float())
        m = m_new
    return (acc / l[..., None]).reshape(B, Sq, H, D).to(q.dtype)


def gemma_oracle(params, cfg, toks, n: int, gold=None):
    """The plain path over one group: ``prefill`` then greedy ``decode_loop``
    (``gold`` None), or fed ``gold`` (B, n) to read its per-step logits.
    -> (tokens (B, n), logits (B, n, V) or None)."""
    B, S = toks.shape
    lg, cache = M.prefill(params, cfg, toks, max_len=S + n)
    if gold is None:
        return M.decode_loop(params, cfg, lg[:, -1].argmax(-1).int(), cache,
                             n)[0], None
    steps = [lg[:, -1]]
    for s in range(n - 1):
        lg, cache = M.decode_step(params, cfg, gold[:, s:s + 1].int(), cache)
        steps.append(lg[:, -1])
    return gold, torch.stack(steps, 1)


def gemma_hybrid(params, cfg, toks, plan, gold=None, marks=None):
    """The hybrid path over one group: ``hybrid_prefill`` then
    ``hybrid_decode_loop`` (``gold`` None; no host sync allowed inside the
    loop), or ``hybrid_decode_step`` fed ``gold`` (B, n) to read its
    per-step logits.  ``marks``: a list to append (time, launch counts,
    logits) to when the prefill has run.  -> (tokens (B, n), logits
    (B, n, V) or None)."""
    lg, cache = M.hybrid_prefill(params, cfg, toks, plan["kv_cap"],
                                 plan["act_cap"], plan["kv_keep"])
    if marks is not None:
        torch.cuda.synchronize()
        marks.append((time.perf_counter(), read_counts(), lg))
    sched = torch.from_numpy(np.ascontiguousarray(plan["sched"])).cuda()
    bounds = dict(pages_bound=plan["pages_bound"],
                  act_pages_bound=plan["act_pages_bound"])
    if gold is None:
        cur = lg[:, -1].argmax(-1).int()
        torch.cuda.set_sync_debug_mode("error")
        try:
            return M.hybrid_decode_loop(params, cfg, cur, cache, sched,
                                        **bounds)[0], None
        finally:
            torch.cuda.set_sync_debug_mode(0)
    steps = [lg[:, -1]]
    for s in range(gold.shape[1] - 1):
        lg, cache = M.hybrid_decode_step(params, cfg, gold[:, s:s + 1].int(),
                                         cache, sched[s], **bounds)
        steps.append(lg[:, -1])
    return gold, torch.stack(steps, 1)


_real_ring, _real_flash, _real_kv_gen = (M.ring_page_table,
                                         M.T.flash_attention, M.kv_gen)


def gemma_ring_one_slot_short(ctx, W):
    """A planted fault: the local layers' ring tables one live slot short
    (below W the new token's own slot, from W on the last slot)."""
    table, _, ntok = _real_ring(ctx, W)
    j = torch.arange(ntok.shape[1], device=ctx.device)[None]
    live = (ctx.long()[:, None] + 1).clamp(max=W) - 1
    ntok = (live - PAGE * j).clamp(0, PAGE).int()
    return table, torch.where(ntok > 0, 0, 2).int(), ntok


# the ring fault acts on the decode steps, which read the rings; past 32
# layers it is held to the limit of the steps after each group's rings wrap
# (the new token's position >= W: all of group 1's, group 2's from its 8th
# decode step), the larger of 0.25 and twice the plain path's own spread over
# those steps.  The step-0 logits come from the prefill, which reads no ring,
# and carry the largest spread (gemma3-27b: 0.375 against 0.266-0.353 over
# the decode steps, NVIDIA H100 80GB HBM3, 700 W), so the whole-run limit
# (0.75) sat 3.6% under the fault's 0.777; the wrapped steps' (0.705) sits
# 10% under it.  The sound path's wrapped steps are held to the same limit
RING_FAULT = "ring_page_ntok_one_slot_short"
# the gemma path's planted faults: (module, attribute, stand-in)
GEMMA_FAULTS = {
    "local_layers_without_window": (
        M.T, "flash_attention",
        lambda q, k, v, causal=True, window=0: _real_flash(q, k, v)),
    "ring_page_ntok_one_slot_short": (M, "ring_page_table",
                                      gemma_ring_one_slot_short),
    "kv_gen_without_knorm": (
        M, "kv_gen", lambda *a, knorm=None, **kw: _real_kv_gen(*a, **kw)),
}


def phase_serve_gemma(results, smi, name=GEMMA, groups_=GEMMA_GROUPS,
                      profile_groups=None):
    """gemma3-1b (or ``name``: gemma3-27b) at full width and depth (26
    layers: 4 periods of 5 local layers and a global one, 2 local tail
    layers; 27b: 62 layers, 10 periods and 2; bfloat16, random weights from
    seed 0) through ``hybrid_prefill`` -> ``hybrid_decode_loop``, two groups
    of ``groups_``, ``GEMMA_STEPS`` tokens each.  Checks the launches per
    prefill (flash: one per layer, the local layers' in the window mode)
    and per decode step (the second-pool mode per layer, counted again at
    head_dim 256, kv_gen with the K norm per global layer), no host sync in
    the decode loop, finite logits, and the tokens against the plain
    ``prefill`` + ``decode_loop`` under the bfloat16 rule (past 32 layers
    its limit the larger of 0.25 and twice the plain path's own spread,
    ``GEMMA_SPREAD_CHUNKS``); each planted fault
    must fail the logit limit.  The profile runs the groups
    ``profile_groups`` picks (all by default).  -> the launch counts of the
    path's run."""
    t_phase = time.perf_counter()
    cfg = get_config(name)
    period, n_per, tail = M._window_split(cfg)
    n_global, n_local = n_per, cfg.num_layers - n_per
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = M.init_params(cfg, seed=0, device="cuda")
    g = torch.Generator(device="cuda").manual_seed(0)
    for stack in (params["periods"]["local"], params["periods"]["global"],
                  params["tail"]):
        for key in ("qnorm", "knorm"):
            t = stack["attn"][key]
            t.copy_(torch.randn(t.shape, generator=g, device="cuda")
                    * GEMMA_QK_NORM_STD)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    n = GEMMA_STEPS
    rng = np.random.default_rng(0)
    groups = []
    for B, S in groups_:
        toks = torch.from_numpy(rng.integers(0, cfg.vocab_size, (B, S))
                                .astype(np.int32)).cuda()
        groups.append((toks, gemma_plan(B, S)))
    out = {"phase": "serve_gemma", "card": smi, "model": cfg.name,
           "layers": cfg.num_layers, "local_layers": n_local,
           "global_layers": n_global, "d_model": cfg.d_model,
           "heads": cfg.num_heads, "kv_heads": cfg.num_kv_heads,
           "head_dim": cfg.head_dim, "window": cfg.sliding_window,
           "vocab_padded": M.pad_vocab(cfg.vocab_size), "dtype": cfg.dtype,
           "params": sum(t.numel() for t in _leaves(params)), "init_s": init_s,
           "qk_norm_std": GEMMA_QK_NORM_STD,
           "groups": [{k: v for k, v in p.items() if k != "sched"}
                      for _, p in groups]}

    for toks, plan in groups:                            # warm-up
        gemma_hybrid(params, cfg, toks, plan)
    torch.cuda.synchronize()
    # the counted main-path run: counts start at 0, each stage's read apart
    reset_counts()
    hyb, stages, prev = [], [], read_counts()
    for toks, plan in groups:
        marks = []
        t0 = time.perf_counter()
        toks_out, _ = gemma_hybrid(params, cfg, toks, plan, marks=marks)
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        after = read_counts()
        (t1, after_prefill, lg), = marks
        if not (torch.isfinite(lg).all() and lg.shape == (
                plan["B"], 1, M.pad_vocab(cfg.vocab_size))):
            raise AssertionError(f"prefill logits {tuple(lg.shape)} not finite")
        hyb.append(toks_out.cpu().numpy())
        stages.append({
            "prefill_s": t1 - t0, "decode_s": t2 - t1,
            "decode_tokens_per_s": plan["B"] * n / (t2 - t1),
            "prefill_launches": {k: after_prefill[k] - prev[k] for k in prev},
            "decode_launches_per_step": {
                k: (after[k] - after_prefill[k]) / n for k in prev}})
        prev = after
    launches = read_counts()
    want_prefill = {k: 0 for k in COUNTERS}
    want_prefill.update(flash_attention=cfg.num_layers,
                        flash_attention_window=n_local)
    want_step = {k: 0 for k in COUNTERS}
    want_step.update(hybrid_paged_attention_two_pool=cfg.num_layers,
                     hybrid_paged_attention_two_pool_hd256=cfg.num_layers
                     if cfg.head_dim > 128 else 0,
                     kv_gen=n_global, kv_gen_qk_norm=n_global)
    for st in stages:
        if st["prefill_launches"] != want_prefill or \
                st["decode_launches_per_step"] != want_step:
            raise AssertionError(f"gemma launches {st}, expected "
                                 f"{want_prefill} / {want_step} a step")
    out.update(launches=launches, stages=stages, decode_loop_host_syncs=0,
               max_memory_allocated=torch.cuda.max_memory_allocated())

    # tokens against the plain path, under the bfloat16 rule (past 32 layers
    # its limit derived from the plain path's own spread, its prefill
    # attention in chunks of GEMMA_SPREAD_CHUNKS[0] keys), and the
    # teacher-forced logit gap; then the planted faults read the same gap
    plain = []
    spread = dict.fromkeys(GEMMA_SPREAD_CHUNKS, 0.0)
    spread_s = dict.fromkeys(GEMMA_SPREAD_CHUNKS, 0.0)
    # per group, per step (the max over its requests): the spreads
    spread_by_step = {c: [] for c in GEMMA_SPREAD_CHUNKS}
    for toks, plan in groups:
        gold, _ = gemma_oracle(params, cfg, toks, n)
        _, ora = gemma_oracle(params, cfg, toks, n, gold)
        plain.append((gold, ora))
        for chunk in GEMMA_SPREAD_CHUNKS:
            t0 = time.perf_counter()
            with patched(M.T, "flash_attention", functools.partial(
                    attention_in_chunks, chunk=chunk)):
                _, other = gemma_oracle(params, cfg, toks, n, gold)
            spread[chunk] = max(spread[chunk], (other - ora).abs().max().item())
            spread_by_step[chunk].append(
                (other - ora).abs().amax((0, 2)).tolist())
            spread_s[chunk] += time.perf_counter() - t0
    logit_tol = LOGIT_TOL_BY_DTYPE[cfg.dtype]
    if cfg.num_layers > 32:
        logit_tol = max(logit_tol, 2 * spread[GEMMA_SPREAD_CHUNKS[0]])
    out.update(plain_spread_dlogit=spread[GEMMA_SPREAD_CHUNKS[0]],
               plain_spread_dlogit_by_chunk=spread,
               plain_spread_dlogit_by_group_step=spread_by_step,
               logit_tol=logit_tol,
               spread_seconds=sum(spread_s.values()),
               spread_seconds_by_chunk=spread_s)
    rule = {"oracle": {}, "margin": {}, "logit_tol": logit_tol, "hybrid": {}}
    outs, rids, forced = {}, [], []
    for gi, ((toks, plan), got, (gold, ora)) in enumerate(zip(groups, hyb,
                                                             plain)):
        _, lg = gemma_hybrid(params, cfg, toks, plan, gold)
        forced.append((toks, plan, gold, ora))
        top2 = ora.topk(2, dim=-1).values
        margin = (top2[..., 0] - top2[..., 1]).cpu().numpy()
        gaps = (lg - ora).abs().amax(-1).cpu().numpy()
        gold_np = gold.cpu().numpy()
        for b in range(plan["B"]):
            rid = f"group{gi}/request{b}"
            rids.append(SimpleNamespace(rid=rid))
            rule["oracle"][rid], rule["margin"][rid] = gold_np[b], margin[b]
            rule["hybrid"][rid], outs[rid] = gaps[b], got[b]
    gap = max(float(g_.max()) for g_ in rule["hybrid"].values())
    out.update(min_oracle_margin=float(min(m.min() for m in rule["margin"]
                                           .values())),
               max_teacher_forced_dlogit=gap,
               dlogit_by_step=np.max(list(rule["hybrid"].values()), 0).tolist())
    if gap > logit_tol:
        emit(out)
        raise AssertionError(f"{name} hybrid teacher-forced logits differ by "
                             f"{gap} (limit {logit_tol})")
    out.update(exactness(rule, "hybrid", outs, rids))
    out["dlogit_by_group_step"] = [
        np.max([rule["hybrid"][f"group{gi}/request{b}"]
                for b in range(plan["B"])], 0).tolist()
        for gi, (_, plan) in enumerate(groups)]
    faults, faults_by_step = {}, {}
    for fault, (mod, attr, stand_in) in GEMMA_FAULTS.items():
        real = getattr(mod, attr)
        setattr(mod, attr, stand_in)
        try:
            per = [(gemma_hybrid(params, cfg, toks, plan, gold)[1] - ora)
                   .abs().amax((0, 2)).tolist()
                   for toks, plan, gold, ora in forced]
        finally:
            setattr(mod, attr, real)
        faults[fault] = max(max(g_) for g_ in per)
        faults_by_step[fault] = per
    out["fault_dlogit"] = faults
    out["fault_dlogit_by_group_step"] = faults_by_step
    # the steps after each group's rings wrap, their spread, limit and gaps
    wrapped = [[t for t in range(1, n) if S + t - 1 >= cfg.sliding_window]
               for _, S in groups_]
    post = lambda per: max(per[gi][t] for gi, ts in enumerate(wrapped)
                           for t in ts)
    wrap_spread = post(spread_by_step[GEMMA_SPREAD_CHUNKS[0]])
    wrap_tol = logit_tol if cfg.num_layers <= 32 else \
        max(LOGIT_TOL_BY_DTYPE[cfg.dtype], 2 * wrap_spread)
    wrap = {"steps": wrapped, "spread": wrap_spread, "logit_tol": wrap_tol,
            "gap": post(out["dlogit_by_group_step"]),
            "ring_fault": post(faults_by_step[RING_FAULT])}
    wrap["ring_fault_margin"] = wrap["ring_fault"] / wrap_tol - 1
    out["wrapped_steps"] = wrap
    held = {f: (v, logit_tol) for f, v in faults.items()}
    held[RING_FAULT] = (wrap["ring_fault"], wrap_tol)
    print(f"{name} per group and step: gap {out['dlogit_by_group_step']}, "
          f"spread {spread_by_step}, faults {faults_by_step}; the steps "
          f"after the rings wrap {wrapped}: spread {wrap_spread}, limit "
          f"{wrap_tol}, gap {wrap['gap']}, ring fault {wrap['ring_fault']} "
          f"(margin {wrap['ring_fault_margin']:.3f})", flush=True)
    if wrap["gap"] > wrap_tol:
        emit(out)
        raise AssertionError(f"{name} hybrid teacher-forced logits after the "
                             f"rings wrap differ by {wrap['gap']} (limit "
                             f"{wrap_tol})")
    print(f"{name}: launches per prefill {stages[0]['prefill_launches']}, per "
          f"step {stages[0]['decode_launches_per_step']}; prefill s "
          f"{[st['prefill_s'] for st in stages]}, decode tokens/s "
          f"{[st['decode_tokens_per_s'] for st in stages]}; teacher-forced "
          f"gap {gap} (limit {logit_tol}; spread by chunk {spread}), faults "
          f"{faults}; peak "
          f"{out['max_memory_allocated'] / 1e9:.2f} GB ({smi})", flush=True)
    if not all(v > tol for v, tol in held.values()):
        emit(out)
        raise AssertionError(f"the logit limit passes a planted fault: "
                             f"{held} (reading, limit)")
    picked = groups if profile_groups is None else \
        [groups[i] for i in profile_groups]
    runs = {"hybrid": lambda: [gemma_hybrid(params, cfg, toks, plan)
                               for toks, plan in picked]}
    phase_profile(results, smi, name, None, None, runs)
    out["seconds"] = time.perf_counter() - t_phase        # profile included
    emit(out)
    results[f"serve {name}"] = out
    return launches


def mamba_run(params, cfg, toks, n: int, gold=None, marks=None):
    """The mamba2 path over one group: ``prefill`` then greedy
    ``decode_loop`` (``gold`` None; no host sync allowed inside the loop), or
    ``decode_step`` fed ``gold`` (B, n) to read its per-step logits.
    ``marks``: a list to append (time, launch counts, logits) to when the
    prefill has run.  -> (tokens (B, n), logits (B, n, V) or None)."""
    B, S = toks.shape
    lg, cache = M.prefill(params, cfg, toks, max_len=S + n)
    if marks is not None:
        torch.cuda.synchronize()
        marks.append((time.perf_counter(), read_counts(), lg))
    if gold is None:
        cur = lg[:, -1].argmax(-1).int()
        torch.cuda.set_sync_debug_mode("error")
        try:
            return M.decode_loop(params, cfg, cur, cache, n)[0], None
        finally:
            torch.cuda.set_sync_debug_mode(0)
    steps = [lg[:, -1]]
    for s in range(n - 1):
        lg, cache = M.decode_step(params, cfg, gold[:, s:s + 1].int(), cache)
        steps.append(lg[:, -1])
    return gold, torch.stack(steps, 1)


_real_ssd_scan, _real_conv, _real_prefill = (L.ssd_scan, L.causal_conv1d,
                                             M.prefill)


def conv_one_step_late(x, w, cache=None):
    """A planted fault: decode's conv reads its cache one token late (each
    cache row takes the row before it, the newest prior token dropped)."""
    if cache is not None:
        cache = torch.cat([cache[:, :1], cache[:, :-1]], 1)
    return _real_conv(x, w, cache)


def prefill_zero_state(params, cfg, toks, max_len):
    """A planted fault: decode starts from a zero SSD state, not the
    prefill's."""
    lg, cache = _real_prefill(params, cfg, toks, max_len)
    cache["state"].zero_()
    return lg, cache


# the mamba2 path's planted faults: (module, attribute, stand-in)
MAMBA_FAULTS = {
    "ssd_state_not_carried_across_chunks": (L, "ssd_scan", ssd_chunks),
    "conv_cache_one_step_late": (L, "causal_conv1d", conv_one_step_late),
    "decode_from_zero_state": (M, "prefill", prefill_zero_state),
}


def phase_serve_mamba2(results, smi):
    """mamba2-2.7b at full width and depth (64 SSD layers, bfloat16, random
    weights from seed 0) through ``prefill`` -> ``decode_loop``, two groups
    of ``MAMBA_GROUPS``, ``MAMBA_STEPS`` tokens each.  Checks the launches
    (ssd_scan once per layer and prefill, nothing in decode), no host sync
    in the decode loop, finite logits, and the tokens against the plain path
    (the same functions with the layers' ``ssd_scan`` swapped for its plain
    version) under the bfloat16 rule, its limit the larger of 0.25 and twice
    the plain path's own spread (``MAMBA_SPREAD_CHUNK``); each planted fault
    must fail the limit.  -> the launch counts of the path's run."""
    cfg = get_config(MAMBA)
    t_phase = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    params = M.init_params(cfg, seed=0, device="cuda")
    draw_dt_biases(params)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t_phase
    n = MAMBA_STEPS
    rng = np.random.default_rng(0)
    groups = [torch.from_numpy(rng.integers(0, cfg.vocab_size, (B, S))
                               .astype(np.int32)).cuda()
              for B, S in MAMBA_GROUPS]
    V = M.pad_vocab(cfg.vocab_size)
    out = {"phase": "serve_mamba2", "card": smi, "model": cfg.name,
           "layers": cfg.num_layers, "d_model": cfg.d_model,
           "ssm_heads": cfg.ssm_num_heads, "ssm_head_dim": cfg.ssm_head_dim,
           "ssm_state": cfg.ssm_state_size, "conv_width": cfg.ssm_conv_width,
           "chunk": cfg.ssm_chunk, "vocab_padded": V, "dtype": cfg.dtype,
           "params": sum(t.numel() for t in _leaves(params)), "init_s": init_s,
           "dt_range": MAMBA_DT_RANGE,
           "groups": [list(g_) for g_ in MAMBA_GROUPS]}

    for toks in groups:                                  # warm-up
        mamba_run(params, cfg, toks, n)
    torch.cuda.synchronize()
    # the counted main-path run: counts start at 0, each stage's read apart
    reset_counts()
    outs_k, stages, prev = [], [], read_counts()
    for toks in groups:
        marks = []
        t0 = time.perf_counter()
        toks_out, _ = mamba_run(params, cfg, toks, n, marks=marks)
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        after = read_counts()
        (t1, after_prefill, lg), = marks
        if not (torch.isfinite(lg).all() and lg.shape == (toks.shape[0], 1, V)):
            raise AssertionError(f"prefill logits {tuple(lg.shape)} not finite")
        outs_k.append(toks_out.cpu().numpy())
        stages.append({
            "prefill_ms": (t1 - t0) * 1e3, "decode_s": t2 - t1,
            "decode_tokens_per_s": toks.shape[0] * n / (t2 - t1),
            "prefill_launches": {k: after_prefill[k] - prev[k] for k in prev},
            "decode_launches_per_step": {
                k: (after[k] - after_prefill[k]) / n for k in prev}})
        prev = after
    launches = read_counts()
    print(f"mamba2 prefill ms per group {MAMBA_GROUPS}: "
          f"{[st['prefill_ms'] for st in stages]}", flush=True)
    want_prefill = {k: 0 for k in COUNTERS}
    want_prefill["ssd_scan"] = cfg.num_layers
    want_step = {k: 0 for k in COUNTERS}
    for st in stages:
        if st["prefill_launches"] != want_prefill or \
                st["decode_launches_per_step"] != want_step:
            raise AssertionError(f"mamba2 launches {st}, expected "
                                 f"{want_prefill} / none a decode step")
    out.update(launches=launches, stages=stages, decode_loop_host_syncs=0,
               max_memory_allocated=torch.cuda.max_memory_allocated())

    # tokens against the plain path, under the bfloat16 rule with the limit
    # derived from the plain path's own spread (MAMBA_SPREAD_CHUNK), and the
    # teacher-forced logit gap; then the planted faults read the same gap
    L.ssd_scan = ssd_chunked_ref
    other = dataclasses.replace(cfg, ssm_chunk=MAMBA_SPREAD_CHUNK)
    try:
        plain, spread = [], 0.0
        for toks in groups:
            gold, _ = mamba_run(params, cfg, toks, n)
            ora = mamba_run(params, cfg, toks, n, gold)[1]
            plain.append((toks, gold, ora))
            spread = max(spread, (mamba_run(params, other, toks, n, gold)[1]
                                  - ora).abs().max().item())
    finally:
        L.ssd_scan = _real_ssd_scan
    logit_tol = max(LOGIT_TOL_BY_DTYPE[cfg.dtype], 2 * spread)
    out.update(plain_spread_dlogit=spread, logit_tol=logit_tol)
    rule = {"oracle": {}, "margin": {}, "logit_tol": logit_tol, "kernel": {}}
    outs, rids = {}, []
    for gi, ((toks, gold, ora), got) in enumerate(zip(plain, outs_k)):
        _, lg = mamba_run(params, cfg, toks, n, gold)
        top2 = ora.topk(2, dim=-1).values
        margin = (top2[..., 0] - top2[..., 1]).cpu().numpy()
        gaps = (lg - ora).abs().amax(-1).cpu().numpy()
        gold_np = gold.cpu().numpy()
        for b in range(toks.shape[0]):
            rid = f"group{gi}/request{b}"
            rids.append(SimpleNamespace(rid=rid))
            rule["oracle"][rid], rule["margin"][rid] = gold_np[b], margin[b]
            rule["kernel"][rid], outs[rid] = gaps[b], got[b]
    gap = max(float(g_.max()) for g_ in rule["kernel"].values())
    try:                    # every reading is emitted before a check fails
        out.update(exactness(rule, "kernel", outs, rids))
        diverged = None
    except AssertionError as e:
        diverged = e
    out.update(min_oracle_margin=float(min(m.min() for m in rule["margin"]
                                           .values())),
               max_teacher_forced_dlogit=gap,
               dlogit_by_step=np.max(list(rule["kernel"].values()), 0).tolist())
    faults = {}
    for name, (mod, attr, fault) in MAMBA_FAULTS.items():
        real = getattr(mod, attr)
        setattr(mod, attr, fault)
        try:
            faults[name] = max(
                (mamba_run(params, cfg, toks, n, gold)[1] - ora)
                .abs().max().item() for toks, gold, ora in plain)
        finally:
            setattr(mod, attr, real)
    out["fault_dlogit"] = faults
    # group 1 alone (group 2's profile was cut to keep the script's time)
    runs = {"serve": lambda: mamba_run(params, cfg, groups[0], n)}
    phase_profile(results, smi, MAMBA, None, None, runs)
    out["seconds"] = time.perf_counter() - t_phase        # profile included
    emit(out)
    results[f"serve {MAMBA}"] = out
    if diverged is not None:
        raise diverged
    if gap > logit_tol:
        raise AssertionError(f"mamba2 teacher-forced logits differ by {gap}")
    if not all(f > logit_tol for f in faults.values()):
        raise AssertionError(f"the logit limit {logit_tol} passes a planted "
                             f"fault: {faults}")
    return launches


# ---------------------------------------------------------------- jamba phase
def jamba_config():
    """jamba-1.5-large-398b at full width, cut to one period of
    ``JAMBA_CUT``."""
    return dataclasses.replace(get_config(JAMBA), **JAMBA_CUT)


class RouteReplay:
    """``L.moe_route`` wrapped to teacher-force the routing, as the tokens
    are: recording (``inner``, a ``MoeWatch`` or the real route, routes),
    it keeps each dispatch's experts in call order; after ``replay()`` the
    next dispatches take those experts, in the same order, in place of the
    router's top-k.  Their gates are the path's own probabilities at them,
    renormalised; the ranks, and so the drops, follow from the experts.
    Two paths fed the same tokens and the same experts differ by their
    arithmetic alone: no near-tie swap of experts moves their gap."""

    def __init__(self, inner=None):
        self.inner, self.idx, self.pos = inner, [], None

    def replay(self):
        self.pos = 0
        return self

    def __call__(self, router, x, **kw):
        if self.pos is None:
            r = (self.inner or REAL_MOE_ROUTE)(router, x, **kw)
            self.idx.append(r.idx)
            return r
        r = REAL_MOE_ROUTE(router, x, **kw)
        idx = self.idx[self.pos]
        self.pos += 1
        G, Tg, k = idx.shape
        sorted_e, order = torch.sort(idx.reshape(G, Tg * k), dim=1,
                                     stable=True)
        counts, starts, rank = L._group_ranks(sorted_e, kw["num_experts"])
        return r._replace(gate=L._renormalise(r.probs.gather(-1, idx)),
                          idx=idx, sorted_e=sorted_e, order=order,
                          counts=counts, starts=starts, rank=rank)


def jamba_forced(params, cfg, toks, n: int, gold, rids, watch=None,
                 route=None):
    """``mamba_run`` fed ``gold`` (B, n), ``route`` (or ``watch``)
    installed as ``L.moe_route``; with ``watch``, every MoE dispatch tagged
    for it: the prefill's rows (each its whole prompt; its drops counted),
    then each step's.  -> the per-step logits (B, n, V)."""
    B, S = toks.shape
    step = iter(range(1, n + 1))
    real_pre = M.prefill
    if watch is None:
        with patched(L, "moe_route", route):
            return mamba_run(params, cfg, toks, n, gold)[1]

    def pre(*a, **kw):
        watch.arm([S] * B, S, rids)
        return real_pre(*a, **kw)

    rows = lambda: (lambda j: [(rid, j, 1) for rid in rids])(next(step))
    with patched(L, "moe_route", route or watch), patched(M, "prefill", pre), \
            tagged_steps(watch, rows):
        return mamba_run(params, cfg, toks, n, gold)[1]


def prefill_states_swapped(params, cfg, toks, max_len):
    """A planted fault: the first two SSD slots' states swapped at the
    prefill -> decode handoff."""
    lg, cache = _real_prefill(params, cfg, toks, max_len)
    st = cache["state"]
    st[:, [0, 1]] = st[:, [1, 0]].clone()
    return lg, cache


def rope_in_the_nope_slot(cfg, positions):
    """A planted fault: the attention slot rotates q and k by RoPE at the
    config's theta, where jamba's attention has no positions."""
    return L.rope_sin_cos(positions, cfg.head_dim, cfg.rope_theta)


# the jamba path's planted faults: (module, attribute, stand-in)
JAMBA_FAULTS = {
    "ssd_states_swapped_at_handoff": (M, "prefill", prefill_states_swapped),
    "rope_in_the_nope_attention": (M.T, "_rope_for", rope_in_the_nope_slot),
}


def phase_serve_jamba(results, smi):
    """jamba-1.5-large-398b at full width, cut to one period of 4 layers
    (``JAMBA_CUT``; bfloat16, random weights from seed 0, the SSD layers'
    dt biases drawn as mamba2's), through ``prefill`` -> ``decode_loop``,
    mamba2's groups and steps.  Checks the launches (per prefill flash once
    for the attention slot, ``ssd_scan`` once per SSD slot; nothing in
    decode), no host sync in the decode loop (the MoE dispatch inside it),
    finite logits, and the tokens against the plain path (the same
    functions with ``ssd_scan`` and flash swapped for their plain versions),
    teacher-forced on its tokens, under the MoE rule with its own routing,
    and within the limit at every output with the plain path's experts
    replayed (``RouteReplay``): a 1000-token prefill swaps experts at some
    near-tie in every request, which leaves the rule nothing to hold.  The
    limit is the larger of 0.25 and twice the plain path's own spread
    (chunk ``MAMBA_SPREAD_CHUNK`` against the config's, experts replayed);
    each planted fault, experts replayed, must exceed it.  -> the launch
    counts of the path's run."""
    cfg, full = jamba_config(), get_config(JAMBA)
    t_phase = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    params = M.init_params(cfg, seed=0, device="cuda")
    draw_dt_biases(params)
    params["periods"]["attn"]["ln1"]["scale"].fill_(JAMBA_ATTN_LN_SCALE - 1)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t_phase
    slots = M.T.hybrid_slots(cfg)
    n_per = cfg.num_layers // cfg.attn_period
    n_ssd = sum(s_ != "attn" for s_, _, _ in slots)
    n = MAMBA_STEPS
    rng = np.random.default_rng(0)
    groups = [torch.from_numpy(rng.integers(0, cfg.vocab_size, (B, S))
                               .astype(np.int32)).cuda()
              for B, S in MAMBA_GROUPS]
    rids = [[f"group{gi}/request{b}" for b in range(t.shape[0])]
            for gi, t in enumerate(groups)]
    V = M.pad_vocab(cfg.vocab_size)
    param_bytes = sum(t.numel() * t.element_size() for t in _leaves(params))
    out = {"phase": "serve_jamba", "card": smi, "model": cfg.name,
           "layers": f"{cfg.num_layers} of {full.num_layers} (one period of "
                     f"attn_period {cfg.attn_period} for jamba's "
                     f"{full.attn_period}; full width)",
           "slots": [list(s_) for s_ in slots], "d_model": cfg.d_model,
           "heads": cfg.num_heads, "kv_heads": cfg.num_kv_heads,
           "ssm_heads": cfg.ssm_num_heads, "ssm_state": cfg.ssm_state_size,
           "experts": cfg.moe_num_experts, "top_k": cfg.moe_top_k,
           "capacity_factor": cfg.moe_capacity_factor, "d_ff": cfg.d_ff,
           "chunk": cfg.ssm_chunk, "vocab_padded": V, "dtype": cfg.dtype,
           "params": sum(t.numel() for t in _leaves(params)),
           "param_bytes": param_bytes, "init_s": init_s,
           "attn_ln1_scale": JAMBA_ATTN_LN_SCALE,
           "groups": [list(g_) for g_ in MAMBA_GROUPS]}
    print(f"jamba: {out['layers']}, {param_bytes / 1e9:.2f} GB of weights on "
          f"the card ({smi})", flush=True)

    for toks in groups:                                  # warm-up
        mamba_run(params, cfg, toks, n)
    torch.cuda.synchronize()
    # the counted main-path run: counts start at 0, each stage's read apart
    reset_counts()
    outs_k, stages, prev = {}, [], read_counts()
    for toks, rs in zip(groups, rids):
        marks = []
        t0 = time.perf_counter()
        toks_out, _ = mamba_run(params, cfg, toks, n, marks=marks)
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        after = read_counts()
        (t1, after_prefill, lg), = marks
        if not (torch.isfinite(lg).all() and lg.shape == (toks.shape[0], 1, V)):
            raise AssertionError(f"prefill logits {tuple(lg.shape)} not finite")
        outs_k.update(zip(rs, toks_out.cpu().numpy()))
        stages.append({
            "prefill_ms": (t1 - t0) * 1e3, "decode_ms_per_step":
            (t2 - t1) * 1e3 / n,
            "decode_tokens_per_s": toks.shape[0] * n / (t2 - t1),
            "prefill_launches": {k: after_prefill[k] - prev[k] for k in prev},
            "decode_launches_per_step": {
                k: (after[k] - after_prefill[k]) / n for k in prev}})
        prev = after
    launches = read_counts()
    want_prefill = {k: 0 for k in COUNTERS}
    want_prefill.update(flash_attention=n_per, ssd_scan=n_per * n_ssd)
    want_step = {k: 0 for k in COUNTERS}
    for st in stages:
        if st["prefill_launches"] != want_prefill or \
                st["decode_launches_per_step"] != want_step:
            raise AssertionError(f"jamba launches {st}, expected "
                                 f"{want_prefill} / none a decode step")
    out.update(launches=launches, stages=stages, decode_loop_host_syncs=0,
               max_memory_allocated=torch.cuda.max_memory_allocated())
    print(f"jamba prefill ms {[st['prefill_ms'] for st in stages]}, decode ms "
          f"a step {[st['decode_ms_per_step'] for st in stages]}; peak "
          f"{out['max_memory_allocated'] / 1e9:.2f} GB ({smi})", flush=True)

    # the plain path's greedy tokens and teacher-forced logits are the
    # reference, its experts recorded; its own spread at another chunk, fed
    # the same tokens and experts, sets the limit
    other = dataclasses.replace(cfg, ssm_chunk=MAMBA_SPREAD_CHUNK)
    ref_watch = MoeWatch()
    rec = RouteReplay(ref_watch)
    ref_toks, ref_lg, spread_lg, forced = {}, {}, {}, []
    with patched(L, "ssd_scan", ssd_chunked_ref), \
            patched(M.T, "flash_attention", flash_attention_ref):
        for toks, rs in zip(groups, rids):
            gold, _ = mamba_run(params, cfg, toks, n)
            forced.append((toks, rs, gold))
            lg = jamba_forced(params, cfg, toks, n, gold, rs, ref_watch, rec)
            for i, rid in enumerate(rs):
                ref_toks[rid], ref_lg[rid] = gold[i].cpu().numpy(), lg[i]
        rec.replay()
        for toks, rs, gold in forced:
            lg = jamba_forced(params, other, toks, n, gold, rs, route=rec)
            spread_lg.update((rid, lg[i]) for i, rid in enumerate(rs))
    reqs = [SimpleNamespace(rid=rid) for rs in rids for rid in rs]
    ref_routes = ref_watch.routes()
    gaps_of = lambda lgs: {r.rid: (lgs[r.rid] - ref_lg[r.rid]).abs().amax(-1)
                           .cpu().numpy() for r in reqs}
    top = lambda gaps: max(float(g_.max()) for g_ in gaps.values())
    spread = top(gaps_of(spread_lg))
    logit_tol = max(LOGIT_TOL_BY_DTYPE[cfg.dtype], 2 * spread)
    out.update(plain_spread_dlogit=spread, logit_tol=logit_tol,
               prefill_drops_plain=ref_watch.drops())

    def kernel_forced(watch=None, route=None):
        lgs = {}
        for toks, rs, gold in forced:
            lg = jamba_forced(params, cfg, toks, n, gold, rs, watch, route)
            lgs.update((rid, lg[i]) for i, rid in enumerate(rs))
        return gaps_of(lgs)

    # the kernel path teacher-forced on the plain path's tokens: its own
    # routing under the MoE rule, and the plain path's experts replayed
    k_watch = MoeWatch()
    gaps = kernel_forced(watch=k_watch)
    rule = moe_rule(reqs, outs_k, gaps, ref_toks, ref_lg, ref_routes,
                    k_watch.routes(), logit_tol)
    r_gaps = kernel_forced(route=rec.replay())
    gap = top(r_gaps)
    out.update(kernel_vs_plain=rule, max_teacher_forced_dlogit=gap,
               max_teacher_forced_dlogit_own_routes=top(gaps),
               prefill_drops_kernel=k_watch.drops(),
               dlogit_by_step=np.max(list(r_gaps.values()), 0).tolist())
    faults = {}
    for fault, (mod, attr, stand_in) in JAMBA_FAULTS.items():
        with patched(mod, attr, stand_in):
            faults[fault] = top(kernel_forced(route=rec.replay()))
    out["fault_dlogit"] = faults
    print(f"jamba kernel vs plain, the plain path's experts replayed: gap "
          f"{gap}, limit {logit_tol} (spread {spread}); own routes: MoE rule "
          f"ok {rule['ok']}, first swaps "
          f"{ {k: v['first_swap_output'] for k, v in rule['requests'].items()} }, "
          f"exact requests {rule['exact_requests']} of {len(reqs)}; prefill "
          f"drops {k_watch.drops()}; faults {faults} ({smi})", flush=True)
    runs = {"serve": lambda: [mamba_run(params, cfg, toks, n)
                              for toks in groups]}
    phase_profile(results, smi, JAMBA, None, None, runs)
    out["seconds"] = time.perf_counter() - t_phase        # profile included
    emit(out)
    results[f"serve {JAMBA}"] = out
    if not rule["ok"]:
        raise AssertionError(f"jamba: the kernel path breaks the MoE rule "
                             f"against the plain path: {rule}")
    if gap > logit_tol:
        raise AssertionError(f"jamba teacher-forced logits differ by {gap}")
    if not all(f > logit_tol for f in faults.values()):
        raise AssertionError(f"the logit limit {logit_tol} passes a planted "
                             f"fault: {faults}")
    return launches


# ------------------------------------------------------------ frontends phase
def frontend_run(params, cfg, toks, n: int, gold=None, marks=None, **inputs):
    """The plain path over one group: ``prefill`` (its frontend ``inputs``:
    whisper's frames and cross mode, qwen2-vl's patches) then greedy
    ``decode_loop`` (``gold`` None), or ``decode_step`` fed ``gold`` (B, n)
    to read its per-step logits.  ``marks``: a list to append (time, launch
    counts, logits, the cache's cross bytes) to when the prefill has run.
    -> (tokens (B, n), logits (B, n, V) or None)."""
    B, S = toks.shape
    if "patches" in inputs:                      # the cache holds them too
        S += inputs["patches"].shape[1]
    lg, cache = M.prefill(params, cfg, toks, S + n, **inputs)
    if marks is not None:
        torch.cuda.synchronize()
        cross = sum(cache[k].numel() * cache[k].element_size()
                    for k in ("cross_k", "cross_v", "enc_act") if k in cache)
        marks.append((time.perf_counter(), read_counts(), lg, cross))
    if gold is None:
        return M.decode_loop(params, cfg, lg[:, -1].argmax(-1).int(), cache,
                             n)[0], None
    steps = [lg[:, -1]]
    for s in range(n - 1):
        lg, cache = M.decode_step(params, cfg, gold[:, s:s + 1].int(), cache)
        steps.append(lg[:, -1])
    return gold, torch.stack(steps, 1)


def counted_runs(params, cfg, toks, n, modes, want_prefill, want_step):
    """Each mode of ``modes`` ({name: prefill inputs}) once, its launch
    counts set to 0 just before and read just after, and held to the
    expected counts per prefill and per decode step.  -> ({mode: tokens},
    {mode: counts}, {mode: stage readings})."""
    toks_out, counts, stages = {}, {}, {}
    for mode, inputs in modes.items():
        reset_counts()
        marks = []
        t0 = time.perf_counter()
        out, _ = frontend_run(params, cfg, toks, n, marks=marks, **inputs)
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        counts[mode] = read_counts()
        (t1, after_prefill, lg, cross), = marks
        V = M.pad_vocab(cfg.vocab_size)
        if not (torch.isfinite(lg).all() and lg.shape == (toks.shape[0], 1, V)):
            raise AssertionError(f"{cfg.name} {mode}: prefill logits "
                                 f"{tuple(lg.shape)} not finite")
        st = {"prefill_ms": (t1 - t0) * 1e3, "decode_s": t2 - t1,
              "decode_tokens_per_s": toks.shape[0] * n / (t2 - t1),
              "cross_cache_bytes": cross,
              "prefill_launches": after_prefill,
              "decode_launches_per_step": {
                  k: (counts[mode][k] - after_prefill[k]) / n for k in COUNTERS}}
        stages[mode] = st
        toks_out[mode] = out
        if st["prefill_launches"] != want_prefill(mode) or \
                st["decode_launches_per_step"] != want_step(mode):
            raise AssertionError(f"{cfg.name} {mode} launches {st}, expected "
                                 f"{want_prefill(mode)} / {want_step(mode)}")
    return toks_out, counts, stages


def held_to(gold, ora, logits, outs, logit_tol) -> dict:
    """The fp rule: ``outs`` (B, n) tokens of a path whose teacher-forced
    ``logits`` (fed ``gold``) are held to the reference's ``ora``; a request
    may leave ``gold`` only where the reference's top-2 margin is within
    the limit and within twice the path's gap there.  -> readings."""
    top2 = ora.topk(2, dim=-1).values
    margin = (top2[..., 0] - top2[..., 1]).cpu().numpy()
    gaps = (logits - ora).abs().amax(-1).cpu().numpy()
    gold_np, outs = gold.cpu().numpy(), outs.cpu().numpy()
    rule = {"oracle": {}, "margin": {}, "logit_tol": logit_tol, "path": {}}
    rids, got = [], {}
    for b in range(gold_np.shape[0]):
        rid = f"request{b}"
        rids.append(SimpleNamespace(rid=rid))
        rule["oracle"][rid], rule["margin"][rid] = gold_np[b], margin[b]
        rule["path"][rid], got[rid] = gaps[b], outs[b]
    gap = float(gaps.max())
    if gap > logit_tol:
        raise AssertionError(f"teacher-forced logits differ by {gap}")
    return dict(exactness(rule, "path", got, rids),
                max_teacher_forced_dlogit=gap,
                dlogit_by_step=gaps.max(0).tolist(),
                min_oracle_margin=float(margin.min()))


_real_cross_act = M._cross_act_attend


def cross_k_of_the_next_layer(params, n_layers: int):
    """A planted fault: each decoder layer's cross K recomputed with the
    next layer's ``xattn.wk`` (the layers are called in order)."""
    calls = [0]

    def fault(lp, cfg, q, *args):
        i = calls[0] % n_layers
        calls[0] += 1
        wk = M.T.layer_params(params, (i + 1) % n_layers)["xattn"]["wk"]
        return _real_cross_act(dict(lp, xattn=dict(lp["xattn"], wk=wk)), cfg,
                               q, *args)
    return fault


def serve_whisper(smi) -> tuple:
    """whisper-base at full width and depth (6 encoder and 6 decoder
    layers, bfloat16, random weights from seed 0, F = 1500 random frames)
    through ``prefill`` -> ``decode_loop`` in both cross modes.  Checks the
    launches (per prefill 18 flash, 12 of them non-causal; per cross-ACT
    decode step one fused launch a layer, none in cross-KV), the cross
    cache's bytes (cross-ACT at least ``MIN_CROSS_RATIO`` times fewer), and
    the cross-ACT tokens against the cross-KV oracle under the bfloat16
    rule; the planted fault (``cross_k_of_the_next_layer``) must break the
    limit.  -> (readings, {mode: launch counts})."""
    cfg = get_config(WHISPER)
    t0 = time.perf_counter()
    params = M.init_params(cfg, seed=0, device="cuda")
    params["layers"]["ln_x"]["scale"].fill_(WHISPER_LN_X_SCALE)
    B, S = FRONTEND_GROUP
    n = FRONTEND_STEPS
    rng = np.random.default_rng(0)
    toks = torch.from_numpy(rng.integers(0, cfg.vocab_size, (B, S))
                            .astype(np.int32)).cuda()
    frames = torch.randn((B, cfg.enc_seq_len, cfg.d_model), device="cuda",
                         generator=torch.Generator(device="cuda").manual_seed(0)
                         ).to(M.torch_dtype(cfg))
    modes = {"cross_kv": dict(frames=frames, cross_act=False),
             "cross_act": dict(frames=frames, cross_act=True)}
    for inputs in modes.values():                                # warm-up
        frontend_run(params, cfg, toks, n, **inputs)
    torch.cuda.synchronize()
    Le, Ld = cfg.enc_num_layers, cfg.num_layers

    def want_prefill(mode):
        want = {k: 0 for k in COUNTERS}
        want["flash_attention"] = Le + 2 * Ld
        want["flash_attention_noncausal"] = Le + Ld
        return want

    def want_step(mode):
        want = {k: 0 for k in COUNTERS}
        if mode == "cross_act":
            want["hybrid_paged_attention"] = Ld
        return want

    outs, counts, stages = counted_runs(params, cfg, toks, n, modes,
                                        want_prefill, want_step)
    kv_bytes = stages["cross_kv"]["cross_cache_bytes"]
    act_bytes = stages["cross_act"]["cross_cache_bytes"]
    out = {"model": cfg.name, "layers": [Le, Ld], "d_model": cfg.d_model,
           "frames": cfg.enc_seq_len, "checkpoint_rows": M.enc_act_len(cfg),
           "dtype": cfg.dtype, "group": [B, S], "steps": n,
           "init_and_warmup_s": time.perf_counter() - t0, "stages": stages,
           "cross_cache_bytes": {"cross_kv": kv_bytes, "cross_act": act_bytes},
           "cross_cache_ratio": kv_bytes / act_bytes}
    # cross-ACT's tokens held to the cross-KV oracle, both fed its tokens
    logit_tol = LOGIT_TOL_BY_DTYPE[cfg.dtype]
    gold = outs["cross_kv"]
    ora = frontend_run(params, cfg, toks, n, gold, **modes["cross_kv"])[1]
    hyb = frontend_run(params, cfg, toks, n, gold, **modes["cross_act"])[1]
    errors = []
    try:
        out["cross_act_vs_cross_kv"] = held_to(gold, ora, hyb,
                                               outs["cross_act"], logit_tol)
    except AssertionError as e:
        errors.append(f"whisper cross-ACT: {e}")
    M._cross_act_attend = cross_k_of_the_next_layer(params, Ld)
    try:
        fault = frontend_run(params, cfg, toks, n, gold, **modes["cross_act"])[1]
    finally:
        M._cross_act_attend = _real_cross_act
    out["fault_dlogit"] = {"cross_k_of_the_next_layer":
                           (fault - ora).abs().max().item()}
    out["logit_tol"] = logit_tol
    if out["cross_cache_ratio"] < MIN_CROSS_RATIO:
        errors.append(f"cross cache only {out['cross_cache_ratio']}x smaller")
    if not out["fault_dlogit"]["cross_k_of_the_next_layer"] > logit_tol:
        errors.append(f"the logit limit {logit_tol} passes a planted fault: "
                      f"{out['fault_dlogit']}")
    out["errors"] = errors
    print(f"whisper prefill ms {[st['prefill_ms'] for st in stages.values()]}, "
          f"decode tokens/s "
          f"{[st['decode_tokens_per_s'] for st in stages.values()]}, cross "
          f"cache {kv_bytes} -> {act_bytes} bytes "
          f"({out['cross_cache_ratio']}x), gap "
          f"{out.get('cross_act_vs_cross_kv', {}).get('max_teacher_forced_dlogit')}"
          f", fault {out['fault_dlogit']}", flush=True)
    return out, counts


def serve_qwen(smi) -> tuple:
    """qwen2-vl-2b at full width and depth (28 layers, G = 6, head_dim 128,
    M-RoPE; bfloat16, random weights from seed 0) through ``prefill`` ->
    ``decode_loop``: 256 random patch embeddings before each 48-token
    prompt.  Checks the launches (28 causal flash per prefill, none per
    decode step) and the tokens against the same path with the flash
    kernel swapped for its plain version, under the bfloat16 rule.
    -> (readings, {"fp": launch counts})."""
    cfg = get_config(QWEN)
    t0 = time.perf_counter()
    params = M.init_params(cfg, seed=0, device="cuda")
    B, S = FRONTEND_GROUP
    n = FRONTEND_STEPS
    rng = np.random.default_rng(1)
    toks = torch.from_numpy(rng.integers(0, cfg.vocab_size, (B, S))
                            .astype(np.int32)).cuda()
    patches = torch.randn((B, cfg.frontend_tokens, cfg.d_model), device="cuda",
                          generator=torch.Generator(device="cuda").manual_seed(1)
                          ).to(M.torch_dtype(cfg))
    modes = {"fp": dict(patches=patches)}
    frontend_run(params, cfg, toks, n, patches=patches)          # warm-up
    torch.cuda.synchronize()

    def want_prefill(mode):
        want = {k: 0 for k in COUNTERS}
        want["flash_attention"] = cfg.num_layers
        return want

    outs, counts, stages = counted_runs(params, cfg, toks, n, modes,
                                        want_prefill,
                                        lambda mode: {k: 0 for k in COUNTERS})
    out = {"model": cfg.name, "layers": cfg.num_layers, "d_model": cfg.d_model,
           "heads": [cfg.num_heads, cfg.num_kv_heads], "head_dim": cfg.head_dim,
           "patches": cfg.frontend_tokens, "dtype": cfg.dtype, "group": [B, S],
           "steps": n, "init_and_warmup_s": time.perf_counter() - t0,
           "stages": stages}
    logit_tol = LOGIT_TOL_BY_DTYPE[cfg.dtype]
    M.T.flash_attention = lambda q, k, v, causal=True, window=0: \
        flash_attention_ref(q, k, v, window, causal)
    try:
        gold, _ = frontend_run(params, cfg, toks, n, patches=patches)
        ora = frontend_run(params, cfg, toks, n, gold, patches=patches)[1]
    finally:
        M.T.flash_attention = flash_attention
    got = frontend_run(params, cfg, toks, n, gold, patches=patches)[1]
    out["logit_tol"], errors = logit_tol, []
    try:
        out["kernel_vs_plain"] = held_to(gold, ora, got, outs["fp"], logit_tol)
    except AssertionError as e:
        errors.append(f"qwen2-vl: {e}")
    out["errors"] = errors
    print(f"qwen2-vl prefill ms {stages['fp']['prefill_ms']}, decode tokens/s "
          f"{stages['fp']['decode_tokens_per_s']}, gap "
          f"{out.get('kernel_vs_plain', {}).get('max_teacher_forced_dlogit')}",
          flush=True)
    return out, counts


def phase_serve_frontends(results, smi) -> dict:
    """whisper-base (``serve_whisper``), then qwen2-vl-2b (``serve_qwen``),
    each model's weights freed before the next.  -> {model: {mode: launch
    counts}}."""
    t_phase = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    out = {"phase": "serve_frontends", "card": smi}
    launches = {}
    out["whisper"], launches[WHISPER] = serve_whisper(smi)
    gc.collect()
    torch.cuda.empty_cache()
    out["qwen"], launches[QWEN] = serve_qwen(smi)
    gc.collect()
    torch.cuda.empty_cache()
    out["max_memory_allocated"] = torch.cuda.max_memory_allocated()
    out["seconds"] = time.perf_counter() - t_phase
    emit(out)
    results["serve frontends"] = out
    errors = out["whisper"]["errors"] + out["qwen"]["errors"]
    if errors:
        raise AssertionError(f"frontends phase: {errors}")
    return launches


# ----------------------------------------------------------------- moe phase
# the MoE models at full width, their depth cut to what one card holds
# (bfloat16: a dbrx layer is 6.52 GB, 4 of its 40 layers 27.3 GB with the
# embeddings; a grok layer 9.84 GB, 2 of its 64 layers 21.3 GB)
MOE_LAYERS = {"dbrx-132b": 4, "grok-1-314b": 2}
MOE_FAULTS = ("pairs_not_returned_to_token_order", "gates_not_renormalised")
# TRACE's requests with shorter prompts (29-42 tokens, buckets of <= 48):
# a group of four prefills <= 192 tokens, 32 dispatch groups of <= 6, so no
# expert gets more than 6 pairs of a group against C = 8 and no pair can
# drop, as none can in the oracle's one-request prefills.  On TRACE itself
# (4 x 80) every request's context dropped pairs on the card (the random
# weights route a sequence's tokens alike), leaving the oracle nothing to
# be held to there
MOE_DROP_FREE_TRACE = dict(TRACE, prompt_mean=40)
# The MoE token rule.  The router is a discontinuous function: where a
# token's k-th and (k+1)-th router logits nearly tie, the rounding that
# separates two sound paths (recomputed K/V against stored K/V, one batch
# shape against another) can swap the two experts, and the logits move by
# up to ~1.2 from there on (measured on dbrx, NVIDIA H100 80GB HBM3, 700 W:
# hybrid against kv mode swapped one token at a router probability margin
# of 0.0047, and the logits moved 0.79 after it).  So the fp rule holds
# each request's logits within the limit at every output before its first
# dispatch that routes a token otherwise, and that first swap must be a
# near-tie: the reference's
# router logits of the expert it kept and of the one the path took instead
# within the same limit of each other (router logits are unit-scale, as
# the output's are: a normed row against a d**-0.5 router).  A token may
# leave the reference's from that output on; before it, as the fp rule
# says.  A wrong path swaps experts at wide margins, or moves the logits
# before any swap.


def moe_config(name):
    return dataclasses.replace(get_config(name), num_layers=MOE_LAYERS[name])


REAL_MOE_ROUTE = L.moe_route


class MoeWatch:
    """``L.moe_route`` wrapped (install with ``patched``).  While ``tags``
    is set (per row of the next dispatches: (rid, output j, its tokens), or
    None), each dispatch's experts and router log-probabilities are kept per
    request and output, on the device, read afterwards.  ``arm(lens, S,
    rids)`` counts the pairs the next prefill's dispatches drop, per row in
    its real context (positions before the row's prefill length, which
    decode attends to and the oracle holds) and in its padding."""

    def __init__(self):
        self.calls, self.tags, self.mask, self.rows = [], None, None, []

    def arm(self, lens, S: int, rids):
        lens = torch.as_tensor(np.asarray(lens), device="cuda")
        self.mask = torch.arange(S, device="cuda")[None] < lens[:, None]
        self.rows.append({"rids": list(rids), "real": torch.zeros(
            len(lens), dtype=torch.int64, device="cuda"), "pad": 0})
        self.tags = [(rid, 0, int(n)) for rid, n in zip(rids, lens.tolist())]

    def __call__(self, router, x, **kw):
        r = REAL_MOE_ROUTE(router, x, **kw)
        T, k = x.shape[0], kw["top_k"]
        if self.tags is not None:
            self.calls.append((self.tags, r.idx.reshape(T, k),
                               r.probs.reshape(T, -1).log()))
        if self.mask is not None and T == self.mask.numel():
            d = L.moe_dropped(r, k).view(self.mask.shape)
            rec = self.rows[-1]
            rec["real"] += (d * self.mask).sum(1)
            rec["pad"] = rec["pad"] + (d * ~self.mask).sum()
        return r

    def drops(self) -> list:
        """Per armed prefill: {"rids", "real" per row, "pad"} as ints."""
        return [{"rids": r["rids"], "real": r["real"].tolist(),
                 "pad": int(r["pad"])} for r in self.rows]

    def routes(self) -> dict:
        """{(rid, output j): [(experts, log-probs) of its tokens, one per
        dispatch in layer order]}."""
        out = {}
        for tags, idx, logp in self.calls:
            per = idx.shape[0] // len(tags)
            for b, tag in enumerate(tags):
                if tag is not None:
                    rid, j, n = tag
                    sl = slice(b * per, b * per + n)
                    out.setdefault((rid, j), []).append((idx[sl], logp[sl]))
        return out


def first_swap(ref: dict, path: dict, rid, n_out: int):
    """The first output of request ``rid`` whose dispatches route a token
    otherwise than the reference's, the tokens swapped in that dispatch
    and the widest reference margin among them (the log-probability of an
    expert the reference kept and the path left, over one the path took
    instead).  -> (output or None, margin, tokens)."""
    for j in range(n_out):
        a, b = ref.get((rid, j), []), path.get((rid, j), [])
        if len(a) != len(b):
            raise AssertionError(f"request {rid} output {j}: {len(a)} "
                                 f"dispatches against {len(b)}")
        for (ri, rl), (pi, _) in zip(a, b):
            rm = torch.zeros_like(rl, dtype=torch.bool).scatter_(1, ri, True)
            pm = torch.zeros_like(rl, dtype=torch.bool).scatter_(1, pi, True)
            diff = (rm != pm).any(1)
            if bool(diff.any()):
                kept = rl.masked_fill(~(rm & ~pm), -math.inf).amax(1)
                taken = rl.masked_fill(~(pm & ~rm), math.inf).amin(1)
                return j, float((kept - taken)[diff].max()), int(diff.sum())
    return None, 0.0, 0


def moe_rule(reqs, toks, gaps, ref_toks, ref_lg, ref_routes, path_routes,
             logit_tol) -> dict:
    """The MoE token rule (above) for each of ``reqs``: ``toks`` the path's
    greedy tokens, ``gaps`` its teacher-forced per-output gaps to the
    reference's logits ``ref_lg``, whose greedy tokens are ``ref_toks``;
    both runs' dispatches as ``MoeWatch.routes`` gives them.  -> {"ok",
    "requests": per request the first swap, the held outputs' largest gap,
    the largest after the swap, where the tokens leave the reference's}."""
    per, ok = {}, True
    for r in reqs:
        g = np.asarray(gaps[r.rid])
        j0, margin, n_sw = first_swap(ref_routes, path_routes, r.rid, len(g))
        held = g[:j0] if j0 is not None else g
        top2 = ref_lg[r.rid].topk(2, dim=-1).values
        m = (top2[:, 0] - top2[:, 1]).float().cpu().numpy()
        diff = np.flatnonzero(np.asarray(toks[r.rid]) != ref_toks[r.rid])
        p = int(diff[0]) if diff.size else None
        tok_ok = p is None or (j0 is not None and p >= j0) or \
            (m[p] <= logit_tol and m[p] <= 2 * g[p])
        rec = {"first_swap_output": j0, "swap_margin": margin,
               "tokens_swapped": n_sw, "held_outputs": int(held.size),
               "max_held_dlogit": float(held.max(initial=0.0)),
               "max_dlogit_after_swap": float(g[j0:].max())
               if j0 is not None else None,
               "leaves_reference_at": p,
               "reference_margin_there": float(m[p]) if p is not None else None}
        rec["ok"] = bool(rec["max_held_dlogit"] <= logit_tol and tok_ok
                         and (j0 is None or margin <= logit_tol))
        ok = ok and rec["ok"]
        per[r.rid] = rec
    return {"ok": ok, "logit_tol": logit_tol, "requests": per,
            "exact_requests": sum(p["leaves_reference_at"] is None
                                  for p in per.values())}


@contextlib.contextmanager
def tagged_steps(watch, rows):
    """``M.hybrid_decode_step`` and ``M.decode_step`` wrapped to tag each
    step's dispatches for ``watch``: ``rows()`` gives the step's
    per-row (rid, output j, 1) or None."""
    real_h, real_d = M.hybrid_decode_step, M.decode_step

    def wrap(real):
        def step(*a, **kw):
            watch.tags = rows()
            return real(*a, **kw)
        return step

    with patched(M, "hybrid_decode_step", wrap(real_h)), \
            patched(M, "decode_step", wrap(real_d)):
        yield
    watch.tags = None


def watched_forced(eng, params, cfg, group, gold, watch):
    """``forced_logits`` over ``group`` with every dispatch tagged for
    ``watch``: the prefill's rows (their context), then each step's."""
    rids = [r.rid for r in group]
    _, _, pbs, *_ = eng.group_schedule(group)
    step = iter(range(1, gold.shape[1] + 1))
    real_pre = M.hybrid_prefill_batched

    def pre(*a, **kw):
        watch.tags = [(rid, 0, int(n)) for rid, n in zip(rids, pbs)]
        return real_pre(*a, **kw)

    rows = lambda: (lambda j: [(rid, j, 1) for rid in rids])(next(step))
    with patched(L, "moe_route", watch), \
            patched(M, "hybrid_prefill_batched", pre), tagged_steps(watch, rows):
        return forced_logits(eng, params, cfg, group, gold)


def watched_oracle(params, cfg, r, gold, watch):
    """``oracle_logits`` of request ``r`` with its dispatches tagged."""
    step = iter(range(1, len(gold) + 1))
    real_pre = M.prefill

    def pre(p, c, toks, **kw):
        watch.tags = [(r.rid, 0, toks.shape[1])]
        return real_pre(p, c, toks, **kw)

    with patched(L, "moe_route", watch), patched(M, "prefill", pre), \
            tagged_steps(watch, lambda: [(r.rid, next(step), 1)]):
        return oracle_logits(params, cfg, r.prompt, gold)


def group_drops(eng, params, cfg, group) -> dict:
    """The pairs the engine's batched prefill of ``group`` drops, per row
    (real context) and in its padding, summed over the layers."""
    toks, kv_keep, pbs, *_ = eng.group_schedule(group)
    watch = MoeWatch()
    watch.arm(pbs, toks.shape[1], [r.rid for r in group])
    with patched(L, "moe_route", watch):
        M.hybrid_prefill_batched(params, cfg, torch.from_numpy(toks).cuda(),
                                 eng.kv_cap, eng.act_cap, kv_keep, pbs)
    return watch.drops()[0]


def oracle_rule(eng, params, cfg, reqs, hyb, logit_tol) -> dict:
    """The engine's hybrid tokens ``hyb`` over ``reqs`` against
    ``exact_reference_generate`` under the MoE rule, held for the requests
    whose group's batched prefill dropped no real token's pair; each
    group's drops and the agreement over all requests kept."""
    groups = eng.plan_groups(reqs)
    drops = [group_drops(eng, params, cfg, g) for g in groups]
    clean = {rid for d in drops for rid, n in zip(d["rids"], d["real"])
             if n == 0}
    oracle = exact_reference_generate(cfg, params, reqs)
    gold = {r.rid: torch.from_numpy(oracle[r.rid]).cuda() for r in reqs}
    o_watch, e_watch = MoeWatch(), MoeWatch()
    ora = {r.rid: watched_oracle(params, cfg, r, gold[r.rid], o_watch)
           for r in reqs}
    gaps = {}
    for g in groups:
        lg = watched_forced(eng, params, cfg, g,
                            torch.stack([gold[r.rid] for r in g]), e_watch)
        for i, r in enumerate(g):
            gaps[r.rid] = (lg[i] - ora[r.rid]).abs().amax(-1).cpu().numpy()
    held = [r for r in reqs if r.rid in clean]
    rule = moe_rule(held, hyb, gaps, oracle, ora, o_watch.routes(),
                    e_watch.routes(), logit_tol)
    rule.update(prefill_drops=drops, held_requests=[r.rid for r in held],
                dlogit_by_request={r.rid: float(gaps[r.rid].max())
                                   for r in reqs},
                agreement_all=agreement(hyb, oracle, reqs))
    return rule


def identity_order(order):
    """A planted fault: the pairs' outputs left in expert order (the inverse
    permutation back to token order skipped)."""
    return torch.arange(order.shape[1], device=order.device).expand_as(order)


class Admissions:
    """A server's admission batches: each batch's rids in row order, its
    tokens and prefill lengths, with ``watch`` armed for each (its drops
    counted per row, its dispatches tagged)."""

    def __init__(self, srv, watch):
        self.srv, self.watch, self.batches = srv, watch, []

    @contextlib.contextmanager
    def patch(self):
        real_batch, real_admit = self.srv._admit_batch, self.srv._admit
        rids = []

        def admit_batch(assignments, stats):
            rids[:] = [r.rid for _, r, _ in assignments]
            real_batch(assignments, stats)

        def admit(toks, kv_keep, lens, slot_idx):
            self.batches.append((list(rids), np.array(toks), np.array(lens)))
            self.watch.arm(lens, toks.shape[1], list(rids))
            return real_admit(toks, kv_keep, lens, slot_idx)

        self.srv._admit_batch, self.srv._admit = admit_batch, admit
        try:
            yield self
        finally:
            for key in ("_admit_batch", "_admit"):
                self.srv.__dict__.pop(key, None)


def admission_oracle(params, cfg, batches, reqs, watch):
    """The kv path of each admission batch: the same batched prefill (the
    same dispatch groups, so the same drops), every context token kept as
    K/V, then greedy decode with every new token K/V; each step's logits
    kept, and the dispatches tagged for ``watch``.  -> (tokens, logits)
    per rid."""
    n_new = {r.rid: r.max_new_tokens for r in reqs}
    tok_out, lg_out = {}, {}
    cap = SCHED_SERVER["kv_cap"]
    with patched(L, "moe_route", watch):
        for rids, toks, lens in batches:
            B, n = len(rids), max(n_new[r] for r in rids)
            watch.tags = [(rid, 0, int(k)) for rid, k in zip(rids, lens)]
            lg, cache = M.hybrid_prefill_batched(
                params, cfg, torch.from_numpy(toks).cuda(), cap, PAGE, lens,
                lens)
            store = torch.zeros(B, dtype=torch.bool, device="cuda")
            steps, cur = [], []
            for s in range(n):
                steps.append(lg[:, -1].float())
                cur.append(lg[:, -1].argmax(-1).int())
                if s < n - 1:
                    watch.tags = [(rid, s + 1, 1) for rid in rids]
                    lg, cache = M.hybrid_decode_step(
                        params, cfg, cur[-1][:, None], cache, store,
                        pages_bound=cap // PAGE, act_pages_bound=0,
                        any_act=False)
            lg_all, tok_all = torch.stack(steps, 1), torch.stack(cur, 1)
            for j, rid in enumerate(rids):
                lg_out[rid] = lg_all[j, :n_new[rid]]
                tok_out[rid] = tok_all[j, :n_new[rid]].cpu().numpy()
    watch.tags = None
    return tok_out, lg_out


def phase_serve_moe(results, smi) -> dict:
    """The MoE models at full width (dbrx-132b at 4 of its 40 layers,
    grok-1-314b at 2 of 64; random weights from seed 0) through the engine,
    device-resident, in hybrid and kv modes on ``TRACE``: launches per
    prefill and decode step, no host sync in the decode loop (the dispatch
    inside it), no leaks.  Tokens under the MoE rule (above): hybrid against
    kv mode of the same engine and group (the kv path's own greedy tokens
    and teacher-forced logits as the reference), and against
    ``exact_reference_generate`` for the requests whose group's batched
    prefill dropped no real token's pair (the oracle prefills one request at
    a time, in groups too small to drop); each prefill's drops, real and
    pad, are printed, and so is the agreement of the rest.  Two planted
    faults (the inverse permutation skipped, the gates not renormalised)
    must break the limit and the rule on dbrx.  dbrx also serves through
    the continuous-batching server at S = 8 on the first four requests of
    the scheduler trace (held under the rule to the kv path of its own
    admission batches, which drop what its admissions drop; the plain
    oracle's agreement printed) and with its layers streamed from pinned
    host memory at depth 1 (tokens equal to the device-resident run's).
    -> {model: launches of its counted hybrid run}."""
    launches = {}
    for name in MOE_LAYERS:
        launches[name] = serve_moe(results, smi, name)
        gc.collect()
        torch.cuda.empty_cache()
    return launches


def serve_moe(results, smi, name) -> dict:
    cfg = moe_config(name)
    logit_tol = LOGIT_TOL_BY_DTYPE[cfg.dtype]
    t_phase = time.perf_counter()
    stage_s = {}

    def stage(label, t0):
        stage_s[label] = time.perf_counter() - t0
        return time.perf_counter()

    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = M.init_params(cfg, seed=0, device="cuda")
    torch.cuda.synchronize()
    t0 = stage("init", t0)
    reqs = request_trace(cfg.vocab_size, **TRACE)
    full = get_config(name)
    out = {"phase": "moe", "card": smi, "model": name,
           "layers": f"{cfg.num_layers} of {full.num_layers} (depth cut to "
                     "one card; full width)",
           "d_model": cfg.d_model, "d_ff": cfg.d_ff,
           "experts": cfg.moe_num_experts, "top_k": cfg.moe_top_k,
           "capacity_factor": cfg.moe_capacity_factor,
           "ffn_type": cfg.ffn_type, "norm_type": cfg.norm_type,
           "heads": cfg.num_heads, "kv_heads": cfg.num_kv_heads,
           "params": sum(t.numel() for t in _leaves(params)),
           "param_bytes": sum(t.numel() * t.element_size()
                              for t in _leaves(params)),
           "prompt_lens": [len(r.prompt) for r in reqs]}
    print(f"moe {name}: {out['layers']}, {out['param_bytes'] / 1e9:.2f} GB "
          f"of weights on the card ({smi})", flush=True)

    eng = HybridServeEngine(cfg, params, mode="hybrid", hw=H100_SXM)
    kv_eng = HybridServeEngine(cfg, params, mode="kv", hw=H100_SXM)
    groups = eng.plan_groups(reqs)
    if [[r.rid for r in g] for g in groups] != \
            [[r.rid for r in g] for g in kv_eng.plan_groups(reqs)]:
        raise AssertionError("hybrid and kv modes plan other groups")
    splits = []
    for g in groups:
        _, kv_keep, pbs, *_ = eng.group_schedule(g)
        splits += [{"rid": r.rid, "kv": int(k), "act": int(p - k)}
                   for r, k, p in zip(g, kv_keep, pbs)]
    out.update(act_frac=eng.act_frac, splits=splits, groups=len(groups))
    runs = {}
    for mode, e in (("hybrid", eng), ("kv", kv_eng)):
        want = expected_launches(e, reqs)
        e.generate(reqs)                                 # warm-up
        torch.cuda.synchronize()
        reset_counts()              # the counted main-path run
        t1 = time.perf_counter()
        toks, stats = e.generate(reqs)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t1
        got = read_counts()
        runs[mode] = toks
        out[mode] = {"launches": got, "wall_s": wall,
                     "tokens_per_s": stats.generated_tokens / wall,
                     "device_calls": stats.device_calls}
        if got != want:
            raise AssertionError(f"moe {name} {mode} launches {got}, "
                                 f"expected {want}")
        if any(p.allocated for p in e.blockman.pools.values()):
            raise AssertionError(f"moe {name}: leaked blocks after {mode}")
        print(f"moe {name} {mode}: {out[mode]['tokens_per_s']:.2f} tokens/s "
              f"({smi})", flush=True)
    del e                     # an engine holds the weights until the offload
    t0 = stage("engine", t0)

    # no host sync inside the decode loop, the MoE dispatch included
    g0 = groups[0]
    toks, kv_keep, pbs, sched, bound_, act_bound = eng.group_schedule(g0)
    lg, cache = M.hybrid_prefill_batched(params, cfg,
                                         torch.from_numpy(toks).cuda(),
                                         eng.kv_cap, eng.act_cap, kv_keep, pbs)
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
        if not np.array_equal(loop_toks[i, :r.max_new_tokens],
                              runs["hybrid"][r.rid]):
            raise AssertionError(f"moe {name} request {r.rid}: the "
                                 "sync-checked loop differs")
    out["decode_loop_host_syncs"] = 0
    del cache
    out["launches_per_decode_step_profiled"] = decode_launches(
        params, cfg, eng, g0, None)
    # one layer's MoE FFN at the decode shape against its bound: every
    # expert's weights read once (the batched products read them all)
    lp = M.layer_params(params, 0)["ffn"]
    x = torch.randn((len(g0), cfg.d_model), device="cuda").to(lp["we1"].dtype)
    moe_ms = time_ms(lambda: L.moe_ffn(
        lp, x, num_experts=cfg.moe_num_experts, top_k=cfg.moe_top_k,
        capacity_factor=cfg.moe_capacity_factor, ffn_type=cfg.ffn_type), 10)
    expert_bytes = sum(lp[k].numel() * lp[k].element_size()
                       for k in ("we1", "we2", "we3") if k in lp)
    out.update(moe_ffn_decode_ms=moe_ms,
               moe_ffn_bound_ms=expert_bytes / PEAK_BYTES_PER_S * 1e3,
               moe_ffn_expert_bytes=expert_bytes)
    del x, lp                  # views of every layer's stacked experts
    print(f"moe {name}: {out['launches_per_decode_step_profiled']} launches "
          f"a decode step; moe_ffn at decode {moe_ms:.4f} ms a layer, bound "
          f"{out['moe_ffn_bound_ms']:.4f} ms ({smi})", flush=True)
    phase_profile(results, smi, name, {"hybrid": eng}, reqs)
    t0 = stage("syncs_and_profile", t0)

    # hybrid against kv mode of the same group: kv's own greedy tokens and
    # teacher-forced logits are the reference
    kv_gold = {r.rid: torch.from_numpy(runs["kv"][r.rid]).cuda() for r in reqs}
    kv_lg, hy_gap = {}, {}
    kv_watch, hy_watch = MoeWatch(), MoeWatch()
    for g in groups:
        gold = torch.stack([kv_gold[r.rid] for r in g])
        lk = watched_forced(kv_eng, params, cfg, g, gold, kv_watch)
        lh = watched_forced(eng, params, cfg, g, gold, hy_watch)
        for i, r in enumerate(g):
            kv_lg[r.rid] = lk[i]
            hy_gap[r.rid] = (lh[i] - lk[i]).abs().amax(-1).cpu().numpy()
    kv_routes = kv_watch.routes()
    rule = moe_rule(reqs, runs["hybrid"], hy_gap, runs["kv"], kv_lg,
                    kv_routes, hy_watch.routes(), logit_tol)
    rule["max_teacher_forced_dlogit"] = max(float(g.max())
                                            for g in hy_gap.values())
    out["hybrid_vs_kv"] = rule
    print(f"moe {name} hybrid vs kv: {json.dumps(rule['requests'])}",
          flush=True)
    if not rule["ok"]:
        raise AssertionError(f"moe {name}: hybrid breaks the MoE rule "
                             f"against kv mode: {rule}")
    del hy_watch
    t0 = stage("hybrid_vs_kv", t0)

    # against the oracle where the group's prefill dropped no real pair: on
    # TRACE, and on a trace whose groups cannot drop
    out["hybrid_vs_oracle"] = {}
    for label, rs in (("trace", reqs), ("drop_free", request_trace(
            cfg.vocab_size, **MOE_DROP_FREE_TRACE))):
        hyb = runs["hybrid"] if rs is reqs else eng.generate(rs)[0]
        o_rule = oracle_rule(eng, params, cfg, rs, hyb, logit_tol)
        out["hybrid_vs_oracle"][label] = o_rule
        print(f"moe {name} hybrid vs the oracle on {label} ({smi}): prefill "
              f"drops {o_rule['prefill_drops']}; held for "
              f"{o_rule['held_requests']}: {json.dumps(o_rule['requests'])}; "
              f"agreement over all {o_rule['agreement_all']}", flush=True)
        if not o_rule["ok"] or (label == "drop_free"
                                and len(o_rule["held_requests"]) < len(rs)):
            raise AssertionError(f"moe {name}: hybrid breaks the MoE rule "
                                 f"against the oracle on {label}: {o_rule}")
    t0 = stage("hybrid_vs_oracle", t0)

    if name == "dbrx-132b":
        faults = {}
        for label, patch in zip(MOE_FAULTS, (
                patched(L, "_inverse", identity_order),
                patched(L, "_renormalise", lambda gate: gate))):
            f_watch, f_gap = MoeWatch(), {}
            with patch:
                for g in groups:
                    lg = watched_forced(eng, params, cfg, g, torch.stack(
                        [kv_gold[r.rid] for r in g]), f_watch)
                    for i, r in enumerate(g):
                        f_gap[r.rid] = (lg[i] - kv_lg[r.rid]).abs().amax(-1) \
                            .cpu().numpy()
            f_rule = moe_rule(reqs, runs["hybrid"], f_gap, runs["kv"], kv_lg,
                              kv_routes, f_watch.routes(), logit_tol)
            faults[label] = {"max_dlogit": max(float(v.max())
                                               for v in f_gap.values()),
                             "rule_ok": f_rule["ok"],
                             "first_swaps": {rid: (p["first_swap_output"],
                                                   p["swap_margin"])
                                             for rid, p in
                                             f_rule["requests"].items()}}
        out["faults"] = faults
        print(f"moe {name} planted faults: {json.dumps(faults)}", flush=True)
        if not all(f["max_dlogit"] > logit_tol and not f["rule_ok"]
                   for f in faults.values()):
            raise AssertionError(f"moe {name}: the limit or the rule passes a "
                                 f"planted fault: {faults}")
        t0 = stage("faults", t0)
        held = {tuple(k) for k in results["kernels"]["shard_keys"]}
        out["shard"], shard = shard_moe_leg(cfg, params, reqs, held,
                                            SHARD_LIMIT, runs["hybrid"])
        results.setdefault("moe_shard_launches", {})[
            f"{name} shard 1x2"] = {"fp": shard}
        gc.collect()
        torch.cuda.empty_cache()
        t0 = stage("shard", t0)
        out["server"] = moe_server(cfg, params, logit_tol, smi)
        t0 = stage("server", t0)
        del eng, kv_eng
        out["host_memory_before_pinning"] = meminfo()
        print(f"moe {name}: host memory before pinning "
              f"{out['host_memory_before_pinning']}", flush=True)
        pool = HostWeightPool(cfg, params, device="cuda")
        del params
        gc.collect()
        torch.cuda.empty_cache()
        out["host_memory_after_pinning"] = meminfo()
        t0 = stage("pin", t0)
        out["offload"] = moe_offload(cfg, pool, reqs, runs["hybrid"], smi)
        del pool
        t0 = stage("offload", t0)
    else:
        del eng, kv_eng, params
    out["max_memory_allocated"] = torch.cuda.max_memory_allocated()
    out["stage_s"] = stage_s
    out["seconds"] = time.perf_counter() - t_phase
    print(f"moe {name}: {out['seconds']:.1f} s {stage_s}", flush=True)
    emit(out)
    results[f"moe {name}"] = out
    return out["hybrid"]["launches"]


def moe_server(cfg, params, logit_tol, smi) -> dict:
    """``ContinuousBatchingServer`` at S = 8 over the scheduler trace's first
    ``SCHED_SUBSET`` requests, every chunk under ``ChunkCheck``: tokens/s,
    calls and readbacks per token, launches, leaks, each admission's drops;
    tokens under the MoE rule against the kv path of its own admission
    batches (a forced run of the same schedule gives the gaps, both runs'
    dispatches tagged), and the plain oracle's agreement printed beside its
    own prefills' drops."""
    reqs, arrivals = open_loop_trace(cfg.vocab_size, SCHED_REQUESTS,
                                     **SCHED_TRACE)
    reqs, arrivals = reqs[:SCHED_SUBSET], arrivals[:SCHED_SUBSET]
    check, watch = ChunkCheck(), MoeWatch()
    srv = ContinuousBatchingServer(cfg, params, chunk_steps=8, hw=H100_SXM,
                                   **SCHED_SERVER)
    adm = Admissions(srv, watch)
    torch.cuda.synchronize()
    reset_counts()
    t0 = time.perf_counter()
    with patched(M, "hybrid_decode_chunk", check), \
            patched(L, "moe_route", watch), adm.patch():
        toks, stats = srv.run(reqs, arrival_steps=arrivals)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    got = read_counts()
    srv.close()
    run = sched_stats(stats, wall)
    want = sched_launches(cfg, stats, check, None)
    checks = {"launches": got == want, "no_leaks": sched_leak_free(srv),
              "one_call_per_batch_and_chunk":
                  stats.device_calls == stats.admission_batches + stats.chunks,
              "one_readback_per_call": stats.host_syncs == stats.device_calls,
              "chunks_checked": check.calls == stats.chunks,
              "lengths_frozen": check.length_faults == 0,
              "bounds_cover_lengths": check.bound_faults == 0}
    run.update(launches=got, admission_drops=watch.drops(), checks=checks)
    print(f"moe server {cfg.name} S=8: {run['tokens_per_s']:.2f} tokens/s, "
          f"{stats.dispatches_per_token:.4f} calls/token, "
          f"{run['host_syncs_per_token']:.4f} readbacks/token; admission "
          f"drops {run['admission_drops']} ({smi})", flush=True)
    if not all(checks.values()):
        raise AssertionError(f"moe server failed {checks}: {run}, expected "
                             f"launches {want}")
    # the reference: the kv path of the same admission batches
    ref_watch, f_watch = MoeWatch(), MoeWatch()
    ref_toks, ref_lg = admission_oracle(params, cfg, adm.batches, reqs,
                                        ref_watch)
    gold = {rid: torch.from_numpy(t).cuda() for rid, t in ref_toks.items()}
    # the server teacher-forced with those tokens, on its own schedule
    srv = ContinuousBatchingServer(cfg, params, chunk_steps=8, hw=H100_SXM,
                                   **SCHED_SERVER)
    f_adm = Admissions(srv, f_watch)
    with f_adm.patch():
        forced = ForcedRun(srv, gold, ref_lg)
        real_chunk, ctx = forced.chunk, {}

        def chunk(params_, cfg_, cur, cache, store, active, **kw):
            ctx.update(rid=[st.rid for st in srv.slots],
                       pos=[len(st.generated) for st in srv.slots],
                       act=active.cpu().numpy(), s=0)
            return real_chunk(params_, cfg_, cur, cache, store, active, **kw)

        def rows():
            s = ctx["s"]
            ctx["s"] += 1
            return [(rid, p + s + 1, 1) if a and rid >= 0 else None
                    for rid, p, a in zip(ctx["rid"], ctx["pos"], ctx["act"][s])]

        forced.chunk = chunk
        with forced.patch(), patched(L, "moe_route", f_watch), \
                tagged_steps(f_watch, rows):
            srv.run(reqs, arrival_steps=arrivals)
    srv.close()
    gaps = forced.gaps()
    rule = moe_rule(reqs, toks, gaps, ref_toks, ref_lg, ref_watch.routes(),
                    f_watch.routes(), logit_tol)
    rule["max_teacher_forced_dlogit"] = max(float(g.max())
                                            for g in gaps.values())
    run["vs_admission_kv_path"] = rule
    print(f"moe server vs the admissions' kv path: "
          f"{json.dumps(rule['requests'])}", flush=True)
    if not rule["ok"]:
        raise AssertionError(f"moe server breaks the MoE rule against the kv "
                             f"path of its admissions: {rule}")
    # the plain oracle, one request at a time: its own drops counted
    o_watch, real_prefill = MoeWatch(), M.prefill

    def prefill(*a, **kw):
        o_watch.arm([a[2].shape[1]], a[2].shape[1], [None])
        return real_prefill(*a, **kw)

    with patched(L, "moe_route", o_watch), patched(M, "prefill", prefill):
        plain = sched_oracle(params, cfg, reqs, logit_tol)[0]["oracle"]
    run["oracle_prefill_drops"] = {r.rid: d["real"][0] for r, d in
                                   zip(reqs, o_watch.drops())}
    run["agreement_with_plain_oracle"] = agreement(toks, plain, reqs)
    run["agreement_of_admission_kv_path_with_plain_oracle"] = agreement(
        ref_toks, plain, reqs)
    return run


def moe_offload(cfg, pool, reqs, resident, smi) -> dict:
    """dbrx with its layers streamed from pinned host memory under the
    default budget (16 GiB on the card at depth 1: two layer slots and
    every KV block): ``offload_run``'s checks, and tokens equal to the
    device-resident hybrid run's."""
    budget = offload_budget(cfg)
    eng = HybridServeEngine(cfg, pool, hw=H100_SXM, offload=True, mode="hybrid",
                            budget=budget)
    toks, _, want, run, checks = offload_run(eng, reqs, "hybrid_d1",
                                             pool.layer_nbytes[0])
    eng.close()
    run.update(budget_dev_bytes=budget.dev_bytes,
               prefetch_depth=budget.prefetch_depth,
               host_buffer_bytes_per_layer=pool.layer_nbytes[0])
    checks.update(pinned=pool.pinned, tokens_equal_device_resident=all(
        np.array_equal(toks[r.rid], resident[r.rid]) for r in reqs))
    run["checks"] = checks
    print(f"moe offload {cfg.name} d1: step {run['step_s_mean']:.4f} s, pcie "
          f"{run['pcie_busy_s_mean']:.4f} s, gpu {run['gpu_busy_s_mean']:.4f} "
          f"s, {run['weights_h2d_GBps']:.2f} GB/s, idle "
          f"{run['gpu_idle_share']:.4f}, peak "
          f"{run['max_memory_allocated'] / 1e9:.2f} GB, host buffer "
          f"{pool.layer_nbytes[0] / 1e9:.3f} GB a layer ({smi})", flush=True)
    if not all(checks.values()):
        raise AssertionError(f"moe offload failed {checks}: {run}, expected "
                             f"launches {want}")
    return run


def shard_resident(plan, tree) -> dict:
    """Each position's bytes of a tree of ``Sharded`` leaves, and what its
    specs imply (``launch.dryrun.leaf_bytes`` of each leaf's global shape)."""
    leaves = list(_leaves(tree))
    held = [sum(x.nbytes(p) for x in leaves) for p in plan.mesh.positions]
    spec = sum(DRY.leaf_bytes(torch.empty(x.shape, dtype=x.dtype,
                                          device="meta"), x.spec, plan.mesh)
               for x in leaves)
    return {"held": held, "spec": spec}


def shard_launches(cfg, plan, eng, reqs) -> dict:
    """Launches of one sharded ``generate``: per layer, group and position
    that runs the group (every model position of each data row) a flash
    launch, and per decode step a fused one (OPT) or a second-pool and a
    ``kv_gen`` one (RoPE)."""
    L, runs = cfg.num_layers, plan.mesh.size
    rope = cfg.pos_type == "rope"
    want = {k: 0 for k in COUNTERS}
    for g in eng.plan_groups(reqs):
        steps = eng.group_schedule(g)[3].shape[1]
        want["flash_attention"] += L * runs
        if rope:
            want["hybrid_paged_attention_two_pool"] += L * runs * steps
            want["kv_gen"] += L * runs * steps
        else:
            want["hybrid_paged_attention"] += L * runs * steps
    return want


def shard_forced(eng, reqs, gold) -> dict:
    """{rid: teacher-forced logits (n, V)} of the sharded engine's path over
    each of its groups, fed the oracle's tokens."""
    out = {}
    for g in eng.plan_groups(reqs):
        toks, kv_keep, pbs, sched, pb, ab = eng.group_schedule(g)
        gold_g = torch.stack([gold[r.rid] for r in g])
        lg = SHD.forced_logits(eng.plan, eng.params, toks, eng.kv_cap,
                               eng.act_cap, kv_keep, pbs,
                               torch.from_numpy(np.ascontiguousarray(
                                   sched.T)).cuda(), gold_g, pages_bound=pb,
                               act_pages_bound=ab, lay=eng._layout)
        for i, r in enumerate(g):
            out[r.rid] = lg[i].float()
    return out


def drop_last_partial(parts, devices):
    """Planted fault: the ``wo`` sum without the last position's partial."""
    return COLL.sum_model(parts[:-1], devices, kind="wo")


def own_act_slice(parts, devices):
    """Planted fault: KV-Gen on each position's own d_model slice of the ACT
    rows (the others' columns zero) instead of the gathered rows."""
    d, m = parts[0].shape[-1], len(parts)
    return [F.pad(p, (c * d, (m - 1 - c) * d)) for c, p in enumerate(parts)]


def phase_shard(results, smi, name, params, reqs, oracle) -> dict:
    """Tensor-parallel serving on this card: ``name``'s trace on each mesh of
    ``SHARD_MESHES`` (every position on cuda:0), on the serve phase's
    weights and oracle.  Per mesh: each position's resident bytes against
    its specs', the launches per prefill and per step (every per-position
    call at a key a kernels-phase row held), the collective bytes, the
    decode loop under the sync check, teacher-forced logits against the
    phase's own 1x1 kernel run (the serve phase's engine) within max(0.25,
    2 x that run's gap to the oracle), tokens under the exactness rule.  On
    the first mesh two planted faults must read over the limit (a ``wo``
    partial dropped, KV-Gen on a position's own slice), and for OPT the
    server (4 slots) and the offload executor (one weight lane per
    position) run there too.  -> {label: launches}."""
    t_phase = time.perf_counter()
    cfg = get_config(name)
    rule, gold, ora = oracle
    held = {tuple(k) for k in results["kernels"]["shard_keys"]}
    one = HybridServeEngine(cfg, params, mode="hybrid", hw=H100_SXM)
    want = {}
    for g in one.plan_groups(reqs):
        lg = forced_logits(one, params, cfg, g,
                           torch.stack([gold[r.rid] for r in g]))
        for i, r in enumerate(g):
            want[r.rid] = lg[i].float()
    spread = max(float(v.max()) for v in rule["hybrid"].values())
    limit = max(SHARD_LIMIT, 2 * spread)
    rule = dict(rule, logit_tol=limit)          # the phase's own rule
    out = {"phase": "shard", "card": smi, "model": name,
           "one_by_one_gap_to_oracle": spread, "logit_limit": limit,
           "meshes": {}, "legs": {}}
    counts = {}
    for shape in SHARD_MESHES[name]:
        label = f"{shape[0]}x{shape[1]}"
        t0 = time.perf_counter()
        plan = make_shard_plan(cfg, make_test_mesh(*shape), params)
        eng = HybridServeEngine(cfg, params, mode="hybrid", hw=H100_SXM,
                                plan=plan)
        resident = shard_resident(plan, eng.params)
        if any(h != resident["spec"] for h in resident["held"]):
            raise AssertionError(f"shard {name} {label}: positions hold "
                                 f"{resident['held']} B of weights, their "
                                 f"specs imply {resident['spec']}")
        expect = shard_launches(cfg, plan, eng, reqs)
        torch.cuda.synchronize()
        reset_counts()
        COLL.COUNTER.reset()
        t1 = time.perf_counter()
        with KernelCalls() as calls:
            outs, stats = eng.generate(reqs)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t1
        launches = read_counts()
        coll = COLL.COUNTER.read()
        counts[label] = launches
        if launches != expect:
            raise AssertionError(f"shard {name} {label}: launches {launches},"
                                 f" expected {expect}")
        unheld = [k for k in calls.first if k not in held]
        if unheld:
            raise AssertionError(f"shard {name} {label}: kernel calls at keys "
                                 f"no kernels-phase row held: {unheld}")
        if any(p.allocated for p in eng.blockman.pools.values()):
            raise AssertionError(f"shard {name} {label}: leaked blocks")
        # the decode loop of group 0 under the sync check
        g0 = eng.plan_groups(reqs)[0]
        toks, kv_keep, pbs, sched, pb, ab = eng.group_schedule(g0)
        curs, cache = SHD.prefill(plan, eng.params, toks, eng.kv_cap,
                                  eng.act_cap, kv_keep, pbs, lay=eng._layout)
        cache_res = shard_resident(plan, cache)
        s_dev = torch.from_numpy(np.ascontiguousarray(sched.T)).cuda()
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            loop, _ = SHD.decode_chunk(plan, eng.params, curs, cache, s_dev,
                                       pages_bound=pb, act_pages_bound=ab,
                                       lay=eng._layout)
        finally:
            torch.cuda.set_sync_debug_mode(0)
        loop = loop.cpu().numpy()
        for i, r in enumerate(g0):
            if not np.array_equal(loop[i, :r.max_new_tokens], outs[r.rid]):
                raise AssertionError(f"shard {name} {label}: request {r.rid}:"
                                     f" the sync-checked loop differs")
        del cache
        got = shard_forced(eng, reqs, gold)
        gap = max(float((got[r.rid] - want[r.rid]).abs().max()) for r in reqs)
        rule[f"shard {label}"] = {r.rid: (got[r.rid] - ora[r.rid]).abs().amax(
            -1).cpu().numpy() for r in reqs}
        ex = exactness(rule, f"shard {label}", outs, reqs)
        if not gap <= limit:
            raise AssertionError(f"shard {name} {label}: teacher-forced logits"
                                 f" {gap} from the 1x1 kernel run, limit "
                                 f"{limit}")
        rec = {"plan": plan.explain().splitlines()[:2],
               "resident_weight_bytes": resident,
               "resident_cache_bytes_group0": cache_res,
               "launches": {k: v for k, v in launches.items() if v},
               "launches_per_prefill_per_group": {
                   "flash_attention": cfg.num_layers * plan.mesh.size},
               "groups": len(eng.plan_groups(reqs)), "steps": stats.steps,
               "device_calls": stats.device_calls, "collective_bytes": coll,
               "collective_bytes_per_step": coll["total"] / max(stats.steps, 1),
               "wall_s": wall, "tokens_per_s": stats.generated_tokens / wall,
               "act_frac": eng.act_frac, "max_dlogit_vs_1x1": gap,
               "exact_requests": ex["exact_requests"],
               "n_requests": len(reqs), "diverged": ex["diverged"],
               "kernel_keys": [list(k) for k in calls.first]}
        if shape == SHARD_MESHES[name][0]:
            faults = {}
            g = eng.plan_groups(reqs)[:1]
            for fault, site, fn in (("wo_partial_dropped", "_attn_sum",
                                     drop_last_partial),
                                    ("kv_gen_on_own_d_slice", "_act_gather",
                                     own_act_slice)):
                with patched(SHD, site, fn):
                    bad = shard_forced(eng, g[0], gold)
                faults[fault] = max(float((bad[r.rid] - want[r.rid]).abs()
                                          .max()) for r in g[0])
            rec["fault_dlogit"] = faults
            if not all(v > limit for v in faults.values()):
                raise AssertionError(f"shard {name} {label}: the limit {limit}"
                                     f" passes a planted fault: {faults}")
            if name == "opt-6.7b":
                rec["server"], counts[f"{label} server"] = shard_server(
                    cfg, params, plan, reqs, rule, label)
                pool = HostWeightPool(cfg, params, plan=plan, device="cuda")
                rec["offload"], counts[f"{label} offload"] = shard_offload(
                    cfg, pool, plan, reqs, outs)
                out["legs"]["1x2 cpu lane"], counts["1x2 cpu lane"] = \
                    shard_cpu_lane(cfg, pool, plan, reqs, gold, want, rule,
                                   limit, held)
                del pool
        rec["seconds"] = time.perf_counter() - t0
        out["meshes"][label] = rec
        print(f"shard {name} {label}: {rec['exact_requests']}/{len(reqs)} "
              f"exact, dlogit {gap:.4f} (limit {limit:.4f}), faults "
              f"{rec.get('fault_dlogit')}, launches {rec['launches']}, "
              f"collective {coll['total']} B ({rec['collective_bytes_per_step']:.0f}"
              f" a step: {coll}), resident {resident}, {wall:.2f} s wall "
              f"({rec['tokens_per_s']:.1f} tok/s), {rec['seconds']:.1f} s",
              flush=True)
        del eng, plan
        gc.collect()
        torch.cuda.empty_cache()
    for leg in SHARD_LEGS[name]:
        if leg.endswith("int8"):
            out["legs"][leg], counts[leg] = shard_int8_leg(
                cfg, params, reqs, held, limit, name == "yi-6b")
        elif leg == "1x8":
            out["legs"][leg], counts[leg] = shard_forced_leg(
                cfg, params, reqs, gold, rule, limit, held, leg)
        gc.collect()
        torch.cuda.empty_cache()
    out["seconds"] = time.perf_counter() - t_phase
    emit(out)
    results[f"shard {name}"] = out
    return counts


def shard_server(cfg, params, plan, reqs, rule, label):
    """The continuous-batching server on ``plan`` (4 slots, chunks of 4):
    one call and one readback per admission batch and per chunk, leak-free,
    tokens under the exactness rule of the engine's sharded run.
    -> (record, launches)."""
    reset_counts()
    t0 = time.perf_counter()
    with ContinuousBatchingServer(cfg, params, hw=H100_SXM, plan=plan,
                                  **SHARD_SERVER) as srv:
        outs, st = srv.run(reqs)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        leak = any(p.allocated for p in srv.blockman.pools.values())
    launches = read_counts()
    if leak or st.device_calls != st.admission_batches + st.chunks \
            or st.host_syncs != st.device_calls:
        raise AssertionError(f"shard server {label}: leak {leak}, calls "
                             f"{st.device_calls}, admissions "
                             f"{st.admission_batches}, chunks {st.chunks}, "
                             f"syncs {st.host_syncs}")
    ex = exactness(rule, f"shard {label}", outs, reqs)
    rec = {"calls": st.device_calls, "host_syncs": st.host_syncs,
           "chunks": st.chunks, "admission_batches": st.admission_batches,
           "wall_s": wall, "tokens_per_s": st.generated_tokens / wall,
           "exact_requests": ex["exact_requests"],
           "launches": {k: v for k, v in launches.items() if v}}
    print(f"shard server {label}: {rec}", flush=True)
    return rec, launches


def shard_offload(cfg, pool, plan, reqs, want):
    """The offload executor on ``plan``: one weight lane per position (its
    slice of each layer pinned on the host in ``pool``, its own staging
    ring and copy stream), over the whole trace; tokens equal ``want``, the
    device-resident sharded engine's, every lane uploads, each step's lane
    seconds (the max over lanes) within the step.  -> (record, launches)."""
    t0 = time.perf_counter()
    with HybridServeEngine(cfg, pool, mode="hybrid", hw=H100_SXM,
                           plan=plan, offload=True) as eng:
        build_s = time.perf_counter() - t0
        pinned = eng.executor.pool.pinned
        reset_counts()
        t1 = time.perf_counter()
        outs, st = eng.generate(reqs)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t1
        launches = read_counts()
        lanes = eng.executor.streamer.lanes
        uploads = [lane.uploads for lane in lanes]
        lane_bytes = [lane.bytes_uploaded for lane in lanes]
        steps = eng.measured_steps
    bad = [r.rid for r in reqs if not np.array_equal(outs[r.rid],
                                                     want[r.rid])]
    over = [(m.pcie_busy, m.total) for m in steps
            if not m.pcie_busy <= m.total + 1e-6]
    if bad or not pinned or len(lanes) != plan.mesh.size \
            or not all(uploads) or over:
        raise AssertionError(f"shard offload: tokens differ {bad}, pinned "
                             f"{pinned}, lanes {len(lanes)} uploads {uploads},"
                             f" lane seconds over the step {over}")
    rec = {"requests": len(reqs), "lanes": len(lanes), "uploads": uploads,
           "bytes_uploaded": lane_bytes, "pool_build_s": build_s,
           "wall_s": wall, "device_calls": st.device_calls,
           "step_s": [m.total for m in steps],
           "pcie_busy_s": [m.pcie_busy for m in steps],
           "gpu_busy_s": [m.gpu_busy for m in steps],
           "launches": {k: v for k, v in launches.items() if v}}
    print(f"shard offload: {rec}", flush=True)
    return rec, launches


def shard_checked_launches(label, want, calls, held):
    """The launches of a leg's counted run against ``want``, and every
    kernel call at a key a kernels-phase row held.  -> the launches."""
    got = read_counts()
    if got != want:
        raise AssertionError(f"shard {label}: launches {got}, expected {want}")
    unheld = [k for k in calls.first if k not in held]
    if unheld:
        raise AssertionError(f"shard {label}: kernel calls at keys no "
                             f"kernels-phase row held: {unheld}")
    return got


def shard_check_resident(label, plan, tree) -> dict:
    res = shard_resident(plan, tree)
    if any(h != res["spec"] for h in res["held"]):
        raise AssertionError(f"shard {label}: positions hold {res['held']} B,"
                             f" their specs imply {res['spec']}")
    return res


def mesh_launches(eng, reqs, plan) -> dict:
    """``expected_launches`` of a sharded engine: every position of every
    data row launches each of the single-device run's kernels once."""
    return {k: v * plan.mesh.size
            for k, v in expected_launches(eng, reqs).items()}


def one_at_schedule(eng, params, cfg, group, greedy_route=None,
                    forced_route=None):
    """The single-device kernel run at a sharded engine's own schedule of
    ``group`` (its split, bounds and int8 plan): its greedy tokens (B, n)
    int32 on the card, then its teacher-forced logits fed them (B, n, V);
    ``*_route``: a ``RouteReplay`` recording each run's routing."""
    toks, kv_keep, pbs, sched, pb, ab = eng.group_schedule(group)
    s_dev = torch.from_numpy(np.ascontiguousarray(sched.T)).cuda()
    with patched(L, "moe_route", greedy_route or REAL_MOE_ROUTE):
        lg, cache = M.hybrid_prefill_batched(
            params, cfg, torch.from_numpy(toks).cuda(), eng.kv_cap,
            eng.act_cap, kv_keep, pbs, quant=eng.quant)
        gen, _ = M.hybrid_decode_loop(params, cfg, lg[:, -1].argmax(-1).int(),
                                      cache, s_dev, pages_bound=pb,
                                      act_pages_bound=ab, quant=eng.quant,
                                      any_act=sched.any(0))
    del cache
    with patched(L, "moe_route", forced_route or REAL_MOE_ROUTE):
        want = forced_logits(eng, params, cfg, group, gen)
    return gen, want


def shard_forced_of(eng, group, gold):
    """The sharded functions' teacher-forced logits over ``group`` at its
    engine's schedule, fed ``gold`` (B, n) -> (B, n, V)."""
    toks, kv_keep, pbs, sched, pb, ab = eng.group_schedule(group)
    s_dev = torch.from_numpy(np.ascontiguousarray(sched.T)).cuda()
    return SHD.forced_logits(eng.plan, eng.params, toks, eng.kv_cap,
                             eng.act_cap, kv_keep, pbs, s_dev, gold,
                             pages_bound=pb, act_pages_bound=ab,
                             any_act=sched.any(0), lay=eng._layout)


def shard_sync_loop(eng, group, label):
    """The sharded prefill, then the decode loop of ``group`` under the sync
    check ("error": no host sync inside it).  -> (tokens (B, n) numpy, the
    cache, its resident bytes against the specs')."""
    toks, kv_keep, pbs, sched, pb, ab = eng.group_schedule(group)
    curs, cache = SHD.prefill(eng.plan, eng.params, toks, eng.kv_cap,
                              eng.act_cap, kv_keep, pbs, lay=eng._layout)
    res = shard_check_resident(f"{label} cache", eng.plan, cache)
    s_dev = torch.from_numpy(np.ascontiguousarray(sched.T)).cuda()
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        loop, _ = SHD.decode_chunk(eng.plan, eng.params, curs, cache, s_dev,
                                   pages_bound=pb, act_pages_bound=ab,
                                   any_act=sched.any(0), lay=eng._layout)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    return loop.cpu().numpy(), cache, res


def leg_rule(reqs, ref_toks, want, got, limit, label) -> dict:
    """The exactness rule of a leg held to a 1x1 run: ``ref_toks`` its
    greedy tokens and ``want`` its teacher-forced logits fed them (the
    margins), ``got`` the leg's fed the same (the per-step gaps)."""
    margin = {}
    for r in reqs:
        top2 = want[r.rid].topk(2, dim=-1).values
        margin[r.rid] = (top2[:, 0] - top2[:, 1]).cpu().numpy()
    return {"oracle": ref_toks, "margin": margin, "logit_tol": limit,
            label: {r.rid: (got[r.rid] - want[r.rid]).abs().amax(-1).cpu()
                    .numpy() for r in reqs}}


def scale_of_own_slice(parts, devices):
    """Planted fault: each position quantizes its slice of the ACT rows
    against its own slice's scale (no max over the row)."""
    return list(parts)


def shard_int8_leg(cfg, params, reqs, held, limit, plant):
    """The int8 cache on 1x2 (``QuantConfig()``; K/V codes and scales split
    with the heads, the ACT codes over d_model with one scale per whole row,
    the codes gathered for KV-Gen): the trace through the engine, launches
    at held keys (the int8 modes; the fused route's exact-row merges as
    int8 ``return_lse`` launches), collective bytes by kind, resident bytes
    of the weights and of group 0's cache, the decode loop under the sync
    check, layer 0's ACT codes and scales after the prefill bit-equal to
    the single-device run's (every plane's equality and the codes off in
    each recorded), and each group held to the single-device kernel
    run at the leg's own schedule (the same int8 plan): teacher-forced
    logits within ``limit``, tokens under the exactness rule.  ``plant``:
    the ACT scale of each position's own slice must read over the limit.
    -> (record, launches)."""
    t0 = time.perf_counter()
    label = f"{cfg.name} 1x2 int8"
    q = QuantConfig()
    plan = make_shard_plan(cfg, make_test_mesh(1, 2), params)
    eng = HybridServeEngine(cfg, params, mode="hybrid", hw=H100_SXM, quant=q,
                            plan=plan)
    resident = shard_check_resident(label, plan, eng.params)
    want_launches = mesh_launches(eng, reqs, plan)
    torch.cuda.synchronize()
    reset_counts()
    COLL.COUNTER.reset()
    t1 = time.perf_counter()
    with KernelCalls() as calls:
        outs, stats = eng.generate(reqs)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t1
    coll = COLL.COUNTER.read()
    launches = shard_checked_launches(label, want_launches, calls, held)
    if any(p.allocated for p in eng.blockman.pools.values()):
        raise AssertionError(f"shard {label}: leaked blocks")
    groups = eng.plan_groups(reqs)
    g0 = groups[0]
    loop, cache, cache_res = shard_sync_loop(eng, g0, label)
    for i, r in enumerate(g0):
        if not np.array_equal(loop[i, :r.max_new_tokens], outs[r.rid]):
            raise AssertionError(f"shard {label}: request {r.rid}: the "
                                 "sync-checked loop differs")
    del cache
    # layer 0's planes after the prefill: the rows every mesh computes alike
    toks, kv_keep, pbs, *_ = eng.group_schedule(g0)
    _, cache = SHD.prefill(plan, eng.params, toks, eng.kv_cap, eng.act_cap,
                           kv_keep, pbs, lay=eng._layout)
    _, one = M.hybrid_prefill_batched(params, cfg, torch.from_numpy(toks)
                                      .cuda(), eng.kv_cap, eng.act_cap,
                                      kv_keep, pbs, quant=q)
    planes = M.region_planes(one)
    layer0 = {k: bool(torch.equal(cache[k].full()[0], one[k][0]))
              for k in planes}
    codes_off = {k: int((cache[k].full() != one[k]).sum()) for k in planes}
    del cache, one
    # layer 0's ACT rows are the embedding on every mesh: its codes and
    # scales must be equal; its K/V come from column slices of wk/wv, which
    # cuBLAS may sum in another order than the whole product (recorded)
    if not (layer0["act"] and layer0["act_s"]):
        raise AssertionError(f"shard {label}: layer 0's ACT codes or scales "
                             f"differ from the single-device run's: {layer0}")
    ref_toks, want, got = {}, {}, {}
    for g in groups:
        gen, w = one_at_schedule(eng, params, cfg, g)
        lg = shard_forced_of(eng, g, gen)
        for i, r in enumerate(g):
            ref_toks[r.rid] = gen[i, :r.max_new_tokens].cpu().numpy()
            want[r.rid], got[r.rid] = w[i].float(), lg[i].float()
    rule = leg_rule(reqs, ref_toks, want, got, limit, "leg")
    ex = exactness(rule, "leg", outs, reqs)
    gap = max(float(v.max()) for v in rule["leg"].values())
    if not gap <= limit:
        raise AssertionError(f"shard {label}: teacher-forced logits {gap} "
                             f"from the 1x1 int8 run, limit {limit}")
    faults = {}
    if plant:
        gold = torch.stack([torch.from_numpy(ref_toks[r.rid]).cuda()
                            for r in g0])
        with patched(SHD, "_act_scale_max", scale_of_own_slice):
            bad = shard_forced_of(eng, g0, gold)
        faults[SHARD_INT8_FAULT] = max(float((bad[i].float() - want[r.rid])
                                             .abs().max())
                                       for i, r in enumerate(g0))
        if not faults[SHARD_INT8_FAULT] > limit:
            raise AssertionError(f"shard {label}: the limit {limit} passes "
                                 f"a planted fault: {faults}")
    rec = {"plan": plan.explain().splitlines()[:2],
           "resident_weight_bytes": resident,
           "resident_cache_bytes_group0": cache_res,
           "launches": {k: v for k, v in launches.items() if v},
           "groups": len(groups), "steps": stats.steps,
           "device_calls": stats.device_calls, "collective_bytes": coll,
           "collective_bytes_per_step": coll["total"] / max(stats.steps, 1),
           "wall_s": wall, "tokens_per_s": stats.generated_tokens / wall,
           "act_frac": eng.act_frac, "layer0_bit_equal": layer0,
           "codes_off_after_prefill": codes_off,
           "max_dlogit_vs_1x1_int8": gap, "logit_limit": limit,
           "exact_requests": ex["exact_requests"], "n_requests": len(reqs),
           "diverged": ex["diverged"], "fault_dlogit": faults,
           "kernel_keys": [list(k) for k in calls.first],
           "seconds": time.perf_counter() - t0}
    print(f"shard {label}: {rec['exact_requests']}/{len(reqs)} exact, dlogit "
          f"{gap:.4f} (limit {limit:.4f}), faults {faults}, launches "
          f"{rec['launches']}, collective {coll}, layer 0 {layer0}, codes off "
          f"{codes_off}, resident {resident}, {wall:.2f} s wall, "
          f"{rec['seconds']:.1f} s", flush=True)
    del eng
    return rec, launches


def shard_path_forced(eng, group, gold):
    """Teacher-forced logits of a sharded engine's own path over ``group``
    (the offload executor and its CPU lane's merge included): one
    ``generate`` with ``SHD.argmax_rows`` wrapped to record each step's
    logits and hand the path ``gold``'s next token (B, n) in place of its
    argmax.  -> (B, n, V).  One data row."""
    real, seen = SHD.argmax_rows, []

    def forced(lay, row, logits):
        seen.append(SHD.full_logits(lay, row, logits)[:, -1].float())
        nxt = gold[:, min(len(seen), gold.shape[1]) - 1].int()
        return [nxt.to(d)[:, None] for d in row.devs]

    with patched(SHD, "argmax_rows", forced):
        eng.generate(group)
    return torch.stack(seen[:gold.shape[1]], 1)


def shard_cpu_lane(cfg, pool, plan, reqs, gold, want, rule, limit, held):
    """OPT's offload executor on 1x2 with the CPU lane, over the serve
    trace's first group under the tight budget (its KV region spilled to
    one arena a model shard): each position's device partial (the fused
    ``return_lse`` mode at its 16 heads) merged with the host's partial
    over its heads of its arena slice.  Launches at held keys, no KV upload
    (the lane attends in place), the CPU lane busy, the executor's host
    waits (one a layer for the queries, and the spill and readback), the
    path's teacher-forced logits (the merge included) within ``limit`` of
    the 1x1 kernel run, tokens under the exactness rule.
    -> (record, launches)."""
    t0 = time.perf_counter()
    label = f"{cfg.name} 1x2 cpu lane"
    with HybridServeEngine(cfg, pool, mode="hybrid", hw=H100_SXM, plan=plan,
                           offload=True, host_attn=True,
                           budget=_tight(cfg)) as eng:
        group = eng.plan_groups(reqs)[0]
        if not spills(eng, group):
            raise AssertionError(f"shard {label}: the group does not spill")
        want_launches = mesh_launches(eng, group, plan)
        syncs0 = eng.executor.blocking_syncs
        reset_counts()
        t1 = time.perf_counter()
        with KernelCalls() as calls:
            outs, st = eng.generate(group)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t1
        launches = shard_checked_launches(label, want_launches, calls, held)
        syncs = eng.executor.blocking_syncs - syncs0
        kv_load = sum(m.traffic["kv_load"] for m in eng.measured_steps)
        gold_g = torch.stack([gold[r.rid] for r in group])
        got = shard_path_forced(eng, group, gold_g)
        fallbacks = eng.executor.host_lane.fault_counters["sync_fallbacks"]
    gaps = {r.rid: (got[i] - want[r.rid]).abs().amax(-1) for i, r in
            enumerate(group)}
    gap = max(float(v.max()) for v in gaps.values())
    rule = dict(rule, logit_tol=limit)
    rule["leg"] = {r.rid: gaps[r.rid].cpu().numpy() for r in group}
    ex = exactness(rule, "leg", outs, group)
    L = cfg.num_layers
    steps = st.steps
    want_syncs = steps * L + 2
    checks = {"spilled": True, "no_kv_upload": kv_load == 0,
              "cpu_lane_busy": st.measured_cpu_busy > 0,
              "no_fallback": fallbacks == 0,
              "host_waits": syncs == want_syncs,
              "logits_within_limit": gap <= limit}
    rec = {"requests": [r.rid for r in group], "steps": steps,
           "launches": {k: v for k, v in launches.items() if v},
           "wall_s": wall, "host_waits": syncs, "host_waits_expected":
           want_syncs, "cpu_busy_s": st.measured_cpu_busy,
           "kv_load_bytes": kv_load, "max_dlogit_vs_1x1": gap,
           "logit_limit": limit, "exact_requests": ex["exact_requests"],
           "diverged": ex["diverged"], "checks": checks,
           "kernel_keys": [list(k) for k in calls.first],
           "seconds": time.perf_counter() - t0}
    print(f"shard {label}: {rec}", flush=True)
    if not all(checks.values()):
        raise AssertionError(f"shard {label} failed {checks}: {rec}")
    return rec, launches


def shard_forced_leg(cfg, params, reqs, gold, rule, limit, held, leg):
    """yi on 1x8 (``leg``): 4 query heads a position over the one KV head
    they share of 4 replicated (``Layout.kv_slice``), ``wk``/``wv`` gathered
    to whole heads, over the serve trace's first group: the teacher-forced
    run's launches (a flash launch a layer and position per prefill, a
    second-pool and a ``kv_gen`` one a layer and position per step) at held
    keys, its logits within ``limit`` of the single-device kernel run at
    the same schedule, collective bytes by kind, resident bytes, and the
    greedy decode loop under the sync check, its tokens under the
    exactness rule.  -> (record, launches)."""
    t0 = time.perf_counter()
    label = f"{cfg.name} {leg}"
    plan = make_shard_plan(cfg, make_test_mesh(*leg_mesh(leg)), params)
    eng = HybridServeEngine(cfg, params, mode="hybrid", hw=H100_SXM,
                            plan=plan)
    resident = shard_check_resident(label, plan, eng.params)
    group = eng.plan_groups(reqs)[0]
    gold_g = torch.stack([gold[r.rid] for r in group])
    want = forced_logits(eng, params, cfg, group, gold_g)
    n = gold_g.shape[1]
    L, size = cfg.num_layers, plan.mesh.size
    want_launches = {k: 0 for k in COUNTERS}
    want_launches.update({"flash_attention": L * size,
                          "hybrid_paged_attention_two_pool": L * size * (n - 1),
                          "kv_gen": L * size * (n - 1)})
    torch.cuda.synchronize()
    reset_counts()
    COLL.COUNTER.reset()
    t1 = time.perf_counter()
    with KernelCalls() as calls:
        got = shard_forced_of(eng, group, gold_g)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t1
    coll = COLL.COUNTER.read()
    launches = shard_checked_launches(label, want_launches, calls, held)
    gaps = {r.rid: (got[i].float() - want[i].float()).abs().amax(-1)
            for i, r in enumerate(group)}
    gap = max(float(v.max()) for v in gaps.values())
    loop, cache, cache_res = shard_sync_loop(eng, group, label)
    del cache
    outs = {r.rid: loop[i, :r.max_new_tokens] for i, r in enumerate(group)}
    rule = dict(rule, logit_tol=limit)
    rule["leg"] = {rid: v.cpu().numpy() for rid, v in gaps.items()}
    ex = exactness(rule, "leg", outs, group)
    if not gap <= limit:
        raise AssertionError(f"shard {label}: teacher-forced logits {gap} "
                             f"from the 1x1 kernel run, limit {limit}")
    lay = eng._layout
    rec = {"plan": plan.explain().splitlines()[:2],
           "heads_a_position": lay.cfg_l.num_heads,
           "kv_head_of_position": lay.kv0,
           "resident_weight_bytes": resident,
           "resident_cache_bytes_group0": cache_res,
           "launches": {k: v for k, v in launches.items() if v},
           "forced_steps": n - 1, "forced_wall_s": wall,
           "collective_bytes": coll, "max_dlogit_vs_1x1": gap,
           "logit_limit": limit, "exact_requests": ex["exact_requests"],
           "n_requests": len(group), "diverged": ex["diverged"],
           "kernel_keys": [list(k) for k in calls.first],
           "seconds": time.perf_counter() - t0}
    print(f"shard {label}: {rec}", flush=True)
    del eng
    return rec, launches


class ShardReplay(RouteReplay):
    """``RouteReplay`` whose replay hands each recorded dispatch to the
    ``m`` positions of a data row in turn: every position routes the row's
    tokens, in the single-device run's dispatch order."""

    def __init__(self, recorded: RouteReplay, m: int):
        super().__init__()
        self.idx, self.m, self.calls = recorded.idx, m, 0
        self.replay()

    def __call__(self, router, x, **kw):
        r = super().__call__(router, x, **kw)
        self.calls += 1
        if self.calls % self.m:
            self.pos -= 1
        return r


def shard_moe_leg(cfg, params, reqs, held, limit, resident_toks):
    """dbrx at its serve cut on 1x2, expert parallel (8 of 16 experts a
    position; the router replicated, every position routing all its row's
    tokens in the single-device run's dispatch groups; the gated sums
    summed over the row in float32): the trace through the engine, launches
    at held keys, collective bytes by kind (``moe`` the expert sums),
    resident bytes.  Per group, at the leg's own schedule: the
    single-device kernel run's greedy tokens and its teacher-forced logits
    fed them, each with its routes recorded; the leg's teacher-forced
    logits with the forced routes replayed (rounding alone swaps experts at
    router near-ties: the gap then reads the arithmetic) within ``limit``,
    and its greedy loop under the sync check with the greedy routes
    replayed, tokens under the exactness rule.  The free-running engine's
    agreement with the device-resident run ``resident_toks`` is printed.
    The ``wo`` sum without a position's partial must read over the limit.
    -> (record, launches)."""
    t0 = time.perf_counter()
    label = f"{cfg.name} 1x2"
    plan = make_shard_plan(cfg, make_test_mesh(1, 2), params)
    eng = HybridServeEngine(cfg, params, mode="hybrid", hw=H100_SXM,
                            plan=plan)
    resident = shard_check_resident(label, plan, eng.params)
    want_launches = mesh_launches(eng, reqs, plan)
    torch.cuda.synchronize()
    reset_counts()
    COLL.COUNTER.reset()
    t1 = time.perf_counter()
    with KernelCalls() as calls:
        outs, stats = eng.generate(reqs)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t1
    coll = COLL.COUNTER.read()
    launches = shard_checked_launches(label, want_launches, calls, held)
    if any(p.allocated for p in eng.blockman.pools.values()):
        raise AssertionError(f"shard {label}: leaked blocks")
    groups = eng.plan_groups(reqs)
    ref_toks, want, got, loops, cache_res = {}, {}, {}, {}, None
    replays = {}
    for gi, g in enumerate(groups):
        g_rec, f_rec = RouteReplay(), RouteReplay()
        gen, w = one_at_schedule(eng, params, cfg, g, g_rec, f_rec)
        with patched(L, "moe_route", ShardReplay(f_rec, plan.model_shards)):
            lg = shard_forced_of(eng, g, gen)
        with patched(L, "moe_route", ShardReplay(g_rec, plan.model_shards)):
            loop, cache, res = shard_sync_loop(eng, g, label)
        del cache
        cache_res = cache_res or res
        replays[gi] = (f_rec, gen)
        for i, r in enumerate(g):
            ref_toks[r.rid] = gen[i, :r.max_new_tokens].cpu().numpy()
            loops[r.rid] = loop[i, :r.max_new_tokens]
            want[r.rid], got[r.rid] = w[i].float(), lg[i].float()
    rule = leg_rule(reqs, ref_toks, want, got, limit, "leg")
    ex = exactness(rule, "leg", loops, reqs)
    gap = max(float(v.max()) for v in rule["leg"].values())
    if not gap <= limit:
        raise AssertionError(f"shard {label}: teacher-forced logits {gap} "
                             f"from the 1x1 run, limit {limit}")
    f_rec, gen = replays[0]
    with patched(L, "moe_route", ShardReplay(f_rec, plan.model_shards)), \
            patched(SHD, "_attn_sum", drop_last_partial):
        bad = shard_forced_of(eng, groups[0], gen)
    faults = {"wo_partial_dropped": max(
        float((bad[i].float() - want[r.rid]).abs().max())
        for i, r in enumerate(groups[0]))}
    if not faults["wo_partial_dropped"] > limit:
        raise AssertionError(f"shard {label}: the limit {limit} passes a "
                             f"planted fault: {faults}")
    rec = {"plan": plan.explain().splitlines()[:2],
           "experts_a_position": eng._layout.cfg.moe_num_experts
           // plan.model_shards, "resident_weight_bytes": resident,
           "resident_cache_bytes_group0": cache_res,
           "launches": {k: v for k, v in launches.items() if v},
           "groups": len(groups), "steps": stats.steps,
           "collective_bytes": coll,
           "collective_bytes_per_step": coll["total"] / max(stats.steps, 1),
           "wall_s": wall, "tokens_per_s": stats.generated_tokens / wall,
           "max_dlogit_vs_1x1_routes_replayed": gap, "logit_limit": limit,
           "exact_requests_routes_replayed": ex["exact_requests"],
           "n_requests": len(reqs), "diverged": ex["diverged"],
           "free_running_agreement_with_1x1": agreement(
               outs, resident_toks, reqs),
           "fault_dlogit": faults,
           "kernel_keys": [list(k) for k in calls.first],
           "seconds": time.perf_counter() - t0}
    print(f"shard {label}: {rec}", flush=True)
    del eng
    return rec, launches


def serve_path(results, smi, name):
    """Serve one model through the engine, then through the
    continuous-batching server on the same weights, then its telemetry phase
    (tracer, metrics registry, adaptive controller) on them, profile it,
    free its weights, so that peak device memory is one model's, then serve
    it from host memory (OPT's engine-side telemetry runs there).  -> the
    launch counts of its device-resident hybrid runs and of its host-attend
    runs, each {"fp": ..., "int8": ...}, of its scheduler runs and of its
    telemetry runs, {run: ...}, and of its shard phase's runs,
    {"<name> shard <mesh>[ server|offload]": {"fp": ...}}."""
    launches, engines, reqs, outs, oracle, q8_oracle, params = phase_serve(
        results, smi, name)
    shard = {f"{name} shard {k}": {"int8" if k.endswith("int8") else "fp": v}
             for k, v in phase_shard(results, smi, name, params, reqs,
                                     oracle).items()}
    gc.collect()
    torch.cuda.empty_cache()
    sched_launches_, sched_ctx = phase_scheduler(results, smi,
                                                 get_config(name), params)
    tel_launches = phase_telemetry(results, smi, get_config(name), params,
                                   sched_ctx)
    del params, sched_ctx
    gc.collect()
    torch.cuda.empty_cache()
    # the hybrid mode alone: the kv and int8 modes' profiles were cut to
    # keep the script's time
    phase_profile(results, smi, name, {"hybrid": engines["hybrid"]}, reqs)
    del engines
    gc.collect()
    torch.cuda.empty_cache()
    ha_launches, tel_offload = phase_offload(results, smi, name, reqs, outs,
                                             oracle, q8_oracle)
    tel_launches.update(tel_offload)
    gc.collect()
    torch.cuda.empty_cache()
    return launches, ha_launches, sched_launches_, tel_launches, shard


# ----------------------------------------------------------------- train phase
# the models trained on the card, each at full width and depth from random
# weights (seed 0), by ``make_train_step`` (remat, AdamW) on TRAIN_STEPS
# batches of TRAIN_BATCH rows: {name: tokens a row, and the planted backward
# fault that step 1's gradients must catch}
# - minitron-4b (uniform: 32 layers, d 3072, 24 heads over 8 kv heads,
#   head_dim 128, vocab 256,000 untied, 4.19 B parameters): 512 tokens; dK
#   and dV not summed over the group
# - gemma3-1b (windowed: 26 layers, 22 local at W 512 and 4 global, MQA with
#   G 4, head_dim 256, q/k norm): 1024 tokens, so that the window is crossed;
#   the window left out of the backward
# - whisper-base (encdec: 6 encoder layers over 1500 frames, 6 decoder
#   layers with cross attention over them, head_dim 64): 448 tokens, its
#   decoder's context, and 1500 frames drawn from a seeded generator; the
#   keys cut at Sq (the cross attention's 1052 frames past the 448 tokens
#   take no part)
# - qwen2-vl-2b (vision: 28 layers, G 6, head_dim 128, M-RoPE): 256 patches
#   drawn from a seeded generator before 512 tokens; dK and dV not summed
#   over the group
# - mamba2-2.7b (ssm: 64 SSD layers, 80 heads of P 64, N 128, chunk 64, 2.70 B
#   parameters, ~32 GB of training state; dt biases at Mamba-2's init): 1024
#   tokens; the SSD backward's state cotangent not carried across chunks
# - the hybrid family at ``jamba_train_config``'s cut (one period of 8 layers
#   at reduced width; dt biases likewise): 1024 tokens; dB and dC taken from
#   one head
TRAIN_MODEL = "minitron-4b"
JAMBA_TRAIN = JAMBA + "-reduced"
TRAIN_RUNS = {TRAIN_MODEL: dict(seq=512, fault="no_group_sum"),
              GEMMA: dict(seq=1024, fault="no_window"),
              WHISPER: dict(seq=448, fault="sk_as_sq"),
              QWEN: dict(seq=512, fault="no_group_sum"),
              MAMBA: dict(seq=1024, fault="bwd_state_not_carried"),
              JAMBA_TRAIN: dict(seq=1024, fault="bwd_heads_not_summed")}
TRAIN_BATCH, TRAIN_STEPS = 4, 5
# five steps from the random init with no warmup.  The params are bfloat16,
# as the reference keeps them: an update under half an ulp (~0.2% of a
# weight) rounds away and one over it moves a whole ulp, so AdamW's first,
# sign-like step moves most weights by one ulp at any small rate, and the
# second step's loss rises before it falls (on the card, minitron-4b: 13.2
# -> 22.9 at 3e-5, -> 24.0 at 1e-4)
TRAIN_OPT = dict(lr=3e-5, warmup_steps=1, total_steps=TRAIN_STEPS)
# step 1 on the flash kernels against the same step with the plain attention
# patched in: both are bf16 computations that round at other points (P and
# dS in 16 bits in the kernels, the outputs of both), and the difference
# grows through the layers of backpropagation.  The limits sit above that
# noise and below what a broken backward gives (the planted fault must
# exceed the gradient limit)
GRAD_REL_L2 = 0.05
LOSS_ABS = 0.02
# the backward kernel's own share of that gap: step 1's gradients on the
# kernels against the same step with the kernel forward kept and only the
# backward swapped for the plain float32 one (``KernelForwardPlainBackward``).
# Both take the same forward outputs and lse; the kernel rounds P and dS to
# bfloat16 and sums dQ with float32 adds in no fixed order, and that
# difference grows through the layers' backward.  On the card (NVIDIA H100
# 80GB HBM3, 700 W) it read 0.58% (whisper-base) to 1.95% (qwen2-vl-2b),
# while the end-to-end gap above, which also holds the forward's rounding,
# reached 4.94% on qwen2-vl-2b.  The limit leaves that worst reading half
# again, and each planted backward fault must exceed it.  Past 32 SSD
# layers the leg reads at its own floor: mamba2-2.7b's 64 read 2.966%,
# where the plain float32 SSD backward against itself with one product
# (C B^T) rounded otherwise reads 2.963% (``phase_train``'s floor leg; ~0.05%
# a layer: any rounding change decorrelates the bf16 backward that much).
# There the limit is max(BWD_GRAD_REL_L2, 2 x that floor, read in the same
# run), the 5% leg's rule of twice the plain path's own spread; every other
# cell keeps BWD_GRAD_REL_L2.  The SSD backward stays deterministic (no
# atomics: the same reading every run)
BWD_GRAD_REL_L2 = 0.03


def gram_f64(C, B):
    """``ssd_scan_bwd_ref``'s C B^T taken in float64 and rounded once: the
    plain backward's own arithmetic in another rounding."""
    return (C.double() @ B.double().transpose(-1, -2)).float()


def jamba_train_config():
    """The hybrid family's training cut.  jamba at full width holds ~22.4 B
    parameters a 4-layer period, and training keeps 2 + 2 + 8 bytes of
    weights, gradients and AdamW moments a parameter (~270 GB), so it
    trains at ``reduced`` width (d 256, 4 experts, vocab 1024) over one whole
    8-layer period (7 SSD layers, 4 of them MoE, one NoPE attention layer),
    in bfloat16, at the full model's SSD shape (P 64, N 128, chunk 64: the
    backward kernel's) and head_dim 64 (one of the flash backward's).  The
    overrides go through ``reduced`` so that ``__post_init__`` recomputes
    ``ssm_num_heads`` (8)."""
    return reduced(get_config(JAMBA), dtype="bfloat16", head_dim=64,
                   ssm_head_dim=64, ssm_state_size=128, ssm_chunk=64)


def train_config(name):
    return jamba_train_config() if name == JAMBA_TRAIN else get_config(name)


class KernelForwardPlainBackward(torch.autograd.Function):
    """The flash kernel's forward with lse, differentiated by the plain
    float32 backward ``flash_attention_bwd_ref`` from the kernel's own
    output and lse: step 1's third leg in ``phase_train``."""

    @staticmethod
    def forward(ctx, q, k, v, window, causal):
        o, lse = FA.flash_attention_lse(q, k, v, window, causal)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.mode = (window, causal)
        return o

    @staticmethod
    def backward(ctx, do):
        return flash_attention_bwd_ref(*ctx.saved_tensors, do.contiguous(),
                                       *ctx.mode) + (None, None)


class SsdKernelForwardPlainBackward(torch.autograd.Function):
    """The ``ssd_scan`` kernel's forward, differentiated by the plain
    float32 backward ``ssd_scan_bwd_ref``: the SSD layers' part of step 1's
    third leg in ``phase_train``."""

    @staticmethod
    def forward(ctx, x, dt, A, B, C, chunk):
        ctx.set_materialize_grads(False)
        ctx.save_for_backward(x, dt, A, B, C)
        ctx.chunk = chunk
        return _ssd_scan(x, dt, A, B, C, chunk=chunk)

    @staticmethod
    def backward(ctx, dy, dfinal):
        return ssd_scan_bwd_ref(*ctx.saved_tensors, dy, dfinal,
                                chunk=ctx.chunk) + (None,)


def _rel_l2(a, b) -> float:
    return ((a.float() - b.float()).norm() / b.float().norm().clamp_min(1e-30)
            ).item()


def train_batches(cfg, n: int, seq: int, device="cuda"):
    """``n`` batches of TRAIN_BATCH rows: ``lm_batches``' tokens and labels
    of ``seq`` positions, and the frontend's rows in the model's dtype, from
    a generator seeded by the batch's index: whisper's frames (B, F, d),
    qwen2-vl's patches (B, P, d)."""
    it = lm_batches(DataConfig(vocab_size=cfg.vocab_size, seq_len=seq,
                               batch_size=TRAIN_BATCH))
    out = []
    for i in range(n):
        raw = next(it)
        b = {k: torch.from_numpy(raw[k]).to(device) for k in ("tokens",
                                                              "labels")}
        g = torch.Generator(device=device).manual_seed(i)
        rows = {"frames": cfg.enc_seq_len if cfg.is_encoder_decoder else 0,
                "patches": cfg.frontend_tokens
                if cfg.frontend == "vision_stub" else 0}
        for key, r in rows.items():
            if r:
                b[key] = torch.randn((TRAIN_BATCH, r, cfg.d_model),
                                     generator=g, device=device).to(
                                         M.torch_dtype(cfg))
        out.append(b)
    return out


def train_launches(cfg) -> dict:
    """Kernel launches of one training step, by counter: per attention call
    (per SSD layer) of the forward, the flash (``ssd_scan``) forward kernel
    twice (remat recomputes each layer in the backward) and its backward
    kernel once.  The windowed family's local layers run in the window
    mode; the encdec family's encoder layers and cross attentions in the
    non-causal mode."""
    encdec = M.family(cfg) == "encdec"
    n_ssd = cfg.layer_kinds().count("ssd")
    n = cfg.num_layers - n_ssd + \
        (cfg.enc_num_layers + cfg.num_layers if encdec else 0)
    n_window = cfg.num_layers - M._window_split(cfg)[1] \
        if M.family(cfg) == "windowed" else 0
    n_nc = cfg.enc_num_layers + cfg.num_layers if encdec else 0
    per = {"flash_attention": 2 * n, "flash_attention_window": 2 * n_window,
           "flash_attention_noncausal": 2 * n_nc, "flash_attention_bwd": n,
           "flash_attention_bwd_window": n_window,
           "flash_attention_bwd_noncausal": n_nc,
           "flash_attention_bwd_hd256": n if cfg.head_dim == 256 else 0,
           "ssd_scan": 2 * n_ssd, "ssd_scan_bwd": n_ssd}
    return {k: per.get(k, 0) for k in COUNTERS}


def grad_gaps(grads, want) -> dict:
    """{leaf path: relative L2 of grads against want}."""
    return {k: _rel_l2(g, w) for (k, g), (_, w) in
            zip(_paths(grads), _paths(want))}


def _paths(tree, prefix=""):
    if isinstance(tree, dict):
        return [kv for k in sorted(tree)
                for kv in _paths(tree[k], f"{prefix}/{k}" if prefix else k)]
    return [(prefix, tree)]


def phase_train(results, smi, name=TRAIN_MODEL, device="cuda") -> dict:
    """Train ``name`` (``TRAIN_RUNS``) at full width and depth (jamba at
    ``jamba_train_config``'s cut) on the card: first step 1's loss and
    gradients on the kernels (flash, ``ssd_scan``) against the same step
    with their plain versions ``flash_attention_ref`` and
    ``ssd_chunked_ref`` patched in (past 32 SSD layers under the limit the
    plain path's own spread sets), and the gradients against the kernel
    forwards with the plain backwards (``KernelForwardPlainBackward``,
    ``SsdKernelForwardPlainBackward``: the backward kernels alone, under
    BWD_GRAD_REL_L2, past 32 SSD layers under max(BWD_GRAD_REL_L2, 2 x that
    leg's floor read in the run); the model's planted backward fault must
    fail both gradient limits), then TRAIN_STEPS steps of
    ``make_train_step`` (remat, AdamW in place) with the launch counts set to
    0 just before and read just after (``train_launches`` a step, exactly),
    then a step split at the optimizer and one profiled.  -> the launch
    counts."""
    t_phase = time.perf_counter()
    cfg, run = train_config(name), TRAIN_RUNS[name]
    batches = train_batches(cfg, TRAIN_STEPS, run["seq"], device)
    params = M.init_params(cfg, seed=0, device=device)
    if cfg.ssm_state_size:
        draw_dt_biases(params)
    n_params = sum(p.numel() for p in adamw.leaves(params))
    fault_key = f"fault_{run['fault']}_rel_l2_max"
    out = {"phase": "train", "card": smi, "model": name,
           "batch": TRAIN_BATCH, "seq": run["seq"],
           "frontend_rows": {k: tuple(v.shape) for k, v in batches[0].items()
                             if k in ("frames", "patches")},
           "params": n_params,
           "limits": {"grad_rel_l2": GRAD_REL_L2, "loss_abs": LOSS_ABS,
                      "bwd_grad_rel_l2": BWD_GRAD_REL_L2}}
    errors = []

    # step 1's gradients: the kernels, the plain attention and SSD scan,
    # the kernel forwards with the plain backwards, a planted fault
    def attention(fn):
        return lambda q, k, v, causal=True, window=0: fn(q, k, v, window,
                                                         causal)

    # an MoE model's legs take the first leg's experts (``RouteReplay``, as
    # jamba's serve phase does): at a router near-tie the two arithmetics
    # pick other experts, and the router's gradient then moves by more than
    # any kernel's rounding (the jamba cut's read 6.2% without it)
    route = RouteReplay() if cfg.moe_num_experts else None

    def legs(flash=None, ssd=None):
        """One leg's stand-ins for the kernels (None: the kernel), and the
        first leg's experts replayed."""
        stack = contextlib.ExitStack()
        if flash is not None:
            stack.enter_context(patched(M.T, "flash_attention",
                                        attention(flash)))
        if ssd is not None:
            stack.enter_context(patched(L, "ssd_scan", ssd))
        if route is not None:
            stack.enter_context(patched(L, "moe_route", route.replay()
                                        if route.idx else route))
        return stack

    kernel_fwd_plain_bwd = lambda x, dt, A, B, C, *, chunk: \
        SsdKernelForwardPlainBackward.apply(x, dt, A, B, C, chunk)
    with legs():
        loss_k, _, g_k = SPECS.loss_and_grads(params, cfg, batches[0])
    with legs(flash_attention_ref, ssd_chunked_ref):
        loss_p, _, g_p = SPECS.loss_and_grads(params, cfg, batches[0])
    gaps = grad_gaps(g_k, g_p)
    with legs(KernelForwardPlainBackward.apply, kernel_fwd_plain_bwd):
        _, _, g_x = SPECS.loss_and_grads(params, cfg, batches[0])
    bwd_gaps = grad_gaps(g_k, g_x)
    del g_k
    # past 32 SSD layers the backward-alone leg reads near its floor: the
    # plain backward against itself with C B^T rounded once from float64,
    # the spread any correct backward may show.  There the leg's limit is
    # the larger of BWD_GRAD_REL_L2 and twice that floor (the 5% leg's rule
    # of twice the plain path's own spread); every other cell keeps
    # BWD_GRAD_REL_L2
    bwd_floor, bwd_tol = None, BWD_GRAD_REL_L2
    if cfg.layer_kinds().count("ssd") > 32:
        with legs(KernelForwardPlainBackward.apply, kernel_fwd_plain_bwd), \
                patched(SSD_REF, "_gram", gram_f64):
            _, _, g_64 = SPECS.loss_and_grads(params, cfg, batches[0])
        bwd_floor = max(grad_gaps(g_64, g_x).values())
        bwd_tol = max(BWD_GRAD_REL_L2, 2 * bwd_floor)
        del g_64
    if run["fault"] in FA.FAULTS:
        fault = (FA, "flash_attention_bwd", lambda *a, **kw:
                 FA._flash_attention_bwd(*a, **kw,
                                         flags=FA.FAULTS[run["fault"]]))
    else:
        fault = (SSD, "ssd_scan_bwd", lambda *a, **kw: SSD._ssd_scan_bwd(
            *a, **kw, flags=SSD_FAULTS[run["fault"]]))
    with legs(), patched(*fault):
        _, _, g_f = SPECS.loss_and_grads(params, cfg, batches[0])
    fault_gaps, fault_bwd_gaps = grad_gaps(g_f, g_p), grad_gaps(g_f, g_x)
    del g_f, g_x
    # past 32 layers of SSD scans (mamba2's 64) the end-to-end leg's limit
    # is the larger of GRAD_REL_L2 and twice the plain path's own spread:
    # its step-1 gradients at chunk MAMBA_SPREAD_CHUNK against the model's
    grad_tol, spread = GRAD_REL_L2, None
    if cfg.layer_kinds().count("ssd") > 32:
        with legs(flash_attention_ref, lambda *a, chunk: ssd_chunked_ref(
                *a, chunk=MAMBA_SPREAD_CHUNK)):
            _, _, g_s = SPECS.loss_and_grads(params, cfg, batches[0])
        spread = max(grad_gaps(g_s, g_p).values())
        grad_tol = max(GRAD_REL_L2, 2 * spread)
        del g_s
    del g_p
    worst = max(gaps, key=gaps.get)
    worst_bwd = max(bwd_gaps, key=bwd_gaps.get)
    out["step1"] = {"loss_kernels": loss_k.item(), "loss_plain": loss_p.item(),
                    "loss_gap": abs(loss_k.item() - loss_p.item()),
                    "grad_rel_l2_max": gaps[worst], "grad_rel_l2_leaf": worst,
                    "grad_rel_l2": gaps,
                    "bwd_grad_rel_l2_max": bwd_gaps[worst_bwd],
                    "bwd_grad_rel_l2_leaf": worst_bwd,
                    "bwd_grad_rel_l2": bwd_gaps,
                    "bwd_floor_grad_rel_l2_max": bwd_floor,
                    "bwd_grad_rel_l2_limit": bwd_tol,
                    fault_key: max(fault_gaps.values()),
                    f"fault_{run['fault']}_rel_l2": fault_gaps,
                    f"fault_{run['fault']}_bwd_rel_l2_max":
                        max(fault_bwd_gaps.values()),
                    "grad_rel_l2_limit": grad_tol,
                    "plain_spread_grad_rel_l2": spread}
    if not out["step1"]["loss_gap"] <= LOSS_ABS:
        errors.append(f"step 1 loss {loss_k.item()} vs plain {loss_p.item()}")
    if not gaps[worst] <= grad_tol:
        errors.append(f"step 1 gradient {worst}: relative L2 {gaps[worst]} "
                      f"(limit {grad_tol})")
    if not bwd_gaps[worst_bwd] <= bwd_tol:
        errors.append(f"step 1 backward alone, gradient {worst_bwd}: relative "
                      f"L2 {bwd_gaps[worst_bwd]} (limit {bwd_tol})")
    if not max(fault_gaps.values()) > grad_tol:
        errors.append(f"the gradient limit passes the planted backward fault "
                      f"{run['fault']}: {max(fault_gaps.values())}")
    if not max(fault_bwd_gaps.values()) > bwd_tol:
        errors.append(f"the backward's gradient limit {bwd_tol} passes the "
                      f"planted fault {run['fault']}: "
                      f"{max(fault_bwd_gaps.values())}")
    gc.collect()
    torch.cuda.empty_cache()

    # the main path: TRAIN_STEPS optimizer steps
    opt_state = adamw.init(params)
    step = SPECS.make_train_step(cfg, adamw.AdamWConfig(**TRAIN_OPT))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    losses, step_s = [], []
    reset_counts()
    for b in batches:
        t0 = time.perf_counter()
        params, opt_state, m = step(params, opt_state, b)
        losses.append(float(m["loss"]))
        torch.cuda.synchronize()
        step_s.append(time.perf_counter() - t0)
    counts = read_counts()
    peak = torch.cuda.max_memory_allocated()
    # one more step, split at the optimizer (host clock, the device drained
    # at each end), then one profiled: where the step's device time goes
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    _, _, grads = SPECS.loss_and_grads(params, cfg, batches[-1])
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    params, opt_state, _ = adamw.update(adamw.AdamWConfig(**TRAIN_OPT), params,
                                        grads, opt_state)
    torch.cuda.synchronize()
    split = {"grads_s": t1 - t0, "adamw_s": time.perf_counter() - t1}
    del grads
    phase_profile(results, smi, f"{name} train", None, None, runs={
        "train_step": lambda: step(params, opt_state, batches[-1])})
    steady = step_s[1:] or step_s
    n = len(batches)
    per_step = train_launches(cfg)
    want = {k: v * n for k, v in per_step.items()}
    out["steps"] = {"losses": losses, "step_seconds": step_s,
                    "tokens_per_s": TRAIN_BATCH * run["seq"] * len(steady)
                    / sum(steady),
                    "max_memory_allocated": peak, "step_split": split,
                    "launches": {k: v for k, v in counts.items() if v},
                    "launches_per_step_expected": {
                        k: v for k, v in per_step.items() if v}}
    if not all(math.isfinite(x) for x in losses):
        errors.append(f"non-finite loss: {losses}")
    if not losses[-1] < losses[0]:
        errors.append(f"the loss did not fall: {losses}")
    if counts != want:
        errors.append(f"launches {out['steps']['launches']} over {n} steps, "
                      f"want {({k: v for k, v in want.items() if v})}")
    print(f"train {name} B={TRAIN_BATCH} S={run['seq']} ({smi}): losses "
          f"{losses}, {out['steps']['tokens_per_s']:.1f} tokens/s, steps "
          f"{step_s} s, peak {peak / 1e9:.2f} GB, launches "
          f"{out['steps']['launches']} over {n} steps; step 1 loss gap "
          f"{out['step1']['loss_gap']}, worst gradient {worst} {gaps[worst]} "
          f"(limit {grad_tol}; plain spread {spread}), the backward alone "
          f"{worst_bwd} "
          f"{bwd_gaps[worst_bwd]} (limit {bwd_tol}; floor "
          f"{bwd_floor}), planted fault "
          f"{run['fault']} {out['step1'][fault_key]}, "
          f"{max(fault_bwd_gaps.values())} against the backward", flush=True)
    del params, opt_state
    gc.collect()
    torch.cuda.empty_cache()
    out["seconds"] = time.perf_counter() - t_phase
    out["errors"] = errors
    emit({k: v for k, v in out.items() if k != "step1"}
         | {"step1": {k: v for k, v in out["step1"].items()
                      if not isinstance(v, dict)}})
    results.setdefault("train", {})[name] = out
    if errors:
        raise AssertionError(f"train phase {name}: {errors}")
    return counts


def phase_serve_cli(results, smi, name="opt-6.7b") -> dict:
    """``repro_torch.launch.serve.main`` at full width with ``--verify`` on
    the card (its own assert holds the tokens to the oracle), the launch
    counts set to 0 just before and read just after.  -> the counts."""
    t_phase = time.perf_counter()
    log = io.StringIO()
    reset_counts()
    with contextlib.redirect_stdout(log):
        outs, stats = SERVE_CLI.main(["--arch", name, "--verify"])
    counts = read_counts()
    text = log.getvalue()
    print(text, end="", flush=True)
    out = {"phase": "serve_cli", "card": smi, "model": name,
           "generated_tokens": stats.generated_tokens,
           "token_exact": "token-exact vs full-KV reference: True" in text,
           "measured": [l for l in text.splitlines() if "measured on" in l],
           "launches": {k: v for k, v in counts.items() if v},
           "seconds": time.perf_counter() - t_phase}
    emit(out)
    results["serve_cli"] = out
    gc.collect()
    torch.cuda.empty_cache()
    if not (out["token_exact"] and counts["flash_attention"]
            and counts["hybrid_paged_attention"]):
        raise AssertionError(f"serve CLI phase: {out}")
    return counts

# ------------------------------------------------------------ the dry run
# the one-card fit check over every config x applicable shape, plus opt-30b
# and opt-66b (their cuts are stated here); the cuts this script runs by
# hand, each at the shape its phase serves (the engine's hybrid cache for
# the MoE models and gemma3-27b, the plain cache for jamba's period): each
# must be reported as fitting
FIT_EXTRA = ("opt-30b", "opt-66b")
SERVE_SHAPE = InputShape("smoke_serve", 1024, 4, "decode")
HAND_CUTS = {"dbrx-132b": dict(layers=4, hybrid=True, shape=SERVE_SHAPE),
             "grok-1-314b": dict(layers=2, hybrid=True, shape=SERVE_SHAPE),
             JAMBA: dict(layers=4, hybrid=False, shape=SERVE_SHAPE),
             GEMMA27: dict(layers=62, hybrid=True,
                           shape=InputShape("smoke_serve27", 4096, 4,
                                            "decode"))}
# --measure on the card: a decode that needs a depth cut (and whose plain
# attention's float32 K/V temporaries then lower it), and a prefill and a
# train step that fit whole and take seconds (whisper-base)
DRYRUN_MEASURE = (("yi-6b", "decode_32k"), ("whisper-base", "prefill_32k"),
                  ("whisper-base", "train_4k"))
RESIDENT_TOL = 0.01


def phase_dryrun(results, smi) -> dict:
    """The dry run's fit check on ``meta`` and its ``--measure`` on the card
    (``repro_torch.launch.dryrun``)."""
    t_phase = time.perf_counter()
    mem, source = DRY.card_memory()
    spec_mem = int(H100_SXM.device_mem)
    print(f"dryrun: card memory {mem} B ({source}), H100_SXM.device_mem "
          f"{spec_mem} B", flush=True)
    table = {}
    for arch in list(ASSIGNED) + list(FIT_EXTRA):
        shapes = [s for s in SHAPES if applicable(arch, SHAPES[s])]
        extra = [("smoke_serve", SERVE_SHAPE, True)] \
            if arch in FIT_EXTRA else []
        for name, shape, hyb in [(s, SHAPES[s], False) for s in shapes] + \
                extra:
            f = DRY.fit_check(get_config(arch), shape, device_mem=mem,
                              hybrid=hyb)
            table[f"{arch} {name}"] = {k: f[k] for k in (
                "fits", "depth_cut", "depth_period", "argument_bytes_full",
                "argument_bytes_cut")}
    fit_s = time.perf_counter() - t_phase
    hand = {}
    for arch, h in HAND_CUTS.items():
        cfg = jamba_config() if arch == JAMBA else get_config(arch)
        f = DRY.fit_check(cfg, h["shape"], device_mem=mem, hybrid=h["hybrid"])
        hand[arch] = dict(layers=h["layers"], fits=f["fits"],
                          depth_cut=f["depth_cut"],
                          argument_bytes_cut=f["argument_bytes_cut"])
    bad = {a: v for a, v in hand.items()
           if v["depth_cut"] is None or v["depth_cut"] < v["layers"]}
    if bad:
        raise AssertionError(f"dryrun: the fit check does not report the "
                             f"cuts this script runs as fitting: {bad}")
    measured = {}
    for arch, shape_name in DRYRUN_MEASURE:
        cfg, shape = get_config(arch), SHAPES[shape_name]
        fit = DRY.measure_fit(cfg, shape,
                              DRY.fit_check(cfg, shape, device_mem=mem))
        before, cut, L = fit["depth_cut_args"], fit["depth_cut"], \
            cfg.num_layers
        runs = fit["measured"]
        ok = [m for m in runs if not m["oom"]]
        for m in ok:
            err = abs(m["resident_bytes"] - m["argument_bytes"]) \
                / m["argument_bytes"]
            m["resident_rel_err"] = err
            if err > RESIDENT_TOL:
                raise AssertionError(
                    f"dryrun {arch} {shape_name}: resident {m['resident_bytes']}"
                    f" B against the dry run's {m['argument_bytes']} B")
        # the cut is bracketed: the walk's one run that fit (its peak read,
        # under the card's memory) is its last, at the cut, no deeper than
        # the arguments' cut; and the cut is full depth or the run one
        # period deeper failed on the card
        deeper = min(cut + fit["depth_period"], L) if cut else None
        if not (cut and cut <= before and len(ok) == 1 and runs[-1] is ok[0]
                and ok[0]["depth"] == cut and ok[0]["peak_bytes"] <= mem
                and (cut == L or (
                    len(runs) > 1 and runs[-2]["oom"]
                    and runs[-2]["depth"] == deeper))):
            raise AssertionError(f"dryrun {arch} {shape_name}: the measured "
                                 f"cut {cut} (arguments' cut {before}) is not "
                                 f"bracketed by its runs: {runs}")
        measured[f"{arch} {shape_name}"] = dict(
            depth_cut_args=before, depth_cut=fit["depth_cut"],
            fits=fit["fits"], runs=runs)
        print(f"dryrun measure {arch} {shape_name}: depth {before} -> "
              f"{fit['depth_cut']} of {cfg.num_layers}, " + "; ".join(
                  f"depth {m['depth']}: " + ("oom" if m["oom"] else
                  f"resident {m['resident_bytes'] / 2**30:.2f} GiB "
                  f"({m['resident_rel_err']:.2e} off), peak "
                  f"{m['peak_bytes'] / 2**30:.2f} GiB, step "
                  f"{m['step_seconds']:.3f} s") for m in runs), flush=True)
        gc.collect()
        torch.cuda.empty_cache()
    out = {"phase": "dryrun", "card": smi, "device_mem": mem,
           "device_mem_source": source, "spec_device_mem": spec_mem,
           "fit": table, "hand_cuts": hand, "measured": measured,
           "fit_seconds": fit_s, "seconds": time.perf_counter() - t_phase}
    emit({k: v for k, v in out.items() if k != "fit"})
    results["dryrun"] = out
    return out


# ------------------------------------------------------------ microbench
# opt-6.7b at full width cut to a few layers: each layer's 403 MB shard is
# a real copy on this link (``bench_config``'s 6 x d 512 shard is ~3 MB)
MICROBENCH = dict(layers=4, B=4, S=256, kv_cap=512, act_cap=512, n_steps=4,
                  reps=3)


def phase_microbench(results, smi) -> dict:
    t_phase = time.perf_counter()
    mb = dict(MICROBENCH)
    cfg = dataclasses.replace(get_config("opt-6.7b"),
                              num_layers=mb.pop("layers"))
    r = weight_stream_microbench(cfg, device="cuda", **mb)
    out = {"phase": "microbench", "card": smi, "model": "opt-6.7b",
           "layers": cfg.num_layers, **r,
           "seconds": time.perf_counter() - t_phase}
    emit(out)
    results["microbench"] = out
    gc.collect()
    torch.cuda.empty_cache()
    if not r["saving_s"] > 0:
        raise AssertionError(f"microbench: the overlapped loop saves nothing "
                             f"over stream + compute: {r}")
    return out


# ------------------------------------------------------------ the examples
# each twin of the reference's drivers (examples/torch_*.py) in process, the
# launch counts set to 0 just before it and read just after; the kernels
# each must have launched
EXAMPLE_TWINS = ("quickstart", "serve_hybrid", "continuous_batching",
                 "arch_zoo", "long_context_ssm", "train_lm")
EXAMPLE_LAUNCHES = {
    "quickstart": ("flash_attention", "hybrid_paged_attention"),
    "serve_hybrid": ("flash_attention", "hybrid_paged_attention"),
    "arch_zoo": ("ssd_scan",),
    "train_lm": ("flash_attention_bwd",)}


def launch_keys(name, a, kw) -> list:
    """-> [(key, shape)] of one wrapper call: the key a kernels-phase row
    is held at (kernel, widths, dtype, mode), the call's batch and lengths;
    a flash call that records a gradient keys its backward too."""
    dt = str(a[0].dtype).removeprefix("torch.")
    if name == "flash_attention":
        (B, S, H, D), (Sk, KVH) = a[0].shape, a[1].shape[1:3]
        mode = (H, KVH, D, dt, kw.get("window", 0), kw.get("causal", True))
        keys = [(("flash",) + mode, {"B": B, "S": S, "Sk": Sk})]
        if torch.is_grad_enabled() and any(t.requires_grad for t in a[:3]):
            keys.append((("flash_bwd",) + mode, {"B": B, "S": S, "Sk": Sk}))
        return keys
    if name == "ssd_scan":
        b, s, h, p = a[0].shape
        return [(("ssd", h, p, a[3].shape[-1], kw.get("chunk", 64), dt),
                 {"B": b, "S": s})]
    int8, lse = kw.get("k_scales") is not None, bool(kw.get("return_lse"))
    if name == "hybrid_paged_attention":
        B, KVH, G, D = a[0].shape
        return [(("hybrid", KVH, G, D, a[3].shape[-1], dt,
                  kw.get("norm_type", "layernorm"), int8, lse), {"B": B})]
    if name == "hybrid_paged_attention_two_pool":
        B, KVH, G, D = a[0].shape
        return [(("two_pool", KVH, G, D, dt, int8, lse), {"B": B})]
    _, KVH, hd = a[3].shape                          # kv_gen: wk (d, KVH, hd)
    return [(("kv_gen", KVH, hd, a[0].shape[-1], str(a[3].dtype).removeprefix(
        "torch."), kw.get("norm_type", "rmsnorm"), kw.get("knorm") is not None,
        kw.get("act_scales") is not None), {"N": len(kw["page_index"])})]


class KernelCalls:
    """Within the block, every call the model makes of a kernel wrapper
    recorded by its ``launch_keys`` (the first call's shape of each key)."""
    SITES = ((M.T, "flash_attention"), (L, "ssd_scan"),
             (M, "hybrid_paged_attention"),
             (M, "hybrid_paged_attention_two_pool"), (M, "kv_gen"))

    def __init__(self):
        self.first = {}

    def __enter__(self):
        self.real = [(mod, name, getattr(mod, name)) for mod, name in self.SITES]
        for mod, name, fn in self.real:
            setattr(mod, name, self.wrap(name, fn))
        return self

    def __exit__(self, *exc):
        for mod, name, fn in self.real:
            setattr(mod, name, fn)

    def wrap(self, name, fn):
        def call(*a, **kw):
            for key, shape in launch_keys(name, a, kw):
                self.first.setdefault(key, shape)
            return fn(*a, **kw)
        return call


def phase_examples(results, smi) -> dict:
    """Each twin in process; every kernel call it makes must be at a key
    (widths, dtype, mode: ``launch_keys``) that a kernels-phase row held
    (``twin_specs``)."""
    t_phase = time.perf_counter()
    held = {tuple(k) for k in results["kernels"]["twin_keys"]}
    out = {}
    for name in EXAMPLE_TWINS:
        t0 = time.perf_counter()
        ns = runpy.run_path(str(ROOT / "examples" / f"torch_{name}.py"),
                            run_name="twin")
        buf = io.StringIO()
        reset_counts()
        with contextlib.chdir(ROOT), contextlib.redirect_stdout(buf), \
                KernelCalls() as calls:
            ret = ns["main"](["--device", "cuda"])
        torch.cuda.synchronize()
        counts = {k: v for k, v in read_counts().items() if v}
        lines = buf.getvalue().splitlines()
        rec = {"seconds": time.perf_counter() - t0, "launches": counts,
               "kernel_keys": [[list(k), v] for k, v in calls.first.items()],
               "last_lines": lines[-4:]}
        unheld = [k for k in calls.first if k not in held]
        if unheld:
            raise AssertionError(f"examples {name}: kernel calls at keys no "
                                 f"kernels-phase row held: {unheld}")
        if name == "train_lm":
            rec.update(loss_first=ret[0], loss_last=ret[-1], steps=len(ret))
        out[name] = rec
        print(f"examples {name}: {rec['seconds']:.1f} s, launches {counts}; "
              + " | ".join(lines[-2:]), flush=True)
        missing = [k for k in EXAMPLE_LAUNCHES.get(name, ()) if not
                   counts.get(k)]
        if missing:
            raise AssertionError(f"examples {name}: no launch of {missing}")
        gc.collect()
        torch.cuda.empty_cache()
    res = {"phase": "examples", "card": smi, "twins": out,
           "seconds": time.perf_counter() - t_phase}
    emit(res)
    results["examples"] = res
    return res


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    results, seconds = {}, {}
    t_start = t0 = time.perf_counter()

    def stage(label, t0):
        seconds[label] = time.perf_counter() - t0
        return time.perf_counter()

    smi = phase_env(results)
    phase_build(results)
    t0 = stage("env_and_build", t0)
    phase_kernels(results)
    t0 = stage("kernels", t0)
    by_path, ha_path, sched_path, tel_path, shard_path = {}, {}, {}, {}, {}
    for name in ("opt-6.7b", "yi-6b"):
        by_path[name], ha_path[name], sched_path[name], tel_path[name], \
            shard = serve_path(results, smi, name)
        shard_path.update(shard)
        t0 = stage(name, t0)
    by_path[GEMMA] = {"fp": phase_serve_gemma(results, smi)}
    gc.collect()
    torch.cuda.empty_cache()
    t0 = stage(GEMMA, t0)
    by_path[GEMMA27] = {"fp": phase_serve_gemma(
        results, smi, GEMMA27, GEMMA27_GROUPS, profile_groups=[0])}
    gc.collect()
    torch.cuda.empty_cache()
    t0 = stage(GEMMA27, t0)
    by_path[MAMBA] = {"fp": phase_serve_mamba2(results, smi)}
    gc.collect()
    torch.cuda.empty_cache()
    t0 = stage(MAMBA, t0)
    by_path[JAMBA] = {"fp": phase_serve_jamba(results, smi)}
    gc.collect()
    torch.cuda.empty_cache()
    t0 = stage(JAMBA, t0)
    for name, n in phase_serve_moe(results, smi).items():
        by_path[name] = {"fp": n}
    shard_path.update(results.pop("moe_shard_launches"))
    t0 = stage("moe", t0)
    by_path.update(phase_serve_frontends(results, smi))
    t0 = stage("frontends", t0)
    train_path = {}
    for name in TRAIN_RUNS:
        train_path[name] = {"fp": phase_train(results, smi, name)}
        t0 = stage(f"train {name}", t0)
    by_path["opt-6.7b"]["cli"] = phase_serve_cli(results, smi)
    t0 = stage("serve_cli", t0)
    phase_examples(results, smi)
    t0 = stage("examples", t0)
    phase_microbench(results, smi)
    t0 = stage("microbench", t0)
    phase_dryrun(results, smi)
    t0 = stage("dryrun", t0)
    seconds["script"] = time.perf_counter() - t_start
    results["seconds"] = seconds
    emit({"phase": "seconds", "card": smi, "seconds": seconds})
    # each kernel's launches on the path that carries it: the fused hybrid
    # kernel on OPT's serve, the second-pool mode and kv_gen on yi's, their
    # gemma modes (the flash window, head_dim 256, the K norm) on gemma's, the
    # return_lse mode of each on that model's host-attend offload run, the
    # int8 modes on the int8 serves and the int8 return_lse of each on that
    # model's int8 host-attend run (the int8 OPT serve also launches it on
    # the steps with an ACT-bound token, for its exact row's merge: listed
    # beside it), ssd_scan on mamba2's (jamba's prefill runs flash and
    # ssd_scan too, gemma3-27b's the gemma modes at head_dim 128: in
    # launches_by_path), the flash kernel's non-causal mode
    # and the fused mode over the checkpoint on whisper's cross-ACT run;
    # the flash backward on minitron-4b's training, its window and head_dim
    # 256 modes on gemma3-1b's, its non-causal mode on whisper-base's, the
    # SSD backward on mamba2's (and on the jamba cut's, in launches_by_path);
    # flash_attention runs on every attention path and reports OPT's
    serve, ha = "serve", "offload host_attn"
    path_of = {"flash_attention": ("opt-6.7b", serve, "fp"),
               "hybrid_paged_attention": ("opt-6.7b", serve, "fp"),
               "hybrid_paged_attention_two_pool": ("yi-6b", serve, "fp"),
               "kv_gen": ("yi-6b", serve, "fp"),
               "hybrid_paged_attention_return_lse": ("opt-6.7b", ha, "fp"),
               "hybrid_paged_attention_two_pool_return_lse": ("yi-6b", ha, "fp"),
               "hybrid_paged_attention_q8": ("opt-6.7b", serve, "int8"),
               "hybrid_paged_attention_two_pool_q8": ("yi-6b", serve, "int8"),
               "kv_gen_q8": ("yi-6b", serve, "int8"),
               "hybrid_paged_attention_return_lse_q8": ("opt-6.7b", ha, "int8"),
               "hybrid_paged_attention_two_pool_return_lse_q8": ("yi-6b", ha,
                                                                 "int8"),
               "flash_attention_window": (GEMMA, serve, "fp"),
               "hybrid_paged_attention_two_pool_hd256": (GEMMA, serve, "fp"),
               "kv_gen_qk_norm": (GEMMA, serve, "fp"),
               "ssd_scan": (MAMBA, serve, "fp"),
               "flash_attention_noncausal": (WHISPER, serve, "cross_act"),
               "hybrid_paged_attention_cross_act": (WHISPER, serve,
                                                    "cross_act"),
               "flash_attention_bwd": (TRAIN_MODEL, "train", "fp"),
               "flash_attention_bwd_window": (GEMMA, "train", "fp"),
               "flash_attention_bwd_hd256": (GEMMA, "train", "fp"),
               "flash_attention_bwd_noncausal": (WHISPER, "train", "fp"),
               "ssd_scan_bwd": (MAMBA, "train", "fp")}
    counts = {serve: by_path, ha: ha_path, "scheduler": sched_path,
              "telemetry": tel_path, "train": train_path, "shard": shard_path}
    k = results["kernels"]
    rows = []
    for name, (src, tpu) in KERNELS.items():
        c = k[name][0]                    # the serve path's own shape first
        model, where, fmt = path_of[name]
        counter = COUNTED_AS.get(name, name)
        rows.append({"name": name, "route": "cuda", "source": src,
                     "replaces": tpu, "path": f"{model} {where} {fmt}",
                     "launches": counts[where][model][fmt][counter],
                     "launches_by_path": {
                         f"{m} {w} {f}": n.get(counter, 0)
                         for w, per in counts.items()
                         for m, fmts in per.items() for f, n in fmts.items()},
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
