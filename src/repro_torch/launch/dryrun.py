"""Dry run: every (arch x shape x mesh) step, with nothing allocated
(counterpart of ``repro.launch.dryrun``), and the one-card fit check.

The reference lowers and compiles each combination for a 256- or 512-chip
mesh and reads XLA's memory and cost analyses.  Here each argument tree is
built on ``meta`` (``launch/specs.py``), each leaf gets its partition spec
(``repro_torch.sharding``), and the step runs once on those ``meta`` tensors
under ``torch.utils.flop_counter.FlopCounterMode`` (a kernel wrapper takes
its plain version for a ``meta`` tensor, which launches nothing).  A record
holds the reference's keys:

  - ``memory.argument_bytes`` / ``output_bytes``: per device and exact, each
    leaf's bytes over the product of its spec's axis sizes (a leaf with no
    spec is replicated); ``alias_bytes``: those of the outputs that are
    input tensors updated in place (the train step's params and AdamW state);
  - ``flops``: per device: the whole program's FLOPs (``flops_program``:
    2 per multiply-add of every matmul, batched matmul and attention, every
    layer counted) over the mesh's devices, an even split.  XLA's
    ``cost_analysis()``, which the reference reads, is per device too but
    counts a scanned layer once, so this is about ``num_layers`` times the
    reference's record (``tests/test_torch_dryrun.py``);
  - ``compile_seconds``: this dry run's own wall seconds;
  - ``null`` where the port measures nothing, each with its reason under
    ``not_measured``: the dry run issues no collective (the serving path
    counts its own, ``sharding.collectives``; the dry run's count of them is
    ROADMAP queue 1, item 5.2), and there is no compiled program to read
    bytes or temporaries from.

``--mesh host`` is the one-card fit check (ROADMAP queue 1, item 4.3): on
the (1, 1) mesh each record adds ``fits`` (do the arguments fit the card's
memory at full depth?) and ``depth_cut``, the largest depth, in whole layer
periods (``depth_period``: the windowed and hybrid families' periods, one
layer otherwise), whose arguments fit (``null``: not even one period).  The
card's memory is ``torch.cuda.mem_get_info()[1]`` where a card is present,
else ``H100_SXM.device_mem``; both are printed.  ``--measure`` (the card
only) runs the step once through the kernels with the argument tree
zero-filled, reading ``torch.cuda.memory_allocated()`` after allocating it
and ``temp_bytes`` and ``peak_bytes`` from
``torch.cuda.max_memory_allocated()`` (at ``measured_depth``), walking
down in whole periods from one period over the arguments' cut to the first
depth that runs (``measure_fit``), and re-judges ``fits`` and
``depth_cut`` with the temporaries.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch yi-6b --shape decode_32k
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch yi-6b --shape train_4k --multi-pod
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all --mesh host
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch yi-6b --shape decode_32k --mesh host --measure
"""
from __future__ import annotations

import argparse
import dataclasses
import functools
import json
import math
import os
import sys
import time
from contextlib import nullcontext
from dataclasses import dataclass
from typing import Any, Callable, Dict, Tuple

import torch
from torch.utils.flop_counter import FlopCounterMode

from repro_torch.configs import (ASSIGNED, SHAPES, InputShape, ModelConfig,
                                 applicable, get_config)
from repro_torch.core.costmodel import H100_SXM
from repro_torch.launch import specs as SP
from repro_torch.launch.mesh import (SHARDING, Mesh, make_host_mesh,
                                     make_production_mesh)
from repro_torch.models.transformer import family, pad_vocab
from repro_torch.optim import adamw
from repro_torch.sharding import batch_specs, cache_specs, params_specs
from repro_torch.sharding.rules import P, _axis_size

META = SP.META

#: why a record's field is null: what the port cannot measure
NOT_MEASURED = {
    "collective_bytes": "the dry run issues no collective; counting the "
                        f"serving seams' bytes here is {SHARDING}",
    "bytes_accessed": "no compiled program to analyse: the step runs as "
                      "eager PyTorch, and FlopCounterMode counts operations, "
                      "not bytes",
    "temp_bytes": "temporaries exist only where the step runs: --measure "
                  "reads them on the card (torch.cuda.max_memory_allocated)",
    "peak_bytes": "as temp_bytes: --measure reads the peak on the card",
    "generated_code_bytes": "no generated program: the kernels are prebuilt "
                            "libraries (kernels/_build.py), the rest eager "
                            "PyTorch",
}

#: the train step's metrics: AdamW's and the loss's float32 scalars
TRAIN_METRICS = ("aux", "ce", "gnorm", "loss", "lr")


@functools.lru_cache(maxsize=16)
def _state_shapes(cfg: ModelConfig):
    """(params, AdamW state) on ``meta`` for ``cfg``, built once: ``meta``
    tensors hold no values, so the steps that write them in place change
    nothing a later build reads."""
    p = SP.params_shape(cfg)
    return p, adamw.init(p)


@dataclass
class Lowering:
    """One (config, shape, mesh) step: its function, its argument trees on
    ``meta``, their specs, and the output specs (``None``: replicated)."""
    cfg: ModelConfig
    shape: InputShape
    mesh: Mesh
    hybrid: bool
    serve_2d: bool
    microbatches: int
    fn: Callable
    args: Tuple[Any, ...]
    arg_specs: Tuple[Any, ...]
    out_specs: Tuple[Any, ...]

    @property
    def kind(self) -> str:
        return self.shape.kind


def build(cfg: ModelConfig, shape: InputShape, mesh: Mesh, *,
          hybrid: bool = False, microbatches: int = 4,
          serve_2d: bool = False) -> Lowering:
    """The reference's ``lower_one`` up to the lowering: the step, its
    ``meta`` arguments and every leaf's spec."""
    train = shape.kind == "train"
    p_shape, o_shape = _state_shapes(cfg)
    p_specs = params_specs(cfg, p_shape, mesh, train=train,
                           weights_2d=serve_2d and not train)
    low = dict(cfg=cfg, shape=shape, mesh=mesh, hybrid=hybrid,
               serve_2d=serve_2d, microbatches=microbatches)
    if train:
        o_specs = adamw.AdamWState(step=P(), m=p_specs, v=p_specs)
        b_shape = SP.batch_specs_for(cfg, shape, with_labels=True)
        b_specs = batch_specs(cfg, b_shape, mesh)
        return Lowering(fn=SP.make_train_step(cfg, microbatches=microbatches),
                        args=(p_shape, o_shape, b_shape),
                        arg_specs=(p_specs, o_specs, b_specs),
                        out_specs=(p_specs, o_specs, None), **low)
    if shape.kind == "prefill":
        b_shape = SP.batch_specs_for(cfg, shape, with_labels=False)
        c_shape = SP.cache_shape(cfg, shape.global_batch, shape.seq_len)
        return Lowering(fn=SP.make_prefill_step(cfg, max_len=shape.seq_len),
                        args=(p_shape, b_shape),
                        arg_specs=(p_specs, batch_specs(cfg, b_shape, mesh)),
                        out_specs=(None, cache_specs(cfg, c_shape, mesh)),
                        **low)
    B = shape.global_batch
    tok = torch.empty((B, 1), dtype=torch.int32, device=META)
    tok_spec = batch_specs(cfg, {"t": tok}, mesh)["t"]
    if hybrid:
        kv_cap = shape.seq_len // 2
        act_cap = shape.seq_len - kv_cap + 16
        c_shape = SP.hybrid_cache_shape(cfg, B, kv_cap, act_cap)
        c_specs = cache_specs(cfg, c_shape, mesh)
        store = torch.empty((B,), dtype=torch.bool, device=META)
        return Lowering(fn=SP.make_hybrid_decode_step(cfg),
                        args=(p_shape, tok, c_shape, store),
                        arg_specs=(p_specs, tok_spec, c_specs,
                                   P(tok_spec[0] if tok_spec else None)),
                        out_specs=(None, c_specs), **low)
    c_shape = SP.cache_shape(cfg, B, shape.seq_len)
    c_specs = cache_specs(cfg, c_shape, mesh)
    return Lowering(fn=SP.make_decode_step(cfg), args=(p_shape, tok, c_shape),
                    arg_specs=(p_specs, tok_spec, c_specs),
                    out_specs=(None, c_specs), **low)


def expected_outputs(low: Lowering) -> Tuple[Any, ...]:
    """The step's output trees on ``meta``, from the arguments alone: the
    train step returns its params and AdamW state (updated in place) and
    ``TRAIN_METRICS``; the serve steps the last position's float32 logits
    (B, 1, V), V the padded vocabulary, and the cache.  ``lower_one`` holds the step's own outputs to
    these."""
    if low.kind == "train":
        scalar = torch.empty((), dtype=torch.float32, device=META)
        return low.args[0], low.args[1], {k: scalar for k in TRAIN_METRICS}
    B = low.shape.global_batch
    logits = torch.empty((B, 1, pad_vocab(low.cfg.vocab_size)),
                         dtype=torch.float32, device=META)
    if low.kind == "prefill":
        return logits, SP.cache_shape(low.cfg, B, low.shape.seq_len)
    return logits, low.args[2]


def _pairs(tree, spec):
    """(leaf, spec) pairs of a tree of tensors (nested dicts, tuples) and
    its spec tree; a ``None`` spec replicates everything under it."""
    if isinstance(tree, torch.Tensor):
        yield tree, spec
    elif isinstance(tree, dict):
        for k in sorted(tree):
            yield from _pairs(tree[k], None if spec is None else spec[k])
    else:
        for i, t in enumerate(tree):
            yield from _pairs(t, None if spec is None else spec[i])


def leaf_bytes(t: torch.Tensor, spec, mesh: Mesh) -> int:
    """Per-device bytes of one leaf: its bytes over the product of its
    spec's axis sizes (exact: the rules shard a dim only where it
    divides)."""
    n = t.numel() * t.element_size()
    div = math.prod(_axis_size(mesh, ax) for ax in (spec or ()))
    assert n % div == 0, (tuple(t.shape), spec)
    return n // div


def tree_bytes(tree, spec, mesh: Mesh) -> int:
    return sum(leaf_bytes(t, s, mesh) for t, s in _pairs(tree, spec))


def _same_structure(got, want) -> bool:
    g, w = list(_pairs(got, None)), list(_pairs(want, None))
    return len(g) == len(w) and all(
        a.shape == b.shape and a.dtype == b.dtype for (a, _), (b, _) in zip(g, w))


def count_flops(low: Lowering):
    """The step once on its ``meta`` arguments -> (program FLOPs, outputs).
    Fails where the step reads a tensor's value (a shape that depends on
    data)."""
    ctx = nullcontext() if low.kind == "train" else torch.no_grad()
    with ctx, FlopCounterMode(display=False) as counter:
        out = low.fn(*low.args)
    return int(counter.get_total_flops()), out


def argument_bytes(low: Lowering) -> int:
    return sum(tree_bytes(a, s, low.mesh)
               for a, s in zip(low.args, low.arg_specs))


def output_bytes(low: Lowering, out) -> int:
    return sum(tree_bytes(o, s, low.mesh) for o, s in zip(out, low.out_specs))


def alias_bytes(low: Lowering, out) -> int:
    """Per-device bytes of the outputs that are argument tensors themselves
    (updated in place, as a donated buffer aliases its output)."""
    ins = {id(t) for a in low.args for t, _ in _pairs(a, None)}
    return sum(leaf_bytes(t, s, low.mesh) for o, sp in zip(out, low.out_specs)
               for t, s in _pairs(o, sp) if id(t) in ins)


# --------------------------------------------------------------------------- fit

def depth_period(cfg: ModelConfig) -> int:
    """Layers per period: a depth cut keeps whole periods (the windowed
    family's local + global group, the hybrid family's attention period)."""
    fam = family(cfg)
    if fam == "windowed":
        return cfg.window_period
    if fam == "hybrid":
        return cfg.attn_period
    return 1


def at_depth(cfg: ModelConfig, layers: int) -> ModelConfig:
    return dataclasses.replace(cfg, num_layers=layers)


def card_memory() -> Tuple[int, str]:
    """(bytes, source): the card's total memory where a card is present,
    else the H100 spec's."""
    if torch.cuda.is_available():
        return int(torch.cuda.mem_get_info()[1]), "torch.cuda.mem_get_info"
    return int(H100_SXM.device_mem), "H100_SXM.device_mem"


def fit_check(cfg: ModelConfig, shape: InputShape, *, device_mem: int,
              hybrid: bool = False, microbatches: int = 4) -> Dict[str, Any]:
    """The arguments on one card: ``fits`` at full depth, and ``depth_cut``,
    the largest whole number of periods whose arguments fit (``None``: not
    even one).  Argument bytes grow by the same leaves each period, so two
    depths give the line; the depth it names is then built and checked."""
    mesh = make_host_mesh()
    nbytes = lambda layers: argument_bytes(build(
        at_depth(cfg, layers), shape, mesh, hybrid=hybrid,
        microbatches=microbatches))
    period = depth_period(cfg)
    full = nbytes(cfg.num_layers)
    out = {"fits": full <= device_mem, "depth_period": period,
           "device_mem": device_mem, "argument_bytes_full": full}
    if out["fits"]:
        return dict(out, depth_cut=cfg.num_layers, argument_bytes_cut=full)
    one = nbytes(period)
    if one > device_mem:
        return dict(out, depth_cut=None, argument_bytes_cut=None)
    per = nbytes(2 * period) - one
    k = 1 + (device_mem - one) // per if per > 0 else 1
    k = min(k, cfg.num_layers // period)
    while k > 1 and nbytes(k * period) > device_mem:
        k -= 1
    return dict(out, depth_cut=k * period, argument_bytes_cut=nbytes(k * period))


def materialize(tree, device):
    """A tree like ``tree`` of zero-filled tensors on ``device``."""
    if isinstance(tree, torch.Tensor):
        return torch.zeros(tree.shape, dtype=tree.dtype, device=device)
    if isinstance(tree, dict):
        return {k: materialize(v, device) for k, v in tree.items()}
    return type(tree)(*(materialize(t, device) for t in tree)) \
        if hasattr(tree, "_fields") else type(tree)(
            materialize(t, device) for t in tree)


def measure(low: Lowering, device="cuda") -> Dict[str, Any]:
    """The step once on the card at ``low``'s shapes, its arguments
    zero-filled: resident argument bytes (``torch.cuda.memory_allocated``
    after allocating them), the peak over the step
    (``max_memory_allocated``) and the temporaries (peak less arguments).
    An allocation that fails reads as a peak over the card."""
    dev = torch.device(device)
    if dev.type != "cuda":
        raise ValueError("--measure runs the step on the card (device cuda)")
    torch.cuda.synchronize(dev)
    torch.cuda.empty_cache()
    base = torch.cuda.memory_allocated(dev)
    rec: Dict[str, Any] = {"depth": low.cfg.num_layers}
    args = out = None
    try:
        args = materialize(low.args, dev)
        torch.cuda.synchronize(dev)
        rec["resident_bytes"] = torch.cuda.memory_allocated(dev) - base
        torch.cuda.reset_peak_memory_stats(dev)
        t0 = time.perf_counter()
        ctx = nullcontext() if low.kind == "train" else torch.no_grad()
        with ctx:
            out = low.fn(*args)
        torch.cuda.synchronize(dev)
        rec["step_seconds"] = time.perf_counter() - t0
        rec["peak_bytes"] = torch.cuda.max_memory_allocated(dev) - base
        rec["temp_bytes"] = rec["peak_bytes"] - rec["resident_bytes"]
        rec["oom"] = False
    except torch.cuda.OutOfMemoryError as e:
        rec.update(oom=True, error=str(e).splitlines()[0][:200],
                   peak_bytes=None, temp_bytes=None)
    finally:
        del args, out
        torch.cuda.synchronize(dev)
        torch.cuda.empty_cache()
    return rec


def measure_fit(cfg: ModelConfig, shape: InputShape, fit: Dict[str, Any], *,
                hybrid: bool = False, microbatches: int = 4,
                device="cuda") -> Dict[str, Any]:
    """``--measure``: the step on the card at depths walked down in whole
    periods, from one period over ``fit["depth_cut"]`` (the arguments' cut;
    at most full depth) to the first that runs within the card's memory,
    which is the cut.  So a cut below full depth has the failed run one
    period deeper just before it in ``measured``.  -> the fit record with
    ``depth_cut_args`` (the arguments' cut), ``fits`` and ``depth_cut``
    re-judged and ``measured`` (each run, deepest first)."""
    period, top = fit["depth_period"], fit["depth_cut"]
    fit = dict(fit, measured=[], depth_cut_args=top)
    depths = list(range(top or 0, 0, -period))
    if top is not None and top < cfg.num_layers:
        depths.insert(0, min(top + period, cfg.num_layers))
    cut = None
    for depth in depths:
        low = build(at_depth(cfg, depth), shape, make_host_mesh(),
                    hybrid=hybrid, microbatches=microbatches)
        m = dict(measure(low, device), argument_bytes=argument_bytes(low))
        fit["measured"].append(m)
        if not m["oom"]:
            cut = depth
            break
    fit["depth_cut"] = cut
    fit["fits"] = fit["fits"] and cut == cfg.num_layers
    return fit


# --------------------------------------------------------------------------- records

def lower_one(arch: str, shape_name: str, *, multi_pod: bool = False,
              hybrid: bool = False, microbatches: int = 4,
              serve_2d: bool = False, mesh_kind: str = "production",
              measure_on_card: bool = False) -> Dict[str, Any]:
    """The record of one combination (module docstring)."""
    cfg = get_config(arch)
    shape = SHAPES[shape_name]
    mesh = make_host_mesh() if mesh_kind == "host" else \
        make_production_mesh(multi_pod=multi_pod)
    t0 = time.time()
    low = build(cfg, shape, mesh, hybrid=hybrid, microbatches=microbatches,
                serve_2d=serve_2d)
    flops, out = count_flops(low)
    want = expected_outputs(low)
    if not _same_structure(out, want):
        raise AssertionError(f"{arch} x {shape_name}: the step's outputs are "
                             "not the trees its specs cover")
    rec = {
        "arch": arch, "shape": shape_name, "kind": shape.kind,
        "mesh": list(mesh.axis_sizes), "axes": list(mesh.axis_names),
        "devices": mesh.size, "hybrid": hybrid, "serve_2d": serve_2d,
        "microbatches": microbatches if shape.kind == "train" else 0,
        "flops": flops / mesh.size,
        "flops_program": flops,
        "bytes_accessed": None,
        "collective_bytes": None,
        "memory": {
            "argument_bytes": argument_bytes(low),
            "output_bytes": output_bytes(low, want),
            "temp_bytes": None,
            "peak_bytes": None,
            "alias_bytes": alias_bytes(low, out),
            "generated_code_bytes": None,
        },
        "not_measured": dict(NOT_MEASURED),
    }
    if mesh_kind == "host":
        mem, source = card_memory()
        fit = fit_check(cfg, shape, device_mem=mem, hybrid=hybrid,
                        microbatches=microbatches)
        fit["device_mem_source"] = source
        fit["spec_device_mem"] = int(H100_SXM.device_mem)
        if measure_on_card:
            fit = measure_fit(cfg, shape, fit, hybrid=hybrid,
                              microbatches=microbatches)
            ok = [m for m in fit["measured"] if not m["oom"]]
            if ok:
                m = ok[-1]
                rec["memory"]["temp_bytes"] = m["temp_bytes"]
                rec["memory"]["peak_bytes"] = m["peak_bytes"]
                for k in ("temp_bytes", "peak_bytes"):
                    rec["not_measured"].pop(k)
                rec["measured_depth"] = m["depth"]
        rec.update(fit)
    rec["compile_seconds"] = time.time() - t0
    return rec


def run_and_save(arch, shape_name, multi_pod=False, hybrid=False,
                 outdir="experiments/dryrun_torch", verbose=True,
                 microbatches=4, serve_2d=False, mesh_kind="production",
                 measure_on_card=False):
    rec = lower_one(arch, shape_name, multi_pod=multi_pod, hybrid=hybrid,
                    microbatches=microbatches, serve_2d=serve_2d,
                    mesh_kind=mesh_kind, measure_on_card=measure_on_card)
    os.makedirs(outdir, exist_ok=True)
    pod = "host" if mesh_kind == "host" else ("pod2" if multi_pod else "pod1")
    tag = f"{arch}_{shape_name}_{pod}" + ("_hybrid" if hybrid else "") + \
        ("_2d" if serve_2d else "")
    with open(os.path.join(outdir, tag + ".json"), "w") as f:
        json.dump(rec, f, indent=1)
    if verbose:
        m = rec["memory"]
        line = (f"[OK] {tag}: flops/dev={rec['flops']:.3e} "
                f"args/dev={m['argument_bytes'] / 2**30:.2f}GiB "
                f"out/dev={m['output_bytes'] / 2**30:.2f}GiB "
                f"dryrun={rec['compile_seconds']:.1f}s")
        if mesh_kind == "host":
            line += (f" fits={rec['fits']} depth_cut={rec['depth_cut']}/"
                     f"{get_config(arch).num_layers}")
            if m["peak_bytes"] is not None:
                line += f" peak={m['peak_bytes'] / 2**30:.2f}GiB"
        print(line)
    return rec


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None, choices=list(SHAPES) + [None])
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--hybrid", action="store_true",
                    help="the hybrid KV/ACT serve step instead")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--outdir", default="experiments/dryrun_torch")
    ap.add_argument("--microbatches", type=int, default=4)
    ap.add_argument("--serve2d", action="store_true",
                    help="2D weight sharding for serve shapes")
    ap.add_argument("--mesh", choices=("production", "host"),
                    default="production",
                    help="host: the (1, 1) mesh and the one-card fit check")
    ap.add_argument("--measure", action="store_true",
                    help="with --mesh host, on the card: run the step at its "
                         "depth cut and read its temporaries")
    args = ap.parse_args(argv)
    if args.measure and args.mesh != "host":
        ap.error("--measure goes with --mesh host")
    if args.measure and not torch.cuda.is_available():
        ap.error("--measure runs on the card; no CUDA device here")
    if args.mesh == "host":
        mem, source = card_memory()
        print(f"card memory: {mem} B ({source}); H100_SXM.device_mem "
              f"{int(H100_SXM.device_mem)} B")
    kw = dict(multi_pod=args.multi_pod, outdir=args.outdir,
              microbatches=args.microbatches, serve_2d=args.serve2d,
              mesh_kind=args.mesh, measure_on_card=args.measure)
    if args.all:
        failures = []
        for arch in ASSIGNED:
            for shape_name in SHAPES:
                if not applicable(arch, SHAPES[shape_name]):
                    print(f"[SKIP] {arch} x {shape_name} (DESIGN.md §4)")
                    continue
                try:
                    run_and_save(arch, shape_name, **kw)
                except Exception as e:  # noqa: BLE001
                    failures.append((arch, shape_name, repr(e)[:200]))
                    print(f"[FAIL] {arch} x {shape_name}: {e!r}"[:300])
        if failures:
            sys.exit(1)
        return
    if args.arch is None or args.shape is None:
        ap.error("--arch and --shape, or --all")
    run_and_save(args.arch, args.shape, hybrid=args.hybrid, **kw)


if __name__ == "__main__":
    main()
