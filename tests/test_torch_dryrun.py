"""The port's dry run against the reference's specs and its XLA program.

- Per-device argument and output bytes of every applicable arch x shape on
  the 16x16, 2x16x16 and host (1x1) meshes equal what the reference's specs
  imply on its ``eval_shape`` trees (params, AdamW state, batch, cache), the
  outputs being the reference's ``out_shardings``: params and AdamW state
  under their specs, the metrics and the last logits replicated, the cache
  under its specs.
- FLOPs counted on ``meta`` equal those counted on real CPU tensors.
- Against the reference's ``cost_analysis()["flops"]``: it counts per
  device (compiled on a (1, 2) mesh of this process's host devices it is
  about half the (1, 1) count), so the port's ``flops`` is the program's
  over the mesh's devices.  The port's program count is 1.97x the
  reference's on yi-6b-reduced's prefill (2 layers), because XLA counts a
  ``while`` body once and the reference's layers are a ``lax.scan``: the
  port at ONE layer counts what the reference counts at two, to the
  element-wise operations that XLA adds and FlopCounterMode does not count
  (within 2%).
- ``main`` writes a record with the reference's keys, each null field with
  its reason.

``repro.launch.dryrun`` is not imported: its import forces 512 host devices
for the whole process.  The JAX steps are lowered here."""
import dataclasses
import functools
import json
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding
from jax.sharding import PartitionSpec as JP

from _compat import abstract_mesh as AbstractMesh

from repro import sharding as JS
from repro.configs import InputShape as JInputShape
from repro.configs import get_config as j_get_config
from repro.launch import specs as JSP
from repro.optim import adamw as j_adamw
from repro_torch.configs import (ASSIGNED, SHAPES, InputShape, applicable,
                                 get_config)
from repro_torch.launch import dryrun as D
from repro_torch.launch import specs as SP
from repro_torch.launch.mesh import Mesh, make_host_mesh, make_production_mesh
from repro_torch.models import model as M
from repro_torch.optim import adamw

torch.set_num_threads(1)

MESHES = {"pod1": make_production_mesh(), "pod2":
          make_production_mesh(multi_pod=True), "host": make_host_mesh()}
# the keys of the reference's record (repro/launch/dryrun.py, lower_one)
REF_KEYS = {"arch", "shape", "kind", "mesh", "axes", "devices", "hybrid",
            "serve_2d", "microbatches", "flops", "bytes_accessed",
            "collective_bytes", "memory", "compile_seconds"}
REF_MEMORY_KEYS = {"argument_bytes", "output_bytes", "temp_bytes",
                   "peak_bytes", "alias_bytes", "generated_code_bytes"}
SDS = jax.ShapeDtypeStruct


@functools.lru_cache(maxsize=None)
def j_state(arch):
    p = JSP.params_shape(j_get_config(arch))
    return p, jax.eval_shape(j_adamw.init, p)


@functools.lru_cache(maxsize=None)
def j_out_leaves():
    """The reference's train metrics and last logits, from eval_shape of a
    reduced config's steps (their structure and dtypes are the config's
    size-free part)."""
    cfg = j_get_config("yi-6b-reduced")
    p, o = j_state("yi-6b-reduced")
    b = JSP.batch_specs_for(cfg, JInputShape("t", 32, 2, "train"),
                            with_labels=True)
    metrics = jax.eval_shape(JSP.make_train_step(cfg), p, o, b)[2]
    logits = jax.eval_shape(JSP.make_decode_step(cfg), p, SDS((2, 1), jnp.int32),
                            JSP.cache_shape(cfg, 2, 32))[0]
    return metrics, logits.dtype


def j_bytes(tree, specs, mesh):
    """Per-device bytes that the reference's specs imply (None: replicated)."""
    sizes = dict(zip(mesh.axis_names, mesh.axis_sizes))
    leaves = jax.tree_util.tree_leaves(tree)
    if specs is None:
        spec_leaves = [JP()] * len(leaves)
    else:
        spec_leaves = jax.tree_util.tree_leaves(
            specs, is_leaf=lambda x: isinstance(x, JP))
    assert len(leaves) == len(spec_leaves)
    tot = 0
    for a, sp in zip(leaves, spec_leaves):
        div = 1
        for ax in tuple(sp):
            for name in (ax if isinstance(ax, tuple) else
                         (() if ax is None else (ax,))):
                div *= sizes[name]
        n = math.prod(a.shape) * jnp.dtype(a.dtype).itemsize
        assert n % div == 0
        tot += n // div
    return tot


def j_expected(arch, shape_name, mesh):
    """(argument bytes, output bytes) per device as the reference's dry run
    lays the combination out."""
    cfg, shape = j_get_config(arch), SHAPES[shape_name]
    jm = AbstractMesh(mesh.axis_sizes, mesh.axis_names)
    p, o = j_state(arch)
    train = shape.kind == "train"
    p_specs = JS.params_specs(cfg, p, jm, train=train)
    if train:
        o_specs = j_adamw.AdamWState(step=JP(), m=p_specs, v=p_specs)
        b = JSP.batch_specs_for(cfg, shape, with_labels=True)
        b_specs = JS.batch_specs(cfg, b, jm)
        metrics, _ = j_out_leaves()
        args = j_bytes(p, p_specs, jm) + j_bytes(o, o_specs, jm) + \
            j_bytes(b, b_specs, jm)
        out = j_bytes(p, p_specs, jm) + j_bytes(o, o_specs, jm) + \
            j_bytes(metrics, None, jm)
        return args, out
    B = shape.global_batch
    _, ldt = j_out_leaves()
    logits = SDS((B, 1, p["embed"].shape[0]), ldt)
    c = JSP.cache_shape(cfg, B, shape.seq_len)
    c_bytes = j_bytes(c, JS.cache_specs(cfg, c, jm), jm)
    if shape.kind == "prefill":
        b = JSP.batch_specs_for(cfg, shape, with_labels=False)
        args = j_bytes(p, p_specs, jm) + j_bytes(b, JS.batch_specs(cfg, b, jm),
                                                  jm)
    else:
        tok = SDS((B, 1), jnp.int32)
        tok_spec = JS.batch_specs(cfg, {"t": tok}, jm)["t"]
        args = j_bytes(p, p_specs, jm) + j_bytes(tok, tok_spec, jm) + c_bytes
    return args, j_bytes(logits, None, jm) + c_bytes


@pytest.mark.parametrize("mesh", MESHES)
@pytest.mark.parametrize("arch", ASSIGNED)
def test_per_device_bytes_equal_what_the_reference_specs_imply(arch, mesh):
    m = MESHES[mesh]
    for shape_name in SHAPES:
        if not applicable(arch, SHAPES[shape_name]):
            continue
        low = D.build(get_config(arch), SHAPES[shape_name], m)
        got = (D.argument_bytes(low),
               D.output_bytes(low, D.expected_outputs(low)))
        assert got == j_expected(arch, shape_name, m), shape_name


@pytest.mark.parametrize("kind", ["train", "prefill", "decode", "hybrid"])
def test_flops_on_meta_equal_flops_on_cpu_tensors(kind):
    """The step on ``meta`` is the step on real tensors (same operations,
    same shapes), and its outputs are the trees the specs cover."""
    cfg = get_config("yi-6b-reduced")
    shape = InputShape("t", 64, 4, "decode" if kind == "hybrid" else kind)
    low = D.build(cfg, shape, make_host_mesh(), hybrid=kind == "hybrid",
                  microbatches=2)
    flops, out = D.count_flops(low)
    assert D._same_structure(out, D.expected_outputs(low))
    cpu = dataclasses.replace(low, args=D.materialize(low.args, "cpu"))
    if kind == "train":        # real weights: a zero tree trains to NaN
        p = M.init_params(cfg, seed=0, device="cpu")
        cpu.args = (p, adamw.init(p), cpu.args[2])
    cpu_flops, _ = D.count_flops(cpu)
    assert flops == cpu_flops > 0


def test_flops_count_as_the_reference_counts_them():
    """See the module docstring: XLA's count is per device and counts a
    scanned layer once."""
    cfg, jcfg = get_config("yi-6b-reduced"), j_get_config("yi-6b-reduced")
    shape = InputShape("t", 64, 4, "prefill")
    jshape = JInputShape("t", 64, 4, "prefill")
    jp = JSP.params_shape(jcfg)
    jb = JSP.batch_specs_for(jcfg, jshape, with_labels=False)
    jflops = {}
    for dims in ((1, 1), (1, 2)):
        jm = jax.make_mesh(dims, ("data", "model"))
        sh = lambda t: jax.tree.map(lambda s: NamedSharding(jm, s), t,
                                    is_leaf=lambda x: isinstance(x, JP))
        fn = jax.jit(JSP.make_prefill_step(jcfg, 64),
                     in_shardings=(sh(JS.params_specs(jcfg, jp, jm,
                                                      train=False)),
                                   sh(JS.batch_specs(jcfg, jb, jm))))
        ca = fn.lower(jp, jb).compile().cost_analysis()
        jflops[dims] = (ca[0] if isinstance(ca, list) else ca)["flops"]
    assert 0.45 < jflops[(1, 2)] / jflops[(1, 1)] < 0.55   # per device

    two = D.build(cfg, shape, Mesh((1, 2), ("data", "model")))
    flops2, _ = D.count_flops(two)
    ratio = flops2 / jflops[(1, 1)]
    assert ratio == pytest.approx(1.97, abs=0.02)
    one, _ = D.count_flops(D.build(D.at_depth(cfg, 1), shape, make_host_mesh()))
    assert one == pytest.approx(jflops[(1, 1)], rel=0.02) and one < \
        jflops[(1, 1)]


def test_main_writes_a_record_with_the_reference_keys(tmp_path):
    D.main(["--arch", "yi-6b-reduced", "--shape", "train_4k", "--mesh",
            "host", "--outdir", str(tmp_path)])
    D.main(["--arch", "yi-6b-reduced", "--shape", "decode_32k", "--hybrid",
            "--multi-pod", "--outdir", str(tmp_path)])
    for tag in ("yi-6b-reduced_train_4k_host",
                "yi-6b-reduced_decode_32k_pod2_hybrid"):
        rec = json.loads((tmp_path / (tag + ".json")).read_text())
        assert REF_KEYS <= set(rec) and set(rec["memory"]) == REF_MEMORY_KEYS
        nulls = [k for k in REF_KEYS if rec[k] is None] + \
            [k for k, v in rec["memory"].items() if v is None]
        assert nulls and all(k in rec["not_measured"] for k in nulls)
        assert rec["flops"] > 0 and rec["memory"]["argument_bytes"] > 0
    host = json.loads((tmp_path / "yi-6b-reduced_train_4k_host.json")
                      .read_text())
    assert host["fits"] and host["depth_cut"] == 2
    # params, m and v are updated in place; the metrics and AdamW's step
    # count (int32) are new tensors
    assert host["memory"]["alias_bytes"] == host["memory"]["output_bytes"] \
        - 4 * len(D.TRAIN_METRICS) - 4
    with pytest.raises(SystemExit):
        D.main(["--arch", "yi-6b", "--shape", "decode_32k", "--measure"])


def test_fit_check_states_a_depth_cut_in_whole_periods():
    """gemma3-27b's decode_32k does not fit one card; its cut is a whole
    number of 6-layer periods whose arguments fit, one more period would
    not."""
    cfg = get_config("gemma3-27b")
    mem = 80 * 2**30
    fit = D.fit_check(cfg, SHAPES["decode_32k"], device_mem=mem)
    assert not fit["fits"] and fit["depth_period"] == 6
    cut = fit["depth_cut"]
    assert cut % 6 == 0 and fit["argument_bytes_cut"] <= mem
    more = D.build(D.at_depth(cfg, cut + 6), SHAPES["decode_32k"],
                   make_host_mesh())
    assert D.argument_bytes(more) > mem


@pytest.mark.parametrize("arch,shape_name,temp_gib", [
    ("yi-6b", "decode_32k", 18), ("yi-6b", "decode_32k", 0),
    ("whisper-base", "prefill_32k", 31)])
def test_measure_fit_finds_the_deepest_depth_that_runs(monkeypatch, arch,
                                                       shape_name, temp_gib):
    """``--measure``'s walk, with the card's run stood in by a model of
    it: the step needs its arguments plus fixed temporaries, and an
    allocation past the card fails before any peak is read (as yi-6b's
    decode_32k does on the card with 18 GiB: the plain decode attention's
    float32 copies of a layer's K and V; whisper-base's prefill_32k fits
    whole with 31 GiB)."""
    cfg, shape, mem = get_config(arch), SHAPES[shape_name], 80 * 2**30
    temp, L = temp_gib * 2**30, cfg.num_layers

    def run(low, device="cuda"):
        a = D.argument_bytes(low)
        rec = {"depth": low.cfg.num_layers, "resident_bytes": a}
        if a + temp > mem:
            return dict(rec, oom=True, peak_bytes=None, temp_bytes=None)
        return dict(rec, oom=False, peak_bytes=a + temp, temp_bytes=temp)

    monkeypatch.setattr(D, "measure", run)
    fit = D.measure_fit(cfg, shape, D.fit_check(cfg, shape, device_mem=mem))
    want = max(k for k in range(1, L + 1) if D.argument_bytes(D.build(
        D.at_depth(cfg, k), shape, make_host_mesh())) + temp <= mem)
    assert fit["depth_cut"] == want and fit["fits"] == (want == L)
    # from one period over the arguments' cut (at most full depth) down to
    # the first depth that runs: a cut below full depth is bracketed by the
    # failed run one period deeper
    top = fit["depth_cut_args"]
    depths = ([top + 1] if top < L else []) + list(range(top, want - 1, -1))
    assert [m["depth"] for m in fit["measured"]] == depths
    assert [m["oom"] for m in fit["measured"]] == [True] * (len(depths) - 1) \
        + [False]
