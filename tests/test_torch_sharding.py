"""The port's partition rules make the reference's decisions.

``repro_torch.sharding`` reads shapes and mesh sizes only, so it is held to
``repro.sharding`` decision for decision on the abstract 16x16 and 2x16x16
meshes of ``tests/test_sharding.py``: every spec and every ``ShardLog``
entry ``(key, dim, size, want, got, reason)``, in order, for every config in
the registry, serving, training and 2D, and for the decode, hybrid and
batch-1 caches and the batches of every shape.  Nothing is allocated: the
port's trees are tensors on ``meta``, the reference's ``eval_shape``
structs."""
import functools

import jax
import pytest
import torch
from jax.sharding import PartitionSpec as JP

from _compat import abstract_mesh as AbstractMesh

from repro import sharding as JS
from repro.configs import REGISTRY as J_REGISTRY
from repro.configs import SHAPES as J_SHAPES
from repro.configs import get_config as j_get_config
from repro.launch import specs as JSP
from repro_torch.configs import REGISTRY, SHAPES, get_config
from repro_torch.launch import mesh as PM
from repro_torch.launch import specs as SP
from repro_torch.models.transformer import family
from repro_torch import sharding as S
from repro_torch.sharding import rules as R

torch.set_num_threads(1)

MESHES = {"16x16": ((16, 16), ("data", "model")),
          "2x16x16": ((2, 16, 16), ("pod", "data", "model"))}
# (train, weights_2d): serving, training, 2D serving, and both flags
MODES = {"serve": (False, False), "train": (True, False),
         "serve2d": (False, True), "train2d": (True, True)}
NAMES = sorted(REGISTRY)


def meshes(key):
    sizes, names = MESHES[key]
    return PM.Mesh(sizes, names), AbstractMesh(sizes, names)


@functools.lru_cache(maxsize=None)
def trees(name):
    """(port params on meta, reference params by eval_shape)."""
    return (SP.params_shape(get_config(name)),
            JSP.params_shape(j_get_config(name)))


def j_flat(tree):
    return {"/".join(JS.rules._key_str(k) for k in path): tuple(spec)
            for path, spec in jax.tree_util.tree_flatten_with_path(
                tree, is_leaf=lambda x: isinstance(x, JP))[0]}


def flat(tree):
    return {"/".join(path): spec for path, spec in R._flatten(tree)}


def decisions(log):
    return [(d.key, d.dim, d.size, d.want, d.got, d.reason)
            for d in log.decisions]


def test_registries_agree():
    assert set(REGISTRY) == set(J_REGISTRY)
    assert list(SHAPES) == list(J_SHAPES)


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("mesh", MESHES)
@pytest.mark.parametrize("name", NAMES)
def test_param_specs_and_decisions_equal_the_reference(name, mesh, mode):
    train, w2 = MODES[mode]
    m, jm = meshes(mesh)
    p, jp = trees(name)
    log, jlog = S.ShardLog(), JS.ShardLog()
    got = S.params_specs(get_config(name), p, m, train=train, weights_2d=w2,
                         log=log)
    want = JS.params_specs(j_get_config(name), jp, jm, train=train,
                           weights_2d=w2, log=jlog)
    assert flat(got) == j_flat(want)
    assert decisions(log) == decisions(jlog)
    assert [d.dropped for d in log.decisions] == \
        [d.dropped for d in jlog.decisions]
    S.check_plan(got, log)
    if mode == "train" and mesh == "2x16x16":
        assert S.explain(get_config(name), got, log) == \
            JS.explain(j_get_config(name), want, jlog)


def _caches(name):
    """(label, port cache, reference cache) for the decode cache of
    decode_32k's batch, the hybrid cache at the dry run's split and the
    batch-1 long-context cache."""
    cfg, jcfg = get_config(name), j_get_config(name)
    out = [("decode", SP.cache_shape(cfg, 128, 1024),
            JSP.cache_shape(jcfg, 128, 1024)),
           ("batch1", SP.cache_shape(cfg, 1, 524288),
            JSP.cache_shape(jcfg, 1, 524288))]
    try:
        h = SP.hybrid_cache_shape(cfg, 128, 512, 528)
    except NotImplementedError:
        # the port's hybrid KV/ACT functions refuse the family, as the
        # reference's hybrid step and engine assert the uniform and
        # windowed families
        assert family(cfg) not in ("uniform", "windowed") or cfg.frontend \
            != "none"
        return out
    out.append(("hybrid", h, JSP.hybrid_cache_shape(jcfg, 128, 512, 528)))
    return out


@pytest.mark.parametrize("mesh", MESHES)
@pytest.mark.parametrize("name", sorted(set(n for n in NAMES
                                            if not n.startswith("opt-"))
                                        | {"opt-6.7b"}))
def test_cache_and_batch_specs_equal_the_reference(name, mesh):
    m, jm = meshes(mesh)
    cfg, jcfg = get_config(name), j_get_config(name)
    for label, c, jc in _caches(name):
        assert sorted(c) == sorted(jc), label
        assert {k: tuple(v.shape) for k, v in c.items()} == \
            {k: tuple(v.shape) for k, v in jc.items()}, label
        log, jlog = S.ShardLog(), JS.ShardLog()
        got = S.cache_specs(cfg, c, m, log=log)
        want = JS.cache_specs(jcfg, jc, jm, log=jlog)
        assert got == {k: tuple(v) for k, v in want.items()}, label
        assert decisions(log) == decisions(jlog), label
        S.check_plan(got, log)
    for shape in SHAPES.values():
        b = SP.batch_specs_for(cfg, shape, with_labels=shape.kind == "train")
        jb = JSP.batch_specs_for(jcfg, J_SHAPES[shape.name],
                                 with_labels=shape.kind == "train")
        assert S.batch_specs(cfg, b, m) == \
            {k: tuple(v) for k, v in JS.batch_specs(jcfg, jb, jm).items()}
    assert S.batch_axes(m) == JS.batch_axes(jm)


def test_context_parallel_batch1_cache_is_sequence_sharded():
    """The batch-1 branch: the sequence dim takes 'data' (and 'model' where
    the kv heads are too few), as the reference's test states it."""
    m, _ = meshes("16x16")
    cfg = get_config("gemma3-27b")
    gk = S.cache_specs(cfg, SP.cache_shape(cfg, 1, 524288), m)["global_k"]
    assert gk[1] is None and gk[2] == "data"


def test_the_mesh_reads_as_the_reference_mesh():
    for key, (sizes, names) in MESHES.items():
        m, jm = meshes(key)
        assert m.axis_names == tuple(jm.axis_names)
        assert m.shape == dict(jm.shape)
        assert m.size == jm.size
    assert PM.make_production_mesh() == meshes("16x16")[0]
    assert PM.make_production_mesh(multi_pod=True) == meshes("2x16x16")[0]
    assert PM.make_host_mesh().shape == {"data": 1, "model": 1}
    dm = PM.make_test_mesh(1, 2, device="cpu")
    assert dm.shape == {"data": 1, "model": 2} and dm.axis_names == \
        tuple(meshes("16x16")[1].axis_names)
    with pytest.raises(ValueError):
        PM.make_test_mesh(0, 2, device="cpu")
    with pytest.raises(ValueError):
        PM.Mesh((2, 2), ("data",))


def test_check_plan_catches_a_contradiction():
    m, _ = meshes("16x16")
    cfg = get_config("yi-6b-reduced")
    log = S.ShardLog()
    specs = S.params_specs(cfg, SP.params_shape(cfg), m, train=True, log=log)
    specs["embed"] = ("model", "model")
    with pytest.raises(AssertionError):
        S.check_plan(specs, log)
