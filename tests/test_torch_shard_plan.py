"""The port's ShardPlan makes the reference's decisions and lays tensors out
where the reference's shardings put them.

Held to ``repro.sharding.make_shard_plan`` on real (data, model) meshes of
the forced host devices the conftest arms, built with ``AxisType.Auto``
axes (``jax.make_mesh`` gives Explicit axes in JAX 0.9, on which the
reference's vocab-sharded gather raises): ``explain()`` line for line, the
shard factors, every ``cache_spec``, ``device_slices`` against
``devices_indices_map`` for every param leaf, each position's resident bytes
against the dry run's ``leaf_bytes``, ``scale_for_shards`` field for field,
the ``BlockManager``'s per-shard accounting, and ``shardhints``' resolution
against the cases of ``tests/test_shardhints.py``.  Two of the sharded
path's trouble spots are here too: heads that do not divide the model axis
(yi's one KV head) and argmax ties across vocabulary slices."""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import AxisType, Mesh as JMesh, PartitionSpec as JP

from _compat import abstract_mesh as AbstractMesh

from repro.configs import get_config as j_get_config
from repro.core import blocks as j_blocks
from repro.core import costmodel as j_cm
from repro.models import model as JM
from repro.models import shardhints as JSH
from repro.sharding import make_shard_plan as j_make_shard_plan
from repro_torch import params as P
from repro_torch.configs import get_config
from repro_torch.core import blocks, costmodel as cm
from repro_torch.launch import dryrun
from repro_torch.launch.mesh import Mesh, make_test_mesh
from repro_torch.models import shardhints as SH
from repro_torch.models import sharded as SHD
from repro_torch.sharding import collectives as C
from repro_torch.sharding import make_shard_plan, place, rules

torch.set_num_threads(1)

CONFIGS = ["opt-6.7b-reduced", "yi-6b-reduced"]
MESHES = [(1, 2), (2, 2)]


def j_mesh(d, m):
    devs = jax.devices()
    assert len(devs) >= d * m, \
        "needs XLA_FLAGS=--xla_force_host_platform_device_count=4 (conftest)"
    return JMesh(np.array(devs[:d * m]).reshape(d, m), ("data", "model"),
                 axis_types=(AxisType.Auto,) * 2)


@functools.lru_cache(maxsize=None)
def setup(name):
    jcfg = j_get_config(name)
    jp = JM.init_params(jcfg, jax.random.PRNGKey(0))
    tp = P.from_numpy(jax.tree.map(np.asarray, jp), device="cpu")
    return get_config(name), tp, jcfg, jp


def plans(name, shape):
    cfg, tp, jcfg, jp = setup(name)
    return (make_shard_plan(cfg, make_test_mesh(*shape, device="cpu"), tp),
            j_make_shard_plan(jcfg, j_mesh(*shape), jp))


def j_leaves(tree):
    return {"/".join(str(k.key) for k in path): leaf for path, leaf in
            jax.tree_util.tree_flatten_with_path(
                tree, is_leaf=lambda x: isinstance(x, JP))[0]}


@pytest.mark.parametrize("shape", MESHES, ids=lambda s: f"{s[0]}x{s[1]}")
@pytest.mark.parametrize("name", CONFIGS)
def test_plan_equals_the_reference_plan(name, shape):
    plan, jplan = plans(name, shape)
    assert plan.explain().splitlines() == jplan.explain().splitlines()
    for f in ("data_shards", "model_shards", "kv_head_shards", "act_shards",
              "shard_factor"):
        assert getattr(plan, f) == getattr(jplan, f), f
    cfg = plan.cfg
    for B in (1, 2, 3, 4):
        shapes = {"k": (2, B, 64, cfg.num_kv_heads, cfg.head_dim),
                  "v": (2, B, 64, cfg.num_kv_heads, cfg.head_dim),
                  "act": (2, B, 64, cfg.d_model), "act_pos": (B, 64),
                  "kv_len": (B,), "act_len": (B,), "other": (B, 3)}
        for key, shp in shapes.items():
            assert plan.cache_spec(key, shp) == tuple(jplan.cache_spec(key, shp)), \
                (key, B)
    # opt's 8 KV heads split; yi-reduced's one falls back to factor 1
    assert (plan.shard_factor == shape[1]) == (name == "opt-6.7b-reduced")


@pytest.mark.parametrize("shape", MESHES, ids=lambda s: f"{s[0]}x{s[1]}")
@pytest.mark.parametrize("name", CONFIGS)
def test_slices_and_resident_bytes_follow_the_specs(name, shape):
    """Every param leaf's per-position slice is ``devices_indices_map``'s,
    the placed shard equals that slice of the tensor, and each position
    holds exactly the bytes its spec implies."""
    cfg, tp, jcfg, jp = setup(name)
    plan, jplan = plans(name, shape)
    jspecs = j_leaves(jplan.param_specs)
    specs = dict(rules._flatten(plan.param_specs))
    placed = plan.place_params(tp)
    jdevs = list(jplan.mesh.devices.flat)
    for path, t in rules._flatten(tp):
        key = "/".join(path)
        assert specs[path] == tuple(jspecs[key]), key
        mine = plan.device_slices(specs[path], t.shape)
        want = jplan.device_slices(jspecs[key], t.shape)
        x = placed
        for k in path:
            x = x[k]
        for pos in plan.mesh.positions:
            assert mine[pos] == want[jdevs[pos.index]], (key, pos)
            assert torch.equal(x.shard(pos), t[mine[pos]])
            assert x.nbytes(pos) == dryrun.leaf_bytes(t, specs[path],
                                                      plan.mesh), key
        assert torch.equal(x.full(), t)
    cache = {"k": torch.zeros(2, 4, 32, cfg.num_kv_heads, cfg.head_dim),
             "act": torch.zeros(2, 4, 32, cfg.d_model),
             "kv_len": torch.zeros(4, dtype=torch.int32)}
    for key, x in plan.place_cache(cache).items():
        for pos in plan.mesh.positions:
            assert x.nbytes(pos) == dryrun.leaf_bytes(cache[key], x.spec,
                                                      plan.mesh)


@pytest.mark.parametrize("shards", [1, 2, 4])
def test_scale_for_shards_and_per_shard_blocks_equal_the_reference(shards):
    cfg = get_config("opt-6.7b-reduced")
    jcfg = j_get_config("opt-6.7b-reduced")
    hw = cm.H100_SXM
    jhw = j_cm.HardwareSpec(**dataclasses.asdict(hw))
    got, want = cm.scale_for_shards(hw, shards), j_cm.scale_for_shards(jhw, shards)
    # field for field (the port's spec has no inter-chip term; the
    # reference's ici_bw is not scaled)
    want = dataclasses.asdict(want)
    assert dataclasses.asdict(got) == {k: want[k] for k in
                                       dataclasses.asdict(got)}
    assert (got is hw) == (shards == 1)
    assert blocks.kv_block_bytes(cfg, shards) == j_blocks.kv_block_bytes(jcfg, shards)
    assert blocks.act_block_bytes(cfg, shards) == \
        j_blocks.act_block_bytes(jcfg, shards)
    kw = dict(host_kv_blocks=8, host_act_blocks=8, dev_kv_blocks=4,
              dev_act_blocks=4, shard_factor=shards)
    bm, jbm = blocks.BlockManager(cfg, **kw), j_blocks.BlockManager(jcfg, **kw)
    for kind, jkind in zip(blocks.BlockType, j_blocks.BlockType):
        for per in (True, False):
            assert bm.block_bytes(kind, per_shard=per) == \
                jbm.block_bytes(jkind, per_shard=per)
        for loc, jloc in zip(blocks.Location, j_blocks.Location):
            assert bm.bytes_capacity(kind, loc) == jbm.bytes_capacity(jkind, jloc)
    for m in (bm, jbm):
        m.new_request(0)
    for t in range(40):
        kinds = (blocks.BlockType.KV, j_blocks.BlockType.KV) if t % 3 else \
            (blocks.BlockType.ACT, j_blocks.BlockType.ACT)
        assert (bm.append_token(0, kinds[0]) is None) == \
            (jbm.append_token(0, kinds[1]) is None)
    assert bm.host_bytes_to_load(0) == jbm.host_bytes_to_load(0)
    assert bm.context_len(0) == jbm.context_len(0)
    assert bm.explain() == jbm.explain()


def test_shardhints_resolve_as_the_reference():
    """``_resolve`` and the drop rules of ``constrain``, on the meshes and
    shapes of ``tests/test_shardhints.py``: the reference's spec read from
    the sharding it constrains to."""
    m1 = AbstractMesh((16, 16), ("data", "model"))
    m2 = AbstractMesh((2, 16, 16), ("pod", "data", "model"))
    p1, p2 = Mesh((16, 16), ("data", "model")), Mesh((2, 16, 16),
                                                      ("pod", "data", "model"))
    for pm, jm in ((p1, m1), (p2, m2)):
        for logical in (SH.BATCH, SH.MODEL, SH.DATA, None, "nonexistent"):
            assert SH._resolve(pm, logical) == JSH._resolve(jm, logical)
    seen = {}

    def capture(x, sharding):
        seen["spec"] = tuple(sharding.spec)
        return x

    orig = jax.lax.with_sharding_constraint
    jax.lax.with_sharding_constraint = capture
    try:
        for d0, d1 in [(1, 1), (16, 16), (32, 17), (64, 64), (3, 48), (32, 32)]:
            for axes in ((SH.BATCH, SH.MODEL), (SH.MODEL, SH.MODEL),
                         (None, SH.BATCH)):
                with JSH.use_mesh(m1):
                    JSH.constrain(jnp.zeros((d0, d1)), *axes)
                assert SH.resolve_spec(p1, (d0, d1), *axes) == \
                    tuple(seen["spec"]) + (None,) * (2 - len(seen["spec"])), \
                    (d0, d1, axes)
    finally:
        jax.lax.with_sharding_constraint = orig
    # no mesh, or a plain tensor: constrain returns its input
    SH.set_mesh(None)
    x = torch.ones(4, 8)
    assert SH.constrain(x, SH.BATCH, SH.MODEL) is x
    with SH.use_mesh(p1):
        assert SH.constrain(x, SH.BATCH, SH.MODEL) is x
    assert SH.get_mesh() is None


def test_constrain_relays_a_sharded_value():
    cfg, tp, *_ = setup("opt-6.7b-reduced")
    plan, _ = plans("opt-6.7b-reduced", (2, 2))
    k = torch.arange(2 * 4 * 16 * 8 * 4, dtype=torch.float32).reshape(
        2, 4, 16, 8, 4)
    x = place(k, (None,) * 5, plan.mesh)
    C.COUNTER.reset()
    with SH.use_mesh(plan.mesh):
        y = SH.constrain(x, None, SH.BATCH, None, SH.MODEL, None)
        assert SH.constrain(y, None, SH.BATCH, None, SH.MODEL, None) is y
    assert y.spec == (None, "data", None, "model", None)
    assert torch.equal(y.full(), k) and y.shards[3].shape == (2, 2, 16, 4, 4)
    # the one real relayout is counted: every position's replica of x
    assert C.COUNTER.read() == {"relayout": 4 * k.numel() * 4,
                                "total": 4 * k.numel() * 4}


@pytest.mark.parametrize("shape", [(1, 2), (2, 2), (2, 1)],
                         ids=lambda s: f"{s[0]}x{s[1]}")
def test_constrain_keeps_a_cache_laid_out_by_cache_spec(shape):
    """The decode loop's ``constrain`` on a cache ``cache_spec`` laid out
    is that cache itself, also where an axis has size 1: the resolved spec
    names the size-1 'data' axis, ``cache_spec`` writes None there, and the
    two place every element alike.  Nothing is moved or counted."""
    cfg, tp, *_ = setup("opt-6.7b-reduced")
    plan = make_shard_plan(cfg, make_test_mesh(*shape, device="cpu"), tp)
    lay = SHD.Layout(plan)
    cache = SHD.init_cache(lay, 4, 32, 32)
    C.COUNTER.reset()
    with SH.use_mesh(plan.mesh):
        for key in ("k", "v"):
            assert SH.constrain(cache[key], None, SH.BATCH, None, SH.MODEL,
                                None) is cache[key]
        assert SH.constrain(cache["act"], None, SH.BATCH, None,
                            SH.MODEL) is cache["act"]
    assert C.COUNTER.read() == {"total": 0}


def test_heads_that_do_not_divide_gather_whole_heads():
    """yi-6b-reduced at model 2: one KV head, so the K/V cache is replicated
    (``kv_head_shards`` 1, ``shard_factor`` 1), but the serve spec still
    cuts ``wk``/``wv``'s 32 columns in the middle of the head.  They are
    stored as the spec says and gathered to the whole head before use."""
    cfg, tp, *_ = setup("yi-6b-reduced")
    plan, _ = plans("yi-6b-reduced", (1, 2))
    assert (plan.kv_head_shards, plan.act_shards, plan.shard_factor) == (1, 2, 1)
    placed = plan.place_params(tp)
    wk = placed["layers"]["attn"]["wk"]
    assert wk.spec == (None, None, "model")
    assert [tuple(s.shape) for s in wk.shards] == [(2, 256, 16)] * 2
    lay = SHD.Layout(plan)
    assert lay.wkv_gather and not lay.kv_split
    assert (lay.cfg_l.num_heads, lay.cfg_l.num_kv_heads) == (4, 1)
    row = SHD.rows_for(plan, 2)[0]
    C.COUNTER.reset()
    got = SHD._row_layers(lay, row, SHD.layer_source(placed, plan)(1))
    for lp in got:
        for key in ("wk", "wv"):
            assert torch.equal(lp["attn"][key], tp["layers"]["attn"][key][1])
    assert C.COUNTER.bytes["weights"] == 2 * 256 * 32 * 4   # two weights, m=2
    cache = SHD.init_cache(lay, 2, 32, 32)
    assert cache["k"].spec == (None, None, None, None, None)
    assert all(s.shape == (2, 2, 32, 1, 32) for s in cache["k"].shards)
    assert cache["act"].spec == (None, None, None, "model")


def test_argmax_ties_take_the_lowest_index():
    """Per-shard (max, index) pairs combine to the lowest global index among
    equal maxima, as ``jnp.argmax`` over the whole vocabulary does."""
    rng = np.random.default_rng(0)
    for m in (2, 4):
        V = 16 * m
        lg = rng.integers(0, 3, size=(64, V)).astype(np.float32)
        lg[0] = 2.0                                     # every entry ties
        lg[1, :] = 0.0
        lg[1, V - 1] = lg[1, V // m] = 1.0              # a tie across shards
        parts = [torch.from_numpy(lg[:, c * 16:(c + 1) * 16]) for c in range(m)]
        got = C.vocab_argmax(parts, [c * 16 for c in range(m)],
                             [torch.device("cpu")])[0]
        np.testing.assert_array_equal(got.numpy(), np.asarray(jnp.argmax(lg, -1)))
        assert got[0] == 0 and got[1] == V // m
