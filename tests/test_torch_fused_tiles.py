"""The fused mode's tile algorithm, on the CPU.

On the card ``hybrid_paged_attention`` runs three kernels: a norm pass (each
ACT row normed once and rounded to the cache dtype), a tile pass over
``tile_plan``'s tiles of four table entries (each tile's ACT rows projected
by ``wk``/``wv`` as one block and rounded, its KV rows read from the pools,
the tile attended with its own (m, l)), and a combine pass that merges the
tiles.  Here: the plan covers every table entry exactly once from the
table's width alone, and the same algorithm in plain PyTorch
(``hybrid_paged_attention_tiled_ref``) equals the plain version over the
whole row and, at a zero LayerNorm bias, the Pallas kernel in interpret
mode, as ``tests/test_kernels.py`` runs it, with the JAX model's own layer
weights carried across by ``params.from_numpy``.  Also the wrapper's refusal
of the shapes the kernels cannot take, and its scratch layout.

Tolerances, float32: 2e-6 absolute on outputs of unit scale and on m, 2e-6
relative on l against the plain version (the same roundings; per-tile
partials merged agree with the one-pass softmax up to a few float32
roundings, and a projection of 4 pages against one of all pages sums in
another order); 1e-5 absolute against the Pallas kernel, as
``tests/test_torch_kernels.py`` holds the plain version to it (two float32
softmax and dot orders at unit-scale inputs)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as j_get_config
from repro.kernels.hybrid_attention.kernel import hybrid_paged_attention as j_hybrid
from repro.models import model as JM
from repro_torch import params as P
from repro_torch.kernels.hybrid_attention.ops import (
    D_MODEL_STEP, MAX_TILES, _check_fused, fused_scratch_bytes)
from repro_torch.kernels.hybrid_attention.ref import (
    TILE_PAGES, hybrid_paged_attention_ref, hybrid_paged_attention_tiled_ref,
    tile_plan)
from repro_torch.models import model as M
from repro_torch.models.quant_ops import quantize

torch.set_num_threads(1)
TOL = 2e-6
PALLAS_TOL = 1e-5
t = torch.from_numpy


@pytest.mark.parametrize("maxp", [0, 1, 3, 4, 5, 7, 8, 9, 64, 1000])
def test_tile_plan_covers_every_entry_once(maxp):
    """The plan takes one host integer (the table's width) and returns two:
    no tensor value is read.  Tile t takes entries [4t, min(4t + 4, maxp));
    a row of no entry gets one empty tile."""
    n_tiles, ppt = tile_plan(maxp)
    assert type(n_tiles) is int and type(ppt) is int
    assert ppt == TILE_PAGES and n_tiles >= 1
    seen = np.zeros(maxp, int)
    for tile in range(n_tiles):
        lo, hi = tile * ppt, min((tile + 1) * ppt, maxp)
        assert lo < hi or maxp == 0          # no tile past the row's end
        seen[lo:hi] += 1
    assert (seen == 1).all()
    assert n_tiles == max(1, -(-maxp // TILE_PAGES))


def _pools(rng, B, KVH, D, d, kv_cap, act_cap, G, bias):
    f = lambda *sh, s=1.0, o=0.0: t((rng.standard_normal(sh) * s + o)
                                    .astype(np.float32))
    kp = f(B * kv_cap // 16, 16, KVH, D, s=0.5)
    vp = f(B * kv_cap // 16, 16, KVH, D, s=0.5)
    ap = f(B * act_cap // 16, 16, d, o=0.1)
    q = f(B, KVH, G, D)
    scale = f(d, s=0.1, o=1.0)
    bi = f(d, s=bias)
    wk, wv = f(d, KVH, D, s=d ** -0.5), f(d, KVH, D, s=d ** -0.5)
    return q, kp, vp, ap, scale, bi, wk, wv


def _engine_tables(kv_tok, act_tok, kv_cap, act_cap, width):
    return M.hybrid_page_table(torch.tensor(kv_tok, dtype=torch.int32),
                               torch.tensor(act_tok, dtype=torch.int32),
                               kv_cap, act_cap, width)


def _holes(B, width, kv_cap, act_cap, seed):
    """Tables the engine does not build: KV and ACT entries interleaved,
    type-2 holes between live entries, short pages anywhere."""
    rng = np.random.default_rng(seed)
    pty = rng.integers(0, 3, (B, width))
    pty[-1] = 2                                # and a row with no token
    n_kv, n_act = kv_cap // 16, act_cap // 16
    pt = np.where(pty == 0, rng.integers(0, n_kv, (B, width)),
                  rng.integers(0, n_act, (B, width)))
    pt = pt + np.where(pty == 0, n_kv, n_act) * np.arange(B)[:, None]
    pn = np.where(pty == 2, 0, rng.integers(1, 17, (B, width)))
    return tuple(t(a.astype(np.int32)) for a in (pt, pty, pn))


# (kv tokens, act tokens) per request at a table 7 entries wide (two tiles,
# the second ragged): a tile holding KV and ACT entries, a KV-only and an
# ACT-only request, and a request with no token
TABLES = {"mixed": ([40, 17, 96, 0], [24, 47, 16, 70]),
          "empty_request": ([33, 0, 17, 0], [10, 0, 43, 0]),
          "kv_only": ([64, 5, 31, 100], [0, 0, 0, 0]),
          "act_only": ([0, 0, 0, 0], [48, 1, 30, 100])}


@pytest.mark.parametrize("table", sorted(TABLES) + ["holes"])
@pytest.mark.parametrize("G", [1, 4, 8])
@pytest.mark.parametrize("mode", ["fp", "int8", "fp_lse", "int8_lse"])
@pytest.mark.parametrize("norm", ["layernorm", "rmsnorm"])
def test_tiled_equals_plain(table, G, mode, norm):
    rng = np.random.default_rng(G + 10 * len(table) + len(mode))
    B, KVH, D, d, cap, width = 4, 2, 32, 64, 128, 7
    q, kp, vp, ap, scale, bi, wk, wv = _pools(rng, B, KVH, D, d, cap, cap, G,
                                              bias=0.3)
    tabs = _holes(B, width, cap, cap, G) if table == "holes" else \
        _engine_tables(*TABLES[table], cap, cap, width)
    sc = {}
    if mode.startswith("int8"):
        (kp, ks), (vp, vs), (ap, as_) = quantize(kp), quantize(vp), quantize(ap)
        sc = {"k_scales": ks, "v_scales": vs, "act_scales": as_}
    lse = mode.endswith("lse")
    args = (q, kp, vp, ap, scale, bi if norm == "layernorm" else None, wk, wv,
            *tabs)
    got = hybrid_paged_attention_tiled_ref(*args, norm_type=norm,
                                           return_lse=lse, **sc)
    want = hybrid_paged_attention_ref(*args, norm_type=norm, return_lse=lse,
                                      **sc)
    if not lse:
        got, want = (got,), (want,)
    o = got[0]
    assert o.dtype == torch.float32 and torch.isfinite(o).all()
    torch.testing.assert_close(o, want[0], atol=TOL, rtol=0)
    if lse:
        torch.testing.assert_close(got[1], want[1], atol=TOL, rtol=0)
        torch.testing.assert_close(got[2], want[2], atol=0, rtol=TOL)
    empty = (tabs[1] == 2).all(1) | (tabs[2] == 0).all(1)
    assert (o[empty] == 0).all()               # zeros, and the empty stats
    if lse:
        assert (got[1][empty] == -1e30).all() and (got[2][empty] == 0).all()


@pytest.mark.parametrize("width", [0, 1, 4, 5, 8, 9])
def test_tiled_at_every_table_width(width):
    """Widths at, below and past a tile's four entries (and none at all):
    the last tile's entries past the row's end are empty."""
    rng = np.random.default_rng(width)
    B, KVH, D, d, cap = 3, 2, 16, 64, 144
    q, kp, vp, ap, scale, bi, wk, wv = _pools(rng, B, KVH, D, d, cap, cap, 2,
                                              bias=0.3)
    kv_tok = [min(width, 3) * 16 - 5, 0, 16]
    act_tok = [max(0, width - 3) * 16, width * 16 - 9, 0]
    tabs = _engine_tables([max(0, k) for k in kv_tok],
                          [max(0, a) for a in act_tok], cap, cap, width)
    args = (q, kp, vp, ap, scale, bi, wk, wv, *tabs)
    got = hybrid_paged_attention_tiled_ref(*args, return_lse=True)
    want = hybrid_paged_attention_ref(*args, return_lse=True)
    for g, w in zip(got, want):
        assert g.shape == w.shape
    torch.testing.assert_close(got[0], want[0], atol=TOL, rtol=0)
    torch.testing.assert_close(got[1], want[1], atol=TOL, rtol=0)
    torch.testing.assert_close(got[2], want[2], atol=0, rtol=TOL)


@pytest.mark.parametrize("dtype", [torch.float16, torch.bfloat16])
def test_tiled_in_cache_dtype_within_rounding(dtype):
    """In the cache dtype both round the normed rows and the recomputed K/V
    at the same points; the tiled version rounds its output once, after the
    merge, as the combine pass does.  A K/V element whose float32 sum falls
    on the other side of a rounding boundary moves a score by one ulp of K,
    so the outputs agree within 4 ulps of the largest, chip_smoke.py's
    limit for the kernel."""
    rng = np.random.default_rng(11)
    B, KVH, D, d, cap = 4, 2, 32, 64, 128
    q, kp, vp, ap, scale, bi, wk, wv = (x.to(dtype) for x in _pools(
        rng, B, KVH, D, d, cap, cap, 4, bias=0.3))
    tabs = _engine_tables(*TABLES["mixed"], cap, cap, 7)
    args = (q, kp, vp, ap, scale, bi, wk, wv, *tabs)
    got = hybrid_paged_attention_tiled_ref(*args)
    want = hybrid_paged_attention_ref(*args)
    ulp = 2.0 ** -{torch.float16: 10, torch.bfloat16: 7}[dtype]
    top = want.float().abs().max()
    assert got.dtype == dtype
    assert (got.float() - want.float()).abs().max() <= 4 * ulp * top


@pytest.mark.parametrize("norm", ["layernorm", "rmsnorm"])
@pytest.mark.parametrize("G", [1, 4])
def test_tiled_matches_pallas_with_model_weights(norm, G):
    """The JAX model's layer-0 ln1 scale and wk/wv (opt-6.7b-reduced's
    initialisation, scale perturbed), carried across by
    ``params.from_numpy``, at a zero bias: the Pallas kernel and its ref
    drop the bias, so only there are they an oracle (fault A)."""
    jcfg = j_get_config("opt-6.7b-reduced")
    jp = JM.init_params(jcfg, jax.random.PRNGKey(0))
    lp = jax.tree.map(lambda a: np.array(a[0]), jp["layers"])
    rng = np.random.default_rng(12 + G)
    d, D = jcfg.d_model, jcfg.head_dim
    KVH = jcfg.num_kv_heads
    lp["ln1"]["scale"] = (1 + 0.1 * rng.standard_normal(d)).astype(np.float32)
    lp["ln1"]["bias"] = np.zeros(d, np.float32)
    tp = P.from_numpy(lp, "cpu")
    wk = tp["attn"]["wk"].reshape(d, KVH, D)
    wv = tp["attn"]["wv"].reshape(d, KVH, D)
    B, cap, width = 3, 96, 6
    q = rng.standard_normal((B, KVH, G, D)).astype(np.float32)
    kp, vp = ((rng.standard_normal((B * cap // 16, 16, KVH, D)) * 0.5)
              .astype(np.float32) for _ in range(2))
    ap = (rng.standard_normal((B * cap // 16, 16, d)) + 0.1).astype(np.float32)
    tabs = _engine_tables([40, 0, 17], [35, 70, 0], cap, cap, width)
    got = hybrid_paged_attention_tiled_ref(
        t(q), t(kp), t(vp), t(ap), tp["ln1"]["scale"],
        tp["ln1"]["bias"] if norm == "layernorm" else None, wk, wv, *tabs,
        norm_type=norm, return_lse=True)
    jargs = [jnp.asarray(a) for a in (q, kp, vp, ap, lp["ln1"]["scale"],
                                      wk.numpy(), wv.numpy(),
                                      *(x.numpy() for x in tabs))]
    want = j_hybrid(*jargs, norm_type=norm, interpret=True, return_lse=True)
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]),
                               atol=PALLAS_TOL)
    np.testing.assert_allclose(got[1].numpy(), np.asarray(want[1]),
                               atol=PALLAS_TOL)
    np.testing.assert_allclose(got[2].numpy(), np.asarray(want[2]),
                               rtol=PALLAS_TOL)


def _refusal_args(D=32, d=64, G=2, maxp=7, dtype=torch.float16):
    B, KVH = 2, 2
    z = lambda *sh, dt=dtype: torch.zeros(sh, dtype=dt)
    tabs = tuple(z(B, maxp, dt=torch.int32) for _ in range(3))
    return (z(B, KVH, G, D), z(4, 16, KVH, D), z(4, 16, KVH, D), z(4, 16, d),
            (None, None, None), z(d), z(d), z(d, KVH, D), z(d, KVH, D), tabs,
            "layernorm")


@pytest.mark.parametrize("bad", [dict(D=24), dict(D=144), dict(d=96),
                                 dict(G=9), dict(maxp=MAX_TILES * TILE_PAGES + 1),
                                 dict(dtype=torch.float32)])
def test_wrapper_refuses_what_the_kernels_cannot_take(bad):
    """A head_dim that is no multiple of 16 or over 128, a d_model that is
    no multiple of 64, G over 8, more tiles than the combine pass merges,
    float32: refused loudly before any launch, never sent down another
    path (on the CPU the wrapper takes the plain version, so the check is
    called as the CUDA branch calls it)."""
    _check_fused(*_refusal_args())                 # the reference shape passes
    with pytest.raises(ValueError, match="hybrid_paged_attention"):
        _check_fused(*_refusal_args(**bad))


def test_fused_scratch_layout():
    """The partials (float32) first, the normed rows (the cache dtype) from
    a 256-byte boundary, each sized by the tile plan, as the C side's
    fused_rows_offset lays them out."""
    B, KVH, G, D, d = 4, 32, 1, 128, 4096
    n_tiles = tile_plan(7)[0]
    total, off = fused_scratch_bytes(B, KVH, G, D, d, n_tiles, 2)
    assert off % 256 == 0 and off >= B * KVH * n_tiles * G * (D + 2) * 4
    assert off - B * KVH * n_tiles * G * (D + 2) * 4 < 256
    assert total - off == B * n_tiles * TILE_PAGES * 16 * d * 2
    assert d % D_MODEL_STEP == 0
