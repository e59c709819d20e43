"""The second-pool mode's split across blocks, on the CPU.

On the card ``hybrid_paged_attention_two_pool`` cuts each page-table row
into ``split_plan``'s ranges, attends each range in its own block and merges
the partials in a second kernel.  Here: the plan covers every table entry
exactly once from shapes alone, and the same algorithm in plain PyTorch
(``hybrid_paged_attention_two_pool_split_ref``: each range through the
plain version with its (m, l), folded with ``merge_partials_torch``) equals
the plain version over the whole row, in float32.  JAX has no second-pool
mode; the existing tests hold ``hybrid_paged_attention_two_pool_ref`` to the
JAX model path, and this file holds the split algorithm to that ref.

Tolerance: 2e-6 absolute on outputs of unit scale and on m, 2e-6 relative
on l; float32 partials normalised per range and merged agree with the
one-pass softmax up to a few float32 roundings."""
import numpy as np
import pytest
import torch

from repro_torch.kernels.hybrid_attention.ops import _check_two_pool, split_plan
from repro_torch.kernels.hybrid_attention.ref import (
    MAX_PAGES_PER_SPLIT, SPLIT_TARGET, hybrid_paged_attention_two_pool_ref,
    hybrid_paged_attention_two_pool_split_ref)
from repro_torch.models import model as M
from repro_torch.models.quant_ops import quantize

torch.set_num_threads(1)
TOL = 2e-6


@pytest.mark.parametrize("B", [1, 3, 4, 64])
@pytest.mark.parametrize("KVH", [1, 4, 32])
@pytest.mark.parametrize("maxp", [0, 1, 5, 7, 64, 200, 4000])
def test_split_plan_covers_every_entry_once(B, KVH, maxp):
    """The plan takes three host integers (the wrapper passes q's shape and
    the table's width) and returns two: no tensor value is read."""
    n_split, pps = split_plan(B, KVH, maxp)
    assert type(n_split) is int and type(pps) is int
    assert 1 <= n_split <= SPLIT_TARGET and 1 <= pps <= MAX_PAGES_PER_SPLIT
    seen = np.zeros(maxp, int)
    for s in range(n_split):
        lo, hi = s * pps, min((s + 1) * pps, maxp)
        assert lo < hi or maxp == 0          # no split past the row's end
        seen[lo:hi] += 1
    assert (seen == 1).all()
    # about two blocks per SM where the table is wide enough, more only
    # where a split would otherwise hold more entries than its
    # shared-memory table
    assert n_split <= max(-(-SPLIT_TARGET // (B * KVH)),
                          -(-maxp // MAX_PAGES_PER_SPLIT), 1)
    if maxp >= SPLIT_TARGET // (B * KVH) > 0:
        assert n_split * B * KVH >= SPLIT_TARGET // 2


def _case(rng, B, KVH=2, G=4, D=32, kv_cap=64, n_act=3):
    f = lambda *sh: torch.from_numpy(rng.standard_normal(sh).astype(np.float32))
    kp, vp = f(B * kv_cap // 16, 16, KVH, D), f(B * kv_cap // 16, 16, KVH, D)
    ak, av = f(B * n_act, 16, KVH, D), f(B * n_act, 16, KVH, D)
    return f(B, KVH, G, D), kp, vp, ak, av


def _tables(kv_tok, act_tok, kv_cap, n_act, width):
    return M.hybrid_page_table(torch.tensor(kv_tok, dtype=torch.int32),
                               torch.tensor(act_tok, dtype=torch.int32),
                               kv_cap, n_act * 16, width)


# (kv tokens, act tokens) per request; the table is 9 entries wide, so the
# last entries of every row are empty (type 2)
CASES = {"mixed": ([40, 17, 0], [24, 47, 16]),
         "empty_request": ([33, 0, 17], [10, 0, 43]),
         "kv_only": ([64, 5, 31], [0, 0, 0]),
         "act_only": ([0, 0, 0], [48, 1, 30])}


@pytest.mark.parametrize("case", sorted(CASES))
@pytest.mark.parametrize("plan", [None, (9, 1), (4, 3), (2, 5), (1, 9)])
@pytest.mark.parametrize("mode", ["fp", "int8", "fp_lse", "int8_lse"])
def test_split_then_combine_equals_plain(case, plan, mode):
    rng = np.random.default_rng(len(case) + 7 * (plan or (0, 0))[0])
    kv_tok, act_tok = CASES[case]
    q, kp, vp, ak, av = _case(rng, B=3)
    tabs = _tables(kv_tok, act_tok, 64, 3, 9)
    sc = {}
    if mode.startswith("int8"):
        (kp, ks), (vp, vs) = quantize(kp), quantize(vp)
        sc = {"k_scales": ks, "v_scales": vs}
    lse = mode.endswith("lse")
    args = (q, kp, vp, ak, av, *tabs)
    got = hybrid_paged_attention_two_pool_split_ref(*args, return_lse=lse,
                                                    plan=plan, **sc)
    want = hybrid_paged_attention_two_pool_ref(*args, return_lse=lse, **sc)
    if not lse:
        got, want = (got,), (want,)
    o, w = got[0], want[0]
    assert o.dtype == torch.float32 and torch.isfinite(o).all()
    torch.testing.assert_close(o, w, atol=TOL, rtol=0)
    if lse:
        torch.testing.assert_close(got[1], want[1], atol=TOL, rtol=0)
        torch.testing.assert_close(got[2], want[2], atol=0, rtol=TOL)
    if case == "empty_request":       # zeros, and the empty partition's stats
        assert (o[1] == 0).all()
        if lse:
            assert (got[1][1] == -1e30).all() and (got[2][1] == 0).all()


def test_split_with_every_range_empty_is_zero():
    """A table of empty entries only, cut into one-entry ranges: every
    partial is empty and the merge gives zeros, m = -1e30, l = 0."""
    rng = np.random.default_rng(0)
    q, kp, vp, ak, av = _case(rng, B=2)
    tabs = _tables([0, 0], [0, 0], 64, 3, 5)
    o, m, l = hybrid_paged_attention_two_pool_split_ref(
        q, kp, vp, ak, av, *tabs, return_lse=True, plan=(5, 1))
    assert (o == 0).all() and (m == -1e30).all() and (l == 0).all()


@pytest.mark.parametrize("dtype", [torch.float16, torch.bfloat16])
def test_split_in_cache_dtype_within_rounding(dtype):
    """In the cache dtype the split version rounds its output once, as the
    kernel's combine pass does: within one ulp of the plain version."""
    rng = np.random.default_rng(1)
    q, kp, vp, ak, av = (t.to(dtype) for t in _case(rng, B=3))
    tabs = _tables(*CASES["mixed"], 64, 3, 9)
    got = hybrid_paged_attention_two_pool_split_ref(q, kp, vp, ak, av, *tabs,
                                                    plan=(9, 1))
    want = hybrid_paged_attention_two_pool_ref(q, kp, vp, ak, av, *tabs)
    ulp = 2.0 ** -{torch.float16: 10, torch.bfloat16: 7}[dtype]
    assert got.dtype == dtype
    assert (got.float() - want.float()).abs().max() <= ulp * want.float().abs().max()


@pytest.mark.parametrize("bad", ["D=24", "D=272", "G=9", "float32",
                                 "int64_tables", "pool_shape"])
def test_two_pool_wrapper_refuses_what_the_kernels_cannot_take(bad):
    """The second-pool wrapper's check, called as its CUDA branch calls it
    (on the CPU the wrapper takes the plain version): a head_dim that is no
    multiple of 16 or over 256, G over 8, float32, tables that are not
    int32, a pool of another head_dim are refused before any launch."""
    D = {"D=24": 24, "D=272": 272}.get(bad, 32)
    G = 9 if bad == "G=9" else 4
    dt = torch.float32 if bad == "float32" else torch.float16
    q = torch.zeros((2, 2, G, D), dtype=dt)
    pool = torch.zeros((4, 16, 2, 16 if bad == "pool_shape" else D), dtype=dt)
    tabs = tuple(torch.zeros((2, 5), dtype=torch.int64 if bad == "int64_tables"
                             else torch.int32) for _ in range(3))
    ok = torch.zeros((4, 16, 2, 32), dtype=torch.float16)
    _check_two_pool(torch.zeros((2, 2, 4, 32), dtype=torch.float16), ok, ok, ok,
                    ok, (None, None), tuple(torch.zeros((2, 5), dtype=torch.int32)
                                           for _ in range(3)))
    with pytest.raises(ValueError, match="hybrid_paged_attention_two_pool"):
        _check_two_pool(q, pool, pool, pool, pool, (None, None), tabs)
