"""The card's flash-attention backward algorithm, on the CPU.

On the card ``flash_attention_bwd`` runs one block per (query head, request,
64-key tile): the group's heads are blocks of their own, each block visits
the query tiles that see its keys (``bwd_tiles``), recomputes S^T and dP^T,
rounds P and dS to the inputs' dtype before their products, adds dQ over the
key tiles, and writes its head's dK/dV partials, which a last pass sums over
the group in head order.  Here that algorithm in plain PyTorch
(``flash_attention_bwd_split_ref``) is held to the plain version
``flash_attention_bwd_ref`` and to ``jax.vjp`` of the reference's
``blockwise_attention`` (its custom VJP, ``_bw_attn_b``), causal, with a
sliding window and non-causal with Sk != Sq, at D 64 and 256, G 1 and 4,
lengths that are no tile multiples, float32 and bfloat16.

Tolerances.  float32 inputs (no rounding: the algorithm alone): against the
plain version 1e-5 of each output's largest entry (sums of a few hundred
terms in another order; measured at most 7.8e-7); against ``jax.vjp`` of
the reference 1e-5 (the reference's own online-softmax forward and chunked
sums; measured at most 4.9e-7).  bfloat16 inputs: against the plain version
on the same inputs (float32 throughout, outputs rounded once), 4 ulps of
bfloat16 at each output's largest entry, chip_smoke.py's limit for the
kernel (P and dS in 16 bits; measured at most 1 ulp).
"""
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import layers as JL
from repro_torch.kernels.flash_attention.ref import (
    BWD_BKV, bwd_query_tile, bwd_tiles, flash_attention_bwd_ref,
    flash_attention_bwd_split_ref, flash_attention_ref)

torch.set_num_threads(1)
REF_RTOL, JAX_RTOL, ULPS = 1e-5, 1e-5, 4

# (B, Sq, Sk, H, KVH, D, window, causal): causal at a ragged length, G 1
# and 4; a window narrower than the tiles; non-causal with Sk != Sq; D 64
# and 256
CASES = [(2, 77, 77, 4, 4, 64, 0, True),
         (1, 150, 150, 8, 2, 64, 0, True),
         (2, 131, 131, 4, 1, 256, 0, True),
         (1, 200, 200, 4, 1, 256, 40, True),
         (1, 150, 150, 4, 4, 64, 100, True),
         (2, 45, 170, 4, 1, 64, 0, False),
         (1, 70, 33, 4, 4, 256, 0, False)]


def _inputs(B, Sq, Sk, H, KVH, D, seed):
    rng = np.random.default_rng(seed)
    f = lambda *shape: rng.standard_normal(shape).astype(np.float32)
    return f(B, Sq, H, D), f(B, Sk, KVH, D), f(B, Sk, KVH, D), f(B, Sq, H, D)


def _case_args(case, dtype=torch.float32):
    B, Sq, Sk, H, KVH, D, W, causal = case
    q, k, v, do = (torch.from_numpy(a).to(dtype)
                   for a in _inputs(B, Sq, Sk, H, KVH, D, seed=Sq + Sk + D))
    o, lse = flash_attention_ref(q, k, v, W, causal, return_lse=True)
    return (q, k, v, o, lse, do), W, causal


def _rel(got, want) -> float:
    return ((got.float() - want.float()).abs().max()
            / want.float().abs().max()).item()


@pytest.mark.parametrize("case", CASES)
def test_the_tiles_cover_every_live_pair_once(case):
    """Each block's query tiles hold every query that sees one of its keys
    under the mask (a pair outside them would be dropped), each tile once,
    at most one tile that holds none of them past the mask's edge."""
    _, Sq, Sk, _, _, D, W, causal = case
    BQ = bwd_query_tile(D)
    blocks = bwd_tiles(Sq, Sk, D, W, causal)
    assert [k0 for k0, _ in blocks] == list(range(0, Sk, BWD_BKV))
    for k0, q0s in blocks:
        assert len(set(q0s)) == len(q0s) and all(q % BQ == 0 for q in q0s)
        seen = {i for q0 in q0s for i in range(q0, min(q0 + BQ, Sq))}
        for key in range(k0, min(k0 + BWD_BKV, Sk)):
            live = {i for i in range(Sq) if not causal or
                    (key <= i and (W <= 0 or key > i - W))}
            assert live <= seen


@pytest.mark.parametrize("case", CASES)
def test_split_matches_the_plain_backward_in_float32(case):
    args, W, causal = _case_args(case)
    got = flash_attention_bwd_split_ref(*args, W, causal)
    want = flash_attention_bwd_ref(*args, W, causal)
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        assert g.shape == w.shape and g.dtype == torch.float32
        assert _rel(g, w) <= REF_RTOL, name


@pytest.mark.parametrize("case", CASES)
def test_split_matches_the_reference_vjp(case):
    """Against ``jax.vjp`` of ``blockwise_attention`` (tiles of 32 queries
    and 32 keys, its custom VJP) on the same float32 inputs and cotangent."""
    args, W, causal = _case_args(case)
    q, k, v, _, _, do = (a.numpy() for a in args)
    fwd = lambda q, k, v: JL.blockwise_attention(
        q, k, v, causal=causal, window=W, q_chunk=32, k_chunk=32)
    _, vjp = jax.vjp(fwd, jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    want = vjp(jnp.asarray(do))
    got = flash_attention_bwd_split_ref(*args, W, causal)
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        assert _rel(g, torch.from_numpy(np.asarray(w))) <= JAX_RTOL, name


@pytest.mark.parametrize("case", CASES)
def test_split_in_bfloat16_within_the_cards_limit(case):
    """bfloat16 inputs: the kernel's roundings (P and dS to bfloat16 before
    their products, outputs once) against the plain version's float32 on
    the same inputs: within chip_smoke.py's 4 ulps at the largest entry."""
    args, W, causal = _case_args(case, torch.bfloat16)
    got = flash_attention_bwd_split_ref(*args, W, causal)
    want = flash_attention_bwd_ref(*args, W, causal)
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        assert g.dtype == torch.bfloat16
        tol = ULPS * 2.0 ** -7 * 2.0 ** math.floor(
            math.log2(w.float().abs().max().item()))
        assert (g.float() - w.float()).abs().max().item() <= tol, name


def test_group_partials_sum_in_head_order():
    """dK and dV are the G heads' partials summed in head order: G = 4 equals
    the sum of four G = 1 backwards, one per head of the group, taken in
    that order (within 1e-6 of the largest entry: the per-head products are
    summed by other matrix-product blockings)."""
    (q, k, v, o, lse, do), W, causal = _case_args(CASES[1])
    dq, dk, dv = flash_attention_bwd_split_ref(q, k, v, o, lse, do, W, causal)
    G = q.shape[2] // k.shape[2]
    parts = []
    for g in range(G):
        heads = list(range(g, q.shape[2], G))
        one = flash_attention_bwd_split_ref(
            q[:, :, heads], k, v, o[:, :, heads], lse[:, heads], do[:, :, heads],
            W, causal)
        parts.append(one)
        assert _rel(one[0], dq[:, :, heads]) <= 1e-6
    acc_k, acc_v = parts[0][1], parts[0][2]
    for one in parts[1:]:
        acc_k, acc_v = acc_k + one[1], acc_v + one[2]
    assert _rel(acc_k, dk) <= 1e-6 and _rel(acc_v, dv) <= 1e-6
