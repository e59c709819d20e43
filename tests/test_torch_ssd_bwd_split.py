"""The card's SSD scan backward algorithm, on the CPU.

On the card ``ssd_scan_bwd`` runs three kernels: a state pass that walks
each (head, request)'s chunks forward for their entering states and back
for the cotangents of the states leaving them, storing both as hi + lo
pieces; a chunk-parallel pass, one block per (head group, chunk, request),
whose products take those pieces and the other operands derived in float32
split into hi + lo, and which sums dB and dC over its group's heads in head
order; and a last pass that sums the groups' parts and dA's in order.  Here
that algorithm in plain PyTorch (``ssd_scan_bwd_split_ref``) is held to the
plain backward ``ssd_scan_bwd_ref`` and to ``jax.vjp`` of the reference's
``ssd_chunked`` (src/repro/models/layers.py:497), at p in {16, 64}, n in
{32, 128}, chunk in {16, 64}, chunk multiples and ragged lengths, one head
group and several; float32, bfloat16 and float16 inputs.  The dt biases are
drawn as Mamba-2 inits them (softplus(dt_bias) log-uniform in [1e-3, 1e-1],
A = -linspace(1, 16)): at the reference's zero bias a chunk's decay passes
exp()'s range above the diagonal, where XLA's gradient of ``ssd_chunked``
is NaN (ROADMAP queue 3, Q).

Tolerances, each of dx, ddt, dA, dB, dC relative to its largest reference
entry.  float32 inputs with bfloat16 pieces (16 significant bits, within
2**-17 of each operand) or float16 pieces: 5e-5 against the plain backward
(measured at most 1.4e-5 over both splits) and against ``jax.vjp``
(measured at most 1.8e-5).  bfloat16 and float16 inputs against the plain
backward on the same inputs: dx, dB, dC within chip_smoke.py's 4 ulps of
the dtype at the largest entry (measured at most 0.5 ulp), ddt and dA
within its 2**-13 (measured at most 5.0e-6).  One head group against
several: 5e-5 (the split of each group's sum of Q moves; measured at most
6.9e-6).
"""
import math

import jax
import numpy as np
import pytest
import torch

from repro.models import layers as JL
from repro_torch.kernels.ssd_scan.ref import (head_groups, split_f16,
                                              ssd_scan_bwd_ref,
                                              ssd_scan_bwd_split_ref)

torch.set_num_threads(1)
RTOL, ULPS, STATE_RTOL = 5e-5, 4, 2.0 ** -13
GRADS = ("dx", "ddt", "dA", "dB", "dC")
MANTISSA = {torch.bfloat16: 7, torch.float16: 10}

# (p, n, chunk, s, h, groups): chunk multiples and ragged lengths, one head
# group and several (groups None: the card's ``head_groups``)
CASES = [(16, 32, 16, 48, 3, 1), (16, 32, 16, 37, 3, 2), (64, 128, 64, 128, 2, None),
         (64, 128, 64, 100, 4, 3), (16, 128, 64, 70, 2, 2), (64, 32, 16, 40, 2, None)]


def _inputs(b, s, h, p, n, seed):
    """x, B, C ~ N(0, 1) (x, B, C as SiLU'd projections are of unit scale),
    dt = softplus(N(0, 1) / 2 + Mamba-2's dt bias), A = -linspace(1, 16),
    and the cotangents of y and of the final state, float32 numpy."""
    rng = np.random.default_rng(seed)
    f = lambda *shape: rng.standard_normal(shape).astype(np.float32)
    dt0 = np.exp(rng.uniform(math.log(1e-3), math.log(1e-1), h))
    bias = dt0 + np.log(-np.expm1(-dt0))
    dt = np.logaddexp(0, f(b, s, h) * 0.5 + bias).astype(np.float32)
    A = -np.linspace(1.0, 16.0, h).astype(np.float32)
    return f(b, s, h, p), dt, A, f(b, s, n), f(b, s, n), f(b, s, h, p), f(b, h, p, n)


def _rel(got, want) -> float:
    return ((got.float() - want.float()).abs().max()
            / want.float().abs().max()).item()


def _case(case, seed=0):
    p, n, chunk, s, h, groups = case
    return [torch.from_numpy(a) for a in _inputs(2, s, h, p, n, seed + s + p)], chunk, groups


@pytest.mark.parametrize("case", CASES)
def test_split_matches_the_plain_backward(case):
    t, chunk, groups = _case(case)
    want = ssd_scan_bwd_ref(*t, chunk=chunk)
    for split in ("bf16", "f16"):
        got = ssd_scan_bwd_split_ref(*t, chunk=chunk, split=split, groups=groups)
        for name, g, w in zip(GRADS, got, want):
            assert g.shape == w.shape and g.dtype == torch.float32
            assert _rel(g, w) <= RTOL, (split, name)


@pytest.mark.parametrize("case", CASES)
def test_split_matches_the_reference_vjp(case):
    """Against ``jax.vjp`` of ``ssd_chunked`` (B and C as one group) with
    cotangents for y and for the final state."""
    t, chunk, groups = _case(case)
    x, dt, A, B, C, dy, dfin = (a.numpy() for a in t)
    fwd = lambda x, dt, A, B, C: JL.ssd_chunked(
        x, dt, A, B[:, :, None], C[:, :, None], chunk=chunk)
    want = jax.jit(lambda *a: jax.vjp(fwd, *a[:5])[1]((a[5], a[6])))(
        x, dt, A, B, C, dy, dfin)
    got = ssd_scan_bwd_split_ref(*t, chunk=chunk, groups=groups)
    for name, g, w in zip(GRADS, got, want):
        w = torch.from_numpy(np.asarray(w).reshape(g.shape))
        assert torch.isfinite(w).all()
        assert _rel(g, w) <= RTOL, name


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
@pytest.mark.parametrize("case", CASES[1::2])
def test_split_in_16_bits_within_the_cards_limits(case, dtype):
    """16-bit inputs (pieces in the input dtype) against the plain backward
    on the same inputs: chip_smoke.py's limits for the kernel."""
    t, chunk, groups = _case(case)
    t = [a.to(dtype) if i in (0, 3, 4, 5) else a for i, a in enumerate(t)]
    want = ssd_scan_bwd_ref(*t, chunk=chunk)
    got = ssd_scan_bwd_split_ref(*t, chunk=chunk, groups=groups)
    for name, g, w in zip(GRADS, got, want):
        assert g.dtype == w.dtype
        if w.dtype == torch.float32:
            assert _rel(g, w) <= STATE_RTOL, name
        else:
            top = w.float().abs().max().item()
            tol = ULPS * 2.0 ** (math.floor(math.log2(top)) - MANTISSA[dtype])
            assert (g.float() - w.float()).abs().max().item() <= tol, name


def test_head_groups_fill_one_wave():
    """One block an SM in a single wave, each group at least one head: at
    mamba2's training shape (4 x 16 chunks, 80 heads) two groups of 40
    heads, 128 blocks; a grid already past the SMs keeps one group."""
    assert head_groups(4, 16, 80) == 2 and 4 * 16 * 2 <= 132
    assert head_groups(1, 2, 80) == 66 and head_groups(1, 1, 8) == 8
    assert head_groups(8, 32, 80) == 1
    for b, nc, h in ((4, 16, 256), (2, 8, 24), (1, 1, 1)):
        g = head_groups(b, nc, h)
        assert 1 <= g <= h and (b * nc * g <= 132 or g == 1)


def test_head_groups_sum_to_the_same_gradient():
    """The group count moves only the order of dB's and dC's float32 sums
    and the hi + lo split of each group's sum of Q: one group, two and one
    per head agree within the split's rounding."""
    t, chunk, _ = _case(CASES[3])
    outs = [ssd_scan_bwd_split_ref(*t, chunk=chunk, groups=g) for g in (1, 2, 4)]
    for other in outs[1:]:
        for name, g, w in zip(GRADS, other, outs[0]):
            assert _rel(g, w) <= RTOL, name


def test_f16_split_reconstructs_within_2_pow_minus_21():
    """float16 hi + lo within 2**-21 of v where the lo piece is a normal
    float16 (|v| >= 1/8); below, the lo piece loses bits to float16's
    subnormals."""
    rng = np.random.default_rng(0)
    v = torch.from_numpy((rng.standard_normal(20000) * 10.0 ** rng.uniform(-0.5, 3, 20000))
                         .astype(np.float32))
    v = v[v.abs() >= 0.125]
    hi, lo = split_f16(v)
    assert torch.equal(hi, hi.half().float()) and torch.equal(lo, lo.half().float())
    assert (((hi + lo) - v).abs() / v.abs()).max() <= 2.0 ** -21
