"""The card's SSD scan algorithm, on the CPU.

On the card ``ssd_scan`` runs two kernels: a Gram pass (G = C B^T once per
request and chunk, for all heads) and the scan, split across blocks along the
head dim, its state carried transposed on chip and its chunk products on the
tensor cores, each operand derived in float32 (G . L . dt, the state, and
x . w or B^T . w) split into hi + lo: bfloat16 pieces for bfloat16 inputs,
TF32 pieces for float16.  Here that algorithm in plain PyTorch
(``ssd_scan_split_ref``, ``cvt.rna.tf32`` emulated on the bits), with either
split, is held to
the plain version ``ssd_chunked_ref``, to the Pallas kernel in interpret mode
(chunk multiples: the Pallas kernel takes no ragged length) and to the
sequential recurrence, at p in {16, 64}, n in {32, 128}, chunk in {16, 64},
chunk multiples and ragged lengths, float32 and bfloat16, one head-dim slice
and several.  Also the wrapper's refusal of strides TMA cannot take.

Tolerances, float32 inputs against the plain version, on y (outputs of unit
scale) absolute and on the final state relative to its largest entry.  TF32
pieces leave each derived operand within 2**-22 of itself, and the two sum a
chunk's products in other orders: 2e-6 and 2e-6 (measured 6.6e-7 and
1.7e-7).  bfloat16 pieces keep 16 significant bits, within 2**-17: 1e-4 and
2e-5 (measured 1.9e-5 and 4.7e-6; the state's limit on the card is 2**-13,
1.2e-4).  Against the Pallas kernel and the sequential recurrence: y within
the plain version's own limit there (``tests/test_torch_kernels.py``: 1e-5)
plus the split's.  bfloat16 inputs against the plain version in bfloat16:
4 ulps of bfloat16 at the largest output, chip_smoke.py's limit for the
kernel (both round y once, a float32 sum on either side of a rounding
boundary differs by one ulp).  The splits themselves: TF32 hi + lo within
2**-20 of v, bfloat16 hi + lo within 2**-16, relative.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.ssd_scan.kernel import ssd_scan as j_ssd_scan
from repro.kernels.ssd_scan.ref import ssd_ref_sequential as j_sequential
from repro_torch.kernels.ssd_scan.ops import _validate
from repro_torch.kernels.ssd_scan.ref import (
    slice_width, split_bf16, split_tf32, ssd_chunked_ref, ssd_ref_sequential,
    ssd_scan_split_ref, tf32_rna)

torch.set_num_threads(1)
# split -> (y absolute, state relative) against the plain version
TOL = {"tf32": (2e-6, 2e-6), "bf16": (1e-4, 2e-5)}
SEQ_TOL = 1e-5
t = torch.from_numpy


def _inputs(b, s, h, p, n, seed=0):
    """x N(0, 0.25), dt softplus(N(0, 1)) / 2, A -exp(N(0, 0.09)), B and C
    N(0, 0.09), as ``tests/test_torch_ssm.py`` draws them."""
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal((b, s, h, p)) * 0.5).astype(np.float32)
    dt = (np.logaddexp(rng.standard_normal((b, s, h)), 0) * 0.5).astype(np.float32)
    A = (-np.exp(rng.standard_normal(h) * 0.3)).astype(np.float32)
    B = (rng.standard_normal((b, s, n)) * 0.3).astype(np.float32)
    C = (rng.standard_normal((b, s, n)) * 0.3).astype(np.float32)
    return x, dt, A, B, C


def _state_rel(got, want) -> float:
    return ((got - want).abs().max() / want.abs().max()).item()


def test_tf32_split_reconstructs_within_2_pow_minus_20():
    rng = np.random.default_rng(0)
    v = t((rng.standard_normal(20000) * 10.0 ** rng.uniform(-6, 6, 20000))
          .astype(np.float32))
    hi, lo = split_tf32(v)
    for part in (hi, lo):                    # TF32: the low 13 bits clear
        assert (part.view(torch.int32) & 0x1FFF == 0).all()
    assert (((hi + lo) - v).abs() / v.abs()).max() <= 2.0 ** -20
    assert ((hi - v).abs() / v.abs()).max() <= 2.0 ** -11      # one half-ulp
    # round to nearest, ties away from zero, on both signs
    tie = torch.tensor([1.0 + 2.0 ** -11, -(1.0 + 2.0 ** -11)])
    assert tf32_rna(tie).tolist() == [1.0 + 2.0 ** -10, -(1.0 + 2.0 ** -10)]
    hi, lo = split_bf16(v)
    for part in (hi, lo):                    # bfloat16: the low 16 bits clear
        assert (part.view(torch.int32) & 0xFFFF == 0).all()
    assert (((hi + lo) - v).abs() / v.abs()).max() <= 2.0 ** -16


@pytest.mark.parametrize("split", ["tf32", "bf16"])
@pytest.mark.parametrize("ragged", [False, True])
@pytest.mark.parametrize("chunk", [16, 64])
@pytest.mark.parametrize("n", [32, 128])
@pytest.mark.parametrize("p", [16, 64])
def test_split_matches_plain_and_sequential(p, n, chunk, ragged, split):
    s = 2 * chunk + (chunk // 2 + 3 if ragged else 0)
    args = [t(a) for a in _inputs(2, s, 2, p, n, seed=p + n + chunk + s)]
    y, state = ssd_scan_split_ref(*args, chunk=chunk, split=split)
    want_y, want_state = ssd_chunked_ref(*args, chunk=chunk)
    y_tol, state_tol = TOL[split]
    assert y.shape == want_y.shape and state.shape == want_state.shape
    assert state.dtype == torch.float32 and torch.isfinite(y).all()
    torch.testing.assert_close(y, want_y, atol=y_tol, rtol=0)
    assert _state_rel(state, want_state) <= state_tol
    torch.testing.assert_close(y, ssd_ref_sequential(*args),
                               atol=SEQ_TOL + y_tol, rtol=0)


@pytest.mark.parametrize("split", ["tf32", "bf16"])
@pytest.mark.parametrize("p,n,chunk", [(16, 32, 16), (64, 128, 64),
                                       (16, 128, 64), (64, 32, 16)])
def test_split_matches_pallas_interpret(p, n, chunk, split):
    x, dt, A, B, C = _inputs(2, 2 * chunk, 2, p, n, seed=7 + p)
    y, _ = ssd_scan_split_ref(*map(t, (x, dt, A, B, C)), chunk=chunk,
                              split=split)
    jargs = [jnp.asarray(a) for a in (x, dt, A, B, C)]
    tol = SEQ_TOL + TOL[split][0]
    np.testing.assert_allclose(y.numpy(), np.asarray(j_ssd_scan(*jargs, chunk=chunk)),
                               atol=tol, rtol=0)
    np.testing.assert_allclose(y.numpy(), np.asarray(j_sequential(*jargs)),
                               atol=tol, rtol=0)


@pytest.mark.parametrize("s", [128, 100])
@pytest.mark.parametrize("p", [16, 64])
def test_split_bf16_within_4_ulps_of_plain(p, s):
    x, dt, A, B, C = _inputs(2, s, 2, p, 128, seed=s + p)
    args = [t(x).bfloat16(), t(dt), t(A), t(B).bfloat16(), t(C).bfloat16()]
    y, state = ssd_scan_split_ref(*args, chunk=64)
    want_y, want_state = ssd_chunked_ref(*args, chunk=64)
    assert y.dtype == torch.bfloat16
    top = want_y.float().abs().max().item()
    ulp = 2.0 ** (np.floor(np.log2(top)) - 7)
    assert (y.float() - want_y.float()).abs().max() <= 4 * ulp
    assert _state_rel(state, want_state) <= TOL["bf16"][1]


@pytest.mark.parametrize("p", [16, 32, 64])
def test_head_dim_slices_agree(p):
    """The recurrence never mixes rows p of the state: one slice or
    several give the same y and state."""
    args = [t(a) for a in _inputs(2, 80, 2, p, 32, seed=p)]
    got = [ssd_scan_split_ref(*args, chunk=16, p_slice=ps)
           for ps in (16, 32, 64) if p % ps == 0]
    for y, state in got[1:]:
        torch.testing.assert_close(y, got[0][0], atol=TOL["tf32"][0], rtol=0)
        assert _state_rel(state, got[0][1]) <= TOL["tf32"][1]
    assert slice_width(p) == (32 if p % 32 == 0 else 16)


@pytest.mark.parametrize("split", ["tf32", "bf16"])
def test_lo_terms_carry_the_state_limit(split):
    """Dropping the lo terms leaves one rounding (2**-11 TF32, 2**-8
    bfloat16) per operand: the state moves by orders of magnitude more
    than with them (chip_smoke.py records the card's reading of the same
    diagnostic)."""
    args = [t(a) for a in _inputs(1, 256, 2, 64, 128, seed=3)]
    want = ssd_chunked_ref(*args, chunk=64)[1]
    with_lo = _state_rel(ssd_scan_split_ref(*args, chunk=64, split=split)[1],
                         want)
    without = _state_rel(ssd_scan_split_ref(*args, chunk=64, split=split,
                                            lo_terms=False)[1], want)
    assert with_lo <= TOL[split][1] and without > 100 * with_lo


def test_wrapper_refuses_strides_tma_cannot_take():
    """x, B and C come as slices of one projection and are read by TMA:
    16-byte aligned starts and row strides of multiples of 8 elements, or
    a loud refusal before any launch (the check is called as the CUDA
    branch calls it)."""
    b, s, h, p, n = 2, 40, 2, 16, 32

    def sliced(extra):
        xbc = torch.zeros((b, s, h * p + 2 * n + extra), dtype=torch.bfloat16)
        x, B, C = torch.split(xbc[..., :h * p + 2 * n], [h * p, n, n], dim=-1)
        dt, A = torch.zeros((b, s, h)), torch.zeros(h)
        return x.unflatten(-1, (h, p)), dt, A, B, C

    _validate(*sliced(0), 16)                  # the model's layout passes
    with pytest.raises(ValueError, match="multiples of 8 elements"):
        _validate(*sliced(4), 16)
