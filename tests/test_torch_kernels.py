"""The plain versions of the port's two kernels against the JAX package.

On the CPU each wrapper runs its plain version (``ref.py``); the CUDA kernels
themselves are held against these plain versions on the card by
``chip_smoke.py``.  The Pallas kernels run in interpret mode, as
``tests/test_kernels.py`` runs them.  Everything is float32; 1e-5 absolute
covers two float32 softmax/dot orders at unit-scale inputs."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as j_get_config
from repro.kernels.flash_attention.kernel import flash_attention as j_flash
from repro.kernels.flash_attention.ref import flash_attention_ref as j_flash_ref
from repro.kernels.hybrid_attention.kernel import hybrid_paged_attention as j_hybrid
from repro.kernels.hybrid_attention.ref import hybrid_paged_attention_ref as j_hybrid_ref
from repro.models import layers as JL
from repro.models import model as JM
from repro_torch import params as P
from repro_torch.configs import get_config
from repro_torch.kernels import _build
from repro_torch.kernels.flash_attention.ops import flash_attention
from repro_torch.kernels.hybrid_attention.ops import hybrid_paged_attention
from repro_torch.kernels.ssd_scan.ops import ssd_scan
from repro_torch.models import model as M

torch.set_num_threads(1)
TOL = 1e-5
t = torch.from_numpy


@pytest.mark.parametrize("H,KVH", [(4, 4), (4, 2)])
def test_flash_plain_matches_pallas_and_blockwise(H, KVH):
    rng = np.random.default_rng(0)
    B, S, D = 2, 64, 32
    q, k, v = (rng.standard_normal((B, S, n, D)).astype(np.float32)
               for n in (H, KVH, KVH))
    launches = flash_attention.launches
    got = flash_attention(t(q), t(k), t(v)).numpy()
    assert flash_attention.launches == launches    # CPU tensor: plain version
    pallas = j_flash(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                     causal=True, q_chunk=32, k_chunk=32, interpret=True)
    blockwise = JL.blockwise_attention(jnp.asarray(q), jnp.asarray(k),
                                       jnp.asarray(v), causal=True,
                                       q_chunk=16, k_chunk=16)
    np.testing.assert_allclose(got, np.asarray(pallas), atol=TOL)
    np.testing.assert_allclose(got, np.asarray(blockwise), atol=TOL)


def test_flash_plain_ragged_length_matches_blockwise():
    """The engine's buckets are multiples of 16, not of the kernel's tile."""
    rng = np.random.default_rng(1)
    q, k, v = (rng.standard_normal((1, 40, 2, 16)).astype(np.float32)
               for _ in range(3))
    want = JL.blockwise_attention(jnp.asarray(q), jnp.asarray(k),
                                  jnp.asarray(v), causal=True, q_chunk=32,
                                  k_chunk=32)
    np.testing.assert_allclose(flash_attention(t(q), t(k), t(v)).numpy(),
                               np.asarray(want), atol=TOL)


@pytest.mark.parametrize("S,W,D", [(64, 16, 32), (96, 40, 32), (64, 24, 256)])
def test_flash_plain_window_matches_pallas_and_ref(S, W, D):
    """The sliding-window mode (gemma3's local layers: MQA, G = 4) against
    the Pallas kernel's window mode in interpret mode and its ``ref.py``, at
    head_dim 32 and 256; tiles wholly before a query tile's window are the
    ones the kernels skip."""
    rng = np.random.default_rng(S + W)
    q = rng.standard_normal((2, S, 4, D)).astype(np.float32)
    k, v = (rng.standard_normal((2, S, 1, D)).astype(np.float32)
            for _ in range(2))
    got = flash_attention(t(q), t(k), t(v), window=W).numpy()
    jq, jk, jv = (jnp.asarray(a) for a in (q, k, v))
    pallas = j_flash(jq, jk, jv, causal=True, window=W, q_chunk=32, k_chunk=32,
                     interpret=True)
    np.testing.assert_allclose(got, np.asarray(pallas), atol=TOL)
    np.testing.assert_allclose(got, np.asarray(j_flash_ref(jq, jk, jv, window=W)),
                               atol=TOL)
    causal = flash_attention(t(q), t(k), t(v)).numpy()
    assert np.abs(got[:, W:] - causal[:, W:]).max() > 1e-2      # the window bites
    np.testing.assert_array_equal(got[:, :W], causal[:, :W])


def test_flash_refuses_a_negative_window():
    x = torch.zeros((1, 16, 1, 16))
    with pytest.raises(ValueError, match="window"):
        flash_attention(x, x, x, window=-1)


def _hybrid_inputs(rng, kvh=2, g=3, d_model=64, D=32, B=2, bias=0.0):
    ks = (rng.standard_normal((4, 16, kvh, D)) * 0.3).astype(np.float32)
    vs = (rng.standard_normal((4, 16, kvh, D)) * 0.3).astype(np.float32)
    ap = (rng.standard_normal((3, 16, d_model)) * 0.5 + 0.2).astype(np.float32)
    q = rng.standard_normal((B, kvh, g, D)).astype(np.float32)
    sc = (1.0 + 0.1 * rng.standard_normal(d_model)).astype(np.float32)
    bi = (bias * rng.standard_normal(d_model)).astype(np.float32)
    wk = (rng.standard_normal((d_model, kvh, D)) * 0.1).astype(np.float32)
    wv = (rng.standard_normal((d_model, kvh, D)) * 0.1).astype(np.float32)
    return q, ks, vs, ap, sc, bi, wk, wv


TABLES = {  # (page_table, page_type, page_ntok), B = 2
    "mixed": ([[0, 1, 0, 2, 3], [2, 1, 0, 0, 0]],
              [[0, 1, 0, 1, 0], [0, 0, 1, 2, 2]],
              [[16, 16, 16, 16, 9], [16, 16, 5, 0, 0]]),
    "act_only": ([[0, 1, 2], [2, 0, 0]], [[1, 1, 1], [1, 1, 2]],
                 [[16, 16, 3], [16, 11, 0]]),
    "kv_only": ([[3, 1, 0], [2, 0, 0]], [[0, 0, 0], [0, 2, 2]],
                [[16, 16, 16], [7, 0, 0]]),
    "empty_pages": ([[0, 0, 1, 0, 2], [0, 1, 0, 3, 0]],
                    [[2, 0, 2, 1, 1], [1, 2, 2, 0, 2]],
                    [[0, 16, 0, 16, 4], [13, 0, 0, 8, 0]]),
}


@pytest.mark.parametrize("table", sorted(TABLES))
@pytest.mark.parametrize("norm", ["layernorm", "rmsnorm"])
def test_hybrid_plain_matches_pallas_at_zero_bias(table, norm):
    rng = np.random.default_rng(2)
    q, ks, vs, ap, sc, bi, wk, wv = _hybrid_inputs(rng)
    pt, pty, pn = (np.asarray(a, np.int32) for a in TABLES[table])
    launches = hybrid_paged_attention.launches
    got = hybrid_paged_attention(
        t(q), t(ks), t(vs), t(ap), t(sc), t(bi), t(wk), t(wv), t(pt), t(pty),
        t(pn), norm_type=norm).numpy()
    assert hybrid_paged_attention.launches == launches
    args = [jnp.asarray(a) for a in (q, ks, vs, ap, sc, wk, wv, pt, pty, pn)]
    pallas = j_hybrid(*args, norm_type=norm, interpret=True)
    ref = j_hybrid_ref(*args, norm_type=norm)
    np.testing.assert_allclose(got, np.asarray(pallas), atol=TOL)
    np.testing.assert_allclose(got, np.asarray(ref), atol=TOL)


def test_hybrid_plain_empty_request_is_zero():
    rng = np.random.default_rng(3)
    q, ks, vs, ap, sc, bi, wk, wv = _hybrid_inputs(rng)
    pt = np.zeros((2, 3), np.int32)
    pty = np.array([[0, 1, 2], [2, 2, 2]], np.int32)
    pn = np.array([[16, 5, 0], [0, 0, 0]], np.int32)
    args = [t(a) for a in (q, ks, vs, ap, sc, bi, wk, wv, pt, pty, pn)]
    got = hybrid_paged_attention(*args).numpy()
    pallas = j_hybrid(*[jnp.asarray(a) for a in (q, ks, vs, ap, sc, wk, wv,
                                                 pt, pty, pn)], interpret=True)
    np.testing.assert_allclose(got, np.asarray(pallas), atol=TOL)
    assert not got[1].any()                          # -1e30 basis: zeros, no NaN


def _layer_setup(bias_scale):
    jcfg = j_get_config("opt-6.7b-reduced")
    jp = JM.init_params(jcfg, jax.random.PRNGKey(0))
    lp = jax.tree.map(lambda a: np.array(a[0]), jp["layers"])
    rng = np.random.default_rng(4)
    d = jcfg.d_model
    lp["ln1"]["bias"] = (bias_scale * rng.standard_normal(d)).astype(np.float32)
    lp["ln1"]["scale"] = (1 + 0.1 * rng.standard_normal(d)).astype(np.float32)
    return jcfg, lp, rng


def test_hybrid_plain_matches_model_path_with_layernorm_bias():
    """The port's decode layer (plain kernel version on the CPU) against the
    reference model path ``_hybrid_layer_step``, with a non-zero LayerNorm
    bias: the Pallas kernel and its ref drop that bias, the model path and
    the port apply it."""
    jcfg, lp, rng = _layer_setup(bias_scale=0.5)
    cfg = get_config("opt-6.7b-reduced")
    B, kv_cap, act_cap, d = 3, 48, 48, cfg.d_model
    KVH, D = cfg.num_kv_heads, cfg.head_dim
    h = rng.standard_normal((B, 1, d)).astype(np.float32)
    kc = (rng.standard_normal((B, kv_cap, KVH, D)) * 0.5).astype(np.float32)
    vc = (rng.standard_normal((B, kv_cap, KVH, D)) * 0.5).astype(np.float32)
    ac = rng.standard_normal((B, act_cap, d)).astype(np.float32)
    kv_len = np.array([20, 0, 33], np.int32)
    act_len = np.array([17, 40, 0], np.int32)
    store = np.array([True, False, True])
    jh, jk, jv, ja = JM._hybrid_layer_step(
        jax.tree.map(jnp.asarray, lp), jcfg, jnp.asarray(h), jnp.asarray(kc),
        jnp.asarray(vc), jnp.asarray(ac), jnp.asarray(kv_len),
        jnp.asarray(act_len), jnp.asarray(store), None, None, False)
    s = t(store)
    tables = M.hybrid_page_table(t(kv_len) + (~s).int(), t(act_len) + s.int(),
                                 kv_cap, act_cap, kv_cap // 16 + act_cap // 16)
    pk, pv, pa = t(kc.copy()), t(vc.copy()), t(ac.copy())
    got = M._hybrid_layer_step(P.from_numpy(lp, "cpu"), cfg, t(h), pk, pv, pa,
                               t(kv_len), t(act_len), s, tables)
    np.testing.assert_allclose(got.numpy(), np.asarray(jh), atol=TOL)
    for mine, ref in ((pk, jk), (pv, jv), (pa, ja)):       # in-place appends
        np.testing.assert_allclose(mine.numpy(), np.asarray(ref), atol=TOL)


def test_pallas_ref_drops_layernorm_bias():
    """Pins fault A: with a non-zero bias the Pallas ref is no oracle for the
    model path, while the port's plain version is (test above)."""
    rng = np.random.default_rng(5)
    q, ks, vs, ap, sc, bi, wk, wv = _hybrid_inputs(rng, bias=0.5)
    pt, pty, pn = (np.asarray(a, np.int32) for a in TABLES["act_only"])
    got = hybrid_paged_attention(*[t(a) for a in (q, ks, vs, ap, sc, bi, wk,
                                                  wv, pt, pty, pn)]).numpy()
    dropped = j_hybrid_ref(*[jnp.asarray(a) for a in (q, ks, vs, ap, sc, wk,
                                                      wv, pt, pty, pn)])
    assert np.abs(got - np.asarray(dropped)).max() > 1e-2


class Elsewhere:
    """A tensor's face on a device that is neither the CPU, ``meta`` nor the
    card (this build has no other device to make a real tensor on)."""
    device = torch.device("xpu")
    dtype = torch.float16
    requires_grad = False

    def __init__(self, shape):
        self.shape = shape

    def __getitem__(self, index):
        return self

    def dim(self):
        return len(self.shape)


def test_wrappers_refuse_other_devices():
    """No silent fallback: only a CPU tensor, or a ``meta`` one (shapes
    only: the dry run's), takes the plain version; a ``meta`` tensor
    launches nothing."""
    q = Elsewhere((1, 16, 2, 16))
    with pytest.raises(ValueError, match="unsupported device"):
        flash_attention(q, q, q)
    with pytest.raises(ValueError, match="unsupported device"):
        hybrid_paged_attention(q, *([q] * 10))
    with pytest.raises(ValueError, match="unsupported device"):
        ssd_scan(q, q[..., 0], q[0, 0, :, 0], q[:, :, 0], q[:, :, 0])
    m = torch.zeros((1, 16, 2, 16), device="meta")
    before = (flash_attention.launches, ssd_scan.launches)
    assert flash_attention(m, m, m).shape == m.shape
    y, state = ssd_scan(m, m[..., 0], m[0, 0, :, 0], m[:, :, 0], m[:, :, 0],
                        chunk=16)
    assert y.device.type == state.device.type == "meta"
    assert (y.shape, state.shape) == (m.shape, (1, 2, 16, 16))
    assert (flash_attention.launches, ssd_scan.launches) == before


def test_build_covers_both_sources_for_sm90a():
    assert set(_build.sources()) == {"flash_attention", "hybrid_attention",
                                     "kv_gen", "ssd_scan"}
    assert "arch=compute_90a,code=sm_90a" in _build.NVCC_FLAGS
    assert _build.BUILD_DIR.parts[-2:] == ("build", "kernels")
