"""The port's windowed family (gemma3: sliding-window local layers in ring
buffers, global layers with the hybrid KV/ACT cache, q/k norm, MQA) against
the JAX package on gemma3-1b-reduced cut to 3 layers: one period (a local
and a global layer) and one local tail layer, W = 64.  The prefill and
decode cases also run gemma3-27b-reduced cut alike (GQA with G = 2, as
gemma3-27b's 32 heads over 16 KV heads).

Same weights (the reference's ``init_params`` through ``params.from_numpy``,
with the q/k norm scales perturbed off their zero init so that the norms
count), same tokens, float32 on both sides.  Tolerances as
``tests/test_torch_rope.py`` states them: 1e-4 on logits, 1e-5 absolute on
cache tensors; greedy tokens must be EXACTLY equal.  Prompts are longer than
W, so the rings wrap in prefill, and the decode steps cross a wrap."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as j_get_config
from repro.models import model as JM
from repro.models import transformer as JT
from repro_torch import params as P
from repro_torch.configs import get_config
from repro_torch.kernels.hybrid_attention.ref import \
    hybrid_paged_attention_two_pool_ref
from repro_torch.models import model as M
from repro_torch.models import transformer as T

torch.set_num_threads(1)
LOGIT_TOL, CACHE_TOL = 1e-4, 1e-5
NAME = "gemma3-1b-reduced"
NAMES = [NAME, "gemma3-27b-reduced"]
CAP = 128                       # kv_cap = act_cap: whole pages, cover S + steps
_MODEL = {}


def _model(name=NAME):
    if name not in _MODEL:
        jcfg = dataclasses.replace(j_get_config(name), num_layers=3)
        cfg = dataclasses.replace(get_config(name), num_layers=3)
        jp = JM.init_params(jcfg, jax.random.PRNGKey(0))
        tree = jax.tree.map(np.asarray, jp)
        rng = np.random.default_rng(5)
        for stack in (tree["periods"]["local"], tree["periods"]["global"],
                      tree["tail"]):
            for key in ("qnorm", "knorm"):
                a = stack["attn"][key]
                stack["attn"][key] = (a + rng.normal(0, 0.3, a.shape)).astype(a.dtype)
        jp = jax.tree.map(jnp.asarray, tree)
        _MODEL[name] = (cfg, P.from_numpy(tree, device="cpu"), jcfg, jp)
    return _MODEL[name]


def _close(mine, ref, tol, what):
    np.testing.assert_allclose(mine.float().numpy(), np.asarray(ref, np.float32),
                               atol=tol, err_msg=what)


def _tokens(cfg, B, S, seed):
    return np.random.default_rng(seed).integers(
        0, cfg.vocab_size, (B, S)).astype(np.int32)


def _caches_close(cache, jcache, keys, what):
    for key in keys:
        if key in jcache:
            _close(cache[key], jcache[key], CACHE_TOL, f"{key}, {what}")


PLAIN_KEYS = ("local_k", "local_v", "global_k", "global_v", "tail_k", "tail_v",
              "kv_len")
HYBRID_KEYS = ("local_k", "local_v", "tail_k", "tail_v", "k", "v", "act",
               "act_pos", "kv_len", "act_len")


def test_family_walk_and_params_bridge_keep_the_pytree():
    cfg, tp, jcfg, jp = _model()
    assert T.family(cfg) == "windowed" and T._window_split(cfg) == (2, 1, 1)
    assert list(T.window_walk(cfg)) == [("local", 0, 0), ("global", 0, None),
                                        ("tail", 0, None)]
    flat = jax.tree_util.tree_flatten_with_path(jp)[0]
    for path, leaf in flat:
        node = tp
        for key in path:
            node = node[key.key]
        assert tuple(node.shape) == leaf.shape and node.device.type == "cpu"
        np.testing.assert_array_equal(node.numpy(), np.asarray(leaf))
    lp = T.layer_params(tp, 0, 0, "local")
    assert torch.equal(lp["attn"]["knorm"], tp["periods"]["local"]["attn"]["knorm"][0, 0])
    assert torch.equal(T.layer_params(tp, 0, stack="tail")["ffn"]["w1"],
                       tp["tail"]["ffn"]["w1"][0])
    mine = M.init_params(cfg, seed=0, device="cpu")
    shapes = lambda t: jax.tree.map(lambda a: tuple(a.shape), t)
    assert shapes(mine) == shapes(jp)
    full = dataclasses.replace(cfg, dtype="bfloat16")
    with pytest.raises(NotImplementedError):
        T.check_supported(full, "engine")
    T.check_supported(get_config("gemma3-1b"))


@pytest.mark.parametrize("name", NAMES)
@pytest.mark.parametrize("S", [40, 80])
def test_plain_prefill_matches(S, name):
    """S = 40 leaves the rings part empty; S = 80 wraps them."""
    cfg, tp, jcfg, jp = _model(name)
    toks = _tokens(cfg, 2, S, seed=S)
    lg, cache = M.prefill(tp, cfg, torch.from_numpy(toks), max_len=S + 8)
    jlg, jcache = JM.prefill(jp, jcfg, {"tokens": jnp.asarray(toks)}, max_len=S + 8)
    _close(lg, jlg, LOGIT_TOL, "prefill logits")
    _caches_close(cache, jcache, PLAIN_KEYS, "prefill")


@pytest.mark.parametrize("name", NAMES)
def test_decode_step_across_the_ring_wrap(name):
    """ctx = W - 2 ... W + 2: the new token lands in the rings' last slots,
    then wraps to their first."""
    cfg, tp, jcfg, jp = _model(name)
    W = cfg.sliding_window
    toks = _tokens(cfg, 2, W - 2 + 5, seed=1)
    lg, cache = M.prefill(tp, cfg, torch.from_numpy(toks[:, :W - 2]),
                          max_len=W + 8)
    jlg, jcache = JM.prefill(jp, jcfg, {"tokens": jnp.asarray(toks[:, :W - 2])},
                             max_len=W + 8)
    for step in range(5):
        nxt = toks[:, W - 2 + step:W - 1 + step]
        lg, cache = M.decode_step(tp, cfg, torch.from_numpy(nxt), cache)
        jlg, jcache = JM.decode_step(jp, jcfg, jnp.asarray(nxt), jcache)
        _close(lg, jlg, LOGIT_TOL, f"decode logits, ctx {W - 2 + step}")
        _caches_close(cache, jcache, PLAIN_KEYS, f"ctx {W - 2 + step}")


@pytest.mark.parametrize("name", NAMES)
def test_hybrid_prefill_and_decode_step_match(name):
    """kv_keep = S // 2, store_act mixed over the requests and the steps;
    the decode crosses a ring wrap (S = W + 14, 4 steps, the global layer's
    ACT region grows while its KV region does too)."""
    cfg, tp, jcfg, jp = _model(name)
    W = cfg.sliding_window
    S = W + 14
    toks = _tokens(cfg, 2, S + 4, seed=2)
    lg, cache = M.hybrid_prefill(tp, cfg, torch.from_numpy(toks[:, :S]), CAP,
                                 CAP, S // 2)
    jlg, jcache = JM.hybrid_prefill(jp, jcfg, {"tokens": jnp.asarray(toks[:, :S])},
                                    kv_cap=CAP, act_cap=CAP, kv_keep=S // 2)
    _close(lg, jlg, LOGIT_TOL, "hybrid prefill logits")
    _caches_close(cache, jcache, HYBRID_KEYS, "hybrid prefill")
    assert cache["act"].device.type == "cpu"      # the tokens' device
    for step, store in enumerate(([True, False], [False, True], [True, True],
                                  [False, False])):
        nxt = toks[:, S + step:S + step + 1]
        st = np.array(store)
        lg, cache = M.hybrid_decode_step(tp, cfg, torch.from_numpy(nxt), cache,
                                         torch.from_numpy(st))
        jlg, jcache = JM.hybrid_decode_step(jp, jcfg, jnp.asarray(nxt), jcache,
                                            store_act=jnp.asarray(st))
        _close(lg, jlg, LOGIT_TOL, f"hybrid decode logits, step {step}")
        _caches_close(cache, jcache, HYBRID_KEYS, f"hybrid step {step}")


def test_greedy_tokens_equal_jax():
    """hybrid_prefill -> hybrid_decode_loop and prefill -> decode_loop give
    JAX's tokens exactly, and each other's."""
    cfg, tp, jcfg, jp = _model()
    S, n = cfg.sliding_window + 6, 8
    toks = _tokens(cfg, 2, S, seed=3)
    sched = np.arange(2 * n).reshape(n, 2) % 3 == 0          # (steps, B)
    lg, cache = M.hybrid_prefill(tp, cfg, torch.from_numpy(toks), CAP, CAP,
                                 S // 2)
    got, _ = M.hybrid_decode_loop(tp, cfg, lg[:, -1].argmax(-1).int(), cache,
                                  torch.from_numpy(sched))
    jlg, jcache = JM.hybrid_prefill(jp, jcfg, {"tokens": jnp.asarray(toks)},
                                    kv_cap=CAP, act_cap=CAP, kv_keep=S // 2)
    want, _ = JM.hybrid_decode_loop(jp, jcfg, jnp.argmax(jlg[:, -1], -1)
                                    .astype(jnp.int32), jcache, jnp.asarray(sched))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    lg, cache = M.prefill(tp, cfg, torch.from_numpy(toks), max_len=S + n)
    plain, _ = M.decode_loop(tp, cfg, lg[:, -1].argmax(-1).int(), cache, n)
    jlg, jcache = JM.prefill(jp, jcfg, {"tokens": jnp.asarray(toks)}, max_len=S + n)
    jplain, _ = JM.decode_loop(jp, jcfg, jnp.argmax(jlg[:, -1], -1)
                               .astype(jnp.int32), jcache, n)
    np.testing.assert_array_equal(plain.numpy(), np.asarray(jplain))
    np.testing.assert_array_equal(plain.numpy(), got.numpy())


@pytest.mark.parametrize("off", [-2, -1, 0, 1, 67])
def test_ring_pages_equal_masked_decode_attn(off):
    """The second-pool plain version over a ring's pages, with the tables of
    ``ring_page_table``, equals the reference's ``_masked_decode_attn`` under
    its ring ``valid`` mask, at ctx = W + off (2W + 3 for off = 67); the
    slots the mask leaves out hold noise."""
    W, B, KVH, G, D = 64, 3, 1, 4, 32
    rng = np.random.default_rng(off + 10)
    ctx = np.array([W + off, max(W + off - 40, 0), W + off + 5], np.int32)
    ring_k, ring_v = (rng.standard_normal((B, W, KVH, D)).astype(np.float32)
                      for _ in range(2))
    q = rng.standard_normal((B, 1, KVH * G, D)).astype(np.float32)
    n = ctx[:, None].astype(np.int64)
    pos = n - (n - np.arange(W)[None]) % W
    valid = (pos >= 0) & (pos >= n + 1 - W)
    want = JT._masked_decode_attn(jnp.asarray(q), jnp.asarray(ring_k),
                                  jnp.asarray(ring_v), jnp.asarray(valid))
    tables = M.ring_page_table(torch.from_numpy(ctx), W)
    empty = torch.zeros((0, 16, KVH, D))
    got = hybrid_paged_attention_two_pool_ref(
        torch.from_numpy(q).reshape(B, KVH, G, D),
        torch.from_numpy(ring_k).view(-1, 16, KVH, D),
        torch.from_numpy(ring_v).view(-1, 16, KVH, D), empty, empty, *tables)
    np.testing.assert_allclose(got.reshape(B, 1, KVH * G, D).numpy(),
                               np.asarray(want), atol=CACHE_TOL)
    live = tables[2].sum(1).numpy()
    np.testing.assert_array_equal(live, valid.sum(1))
    assert (live == np.minimum(ctx + 1, W)).all()


def test_windowed_hybrid_cache_refuses_quant_and_ragged_windows():
    cfg, *_ = _model()
    from repro_torch.core.quant import QuantConfig
    with pytest.raises(NotImplementedError):
        M.init_hybrid_cache(cfg, 1, 16, 16, device="cpu", quant=QuantConfig())
    with pytest.raises(ValueError):
        M.init_hybrid_cache(dataclasses.replace(cfg, sliding_window=40), 1, 16,
                            16, device="cpu")
