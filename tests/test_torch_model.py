"""The port's model paths against ``repro.models.model`` on opt-6.7b-reduced.

Same weights (the reference's ``init_params`` through ``params.from_numpy``),
same tokens, float32 on both sides.  Tolerances: 1e-5 absolute on cache
tensors (layer outputs of unit scale, two float32 matmul orders) and 1e-4 on
logits (a 256-deep unembedding product on top of two layers)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as j_get_config
from repro.models import model as JM
from repro_torch import params as P
from repro_torch.configs import get_config
from repro_torch.models import model as M

torch.set_num_threads(1)
LOGIT_TOL, CACHE_TOL = 1e-4, 1e-5
KV_CAP = ACT_CAP = 64


@pytest.fixture(scope="module")
def models():
    jcfg = j_get_config("opt-6.7b-reduced")
    jp = JM.init_params(jcfg, jax.random.PRNGKey(0))
    tp = P.from_numpy(jax.tree.map(np.asarray, jp), device="cpu")
    return get_config("opt-6.7b-reduced"), tp, jcfg, jp


def _close(mine, ref, tol, what):
    np.testing.assert_allclose(mine.float().numpy(), np.asarray(ref, np.float32),
                               atol=tol, err_msg=what)


def _tokens(cfg, B, S, seed):
    return np.random.default_rng(seed).integers(
        0, cfg.vocab_size, (B, S)).astype(np.int32)


def test_params_bridge_keeps_keys_and_layout(models):
    cfg, tp, jcfg, jp = models
    flat = jax.tree_util.tree_flatten_with_path(jp)[0]
    for path, leaf in flat:
        node = tp
        for key in path:
            node = node[key.key]
        assert tuple(node.shape) == leaf.shape and node.device.type == "cpu"
        np.testing.assert_array_equal(node.numpy(), np.asarray(leaf))


def test_plain_prefill_and_decode_match(models):
    cfg, tp, jcfg, jp = models
    toks = _tokens(cfg, 2, 32, seed=0)
    lg, cache = M.prefill(tp, cfg, torch.from_numpy(toks), max_len=40)
    jlg, jcache = JM.prefill(jp, jcfg, {"tokens": jnp.asarray(toks)}, max_len=40)
    _close(lg, jlg, LOGIT_TOL, "prefill logits")
    for key in ("k", "v", "kv_len"):
        _close(cache[key], jcache[key], CACHE_TOL, key)
    nxt = np.array([[5], [900]], np.int32)
    for step in range(2):
        lg, cache = M.decode_step(tp, cfg, torch.from_numpy(nxt), cache)
        jlg, jcache = JM.decode_step(jp, jcfg, jnp.asarray(nxt), jcache)
        _close(lg, jlg, LOGIT_TOL, f"decode logits, step {step}")
        for key in ("k", "v", "kv_len"):
            _close(cache[key], jcache[key], CACHE_TOL, f"{key}, step {step}")
        nxt = np.array(jnp.argmax(jlg[:, -1], -1), np.int32)[:, None]


@pytest.mark.parametrize("kv_keep", [0, 20, 48])
def test_hybrid_prefill_one_split_matches(models, kv_keep):
    """``hybrid_prefill`` (one split for every request, the reference's
    entry point) on the uniform family: the reference's logits, and its
    regions over the tokens each holds."""
    cfg, tp, jcfg, jp = models
    toks = _tokens(cfg, 2, 48, seed=2)
    lg, cache = M.hybrid_prefill(tp, cfg, torch.from_numpy(toks), KV_CAP,
                                 ACT_CAP, kv_keep)
    jlg, jc = JM.hybrid_prefill(jp, jcfg, {"tokens": jnp.asarray(toks)},
                                KV_CAP, ACT_CAP, kv_keep)
    _close(lg, jlg, LOGIT_TOL, "prefill logits")
    n_act = 48 - kv_keep
    for key in ("kv_len", "act_len"):
        _close(cache[key], jc[key], 0, key)
    for key, n in (("k", kv_keep), ("v", kv_keep), ("act", n_act)):
        _close(cache[key][:, :, :n], jc[key][:, :, :n], CACHE_TOL, key)
    _close(cache["act_pos"][:, :n_act], jc["act_pos"][:, :n_act], 0, "act_pos")


SPLITS = {"zero": [0, 0, 0], "mixed": [16, 32, 16], "full": [48, 32, 48]}
# per-step store_act flags of the three requests (True: ACT region)
SCHED = np.array([[True, False, True], [False, False, True],
                  [True, True, False], [False, True, False]])


@pytest.mark.parametrize("split", sorted(SPLITS))
def test_hybrid_prefill_and_decode_match(models, split):
    cfg, tp, jcfg, jp = models
    toks = _tokens(cfg, 3, 48, seed=1)
    kv_keep = np.array(SPLITS[split], np.int32)
    last_pos = np.array([48, 32, 48], np.int32)
    lg, cache = M.hybrid_prefill_batched(
        tp, cfg, torch.from_numpy(toks), KV_CAP, ACT_CAP,
        torch.from_numpy(kv_keep), torch.from_numpy(last_pos))
    jlg, jcache = JM.hybrid_prefill_batched(
        jp, jcfg, {"tokens": jnp.asarray(toks)}, KV_CAP, ACT_CAP,
        jnp.asarray(kv_keep), jnp.asarray(last_pos))
    _close(lg, jlg, LOGIT_TOL, "prefill logits")
    keys = ("k", "v", "act", "act_pos", "kv_len", "act_len")
    for key in keys:
        _close(cache[key], jcache[key], CACHE_TOL, f"prefill {key}")

    step = jax.jit(lambda p, tok, c, s: JM.hybrid_decode_step(p, jcfg, tok, c, s))
    tok = np.array(jnp.argmax(jlg[:, -1], -1), np.int32)[:, None]
    for s, store in enumerate(SCHED):
        lg, cache = M.hybrid_decode_step(tp, cfg, torch.from_numpy(tok), cache,
                                         torch.from_numpy(store))
        jlg, jcache = step(jp, jnp.asarray(tok), jcache, jnp.asarray(store))
        _close(lg, jlg, LOGIT_TOL, f"decode logits, step {s}")
        for key in keys:
            _close(cache[key], jcache[key], CACHE_TOL, f"{key}, step {s}")
        tok = np.array(jnp.argmax(jlg[:, -1], -1), np.int32)[:, None]


def test_page_table_is_compacted_and_bounded():
    kv_tokens = torch.tensor([17, 0, 32], dtype=torch.int32)
    act_tokens = torch.tensor([3, 20, 0], dtype=torch.int32)
    pt, pty, pn = M.hybrid_page_table(kv_tokens, act_tokens, 64, 32, 4)
    assert pty.tolist() == [[0, 0, 1, 2], [1, 1, 2, 2], [0, 0, 2, 2]]
    assert pn.tolist() == [[16, 1, 3, 0], [16, 4, 0, 0], [16, 16, 0, 0]]
    assert pt[:, :2].tolist() == [[0, 1], [2, 3], [8, 9]]
    assert pt[0, 2].item() == 0 and pt.dtype == torch.int32


def test_hybrid_decode_loop_matches_stepwise_and_bound(models):
    """The greedy loop with a tight ``pages_bound`` gives the tokens of the
    step-by-step path over full-width page tables."""
    cfg, tp, _, _ = models
    toks = torch.from_numpy(_tokens(cfg, 3, 48, seed=2))
    kv_keep = torch.tensor(SPLITS["mixed"], dtype=torch.int32)
    last_pos = torch.tensor([48, 32, 48], dtype=torch.int32)

    def fresh():
        lg, c = M.hybrid_prefill_batched(tp, cfg, toks, KV_CAP, ACT_CAP,
                                         kv_keep, last_pos)
        return lg[:, -1].argmax(-1).int(), c

    cur, cache = fresh()
    kv_end = kv_keep + torch.from_numpy((~SCHED).sum(0)).int()
    act_end = last_pos - kv_keep + torch.from_numpy(SCHED.sum(0)).int()
    bound = int(((kv_end + 15) // 16 + (act_end + 15) // 16).max())
    got, _ = M.hybrid_decode_loop(tp, cfg, cur, cache, torch.from_numpy(SCHED),
                                  pages_bound=bound)
    cur, cache = fresh()
    want = [cur]
    for store in SCHED[:-1]:
        lg, cache = M.hybrid_decode_step(tp, cfg, want[-1][:, None], cache,
                                         torch.from_numpy(store))
        want.append(lg[:, -1].argmax(-1).int())
    assert bound < KV_CAP // 16 + ACT_CAP // 16
    assert torch.equal(got, torch.stack(want, 1))


_CAP_MODELS = {}


def _cap_models(name):
    """Port and reference weights of ``name``, built once per module."""
    if name not in _CAP_MODELS:
        jcfg = j_get_config(name)
        jp = JM.init_params(jcfg, jax.random.PRNGKey(0))
        tp = P.from_numpy(jax.tree.map(np.asarray, jp), device="cpu")
        _CAP_MODELS[name] = (get_config(name), tp, jcfg, jp)
    return _CAP_MODELS[name]


@pytest.mark.parametrize("name", ["opt-6.7b-reduced", "yi-6b-reduced"])
def test_hybrid_decode_drops_a_write_past_capacity(name):
    """A decode step whose token's region is full: the reference's scatter
    drops the write (``.at[b, len].set`` out of range), so the region keeps
    its last row, ``act_pos`` its last position, and attention reads the
    region as it was.  Request 0's KV region and request 1's ACT region are
    full after prefill; the first step appends to each, the second step
    appends to request 0's KV region again, one past capacity.  Logits and
    every cache tensor as the reference's."""
    cfg, tp, jcfg, jp = _cap_models(name)
    toks = _tokens(cfg, 3, KV_CAP, seed=5)
    kv_keep = np.array([KV_CAP, 0, 32], np.int32)
    last_pos = np.array([KV_CAP] * 3, np.int32)
    lg, cache = M.hybrid_prefill_batched(
        tp, cfg, torch.from_numpy(toks), KV_CAP, ACT_CAP,
        torch.from_numpy(kv_keep), torch.from_numpy(last_pos))
    jlg, jcache = JM.hybrid_prefill_batched(
        jp, jcfg, {"tokens": jnp.asarray(toks)}, KV_CAP, ACT_CAP,
        jnp.asarray(kv_keep), jnp.asarray(last_pos))
    assert cache["kv_len"].tolist() == [KV_CAP, 0, 32]
    assert cache["act_len"].tolist() == [0, ACT_CAP, 32]
    step = jax.jit(lambda p, tok, c, s: JM.hybrid_decode_step(p, jcfg, tok, c, s))
    keys = ("k", "v", "act", "act_pos", "kv_len", "act_len")
    tok = np.array(jnp.argmax(jlg[:, -1], -1), np.int32)[:, None]
    for s, store in enumerate(np.array([[False, True, True],
                                        [False, False, True]])):
        lg, cache = M.hybrid_decode_step(tp, cfg, torch.from_numpy(tok), cache,
                                         torch.from_numpy(store))
        jlg, jcache = step(jp, jnp.asarray(tok), jcache, jnp.asarray(store))
        _close(lg, jlg, LOGIT_TOL, f"decode logits, step {s}")
        for key in keys:
            _close(cache[key], jcache[key], CACHE_TOL, f"{key}, step {s}")
        tok = np.array(jnp.argmax(jlg[:, -1], -1), np.int32)[:, None]


def _refuse_reads(monkeypatch):
    """Every read of a tensor's value raises: a read of a device tensor is
    a sync its caller did not count."""
    def refuse(*a, **kw):
        raise AssertionError("the prefill read a tensor's value")

    for name in ("__int__", "__index__", "__float__", "__bool__", "item",
                 "tolist", "numpy", "__array__"):
        monkeypatch.setattr(torch.Tensor, name, refuse)


def test_hybrid_prefill_reads_no_device_value(models, monkeypatch):
    """The batched prefill checks its host split on the host and reads no
    tensor's value (the split's capacity check read it back from the
    device).  It equals the prefill run without the refusal."""
    cfg, tp, *_ = models
    toks = torch.from_numpy(_tokens(cfg, 3, 48, seed=1))
    kv_keep = np.array(SPLITS["mixed"], np.int32)
    last_pos = np.array([48, 32, 48], np.int32)
    want_lg, want = M.hybrid_prefill_batched(tp, cfg, toks, KV_CAP, ACT_CAP,
                                             kv_keep, last_pos)
    with monkeypatch.context() as m:
        _refuse_reads(m)
        lg, cache = M.hybrid_prefill_batched(tp, cfg, toks, KV_CAP, ACT_CAP,
                                             kv_keep, last_pos)
    assert torch.equal(lg, want_lg)
    for key in ("k", "v", "act", "act_pos", "kv_len", "act_len"):
        assert torch.equal(cache[key], want[key]), key


def test_hybrid_prefill_checks_a_host_split(models):
    """A host split over a capacity raises the ``ValueError`` the device
    check raised, before anything runs; ``check_split`` is that check."""
    cfg, tp, *_ = models
    toks = torch.from_numpy(_tokens(cfg, 2, 48, seed=2))
    with pytest.raises(ValueError, match="exceeds kv_cap=32"):
        M.hybrid_prefill_batched(tp, cfg, toks, 32, ACT_CAP,
                                 np.array([48, 16]), np.array([48, 48]))
    with pytest.raises(ValueError, match="exceeds act_cap=16"):
        M.hybrid_prefill_batched(tp, cfg, toks, KV_CAP, 16,
                                 [16, 16], [48, 32])
    M.check_split([32, 16], [48, 32], 32, 16)
    with pytest.raises(ValueError, match="ACT span 17"):
        M.check_split([32, 15], [48, 32], 32, 16)
