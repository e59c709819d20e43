"""The port's RoPE path against the JAX package on yi-6b-reduced (RMSNorm,
SwiGLU, GQA with G = 8) and minitron-4b-reduced (LayerNorm with bias,
squared ReLU, G = 4).

Same weights (the reference's ``init_params`` through ``params.from_numpy``),
same tokens, float32 on both sides.  Tolerances: 1e-6 on the RoPE tables and
rotations (one float32 sin/cos/product per element), 1e-5 absolute on cache
tensors and 1e-4 on logits, as ``tests/test_torch_model.py`` states them;
greedy tokens must be EXACTLY equal."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as j_get_config
from repro.core import costmodel as j_cm
from repro.models import layers as JL
from repro.models import model as JM
from repro.serving import HybridServeEngine as JEngine
from repro.serving import exact_reference_generate as j_reference
from repro_torch import params as P
from repro_torch.configs import get_config
from repro_torch.core import costmodel as cm
from repro_torch.data.pipeline import request_trace
from repro_torch.models import layers as L
from repro_torch.models import model as M
from repro_torch.serving import HybridServeEngine, exact_reference_generate

torch.set_num_threads(1)
ROPE_TOL, LOGIT_TOL, CACHE_TOL = 1e-6, 1e-4, 1e-5
KV_CAP = ACT_CAP = 64
NAMES = ["yi-6b-reduced", "minitron-4b-reduced"]
_MODELS = {}


def _models(name):
    if name not in _MODELS:
        jcfg = j_get_config(name)
        jp = JM.init_params(jcfg, jax.random.PRNGKey(0))
        tp = P.from_numpy(jax.tree.map(np.asarray, jp), device="cpu")
        _MODELS[name] = (get_config(name), tp, jcfg, jp)
    return _MODELS[name]


def _close(mine, ref, tol, what):
    np.testing.assert_allclose(mine.float().numpy(), np.asarray(ref, np.float32),
                               atol=tol, err_msg=what)


def _tokens(cfg, B, S, seed):
    return np.random.default_rng(seed).integers(
        0, cfg.vocab_size, (B, S)).astype(np.int32)


@pytest.mark.parametrize("theta", [1e4, 5e6])
def test_rope_tables_and_rotation_match(theta):
    rng = np.random.default_rng(0)
    pos = rng.integers(0, 4096, (3, 20)).astype(np.int32)
    sin, cos = L.rope_sin_cos(torch.from_numpy(pos), 32, theta)
    jsin, jcos = JL.rope_sin_cos(jnp.asarray(pos), 32, theta)
    _close(sin, jsin, ROPE_TOL, "sin")
    _close(cos, jcos, ROPE_TOL, "cos")
    x = rng.standard_normal((3, 20, 4, 32)).astype(np.float32)
    got = L.apply_rope(torch.from_numpy(x), sin, cos)
    want = JL.apply_rope(jnp.asarray(x), jsin, jcos)
    _close(got, want, ROPE_TOL, "rotated x")
    assert got.dtype == torch.float32


# (head_dim, theta) of each RoPE config the port serves: gemma3-1b, yi-6b,
# minitron-4b
ROPE_CONFIGS = [(256, 1e6), (128, 5e6), (128, 1e4)]
TABLE_TOL = 1e-7


@pytest.mark.parametrize("head_dim,theta", ROPE_CONFIGS)
def test_rope_tables_match_jax_at_long_positions(head_dim, theta):
    """The port's own tables against the reference's up to position 131,072:
    the angle multiplies any error in a frequency by the position, so a
    one-ulp frequency shows here as ~1e-4 in sin (float32 ``pow``; the
    frequencies are computed in float64 and rounded once)."""
    rng = np.random.default_rng(int(theta))
    pos = np.concatenate([np.arange(64), rng.integers(0, 131_073, 4096),
                          np.arange(131_073 - 64, 131_073)]).astype(np.int32)
    sin, cos = L.rope_sin_cos(torch.from_numpy(pos)[None], head_dim, theta)
    jsin, jcos = JL.rope_sin_cos(jnp.asarray(pos)[None], head_dim, theta)
    _close(sin, jsin, TABLE_TOL, "sin")
    _close(cos, jcos, TABLE_TOL, "cos")


def test_apply_rope_rounds_back_to_the_input_dtype():
    x = torch.randn(2, 5, 3, 16, generator=torch.Generator().manual_seed(0))
    sin, cos = L.rope_sin_cos(torch.arange(5)[None], 16, 1e4)
    got = L.apply_rope(x.to(torch.bfloat16), sin, cos)
    want = L.apply_rope(x.to(torch.bfloat16).float(), sin, cos)
    assert got.dtype == torch.bfloat16
    assert torch.equal(got, want.to(torch.bfloat16))


@pytest.mark.parametrize("name", NAMES)
def test_params_bridge_and_init_keep_the_pytree(name):
    """``from_numpy`` copies the untied ``unembed``, the gated ``w3`` (yi)
    and no ``pos_embed``; the port's own ``init_params`` makes the same keys
    and shapes."""
    cfg, tp, jcfg, jp = _models(name)
    flat = jax.tree_util.tree_flatten_with_path(jp)[0]
    for path, leaf in flat:
        node = tp
        for key in path:
            node = node[key.key]
        assert tuple(node.shape) == leaf.shape and node.device.type == "cpu"
        np.testing.assert_array_equal(node.numpy(), np.asarray(leaf))
    assert "unembed" in tp and "pos_embed" not in tp
    assert ("w3" in tp["layers"]["ffn"]) == cfg.ffn_type.startswith("gated")
    mine = M.init_params(cfg, seed=0, device="cpu")
    shapes = lambda t: jax.tree.map(lambda a: tuple(a.shape), t)
    assert shapes(mine) == shapes(jp)


@pytest.mark.parametrize("name", NAMES)
def test_plain_prefill_and_decode_match(name):
    cfg, tp, jcfg, jp = _models(name)
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


# the splits and store schedule of tests/test_torch_model.py
SPLITS = {"zero": [0, 0, 0], "mixed": [16, 32, 16], "full": [48, 32, 48]}
SCHED = np.array([[True, False, True], [False, False, True],
                  [True, True, False], [False, True, False]])


@pytest.mark.parametrize("split", sorted(SPLITS))
@pytest.mark.parametrize("name", NAMES)
def test_hybrid_prefill_and_decode_match(name, split):
    """K/V/ACT/act_pos after prefill and every decode step, and the logits:
    the ACT region's K are recomputed and rotated at the recorded,
    interleaving ``act_pos`` (the schedule appends to both regions)."""
    cfg, tp, jcfg, jp = _models(name)
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


@pytest.mark.parametrize("name", NAMES)
def test_hybrid_decode_with_a_too_small_act_bound_matches_jax(name):
    """An ``act_pages_bound`` below what requests hold drops each request's
    ACT tokens past it from attention, as the reference's ``act_bound``
    does, and no page-table entry reaches past the request's scratch pages
    (the ``mixed`` split holds 32 ACT tokens in requests 0 and 2; the bound
    is one page)."""
    cfg, tp, jcfg, jp = _models(name)
    toks = _tokens(cfg, 3, 48, seed=3)
    kv_keep = np.array(SPLITS["mixed"], np.int32)
    last_pos = np.array([48, 32, 48], np.int32)
    lg, cache = M.hybrid_prefill_batched(
        tp, cfg, torch.from_numpy(toks), KV_CAP, ACT_CAP,
        torch.from_numpy(kv_keep), torch.from_numpy(last_pos))
    jlg, jcache = JM.hybrid_prefill_batched(
        jp, jcfg, {"tokens": jnp.asarray(toks)}, KV_CAP, ACT_CAP,
        jnp.asarray(kv_keep), jnp.asarray(last_pos))
    step = jax.jit(lambda p, tok, c, s: JM.hybrid_decode_step(
        p, jcfg, tok, c, s, act_bound=16))
    tok = np.array(jnp.argmax(jlg[:, -1], -1), np.int32)[:, None]
    keys = ("k", "v", "act", "act_pos", "kv_len", "act_len")
    for s, store in enumerate(SCHED):
        lg, cache = M.hybrid_decode_step(tp, cfg, torch.from_numpy(tok), cache,
                                         torch.from_numpy(store), act_pages_bound=1)
        jlg, jcache = step(jp, jnp.asarray(tok), jcache, jnp.asarray(store))
        _close(lg, jlg, LOGIT_TOL, f"decode logits, step {s}")
        for key in keys:
            _close(cache[key], jcache[key], CACHE_TOL, f"{key}, step {s}")
        tok = np.array(jnp.argmax(jlg[:, -1], -1), np.int32)[:, None]
    assert int(cache["act_len"].max()) > 16           # the bound was short


def test_hybrid_decode_loop_bounds_match_stepwise(monkeypatch):
    """The greedy loop with tight ``pages_bound``/``act_pages_bound`` gives
    the tokens of the step-by-step path over every page; ``kv_gen`` runs
    once per layer and step over the bounded prefix, and not at all with an
    ACT bound of 0 (nothing held as ACT)."""
    cfg, tp, _, _ = _models("yi-6b-reduced")
    toks = torch.from_numpy(_tokens(cfg, 3, 48, seed=2))
    last_pos = torch.tensor([48, 32, 48], dtype=torch.int32)
    calls = []
    real = M.kv_gen
    monkeypatch.setattr(M, "kv_gen", lambda *a, **k: calls.append(
        k["page_index"].numel()) or real(*a, **k))

    def fresh(kv_keep):
        lg, c = M.hybrid_prefill_batched(tp, cfg, toks, KV_CAP, ACT_CAP,
                                         kv_keep, last_pos)
        return lg[:, -1].argmax(-1).int(), c

    kv_keep = torch.tensor(SPLITS["mixed"], dtype=torch.int32)
    sched = torch.from_numpy(SCHED)
    kv_end = kv_keep + (~sched).sum(0).int()
    act_end = last_pos - kv_keep + sched.sum(0).int()
    act_bound = int(((act_end + 15) // 16).max())
    bound = int(((kv_end + 15) // 16 + (act_end + 15) // 16).max())
    cur, cache = fresh(kv_keep)
    got, _ = M.hybrid_decode_loop(tp, cfg, cur, cache, sched,
                                  pages_bound=bound, act_pages_bound=act_bound)
    assert calls == [3 * act_bound] * (cfg.num_layers * len(SCHED))
    cur, cache = fresh(kv_keep)
    want = [cur]
    for store in SCHED[:-1]:
        lg, cache = M.hybrid_decode_step(tp, cfg, want[-1][:, None], cache,
                                         torch.from_numpy(store))
        want.append(lg[:, -1].argmax(-1).int())
    assert act_bound < ACT_CAP // 16 and bound < KV_CAP // 16 + ACT_CAP // 16
    assert torch.equal(got, torch.stack(want, 1))

    calls.clear()                     # all KV: the ACT bound is 0
    cur, cache = fresh(last_pos)
    kv_sched = torch.zeros_like(sched)
    M.hybrid_decode_loop(tp, cfg, cur, cache, kv_sched, pages_bound=4,
                         act_pages_bound=0)
    assert calls == []


# at reduced widths the H100 spec keeps almost all of the context as ACT; a
# 20 TFLOP/s spec splits each prompt, so the decode runs both page types
MIXED = dataclasses.replace(cm.H100_SXM, name="h100-20tflops", flops=2e13)
CASES = {"hybrid": ("hybrid", cm.H100_SXM), "kv": ("kv", cm.H100_SXM),
         "hybrid-mixed": ("hybrid", MIXED)}
_ENGINE = {}


def _engine_setup():
    if not _ENGINE:
        cfg, tp, jcfg, jp = _models("yi-6b-reduced")
        reqs = request_trace(1024, n_requests=3, prompt_mean=40, gen_tokens=6,
                             seed=7)
        _ENGINE["v"] = (cfg, tp, jcfg, jp, reqs, j_reference(jcfg, jp, reqs))
    return _ENGINE["v"]


def test_oracle_matches_jax_oracle():
    cfg, tp, _, _, reqs, j_ref = _engine_setup()
    ref = exact_reference_generate(cfg, tp, reqs, device="cpu")
    for r in reqs:
        np.testing.assert_array_equal(ref[r.rid], j_ref[r.rid])


@pytest.mark.parametrize("case", sorted(CASES))
def test_engine_matches_jax_engine_and_oracle(case):
    cfg, tp, jcfg, jp, reqs, j_ref = _engine_setup()
    mode, hw = CASES[case]
    eng = HybridServeEngine(cfg, tp, mode=mode, hw=hw, device="cpu")
    j_eng = JEngine(jcfg, jp, mode=mode,
                    hw=j_cm.HardwareSpec(**dataclasses.asdict(hw)))
    assert eng.act_frac == j_eng.act_frac
    groups = eng.plan_groups(reqs)
    assert [[r.rid for r in g] for g in groups] == \
        [[r.rid for r in g] for g in j_eng.plan_groups(reqs)]
    out, stats = eng.generate(reqs)
    j_out, j_stats = j_eng.generate(reqs)
    for r in reqs:
        np.testing.assert_array_equal(out[r.rid], j_out[r.rid])
        np.testing.assert_array_equal(out[r.rid], j_ref[r.rid])
    assert stats.device_calls == j_stats.device_calls == 2 * len(groups)
    assert stats.generated_tokens == j_stats.generated_tokens
    assert all(p.allocated == 0 for p in eng.blockman.pools.values())
    _, kv_keep, pbs, _, _, act_bound = eng.group_schedule(groups[0])
    if mode == "kv":
        assert act_bound == 0
    else:
        assert act_bound > 0
    if case == "hybrid-mixed":       # both page types on the decode path
        assert ((kv_keep > 0) & (kv_keep < np.asarray(pbs))).any()


@pytest.mark.parametrize("change", [{"pos_type": "mrope"}, {"qk_norm": True},
                                    {"window_period": 2, "sliding_window": 64},
                                    {"arch_type": "hybrid", "moe_num_experts": 4},
                                    {"arch_type": "moe", "moe_num_experts": 4,
                                     "moe_every": 2}],
                         ids=lambda c: "-".join(c))
def test_engine_and_init_refuse_unsupported_configs(change):
    """The engine serves the uniform family without q/k norm, MoE in every
    layer included; the model functions also serve q/k norm (with RoPE) and
    the windowed family, and refuse the rest: experts under another arch
    type, and MoE in every other layer (jamba's)."""
    cfg = dataclasses.replace(get_config("yi-6b-reduced"), **change)
    tp = _models("yi-6b-reduced")[1]
    with pytest.raises(NotImplementedError, match="uniform-family"):
        HybridServeEngine(cfg, tp, device="cpu")
    if "qk_norm" in change or "window_period" in change:
        assert "periods" in M.init_params(cfg, device="cpu") or cfg.qk_norm
        return
    with pytest.raises(NotImplementedError, match="uniform-family"):
        M.init_params(cfg, device="cpu")
