"""The port's checkpoint store: every case of the reference's store tests
(``tests/test_checkpoint_store.py``, ``tests/test_substrate.py``'s round
trip and shape check) on torch trees, a checkpoint written by either
package restored by the other (float32 and bfloat16, exactly), and
restore-then-train.  Values compare exactly (a restore is a copy)."""
import dataclasses
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import checkpoint as jck
from repro.configs import get_config as j_get_config
from repro.models import model as JM
from repro_torch import checkpoint as ck
from repro_torch import params as P
from repro_torch.configs import get_config
from repro_torch.launch.specs import params_shape
from repro_torch.models import model as M
from repro_torch.optim import adamw

torch.set_num_threads(1)


def _tree(dtype):
    return {
        "layers": {"w": torch.arange(12, dtype=torch.float32).reshape(3, 4)
                   .to(dtype)},
        "embed": torch.linspace(-2.0, 2.0, 10).to(dtype),
        "scalars": [torch.ones((2,), dtype=torch.float32),
                    torch.zeros((1,), dtype=torch.int32)],
    }


def _leaves(tree, path=""):
    """{path: leaf} of a tree of dicts and lists."""
    if isinstance(tree, dict):
        items = tree.items()
    elif isinstance(tree, (list, tuple)):
        items = enumerate(tree)
    else:
        return {path: tree}
    return {k: v for key, sub in items
            for k, v in _leaves(sub, f"{path}/{key}").items()}


def _same(got, want):
    got, want = _leaves(got), _leaves(want)
    assert set(got) == set(want)
    for key, w in want.items():
        g = got[key]
        assert g.dtype == w.dtype and g.shape == w.shape, key
        assert torch.equal(g, w), key


def test_bf16_bitcast_round_trip(tmp_path):
    """bfloat16 leaves survive the ::bf16 uint16 bit-cast exactly and come
    back as bfloat16."""
    path = str(tmp_path / "ck")
    tree = _tree(torch.bfloat16)
    ck.save(path, tree, metadata={"arch": "unit"})
    _same(ck.restore(path, tree), tree)
    meta_keys = set(json.load(open(path + ".meta.json"))["keys"])
    assert "layers/w::bf16" in meta_keys and "scalars/#1" in meta_keys


def test_cross_dtype_restore_still_allowed(tmp_path):
    path = str(tmp_path / "ck")
    ck.save(path, _tree(torch.bfloat16), metadata={})
    out = ck.restore(path, _tree(torch.float32))
    assert out["layers"]["w"].dtype == torch.float32
    path2 = str(tmp_path / "ck2")
    ck.save(path2, _tree(torch.float32), metadata={})
    out2 = ck.restore(path2, _tree(torch.bfloat16))
    assert out2["layers"]["w"].dtype == torch.bfloat16


def test_shard_suffix_layout_hook(tmp_path):
    path = str(tmp_path / "sharded")
    tree = _tree(torch.float32)
    ck.save(path, tree, metadata={"host": 0}, shard_suffix="-of2.0")
    assert os.path.exists(path + "-of2.0.npz")
    assert not os.path.exists(path + ".npz")
    assert os.path.exists(path + ".meta.json")
    _same(ck.restore(path, tree, shard_suffix="-of2.0"), tree)
    assert ck.load_metadata(path) == {"host": 0}


def test_restore_rejects_mismatched_structure(tmp_path):
    path = str(tmp_path / "ck")
    tree = _tree(torch.float32)
    ck.save(path, tree, metadata={"arch": "unit"})
    wrong = dict(tree, extra_head=torch.zeros(3))
    with pytest.raises(ValueError, match="does not match"):
        ck.restore(path, wrong)
    with pytest.raises(ValueError, match="unexpected"):
        ck.restore(path, {"embed": tree["embed"]})


def test_restore_expect_metadata_without_sidecar(tmp_path):
    path = str(tmp_path / "ck")
    tree = _tree(torch.float32)
    ck.save(path, tree)
    os.remove(path + ".meta.json")
    ck.restore(path, tree)                              # no sidecar: fine
    with pytest.raises(ValueError, match="no .meta.json"):
        ck.restore(path, tree, expect_metadata={"arch": "opt"})


def test_restore_rejects_mismatched_metadata(tmp_path):
    path = str(tmp_path / "ck")
    tree = _tree(torch.float32)
    ck.save(path, tree, metadata={"arch": "opt-6.7b", "step": 100})
    ck.restore(path, tree, expect_metadata={"arch": "opt-6.7b"})
    with pytest.raises(ValueError, match="metadata mismatch"):
        ck.restore(path, tree, expect_metadata={"arch": "yi-6b"})
    with pytest.raises(ValueError, match="metadata mismatch"):
        ck.restore(path, tree, expect_metadata={"step": 200})


def test_restore_rejects_truncated_shard(tmp_path):
    path = str(tmp_path / "ck")
    tree = _tree(torch.float32)
    ck.save(path, tree, metadata={})
    blob = open(path + ".npz", "rb").read()
    with open(path + ".npz", "wb") as f:
        f.write(blob[: len(blob) // 2])
    with pytest.raises(ValueError, match="truncated or corrupted"):
        ck.restore(path, tree)


def test_restore_rejects_bit_corrupted_member(tmp_path):
    path = str(tmp_path / "ck")
    tree = _tree(torch.float32)
    ck.save(path, tree, metadata={})
    blob = bytearray(open(path + ".npz", "rb").read())
    blob[200] ^= 0xFF
    with open(path + ".npz", "wb") as f:
        f.write(bytes(blob))
    with pytest.raises(ValueError, match="truncated or corrupted"):
        ck.restore(path, tree)


def test_restore_rejects_content_checksum_mismatch(tmp_path):
    path = str(tmp_path / "ck")
    tree = _tree(torch.float32)
    ck.save(path, tree, metadata={})
    data = dict(np.load(path + ".npz"))
    victim = sorted(data)[0]
    data[victim] = data[victim] + 1             # valid zip, wrong contents
    np.savez(path + ".npz", **data)
    with pytest.raises(ValueError, match="content checksum"):
        ck.restore(path, tree)
    meta = json.load(open(path + ".meta.json"))
    del meta["crc32"]
    json.dump(meta, open(path + ".meta.json", "w"))
    assert ck.restore(path, tree)["embed"] is not None   # old sidecar


def test_checkpoint_roundtrip_and_shape_mismatch(tmp_path):
    tree = {"a": torch.arange(6, dtype=torch.float32).reshape(2, 3),
            "b": {"c": torch.ones(4, dtype=torch.bfloat16)}}
    path = str(tmp_path / "ck")
    ck.save(path, tree, metadata={"step": 7})
    out = ck.restore(path, adamw.tree_map(torch.zeros_like, tree))
    _same(out, tree)
    assert ck.load_metadata(path)["step"] == 7
    path2 = str(tmp_path / "ck2")
    ck.save(path2, {"a": torch.zeros(2, 2)})
    with pytest.raises(ValueError, match="shape"):
        ck.restore(path2, {"a": torch.zeros(3, 3)})


def test_optimizer_state_keys_are_the_references(tmp_path):
    """A NamedTuple (``AdamWState``) flattens to its field names, as
    ``jax.tree_util`` names them: the reference restores the port's
    optimizer state."""
    tp = {"w": torch.randn(3, 2), "b": {"c": torch.randn(2)}}
    state = adamw.init(tp)
    path = str(tmp_path / "opt")
    ck.save(path, state)
    jlike = jax.tree.map(lambda t: jnp.asarray(t.numpy()), tuple(state))
    from repro.optim.adamw import AdamWState as JState
    out = jck.restore(path, JState(*jlike))
    assert int(out.step) == 0 and out.m["w"].shape == (3, 2)
    mine = ck.restore(path, state)
    assert isinstance(mine, adamw.AdamWState) and mine.step.shape == ()
    _same(mine._asdict(), state._asdict())


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_checkpoints_cross_between_the_packages(tmp_path, dtype):
    """The reference's params saved by ``repro.checkpoint`` restore through
    ``repro_torch.checkpoint`` (into the ``meta`` specs) to the tensors
    ``from_numpy`` gives, and the port's saved params restore through the
    reference to the same arrays."""
    name = "yi-6b-reduced"
    jcfg = dataclasses.replace(j_get_config(name), dtype=dtype)
    cfg = dataclasses.replace(get_config(name), dtype=dtype)
    jp = JM.init_params(jcfg, jax.random.PRNGKey(0))
    want = P.from_numpy(jax.tree.map(np.asarray, jp), device="cpu")
    path = str(tmp_path / "from_jax")
    jck.save(path, {"params": jp}, metadata={"arch": name})
    got = ck.restore(path, {"params": params_shape(cfg)}, device="cpu",
                     expect_metadata={"arch": name})["params"]
    _same(got, want)
    path2 = str(tmp_path / "from_torch")
    ck.save(path2, {"params": want}, metadata={"arch": name})
    back = jck.restore(path2, {"params": jp},
                       expect_metadata={"arch": name})["params"]
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(jp), strict=True):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(np.asarray(a, np.float32),
                                      np.asarray(b, np.float32))


def test_restore_then_train(tmp_path):
    """Save -> restore -> the same loss (the reference's
    ``test_checkpoint_resume_training`` on a model the port trains): the
    reference's params through the reference's store, the loss of the
    port's restored params against the reference's on the originals."""
    name = "yi-6b-reduced"
    jcfg, cfg = j_get_config(name), get_config(name)
    jp = JM.init_params(jcfg, jax.random.PRNGKey(0))
    path = str(tmp_path / "resume")
    jck.save(path, {"params": jp})
    restored = ck.restore(path, {"params": params_shape(cfg)},
                          device="cpu")["params"]
    tokens = np.ones((2, 16), np.int32)
    batch = {"tokens": tokens, "labels": tokens}
    l1, _ = JM.apply_train(jp, jcfg, jax.tree.map(jnp.asarray, batch),
                           remat=False)
    l2, _ = M.apply_train(restored, cfg,
                          {k: torch.from_numpy(v) for k, v in batch.items()},
                          remat=False)
    assert abs(float(l1) - l2.item()) < 1e-4
