"""The six example drivers' twins (``examples/torch_*.py``) run on the CPU
with ``--device cpu``, in process, with their reference's configs, traces,
seeds and asserts: token-exact serving in every mode and under offload,
finite logits in every family, finite losses.  ``torch_train_lm`` runs one
step at a small batch here (its model is the reference's 100M-parameter
one); its 300-step loss-fall assert is held on the card by
``chip_smoke.py``."""
import runpy
from pathlib import Path

import pytest
import torch

torch.set_num_threads(1)

EXAMPLES = Path(__file__).resolve().parents[1] / "examples"
TWINS = {"quickstart": [], "serve_hybrid": [], "continuous_batching": [],
         "arch_zoo": [], "long_context_ssm": [],
         "train_lm": ["--steps", "1", "--batch", "1", "--seq", "16"]}


def test_every_reference_driver_has_a_twin():
    ref = {p.stem for p in EXAMPLES.glob("*.py") if not p.stem.startswith(
        "torch_")}
    assert ref == set(TWINS)
    assert {p.stem for p in EXAMPLES.glob("torch_*.py")} == \
        {"torch_" + n for n in TWINS}


@pytest.mark.parametrize("name", TWINS)
def test_twin_runs_on_the_cpu(name, tmp_path, monkeypatch, capsys):
    monkeypatch.chdir(tmp_path)            # train_lm writes its checkpoint
    ns = runpy.run_path(str(EXAMPLES / f"torch_{name}.py"), run_name="twin")
    ns["main"](["--device", "cpu"] + TWINS[name])
    out = capsys.readouterr().out
    assert ("token-exact vs offline decode: True" if name ==
            "continuous_batching" else "✓") in out
    if name == "train_lm":
        assert (tmp_path / "experiments/ckpt/train_lm.meta.json").exists()
