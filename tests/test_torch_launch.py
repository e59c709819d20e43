"""The port's launchers against the reference's CLIs: ``launch.train``'s
first losses and ``launch.serve``'s tokens (plain engine and continuous
server, ``--verify``), on the reference's weights (``--init``, a
checkpoint written by ``repro.checkpoint``), plus ``--trace``'s Chrome
trace and the refusals of a mesh.  Losses within 1e-4 (three float32
train steps, where the reference compiles with XLA and the port runs eager
torch); tokens equal."""
import json

import jax
import numpy as np
import pytest
import torch

from repro import checkpoint as jck
from repro.configs import get_config as j_get_config
from repro.launch import serve as jserve
from repro.launch import train as jtrain
from repro.models import model as JM
from repro_torch.launch import serve, train
from repro_torch.obs import validate_chrome_trace

torch.set_num_threads(1)
LOSS_TOL = 1e-4
SERVE = ["--arch", "opt-6.7b-reduced", "--requests", "4", "--prompt-mean",
         "24", "--gen-tokens", "5", "--verify"]


def _init(tmp_path, name):
    path = str(tmp_path / name)
    jp = JM.init_params(j_get_config(name), jax.random.PRNGKey(0))
    jck.save(path, {"params": jp}, metadata={"arch": name})
    return path


def test_train_cli_gives_the_reference_losses(tmp_path, capsys):
    """``python -m repro_torch.launch.train --arch minitron-4b-reduced
    --device cpu --steps 3`` from the reference's weights: the reference
    CLI's three losses, the same step lines, and a checkpoint the reference
    reads back."""
    args = ["--arch", "minitron-4b-reduced", "--steps", "3", "--batch", "2",
            "--seq", "32", "--log-every", "1"]
    want = jtrain.main(args)
    ref_lines = [l for l in capsys.readouterr().out.splitlines()
                 if l.startswith("step")]
    save = str(tmp_path / "trained")
    got = train.main(args + ["--device", "cpu", "--init",
                             _init(tmp_path, "minitron-4b-reduced"),
                             "--save", save])
    lines = [l for l in capsys.readouterr().out.splitlines()
             if l.startswith("step")]
    assert len(got) == len(want) == 3
    np.testing.assert_allclose(got, want, rtol=0, atol=LOSS_TOL)
    assert got[-1] < got[0]
    # the same lines up to the seconds per step (and the last digit)
    cut = lambda l: l.split(" loss=")[0]
    assert [cut(l) for l in lines] == [cut(l) for l in ref_lines]
    meta = jck.load_metadata(save)
    assert meta["arch"] == "minitron-4b-reduced" and meta["steps"] == 3


@pytest.mark.parametrize("extra", [[], ["--continuous", "--chunk-steps", "2"]],
                         ids=["engine", "continuous"])
def test_serve_cli_gives_the_reference_tokens(tmp_path, extra):
    """The serve CLI on opt-6.7b-reduced, ``--device cpu --verify``: the
    reference CLI's tokens for every request, the engine's or the
    server's."""
    want, _ = jserve.main(SERVE + extra)
    got, stats = serve.main(SERVE + extra + [
        "--device", "cpu", "--init", _init(tmp_path, "opt-6.7b-reduced")])
    assert set(got) == set(want)
    for rid in want:
        np.testing.assert_array_equal(got[rid], want[rid])
    assert stats.generated_tokens == sum(len(t) for t in want.values())


def test_serve_cli_trace_and_wall_clock(tmp_path, capsys):
    """``--trace`` writes a valid Chrome trace, ``--snapshot`` prints the
    metrics; the run prints its wall-clock rate on the CPU beside the
    figure simulated on H100_SXM."""
    out = str(tmp_path / "trace.json")
    serve.main(SERVE + ["--device", "cpu", "--trace", out, "--snapshot"])
    text = capsys.readouterr().out
    assert "measured on cpu:" in text and "simulated on h100-sxm" in text
    assert "metrics snapshot:" in text
    events = json.load(open(out))
    validate_chrome_trace(events)
    assert any(e.get("ph") == "X" for e in
               (events["traceEvents"] if isinstance(events, dict) else events))


@pytest.mark.parametrize("bad", [["--mesh", "2,2"], ["--explain-plan"]],
                         ids=["mesh", "explain-plan"])
def test_serve_cli_refuses_a_mesh(bad, capsys):
    """An MoE model, refused under a mesh until item 5.2.3, now serves on
    one (expert parallel, token-exact with ``--verify``) and explains its
    plan (the experts split over 'model'); a family the engine does not
    serve is refused under a mesh, whether served or explained."""
    mesh = bad if "--mesh" in bad else ["--mesh", "1,2"] + bad
    if "--explain-plan" in bad:
        assert serve.main(["--arch", "dbrx-132b-reduced", "--device", "cpu"]
                          + mesh) == (None, None)
        assert "layers/ffn/we1[1]" in capsys.readouterr().out
    else:
        serve.main(["--arch", "dbrx-132b-reduced", "--device", "cpu",
                    "--requests", "2", "--gen-tokens", "3", "--verify"]
                   + mesh)
        assert "token-exact vs full-KV reference: True" in \
            capsys.readouterr().out
    with pytest.raises(SystemExit):
        serve.main(["--arch", "mamba2-2.7b-reduced", "--device", "cpu"]
                   + mesh)
    assert "not served by" in capsys.readouterr().err
