"""The port stands alone: no JAX, nothing of the JAX package, and its entry
points default to the card."""
import inspect
import os
import re
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from repro_torch import params as P
from repro_torch.configs import get_config
from repro_torch.models import model as M
from repro_torch.models import quantized_cache as QC
from repro_torch.offload import host_pool as HP
from repro_torch.offload.executor import OffloadExecutor
from repro_torch.serving import engine as E
from repro_torch.serving import scheduler as S

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"
FORBIDDEN = re.compile(r"^\s*(import\s+(jax|repro)\b(?!_)|from\s+(jax|repro)\b(?!_))",
                       re.MULTILINE)
PORT_FILES = sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]


def _modules():
    for p in sorted(PORT.rglob("*.py")):
        rel = p.relative_to(PORT.parent).with_suffix("")
        yield ".".join(rel.parts[:-1] if rel.name == "__init__" else rel.parts)


@pytest.mark.parametrize("path", PORT_FILES,
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_sources_import_no_jax_and_no_repro(path):
    src = path.read_text()
    assert not FORBIDDEN.search(src), FORBIDDEN.search(src).group(0)


def test_forbidden_pattern_catches_what_it_should():
    for bad in ("import jax", "from jax import numpy", "import repro.core",
                "from repro.models import model", "  from repro import x"):
        assert FORBIDDEN.search(bad), bad
    for ok in ("from repro_torch.core import x", "import repro_torch",
               "import numpy  # jax-free"):
        assert not FORBIDDEN.search(ok), ok


def test_importing_every_port_module_loads_no_jax():
    mods = list(_modules()) + ["chip_smoke"]
    code = ("import importlib, sys\n"
            f"for m in {mods!r}: importlib.import_module(m)\n"
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'repro'))\n"
            "print(len(sys.modules)); assert not bad, bad\n")
    env = dict(os.environ, PYTHONPATH=f"{ROOT / 'src'}{os.pathsep}{ROOT}")
    res = subprocess.run([sys.executable, "-c", code], env=env, cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr


@pytest.mark.parametrize("fn", [M.init_params, M.init_cache,
                                M.init_hybrid_cache, P.from_numpy,
                                E.HybridServeEngine.__init__,
                                E.exact_reference_generate,
                                S.ContinuousBatchingServer.__init__,
                                HP.HostWeightPool.__init__,
                                HP.HostBlockPool.__init__, HP.make_spill_pool,
                                OffloadExecutor.__init__, QC.init_cache_q8],
                         ids=lambda f: f.__qualname__)
def test_entry_points_default_to_cuda(fn):
    assert inspect.signature(fn).parameters["device"].default == "cuda"


@pytest.mark.parametrize("make", [
    lambda cfg: M.init_params(cfg),
    lambda cfg: M.init_cache(cfg, 1, 16),
    lambda cfg: M.init_hybrid_cache(cfg, 1, 16, 16)],
    ids=["init_params", "init_cache", "init_hybrid_cache"])
def test_windowed_entry_points_default_to_cuda(make):
    """The windowed family's branches allocate on the card by default: every
    tensor lies on it, or, where this build has no CUDA, the call raises
    instead of falling back to the CPU.  ``hybrid_prefill`` takes no device:
    it follows its tokens', as ``hybrid_prefill_batched`` does."""
    cfg = get_config("gemma3-1b-reduced")
    assert "device" not in inspect.signature(M.hybrid_prefill).parameters
    if not torch.cuda.is_available():
        with pytest.raises((AssertionError, RuntimeError), match="CUDA"):
            make(cfg)
        return
    tree = make(cfg)
    leaves = [tree]
    while leaves:
        t = leaves.pop()
        if isinstance(t, dict):
            leaves += list(t.values())
        else:
            assert t.device.type == "cuda"


@pytest.mark.parametrize("make", [
    lambda cfg: M.init_params(cfg),
    lambda cfg: M.init_cache(cfg, 1, 16)], ids=["init_params", "init_cache"])
def test_ssm_entry_points_default_to_cuda(make):
    """The ssm family's branches (mamba2) allocate on the card by default,
    or raise where this build has no CUDA."""
    cfg = get_config("mamba2-2.7b-reduced")
    if not torch.cuda.is_available():
        with pytest.raises((AssertionError, RuntimeError), match="CUDA"):
            make(cfg)
        return
    tree = make(cfg)
    leaves = [tree]
    while leaves:
        t = leaves.pop()
        if isinstance(t, dict):
            leaves += list(t.values())
        else:
            assert t.device.type == "cuda"
