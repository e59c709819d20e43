"""Parameter bridge: a tree of numpy arrays (the JAX pytree after
``jax.tree.map(np.asarray, params)``) -> the port's params dict."""
from __future__ import annotations

import numpy as np
import torch


def _tensor(a, device) -> torch.Tensor:
    a = np.array(a)                        # contiguous, writable copy
    if a.dtype.name == "bfloat16":         # ml_dtypes' bfloat16: bit-cast
        return torch.from_numpy(a.view(np.uint16)).view(torch.bfloat16).to(device)
    return torch.from_numpy(a).to(device)


def from_numpy(tree, device="cuda"):
    """Same keys, same layouts (stacked layers on dim 0, weights
    ``(d_in, d_out)``), same dtypes; every leaf copied onto ``device``."""
    if isinstance(tree, dict):
        return {k: from_numpy(v, device) for k, v in tree.items()}
    return _tensor(tree, device)
