"""AdamW with a warmup + cosine schedule (counterpart of
``repro.optim.adamw``, the same arithmetic in float32).

The optimizer state mirrors the params tree: m and v in float32, and the
step count as an int32 scalar.  ``update`` writes in place, the params, m
and v alike: at minitron-4b's size a second copy of m, v or the params
would be another 8.4 to 33.5 GB on the card.  Each leaf is updated in
slices of ``CHUNK`` elements, so the float32 temporaries stay a slice large
whatever the leaf (the embedding is 786 M elements).  Every scalar (the
gradient norm, the clip factor, the learning rate) stays a tensor on the
params' device: an update reads nothing back to the host.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any, NamedTuple

import torch

#: elements of a leaf updated at a time
CHUNK = 1 << 24


class AdamWState(NamedTuple):
    step: torch.Tensor
    m: Any
    v: Any


@dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    warmup_steps: int = 100
    total_steps: int = 10_000
    min_lr_frac: float = 0.1
    grad_clip: float = 1.0


def leaves(tree) -> list:
    """The tensors of a nested dict, keys sorted at each level (the order
    ``jax.tree.leaves`` takes, so sums over leaves add in the same order)."""
    if isinstance(tree, dict):
        return [t for k in sorted(tree) for t in leaves(tree[k])]
    return [tree]


def tree_map(fn, tree):
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    return fn(tree)


def cosine_lr(cfg: AdamWConfig, step):
    """step (int tensor) -> the float32 learning rate: linear warmup, then
    cosine decay to ``min_lr_frac`` of the peak."""
    step = step.float()
    warm = torch.clamp(step / max(cfg.warmup_steps, 1), max=1.0)
    prog = torch.clamp((step - cfg.warmup_steps)
                       / max(cfg.total_steps - cfg.warmup_steps, 1), 0.0, 1.0)
    cos = 0.5 * (1 + torch.cos(math.pi * prog))
    return cfg.lr * warm * (cfg.min_lr_frac + (1 - cfg.min_lr_frac) * cos)


def init(params) -> AdamWState:
    """Zero moments (float32) beside each leaf, step 0."""
    zeros = lambda p: torch.zeros(p.shape, dtype=torch.float32, device=p.device)
    dev = leaves(params)[0].device
    return AdamWState(step=torch.zeros((), dtype=torch.int32, device=dev),
                      m=tree_map(zeros, params), v=tree_map(zeros, params))


def global_norm(tree) -> torch.Tensor:
    """sqrt of the summed squares of every leaf, in float32."""
    return torch.sqrt(sum(x.float().square().sum() for x in leaves(tree)))


def _update_slice(cfg, p, g, m, v, clip, lr, b1c, b2c) -> None:
    """The reference's ``upd`` on flat slices, m, v and p written in place."""
    g = g.float() * clip
    m.mul_(cfg.b1).add_((1 - cfg.b1) * g)
    v.mul_(cfg.b2).add_((1 - cfg.b2) * g * g)
    p32 = p.float()
    step_ = m / b1c / (torch.sqrt(v / b2c) + cfg.eps) + cfg.weight_decay * p32
    p.copy_(p32 - lr * step_)


def update(cfg: AdamWConfig, params, grads, state: AdamWState):
    """-> (params, state, {"lr", "gnorm"}): one AdamW step, the gradients
    clipped to ``grad_clip`` by their global norm before the moments.  The
    params, m and v are updated in place (the returned trees are the ones
    passed in) and ``state.step`` is a new tensor."""
    gnorm = global_norm(grads)
    clip = torch.clamp(cfg.grad_clip / (gnorm + 1e-9), max=1.0)
    step = state.step + 1
    lr = cosine_lr(cfg, step)
    b1c = 1 - cfg.b1 ** step.float()
    b2c = 1 - cfg.b2 ** step.float()
    with torch.no_grad():
        for p, g, m, v in zip(leaves(params), leaves(grads), leaves(state.m),
                              leaves(state.v)):
            pf, gf, mf, vf = (t.view(-1) for t in (p, g.contiguous(), m, v))
            for i in range(0, pf.numel(), CHUNK):
                sl = slice(i, i + CHUNK)
                _update_slice(cfg, pf[sl], gf[sl], mf[sl], vf[sl], clip, lr,
                              b1c, b2c)
    return params, AdamWState(step, state.m, state.v), {"lr": lr, "gnorm": gnorm}
