"""Shape specs and step functions per (arch, shape): counterpart of
``repro.launch.specs``.

The specs are tensors on ``torch.device("meta")``: the shapes and dtypes of
the params, the optimizer state, the caches and a batch, with no storage
(the reference's ``jax.eval_shape``).  The steps are plain functions over
the port's params: ``make_train_step`` returns one optimizer step with
optional sequential gradient accumulation over microbatches.
"""
from __future__ import annotations

from typing import Dict

import torch

from repro_torch.configs import InputShape, ModelConfig
from repro_torch.models import model as M
from repro_torch.models.transformer import torch_dtype
from repro_torch.optim import adamw

META = torch.device("meta")


def batch_specs_for(cfg: ModelConfig, shape: InputShape, *,
                    with_labels: bool) -> Dict[str, torch.Tensor]:
    B, S = shape.global_batch, shape.seq_len
    spec = lambda *dims, dtype=torch.int32: torch.empty(dims, dtype=dtype,
                                                        device=META)
    out: Dict[str, torch.Tensor] = {}
    if cfg.frontend == "vision_stub":
        P = cfg.frontend_tokens
        out["patches"] = spec(B, P, cfg.d_model, dtype=torch_dtype(cfg))
        S = S - P
    elif cfg.is_encoder_decoder:
        out["frames"] = spec(B, cfg.enc_seq_len, cfg.d_model,
                             dtype=torch_dtype(cfg))
    out["tokens"] = spec(B, S)
    if with_labels:
        out["labels"] = spec(B, S)
    return out


def params_shape(cfg: ModelConfig):
    return M.init_params(cfg, device=META)


def optstate_shape(cfg: ModelConfig):
    return adamw.init(params_shape(cfg))


def cache_shape(cfg: ModelConfig, B: int, max_len: int):
    return M.init_cache(cfg, B, max_len, device=META)


def hybrid_cache_shape(cfg: ModelConfig, B: int, kv_cap: int, act_cap: int):
    return M.init_hybrid_cache(cfg, B, kv_cap, act_cap, device=META)


# --------------------------------------------------------------------------- steps

def loss_and_grads(params, cfg: ModelConfig, batch):
    """-> (loss, metrics, grads): ``apply_train`` with remat, and the
    gradient of every leaf (a tree like ``params``, in each leaf's dtype).
    ``batch`` holds ``tokens`` and ``labels``, and the vision frontend's
    ``patches`` or the encdec family's ``frames`` (``batch_specs_for``).
    ``params`` are left as they were (no ``requires_grad``, no ``.grad``)."""
    flat = adamw.leaves(params)
    for p in flat:
        p.requires_grad_(True)
    try:
        with torch.enable_grad():
            loss, metrics = M.apply_train(params, cfg, batch, remat=True)
            grads = torch.autograd.grad(loss, flat, allow_unused=True)
    finally:
        for p in flat:
            p.requires_grad_(False)
    grad_of = {id(p): torch.zeros_like(p) if g is None else g
               for p, g in zip(flat, grads)}
    metrics = {k: v.detach() if isinstance(v, torch.Tensor) else v
               for k, v in metrics.items()}
    return loss.detach(), metrics, adamw.tree_map(lambda p: grad_of[id(p)],
                                                  params)


def make_train_step(cfg: ModelConfig,
                    opt_cfg: adamw.AdamWConfig = adamw.AdamWConfig(),
                    microbatches: int = 1):
    """One optimizer step, ``train_step(params, opt_state, batch) ->
    (params, opt_state, metrics)``; params, m and v are updated in place.
    ``microbatches`` > 1 accumulates float32 gradients over sequential
    slices of the batch's rows (activation memory / m), then averages the
    gradients and the loss.  Every entry of the batch (tokens, labels,
    patches, frames) is sliced by the same rows."""
    def train_step(params, opt_state, batch):
        if microbatches == 1:
            loss, metrics, grads = loss_and_grads(params, cfg, batch)
        else:
            n = next(iter(batch.values())).shape[0] // microbatches
            gsum = adamw.tree_map(lambda p: torch.zeros(
                p.shape, dtype=torch.float32, device=p.device), params)
            lsum = 0.0
            for i in range(microbatches):
                mb = {k: x[i * n:(i + 1) * n] for k, x in batch.items()}
                l, _, g = loss_and_grads(params, cfg, mb)
                for a, x in zip(adamw.leaves(gsum), adamw.leaves(g)):
                    a.add_(x.float())
                lsum = lsum + l
                del g
            grads = adamw.tree_map(lambda a: a.div_(microbatches), gsum)
            loss = lsum / microbatches
            metrics = {"ce": loss, "aux": torch.zeros((), device=loss.device)}
        params, opt_state, om = adamw.update(opt_cfg, params, grads, opt_state)
        return params, opt_state, {"loss": loss, **metrics, **om}
    return train_step


def make_prefill_step(cfg: ModelConfig, max_len: int):
    """``prefill_step(params, batch) -> (last_logits, cache)``; the batch's
    ``frames`` (encdec) or ``patches`` (vision) go with its tokens."""
    def prefill_step(params, batch):
        return M.prefill(params, cfg, batch["tokens"], max_len=max_len,
                         frames=batch.get("frames"),
                         patches=batch.get("patches"))
    return prefill_step


def make_decode_step(cfg: ModelConfig):
    def decode_step(params, token, cache):
        return M.decode_step(params, cfg, token, cache)
    return decode_step


def make_hybrid_decode_step(cfg: ModelConfig):
    def hybrid_step(params, token, cache, store_act):
        return M.hybrid_decode_step(params, cfg, token, cache, store_act)
    return hybrid_step
