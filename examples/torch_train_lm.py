"""End-to-end driver on the PyTorch port: train a ~100M-param dense LM for a
few hundred steps.

Uses the full framework stack: config -> model -> data pipeline -> AdamW ->
checkpointing.  The config is a scaled yi-style GQA decoder sized to ~100M
params (12L, d=768), trained on the synthetic structured corpus; loss must
drop substantially from its ~ln(V) start.  The reference trains it in
float32; on the card the flash kernel takes float16 and bfloat16 only, so
the card trains it in bfloat16 (printed), the loss check unchanged.  The
loss must fall by more than 0.5 over the full 300 steps; a shorter run
checks only that every loss is finite.

Runs on the card unless given ``--device cpu``.

Run:  PYTHONPATH=src python examples/torch_train_lm.py [--steps 300] [--device cpu]
"""
import argparse
import dataclasses
import time

import numpy as np
import torch

from repro_torch import checkpoint
from repro_torch.configs import get_config
from repro_torch.data import DataConfig, lm_batches
from repro_torch.launch.specs import make_train_step
from repro_torch.models import model as M
from repro_torch.optim import adamw

STEPS = 300


def build_100m(dtype: str = "float32"):
    base = get_config("yi-6b")
    return dataclasses.replace(
        base, name="yi-100m", num_layers=12, d_model=768, num_heads=12,
        num_kv_heads=4, head_dim=64, d_ff=2048, vocab_size=8192,
        max_seq_len=1024, dtype=dtype)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=STEPS)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    dev = torch.device(args.device)

    cfg = build_100m("bfloat16" if dev.type == "cuda" else "float32")
    n_params = cfg.num_params()
    print(f"model {cfg.name}: {n_params / 1e6:.0f}M params, {cfg.dtype} on "
          f"{args.device}")

    params = M.init_params(cfg, seed=0, device=dev)
    opt_cfg = adamw.AdamWConfig(lr=6e-4, warmup_steps=20,
                                total_steps=args.steps)
    opt_state = adamw.init(params)
    step_fn = make_train_step(cfg, opt_cfg)
    it = lm_batches(DataConfig(vocab_size=cfg.vocab_size, seq_len=args.seq,
                               batch_size=args.batch))

    losses, t0 = [], time.time()
    for step in range(args.steps):
        raw = next(it)
        batch = {k: torch.from_numpy(raw[k]).to(dev)
                 for k in ("tokens", "labels")}
        params, opt_state, metrics = step_fn(params, opt_state, batch)
        losses.append(float(metrics["loss"]))
        if step % 25 == 0 or step == args.steps - 1:
            print(f"step {step:4d} loss={losses[-1]:.4f} "
                  f"({(time.time() - t0) / (step + 1):.2f}s/step)")
    assert np.isfinite(losses).all()
    if args.steps >= STEPS:
        assert losses[-1] < losses[0] - 0.5, \
            "loss should fall on structured data"
    else:
        print(f"(the loss-fall check needs the full {STEPS} steps)")
    checkpoint.save("experiments/ckpt/train_lm", {"params": params},
                    metadata={"final_loss": losses[-1], "steps": args.steps})
    print(f"loss {losses[0]:.3f} -> {losses[-1]:.3f}; checkpoint saved ✓")
    return losses


if __name__ == "__main__":
    main()
