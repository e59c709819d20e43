"""Training launcher of the port: real steps on the card, or on the CPU with
``--device cpu``.

  PYTHONPATH=src python -m repro_torch.launch.train --arch minitron-4b-reduced --device cpu --steps 3
  PYTHONPATH=src python -m repro_torch.launch.train --arch minitron-4b --batch 4 --seq 512 --steps 5

Every family trains (``T.check_supported(cfg, "train")``; the ssm and
hybrid families' SSD layers through the ``ssd_scan`` kernel's backward on
the card); the vision frontend's patches and the encdec family's frames
are zeros, as the reference CLI's are (in the model's dtype here: torch
does not mix a float32 input with bfloat16 weights in a product).  The
weights are the port's ``init_params`` at seed 0, or with ``--init PATH``
those of a checkpoint written by either package (``repro.checkpoint`` or
``repro_torch.checkpoint``: ``{"params": ...}``), so the same weights give
the reference CLI's losses.  The step lines are the reference's.
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch import checkpoint
from repro_torch.configs import get_config
from repro_torch.data import DataConfig, lm_batches
from repro_torch.launch.specs import make_train_step, params_shape
from repro_torch.models import model as M
from repro_torch.models.transformer import torch_dtype
from repro_torch.optim import adamw


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--save", default=None)
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--init", default=None, metavar="PATH",
                    help="start from the params of this checkpoint")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    cfg = get_config(args.arch)
    if args.init:
        params = checkpoint.restore(args.init, {"params": params_shape(cfg)},
                                    device=args.device)["params"]
    else:
        params = M.init_params(cfg, seed=0, device=args.device)
    opt_cfg = adamw.AdamWConfig(lr=args.lr, warmup_steps=max(args.steps // 10, 1),
                                total_steps=args.steps)
    opt_state = adamw.init(params)
    step_fn = make_train_step(cfg, opt_cfg)

    data = DataConfig(vocab_size=cfg.vocab_size, seq_len=args.seq,
                      batch_size=args.batch)
    it = lm_batches(data)

    losses = []
    t0 = time.time()
    for step in range(args.steps):
        raw = next(it)
        batch = {k: torch.from_numpy(raw[k]).to(args.device)
                 for k in ("tokens", "labels")}
        if cfg.frontend == "vision_stub":
            batch["patches"] = torch.zeros(
                (args.batch, cfg.frontend_tokens, cfg.d_model),
                dtype=torch_dtype(cfg), device=args.device)
        if cfg.is_encoder_decoder:
            batch["frames"] = torch.zeros(
                (args.batch, cfg.enc_seq_len, cfg.d_model),
                dtype=torch_dtype(cfg), device=args.device)
        params, opt_state, metrics = step_fn(params, opt_state, batch)
        losses.append(float(metrics["loss"]))
        if step % args.log_every == 0 or step == args.steps - 1:
            print(f"step {step:5d} loss={losses[-1]:.4f} "
                  f"lr={float(metrics['lr']):.2e} gnorm={float(metrics['gnorm']):.2f} "
                  f"({(time.time()-t0)/(step+1):.2f}s/step)")
    assert np.isfinite(losses).all(), "NaN loss"
    print(f"final loss {losses[-1]:.4f} (start {losses[0]:.4f}) "
          f"improved={losses[-1] < losses[0]}")
    if args.save:
        checkpoint.save(args.save, {"params": params},
                        metadata={"arch": args.arch, "steps": args.steps,
                                  "final_loss": losses[-1]})
        print(f"saved checkpoint to {args.save}.npz")
    return losses


if __name__ == "__main__":
    main()
