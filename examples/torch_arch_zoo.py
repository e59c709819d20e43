"""Walk the assigned architecture zoo on the PyTorch port: one reduced
forward+decode per family.

Runs on the card (each reduced config's float32 becomes its full config's
dtype there: the kernels take float16 and bfloat16) unless given
``--device cpu``.

Run:  PYTHONPATH=src python examples/torch_arch_zoo.py [--device cpu]
"""
import argparse

import torch

from repro_torch.configs import ASSIGNED, reduced
from repro_torch.models import model as M
from repro_torch.models.transformer import torch_dtype


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    dev = torch.device(args.device)
    for name in ASSIGNED:
        full = ASSIGNED[name]
        # the kernels take float16 and bfloat16: on the card the reduced
        # config keeps its full config's dtype (float32 is its CPU one)
        cfg = reduced(full, dtype=full.dtype) if dev.type == "cuda" \
            else reduced(full)
        params = M.init_params(cfg, seed=0, device=dev)
        B, S = 2, 32
        P = cfg.frontend_tokens if cfg.frontend == "vision_stub" else 0
        tokens = (torch.arange(B * S, dtype=torch.int32, device=dev)
                  .reshape(B, S) % cfg.vocab_size)
        extra = {}
        if P:
            extra["patches"] = torch.zeros((B, P, cfg.d_model),
                                           dtype=torch_dtype(cfg), device=dev)
        if cfg.is_encoder_decoder:
            extra["frames"] = torch.zeros((B, cfg.enc_seq_len, cfg.d_model),
                                          dtype=torch_dtype(cfg), device=dev)
        logits, cache = M.prefill(params, cfg, tokens, max_len=S + P + 8,
                                  **extra)
        tok = logits[:, -1].argmax(-1).int()[:, None]
        lg, cache = M.decode_step(params, cfg, tok, cache)
        assert torch.isfinite(lg).all() and torch.isfinite(logits).all()
        print(f"{name:24s} [{cfg.arch_type:6s}] {M.family(cfg):8s} "
              f"full={full.num_params() / 1e9:6.1f}B  reduced fwd+decode "
              f"({cfg.dtype}) ✓")
    print(f"\nall {len(ASSIGNED)} assigned architectures run ✓")


if __name__ == "__main__":
    main()
