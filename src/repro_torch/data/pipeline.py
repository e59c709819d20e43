"""Seeded request traces (copied from ``repro.data.pipeline``, so the same
seed gives the same prompts in both packages)."""
from __future__ import annotations

from dataclasses import dataclass
from typing import List, Sequence, Tuple

import numpy as np


def _zipf(rng: np.random.Generator, a: float, vocab: int, n: int) -> np.ndarray:
    # bounded zipf via inverse-CDF on ranks
    ranks = np.arange(1, vocab + 1, dtype=np.float64)
    probs = ranks ** (-a)
    probs /= probs.sum()
    return rng.choice(vocab, size=n, p=probs)


@dataclass(frozen=True)
class Request:
    rid: int
    prompt: np.ndarray           # (prompt_len,) int32
    max_new_tokens: int


def open_loop_trace(vocab: int, n_requests: int, *, seed: int = 0,
                    prompt_lo: int = 8, prompt_hi: int = 56,
                    max_new_choices: Sequence[int] = (4, 8),
                    arrival_hi: int = 12) -> Tuple[List[Request], List[int]]:
    """Seeded open-loop serving trace: (requests, arrival_steps), the
    continuous-batching server's traffic: free-form prompt lengths,
    max_new drawn from a small set, and a per-request arrival step for the
    server's ``arrival_steps`` input."""
    rng = np.random.default_rng(seed)
    reqs, arrivals = [], []
    for i in range(n_requests):
        plen = int(rng.integers(prompt_lo, prompt_hi))
        prompt = _zipf(rng, 1.2, vocab, plen).astype(np.int32)
        reqs.append(Request(rid=i, prompt=prompt,
                            max_new_tokens=int(rng.choice(
                                list(max_new_choices)))))
        arrivals.append(int(rng.integers(0, arrival_hi)))
    return reqs, arrivals


def request_trace(vocab: int, n_requests: int, *, prompt_mean: int = 128,
                  gen_tokens: int = 32, seed: int = 0,
                  prompt_jitter: float = 0.5) -> List[Request]:
    """Serving trace with log-normal-ish prompt lengths (paper: fixed grid of
    prompt lengths; jitter exercises the ragged mini-batch packing)."""
    rng = np.random.default_rng(seed)
    reqs = []
    for i in range(n_requests):
        plen = max(8, int(prompt_mean * np.exp(prompt_jitter * rng.standard_normal())))
        prompt = _zipf(rng, 1.2, vocab, plen).astype(np.int32)
        reqs.append(Request(rid=i, prompt=prompt, max_new_tokens=gen_tokens))
    return reqs
