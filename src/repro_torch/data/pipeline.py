"""Synthetic data, copied numpy for numpy from ``repro.data.pipeline`` (the
same seed gives the same arrays in both packages): the structured LM corpus
the training path learns (Zipf-distributed tokens with short-range copies,
so the loss falls), and seeded request traces."""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Dict, Iterator, List, Sequence, Tuple

import numpy as np


def _zipf(rng: np.random.Generator, a: float, vocab: int, n: int) -> np.ndarray:
    # bounded zipf via inverse-CDF on ranks
    ranks = np.arange(1, vocab + 1, dtype=np.float64)
    probs = ranks ** (-a)
    probs /= probs.sum()
    return rng.choice(vocab, size=n, p=probs)


@dataclass(frozen=True)
class DataConfig:
    vocab_size: int
    seq_len: int
    batch_size: int
    seed: int = 0
    zipf_a: float = 1.2
    repeat_p: float = 0.3      # P(copy a recent token) — learnable structure


def token_stream(cfg: DataConfig) -> Iterator[np.ndarray]:
    """Infinite stream of (seq_len+1,) token windows."""
    rng = np.random.default_rng(cfg.seed)
    while True:
        toks = _zipf(rng, cfg.zipf_a, cfg.vocab_size, cfg.seq_len + 1)
        # inject copy structure: with prob repeat_p, token t = token t-k
        mask = rng.random(cfg.seq_len + 1) < cfg.repeat_p
        lags = rng.integers(1, 8, size=cfg.seq_len + 1)
        for t in range(8, cfg.seq_len + 1):
            if mask[t]:
                toks[t] = toks[t - lags[t]]
        yield toks


def lm_batches(cfg: DataConfig) -> Iterator[Dict[str, np.ndarray]]:
    """{'tokens': (B, S), 'labels': (B, S)} int32 numpy — next-token
    prediction, one stream per row (seeds seed, seed + 1, ...)."""
    streams = [token_stream(dataclasses.replace(cfg, seed=cfg.seed + i))
               for i in range(cfg.batch_size)]
    while True:
        rows = [next(s) for s in streams]
        arr = np.stack(rows, 0)
        yield {"tokens": arr[:, :-1].astype(np.int32),
               "labels": arr[:, 1:].astype(np.int32)}


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
