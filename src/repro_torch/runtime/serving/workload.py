"""Seeded serving workloads: per-request prompt and output lengths, and
the request lifecycle (``repro.runtime.serving.workload``; numpy only, the
same draws from the same seed).

Prompt lengths come from buckets (the pow2 prefill buckets the context
server captures) with optional weights — skewing them per replica builds
an imbalanced fleet — and output lengths from a jittered mean. Arrivals
are Poisson at ``arrival_rate`` (0 = closed loop: every request arrives
at t = 0 and the decode slots cap concurrency).
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np


@dataclasses.dataclass
class ServedRequest:
    """One request's serving lifecycle: arrived -> admitted | queued |
    rejected; active -> evicted (back to the queue, its decode state in
    ``resume``) -> resumed; active -> done."""

    req_id: int
    prompt_len: int
    target_len: int
    arrival: float = 0.0
    tokens: Optional[np.ndarray] = None   # the prompt a live client prefills
    # evict-to-queue: the GenerationServer.snapshot_slot payload, and the
    # output tokens still owed when it was taken
    resume: Optional[dict] = None
    remaining: Optional[int] = None

    def __post_init__(self):
        if self.prompt_len < 1:
            raise ValueError(f"Request {self.req_id}: prompt_len must be >= 1, got {self.prompt_len}")
        if self.target_len < 1:
            raise ValueError(f"Request {self.req_id}: target_len must be >= 1, got {self.target_len}")


@dataclasses.dataclass(frozen=True)
class WorkloadConfig:
    """Distribution of one replica's traffic."""

    num_requests: int
    isl_buckets: tuple = (64,)     # prompt-length buckets (pow2 on live engines)
    isl_weights: tuple = ()        # bucket draw weights (uniform if empty)
    osl: int = 16                  # mean output tokens
    osl_jitter: float = 0.0        # uniform +/- fraction of the mean
    arrival_rate: float = 0.0      # Poisson requests/s; 0 = all at t = 0
    seed: int = 0

    def __post_init__(self):
        if self.num_requests < 0:
            raise ValueError(f"num_requests >= 0, got {self.num_requests}")
        if not self.isl_buckets:
            raise ValueError("isl_buckets must name at least one bucket")
        if self.isl_weights and len(self.isl_weights) != len(self.isl_buckets):
            raise ValueError(f"isl_weights ({len(self.isl_weights)}) must match "
                             f"isl_buckets ({len(self.isl_buckets)})")
        if not 0.0 <= self.osl_jitter < 1.0:
            raise ValueError(f"osl_jitter must lie in [0, 1), got {self.osl_jitter}")


def synthesize_workload(cfg: WorkloadConfig, *, vocab_size: int = 0,
                        req_id_base: int = 0) -> list[ServedRequest]:
    """The request list of a workload, in arrival order. ``vocab_size > 0``
    also draws each prompt's tokens (int32), which live clients need."""
    rng = np.random.default_rng(cfg.seed)
    weights = None
    if cfg.isl_weights:
        w = np.asarray(cfg.isl_weights, np.float64)
        weights = w / w.sum()
    lens = rng.choice(np.asarray(cfg.isl_buckets, np.int64), size=cfg.num_requests, p=weights)
    if cfg.osl_jitter > 0.0:
        osls = np.maximum(1, np.round(
            cfg.osl * rng.uniform(1.0 - cfg.osl_jitter, 1.0 + cfg.osl_jitter, cfg.num_requests)
        ).astype(np.int64))
    else:
        osls = np.full(cfg.num_requests, max(1, cfg.osl), np.int64)
    if cfg.arrival_rate > 0.0:
        arrivals = np.cumsum(rng.exponential(1.0 / cfg.arrival_rate, cfg.num_requests))
    else:
        arrivals = np.zeros(cfg.num_requests)
    out = []
    for i in range(cfg.num_requests):
        tokens = None
        if vocab_size > 0:
            tokens = rng.integers(0, vocab_size, int(lens[i])).astype(np.int32)
        out.append(ServedRequest(req_id=req_id_base + i, prompt_len=int(lens[i]),
                                 target_len=int(osls[i]), arrival=float(arrivals[i]),
                                 tokens=tokens))
    return out
