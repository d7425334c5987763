"""Serving metrics of the port: per-request records and TTFT / TPOT
percentiles (the JAX package's ``runtime.metrics``, limited to TTFT and
TPOT). Times are seconds on the host clock."""
from __future__ import annotations

import dataclasses
import math
import statistics
from typing import Optional


def _pct(xs: list, q: float) -> float:
    """Nearest-rank percentile (q in (0, 1]); 0.0 on an empty sample."""
    if not xs:
        return 0.0
    s = sorted(xs)
    i = max(0, min(len(s) - 1, int(math.ceil(q * len(s))) - 1))
    return float(s[i])


@dataclasses.dataclass
class RequestRecord:
    req_id: int
    arrival: float
    prompt_len: int
    target_len: int
    first_token_time: Optional[float] = None
    done_time: Optional[float] = None
    tokens_out: int = 0

    @property
    def ttft(self) -> Optional[float]:
        if self.first_token_time is None:
            return None
        return self.first_token_time - self.arrival

    @property
    def tpot(self) -> Optional[float]:
        """Mean time per output token over the decode phase (excludes the
        prefill-emitted first token)."""
        if self.done_time is None or self.first_token_time is None or self.tokens_out < 2:
            return None
        return (self.done_time - self.first_token_time) / (self.tokens_out - 1)


@dataclasses.dataclass
class ServingMetrics:
    records: list = dataclasses.field(default_factory=list)

    def summary(self) -> dict:
        done = [r for r in self.records if r.done_time is not None]
        ttfts = [r.ttft for r in done if r.ttft is not None]
        tpots = [t for t in (r.tpot for r in done) if t is not None]
        out = {
            "completed": len(done),
            "median_ttft_s": statistics.median(ttfts) if ttfts else None,
            "total_output_tokens": sum(r.tokens_out for r in done),
        }
        for stat, xs in (("ttft", ttfts), ("tpot", tpots)):
            for q in (0.50, 0.95, 0.99):
                out[f"{stat}_p{int(q * 100)}_s"] = _pct(xs, q)
        return out
