"""Disaggregated serving on the port: context server (prefill + KV
capture), slot-based continuous-batching generation server, and the
engine that moves requests between them.

The port of ``repro.runtime.engine`` (``Request``, ``ContextServer``,
``GenerationServer``, ``DisaggregatedEngine``) for the DWDP path with the
all-fetch and the route-before-gather expert fetches (``expert_fetch``
demand / predictive / sync_free; the generation server carries the
predictive state across decode steps and keeps each step's
``pred_stats``). PyTorch runs eagerly, so there is no variant cache to compile;
the health monitor, the online scheduler and CUDA graphs come later.
Times are seconds on the host clock, read after the device has
finished (``torch.cuda.synchronize``).
"""
from __future__ import annotations

import dataclasses
import time
from typing import Optional

import numpy as np
import torch

from repro_torch.configs.base import InputShape
from repro_torch.core import execution
from repro_torch.core.strategy import PolicyTable, make_execution_plan
from repro_torch.models.cache import init_decode_state
from repro_torch.models.transformer import Model
from repro_torch.runtime.metrics import RequestRecord, ServingMetrics


@dataclasses.dataclass
class Request:
    req_id: int
    tokens: np.ndarray        # (prompt_len,)
    target_len: int           # output tokens to generate
    arrival: float = 0.0

    def __post_init__(self):
        self.tokens = np.asarray(self.tokens)
        if self.tokens.ndim != 1 or self.tokens.size == 0:
            raise ValueError(
                f"Request {self.req_id}: tokens must be a non-empty 1-d "
                f"prompt, got shape {self.tokens.shape}"
            )
        if int(self.target_len) < 1:
            raise ValueError(
                f"Request {self.req_id}: target_len must be >= 1 "
                f"(the prefill emits the first token), got {self.target_len}"
            )


class ContextServer:
    """Prefill worker: returns (first_token, captured decode state).
    ``ContextServer`` prefills one request at a time (global batch 1), so
    the model axis shards the prompt's sequence."""

    def __init__(self, model: Model, mesh_sizes: dict, *, mode: str = "dwdp",
                 prefill_len: int, cache_len: int,
                 capacity_from: str = "local", expert_fetch: str = "all",
                 demand_budget: int = 0, cache_budget: int = 0):
        self.model = model
        self.prefill_len = prefill_len
        self.cache_len = cache_len
        self.xp = make_execution_plan(
            model, InputShape("ctx", prefill_len, 1, "prefill"), mesh_sizes,
            mode=mode, capacity_from=capacity_from,
            policy=PolicyTable.uniform(fetch=expert_fetch, budget=demand_budget,
                                       cache_budget=cache_budget),
        )

    def forward(self, params, tokens: np.ndarray, *, impl: Optional[str] = None) -> dict:
        """One prefill of ``tokens`` (prompt_len,) -> the forward's outputs
        (``last_logits`` (1, vocab_pad) f32 and the captured ``state``).
        ``impl="torch"`` runs the plain version of every kernel."""
        if len(tokens) != self.prefill_len:
            raise ValueError(f"prompt length {len(tokens)} != prefill_len {self.prefill_len}")
        row = torch.as_tensor(np.asarray(tokens)[None, :], dtype=torch.int64,
                              device=self.model.device)
        ctx = execution.Ctx(model=self.model, xp=self.xp, capture_len=self.cache_len, impl=impl)
        return execution.forward_prefill(params, row, ctx)

    def prefill(self, params, tokens: np.ndarray):
        out = self.forward(params, tokens)
        first = int(torch.argmax(out["last_logits"][0]))
        return first, out["state"]


class GenerationServer:
    """Slot-based continuous-batching decode worker. Under the predictive
    and sync-free fetch the decode state carries the per-rank predictor
    and residency cache (``state["pred"]``, attached cold); it is per rank,
    not per slot, so admitting a request leaves it as it is.
    ``pred_stats`` keeps each decode step's ``[predicted, spec_hit,
    cache_hit, corr_rows, evicted]`` expert rows (summed over layers and
    ranks)."""

    def __init__(self, model: Model, mesh_sizes: dict, *, mode: str = "dwdp",
                 max_batch: int, cache_len: int,
                 capacity_from: str = "local", expert_fetch: str = "all",
                 demand_budget: int = 0, cache_budget: int = 0):
        self.model = model
        self.max_batch = max_batch
        self.cache_len = cache_len
        self.xp = make_execution_plan(
            model, InputShape("gen", cache_len, max_batch, "decode"), mesh_sizes,
            mode=mode, capacity_from=capacity_from,
            policy=PolicyTable.uniform(fetch=expert_fetch, budget=demand_budget,
                                       cache_budget=cache_budget),
        )
        seq_shards = self.xp.seq_shards if self.xp.seq_axes else 1
        self.state = execution.attach_predict_state(
            init_decode_state(model, max_batch, cache_len, seq_shards=seq_shards),
            model, self.xp,
        )
        self.pred_stats: list[np.ndarray] = []
        self.slot_req: list[Optional[int]] = [None] * max_batch
        self.slot_remaining = np.zeros(max_batch, np.int64)
        self.cur_token = torch.zeros((max_batch, 1), dtype=torch.int64, device=model.device)

    def free_slots(self) -> list[int]:
        return [i for i, r in enumerate(self.slot_req) if r is None]

    def admit(self, slot: int, req_id: int, first_token: int, ctx_state: dict) -> None:
        """Install a context-server state into one batch slot (in place:
        the server owns its state tensors). Scan groups carry a leading
        cycle axis, so the batch axis is 1 there."""
        for group in self.model.plan:
            bax = 1 if group.scan else 0
            for key, ranks in self.state["layers"][group.name].items():
                src_ranks = ctx_state["layers"][group.name][key]
                for dst, src in zip(ranks, src_ranks):
                    for f in dst:
                        idx = (slice(None),) * bax + (slot,)
                        sidx = (slice(None),) * bax + (0,)
                        dst[f][idx] = src[f][sidx].to(dst[f].dtype)
        self.state["pos"][slot] = ctx_state["pos"][0]
        self.cur_token[slot, 0] = first_token
        self.slot_req[slot] = req_id

    def decode_step(self, params) -> np.ndarray:
        ctx = execution.Ctx(model=self.model, xp=self.xp)
        out = execution.forward_decode(params, self.cur_token, self.state, ctx)
        self.state = out["state"]
        self.cur_token = out["next_token"].to(torch.int64)
        if "pred_stats" in out:
            self.pred_stats.append(out["pred_stats"].cpu().numpy())
        return out["next_token"][:, 0].cpu().numpy()

    def release(self, slot: int) -> None:
        self.slot_req[slot] = None


class DisaggregatedEngine:
    """Queues + rate matching between the context and generation servers."""

    def __init__(self, params, ctx: ContextServer, gen: GenerationServer):
        self.params = params
        self.ctx = ctx
        self.gen = gen
        self.queue: list[Request] = []
        self.records: dict[int, RequestRecord] = {}
        self.outputs: dict[int, list[int]] = {}
        self.metrics = ServingMetrics()
        self._t0 = time.perf_counter()

    def now(self) -> float:
        """Seconds since the engine started, after the device finished."""
        if self.gen.model.device.type == "cuda":
            torch.cuda.synchronize(self.gen.model.device)
        return time.perf_counter() - self._t0

    def warmup(self) -> None:
        """One prefill and one decode step off the serving path, so that
        one-time costs (kernel module loading, library handles) stay out
        of the first request's TTFT. Slot and predictive state are left as
        they were: the decode step's outputs are dropped
        (``forward_decode`` never writes its input state)."""
        self.ctx.forward(self.params, np.zeros(self.ctx.prefill_len, np.int64))
        state, token = self.gen.state, self.gen.cur_token
        n_stats = len(self.gen.pred_stats)
        self.gen.decode_step(self.params)
        self.gen.state, self.gen.cur_token = state, token
        del self.gen.pred_stats[n_stats:]
        self.now()

    def submit(self, req: Request) -> None:
        if len(req.tokens) != self.ctx.prefill_len:
            raise ValueError(
                f"Request {req.req_id}: prompt length {len(req.tokens)} != "
                f"prefill_len {self.ctx.prefill_len}"
            )
        if len(req.tokens) + req.target_len - 1 > self.gen.cache_len:
            raise ValueError(
                f"Request {req.req_id}: prompt ({len(req.tokens)}) + output "
                f"({req.target_len}) tokens exceed the decode ring capacity "
                f"cache_len={self.gen.cache_len}"
            )
        self.queue.append(req)
        self.records[req.req_id] = RequestRecord(
            req_id=req.req_id, arrival=self.now(),
            prompt_len=len(req.tokens), target_len=req.target_len,
        )
        self.outputs[req.req_id] = []

    def busy(self) -> bool:
        return bool(self.queue) or any(r is not None for r in self.gen.slot_req)

    def run(self, steps: int) -> ServingMetrics:
        """Each step = one decode iteration; free slots pull queued
        requests through the context server first."""
        for _ in range(steps):
            for slot in self.gen.free_slots():
                if not self.queue:
                    break
                req = self.queue.pop(0)
                first, state = self.ctx.prefill(self.params, req.tokens)
                rec = self.records[req.req_id]
                rec.first_token_time = self.now()
                rec.tokens_out = 1
                self.outputs[req.req_id].append(first)
                self.gen.admit(slot, req.req_id, first, state)
                self.gen.slot_remaining[slot] = req.target_len - 1
            toks = self.gen.decode_step(self.params)
            t = self.now()
            for slot, rid in enumerate(self.gen.slot_req):
                if rid is None:
                    continue
                rec = self.records[rid]
                self.outputs[rid].append(int(toks[slot]))
                rec.tokens_out += 1
                self.gen.slot_remaining[slot] -= 1
                if self.gen.slot_remaining[slot] <= 0:
                    rec.done_time = t
                    self.metrics.records.append(rec)
                    self.gen.release(slot)
        return self.metrics
