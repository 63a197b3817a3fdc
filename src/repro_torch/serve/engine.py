"""Continuous-batching serving engine (port of ``src/repro/serve/engine.py``).

Scheduler tick:
  1. admit waiting requests while KV pages are available; prefix-cache
     lookups are issued as ONE batched round against the Elim-ABtree index
     (hits share pages, ref-counted);
  2. run one fused decode step for all running requests (static max_batch
     slots; finished slots are masked);
  3. retire finished requests: their page-table pages are released and
     their prefix blocks (un)published in a second batched round; under
     session churn these rounds are the paper's skewed update-heavy
     workload.

The model step is ``models.backbone.forward_decode``, whose attention runs
the decode-attention kernel on the card; the indexes run the port's
``ABTree`` (``serve/pages.py``).  This module is the host-side control
plane.

Device and streams.  ``device`` defaults to ``"cuda"`` and raises without a
card; tests pass ``device="cpu"``.  On the card every model step (the fused
decode and the teacher-forced prefill steps that chain onto its cache) is
enqueued on one CUDA stream of the engine's own, while the index rounds run
on the current stream: their host copies then wait only for their own
work, not for an in-flight decode.  A tick reads the decode's next tokens
only after the event recorded behind them has completed (the fence).  The
pipelined tick (``pipelined=True``) enqueues round N's decode, runs round
N+1's admission on the host while the card works, and then fences, which
is what JAX's asynchronous dispatch gave the reference.

Behaviour kept from the reference, faults included (ROADMAP.md queue C):
a model step writes the new K/V of EVERY slot at one shared position, so a
prefill (one slot's token, zeros in the other rows) overwrites the other
running slots' cache columns at the positions it passes; the fused decode
runs every active slot at the largest active position; and in the
recurrent families (xLSTM, zamba2's mamba2 layers) every model step
advances every slot's recurrent state, so a prefill moves the other
running slots' states on by the zero token, and an admitted slot starts
from the state its previous request left.
"""
from __future__ import annotations

import contextlib
import dataclasses
import os
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from repro_torch.models import backbone
from repro_torch.models.config import ModelConfig
from repro_torch.models.params import init_params
from repro_torch.obs.metrics import MetricsRegistry
from repro_torch.obs.tracer import NULL_TRACER
from repro_torch.serve.pages import (
    PAGE,
    PagedKVCache,
    PrefixIndex,
    SessionIndex,
    prefix_hashes,
)


@dataclasses.dataclass
class Request:
    rid: int
    prompt: List[int]
    max_new: int = 16
    out: List[int] = dataclasses.field(default_factory=list)
    t_submit: float = 0.0
    t_done: Optional[float] = None
    cache_hit_blocks: int = 0


class ServeEngine:
    def __init__(
        self,
        cfg: ModelConfig,
        *,
        max_batch: int = 8,
        s_max: int = 512,
        n_pages: int = 1024,
        index_mode: str = "elim",
        index_shards: int = 1,
        index_durable_dir: Optional[str] = None,
        index_faults=None,
        pipelined: bool = False,
        group_commit_every: int = 1,
        group_commit_max_wait_s: float = 0.05,
        commit_async: Optional[bool] = None,
        seed: int = 0,
        device=None,
        params=None,
    ):
        """``params`` (a param tree of fp32 tensors, e.g. carried from the
        JAX package by ``repro_torch.interop``) replaces the initialization
        from ``seed``.  ``index_shards > 1`` partitions both indexes' key
        spaces into an ``ABForest``.

        ``index_durable_dir`` journals both indexes as ``DurableForest``s
        (``prefix/`` and ``sessions/`` below it): an engine pointed at the
        same directory recovers its prefix cache warm.  ``index_faults`` (a
        ``FaultPlan`` / ``CrashPoint``) is installed on both journals; the
        durable layer's retry and circuit breaker keep ``tick()`` from
        raising on a sick disk (it degrades to volatile serving, visible in
        ``stats()["durability"]``).  ``group_commit_every > 1`` batches that
        many index rounds per manifest rename on both journals;
        ``commit_async`` (default: on whenever grouping is on) moves the
        boundary commit I/O to the durable layer's background thread.
        ``run_until_done()`` drains pending groups at exit; ``close()``
        also stops the commit threads."""
        if device is None:
            if not torch.cuda.is_available():
                raise RuntimeError(
                    "ServeEngine: no CUDA device; pass device='cpu' to run the plain "
                    "versions of the kernels on the host"
                )
            device = "cuda"
        self.device = torch.device(device)
        self.cfg = cfg
        self.max_batch = max_batch
        self.s_max = s_max
        self.pipelined = pipelined
        if commit_async is None:
            commit_async = group_commit_every > 1
        if params is None:
            params = init_params(backbone.model_spec(cfg), self.device, seed)
        # each weight cast to the compute dtype once here (the reference
        # casts it at every use: the same bf16 values, ~3 GB a step less
        # traffic at qwen2-0.5b's full width)
        self.params = backbone.compute_params(params, cfg)
        self.kv = PagedKVCache(n_pages)
        # index_shards > 1: prefix hashes are uniform over the 63-bit
        # domain, so static even splits suffice; session ids are monotone,
        # so static splits alone would route every live id to one shard:
        # max_keys_per_shard makes the forest re-partition the live id
        # range (live sessions are bounded by the page pool).
        durable = dict(faults=index_faults, group_commit_every=group_commit_every,
                       group_commit_max_wait_s=group_commit_max_wait_s,
                       commit_async=commit_async, device=self.device)

        def journal(name):
            return None if index_durable_dir is None else os.path.join(index_durable_dir, name)

        self.index = PrefixIndex(mode=index_mode, shards=index_shards,
                                 durable_dir=journal("prefix"), **durable)
        self.sessions = SessionIndex(
            mode=index_mode, shards=index_shards, key_space=(0, 1 << 31),
            max_keys_per_shard=None if index_shards == 1 else max(64, n_pages // index_shards),
            durable_dir=journal("sessions"), **durable,
        )
        # engine-level telemetry: tick latency + scheduler counters live in
        # the engine's own registry; the index holders keep theirs.
        self.metrics = MetricsRegistry()
        self._tracer = NULL_TRACER
        self._evict_floor = 0  # session ids below this are already swept
        self._retired_since_sweep = 0
        self._max_rid = -1  # highest session id ever admitted
        self.waiting: List[Request] = []
        self.running: Dict[int, Request] = {}
        self.slots: List[Optional[int]] = [None] * max_batch  # slot → rid
        self.pos = np.zeros(max_batch, np.int64)
        self.cache = backbone.init_cache(cfg, max_batch, s_max, self.device)
        self.done: List[Request] = []
        self._stream = None
        if self.device.type == "cuda":
            # the model steps run on their own stream: order it after the
            # params and cache made above on the current one
            self._stream = torch.cuda.Stream(self.device)
            self._stream.wait_stream(torch.cuda.current_stream(self.device))

    # ------------------------------------------------------------------ --

    @property
    def tracer(self):
        return self._tracer

    @tracer.setter
    def tracer(self, t):
        # one tracer for the whole stack: installing it here also times the
        # round-engine phases under both indexes.
        self._tracer = t
        self.index.tree.tracer = t
        self.sessions.tree.tracer = t

    @property
    def recorder(self):
        """The prefix index's flight recorder.  Assigning installs one
        recorder on BOTH index holders."""
        return self.index.tree.recorder

    @recorder.setter
    def recorder(self, r):
        self.index.tree.recorder = r
        self.sessions.tree.recorder = r

    def submit(self, req: Request):
        req.t_submit = time.time()
        self.waiting.append(req)

    # -- model steps ---------------------------------------------------------

    def _on_model_stream(self):
        if self._stream is None:
            return contextlib.nullcontext()
        return torch.cuda.stream(self._stream)

    def _tokens(self, tokens: np.ndarray) -> torch.Tensor:
        t = torch.from_numpy(tokens)
        if self._stream is None:
            return t
        # pinned + non-blocking: the copy queues behind an in-flight decode
        # instead of holding the host until it ends
        return t.pin_memory().to(self.device, non_blocking=True)

    def _model_step(self, tokens: np.ndarray, pos: int, *, next_tokens: bool):
        """Enqueue one decode step of every slot at the shared ``pos``.  With
        ``next_tokens`` returns ``(argmax tokens on the device, event)``."""
        with self._on_model_stream():
            logits, self.cache = backbone.forward_decode(
                self.params, self.cache, self._tokens(tokens), pos, self.cfg
            )
            if not next_tokens:
                return None
            nxt = torch.argmax(logits, -1)
            done = None
            if self._stream is not None:
                done = torch.cuda.Event()
                done.record(self._stream)
        return nxt, done

    @staticmethod
    def _fence(step) -> np.ndarray:
        """Wait for a dispatched decode and bring its next tokens to the host."""
        nxt, done = step
        if done is not None:
            done.synchronize()
        return nxt.cpu().numpy()

    # -- scheduling ----------------------------------------------------------

    def _admit(self):
        for slot in range(self.max_batch):
            if self.slots[slot] is not None or not self.waiting:
                continue
            req = self.waiting.pop(0)
            # prefix-cache lookup: one batched round per request admission
            chain = prefix_hashes(req.prompt)
            hits = self.index.lookup_batch([h for h, _ in chain])
            n_hit = 0
            for h in hits:
                if h is None:
                    break
                n_hit += 1
            req.cache_hit_blocks = n_hit
            self.metrics.inc("cache_hit_blocks", n_hit)
            need_pages = max(1, (len(req.prompt) + req.max_new + PAGE - 1) // PAGE)
            pages = self.kv.alloc(req.rid, need_pages)
            if pages is None:
                self.waiting.insert(0, req)
                return
            # publish the prompt's prefix blocks (batched insert round)
            if chain[n_hit:]:
                self.index.publish_batch(
                    [h for h, _ in chain[n_hit:]], pages[: len(chain) - n_hit] or [0]
                )
            # session index: rid → first page of the request's page table
            self.sessions.publish_batch([req.rid], [pages[0]])
            self._max_rid = max(self._max_rid, req.rid)
            # teacher-forced prefill through the decode path (simple engine:
            # prompt tokens streamed token-by-token into the slot's cache)
            self.slots[slot] = req.rid
            self.running[req.rid] = req
            self.metrics.inc("admitted")
            self.pos[slot] = 0
            for tok in req.prompt[:-1]:
                self._step_slot(slot, tok)
            req._last_tok = req.prompt[-1]

    def _step_slot(self, slot: int, tok: int):
        tokens = np.zeros(self.max_batch, np.int32)
        tokens[slot] = tok
        self._model_step(tokens, int(self.pos[slot]), next_tokens=False)
        self.pos[slot] += 1

    def _decode_inputs(self, active):
        tokens = np.zeros(self.max_batch, np.int32)
        for s in active:
            tokens[s] = getattr(self.running[self.slots[s]], "_last_tok", 0)
        # NOTE: single shared `pos` per fused step (the reference's rule):
        # the fused decode uses the largest active position.
        return tokens, int(self.pos[active].max())

    def tick(self):
        """One scheduler iteration: admit + fused decode for all running.
        Pipelined mode dispatches the decode first and admits under it."""
        t0 = time.perf_counter()
        tr = self._tracer
        overlap = 0.0
        with tr.span("serve.tick"):
            if self.pipelined:
                overlap = self._tick_pipelined(tr)
            else:
                self._tick_body(tr)
        dt = time.perf_counter() - t0
        self.metrics.inc("ticks")
        self.metrics.observe("tick_latency_s", dt)
        if self.pipelined:
            frac = overlap / dt if dt > 0 else 0.0
            self.metrics.set_gauge("tick_overlap_frac", frac)
            self.metrics.observe("tick_overlap_frac", frac)

    def _tick_body(self, tr):
        with tr.span("serve.admit", waiting=len(self.waiting)):
            self._admit()
        active = [s for s in range(self.max_batch) if self.slots[s] is not None]
        if not active:
            return
        tokens, pos = self._decode_inputs(active)
        with tr.span("serve.decode", lanes=len(active)) as sp:
            nxt = self._fence(self._model_step(tokens, pos, next_tokens=True))
            sp.fence(self.cache)
        self._finish_decode(tr, active, nxt, pos)

    def _tick_pipelined(self, tr) -> float:
        """Double-buffered tick: enqueue round N's fused decode, run round
        N+1's admit (prefix lookups, page allocation, publish rounds) on the
        host while the card works, then fence on the decode and retire.
        Admitted requests join the decode from the NEXT tick (their prefill
        steps queue behind it on the model stream, so per-slot KV stays
        exact).  Returns the seconds of host work overlapped with the
        in-flight decode (0 when nothing was running)."""
        active = [s for s in range(self.max_batch) if self.slots[s] is not None]
        step = None
        pos = 0
        if active:
            tokens, pos = self._decode_inputs(active)
            with tr.span("serve.decode.dispatch", lanes=len(active)):
                step = self._model_step(tokens, pos, next_tokens=True)
        t0 = time.perf_counter()
        with tr.span(
            "serve.admit", waiting=len(self.waiting), overlapped=bool(active)
        ):
            self._admit()
        overlap = time.perf_counter() - t0 if active else 0.0
        if step is None:
            return 0.0
        with tr.span("serve.decode", lanes=len(active)) as sp:
            nxt = self._fence(step)  # the fence: blocks here
            sp.fence(self.cache)
        self._finish_decode(tr, active, nxt, pos)
        return overlap

    def _finish_decode(self, tr, active, nxt, pos):
        self.metrics.inc("decode_tokens", len(active))
        for s in active:
            rid = self.slots[s]
            req = self.running[rid]
            req.out.append(int(nxt[s]))
            req._last_tok = int(nxt[s])
            self.pos[s] = pos + 1
            if len(req.out) >= req.max_new or self.pos[s] >= self.s_max - 1:
                with tr.span("serve.retire", slot=s):
                    self._retire(s)

    def _retire(self, slot: int):
        rid = self.slots[slot]
        req = self.running.pop(rid)
        req.t_done = time.time()
        self.done.append(req)
        self.metrics.inc("retired")
        self.slots[slot] = None
        self.kv.release(rid)
        # session churn: hot prompts get re-inserted by the next request;
        # eviction + re-publish of the same keys is the elimination workload
        chain = prefix_hashes(req.prompt)
        if chain and self.kv.used > self.kv.n_pages // 2:
            self.index.evict_batch([h for h, _ in chain])
        # session-range sweep: retired ids accumulate below the lowest live
        # id, so ONE fused scan+delete round clears them in bulk.
        self._retired_since_sweep += 1
        if self._retired_since_sweep >= 8 or not self.running:
            # with nothing running, sweep past the highest id ever admitted
            # (the last retiree may have a lower rid than earlier ones)
            live_floor = min(self.running.keys(), default=self._max_rid + 1)
            if live_floor > self._evict_floor:
                self.sessions.evict_range(self._evict_floor, live_floor)
                self._evict_floor = live_floor
            self._retired_since_sweep = 0

    def drain_durability(self):
        """Flush both journals' pending commit groups and join any in-flight
        async commits: the engine-level persist fence (a no-op for volatile
        or non-grouped indexes)."""
        for h in (self.index.tree, self.sessions.tree):
            drain = getattr(h, "drain", None)
            if drain is not None:
                drain()

    def close(self):
        """Shut down: drain both journals and stop their commit threads."""
        self.index.close()
        self.sessions.close()

    def run_until_done(self, max_ticks: int = 10000):
        t = 0
        while (self.waiting or self.running) and t < max_ticks:
            self.tick()
            t += 1
        self.drain_durability()
        return self.done

    def stats(self) -> dict:
        s = dict(self.index.stats())
        s["pages_used"] = self.kv.used
        s["session_scans"] = self.sessions.stats()["scans"]
        lat = [r.t_done - r.t_submit for r in self.done if r.t_done]
        s["n_done"] = len(self.done)
        s["mean_latency_s"] = float(np.mean(lat)) if lat else 0.0
        s["cache_hit_blocks"] = sum(r.cache_hit_blocks for r in self.done)
        s["ticks"] = self.metrics.value("ticks")
        s["tick_latency"] = self.metrics.histogram_summary("tick_latency_s")
        s["metrics"] = self.metrics.snapshot()
        s["index_metrics"] = self.index.tree.metrics.snapshot()
        s["recorder"] = self.recorder.snapshot()
        # durability degradation surface: present only when the indexes are
        # journaled; "degraded" is True if EITHER index's circuit breaker
        # is open (serving continues volatile, commits suspended).
        durable = {
            name: h.durability_status()
            for name, h in (("prefix", self.index.tree), ("sessions", self.sessions.tree))
            if hasattr(h, "durability_status")
        }
        if durable:
            durable["degraded"] = any(v["degraded"] for v in durable.values())
            s["durability"] = durable
        return s
