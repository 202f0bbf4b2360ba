"""Slot-recycling continuous-batching scheduler over the paged KV cache.

``StreamFrontend`` decodes every request in its own batch-1 step. This
scheduler moves all live requests into ONE batched decode step of fixed
width ``max_live`` (rows are recycled slots) while keeping EVERY clause of
the front end's request-lifecycle contract:

* **Admission / backpressure** — the same bounded queue, the same
  reject-newest shedding, the same typed
  :class:`~repro_torch.serve.requests.Overloaded` result. KV-block
  exhaustion is a SECOND backpressure signal below admission: the paged
  allocator (``serve.kv_cache``) returns ``None`` instead of raising, and
  the scheduler answers with **preemption**, never a crash.
* **Preempt and resume** — when a live request cannot grow its KV blocks
  (pool exhausted), the NEWEST-admitted live request is preempted: its
  blocks are released (scrubbed), its generated prefix is parked, and it
  re-enters the FRONT of the queue in the transient ``preempted`` state,
  keeping its original admission time (and so its deadline). Resume
  re-prefills the prompt and replays the generated prefix teacher-forced;
  sampling is seeded per (request_id, step), so the resumed stream is
  BITWISE identical to the uninterrupted run. The conservation invariant
  extends to ``admitted == completed + evicted + deadline_miss + open +
  preempted_open`` (see ``repro_torch.core.health``).
* **Blast-radius containment (bisection)** — a failed batched step is
  classified (``health.classify_failure``), retried with capped backoff,
  and on retry exhaustion BISECTED: every live row is re-run alone; rows
  whose re-run fails are evicted as ``guilty``, rows that pass are
  ``exonerated`` and their re-run result is committed directly — one
  poisoned request costs exactly one eviction and survivors stay bitwise
  identical to a fault-free run. Fault site ``batch_step`` fires once per
  shared attempt AND once per re-run, so the multi-hit arming form
  (``batch_step:n1,n2``) stages the whole story.
* **Step watchdog** — deadlines are checked every scheduler tick at step
  granularity across the whole batch (injectable clock), and freed rows
  admit queued requests on the next tick.
* **Per-request isolation** — per-row sampling seeds and per-row numerics
  guarding: a non-finite logits row under ``REPRO_NUMERICS_GUARD=1``
  evicts that row only.

The batched step has no kernel of its own (the JAX package's step is
plain ``jnp`` too): :meth:`PagedKVCache.gather` copies ``pool[:, tables]``
into the dense per-layer view, the unchanged ``model.decode`` runs on it
(its in-place write of the new position lands in the copy), and
:meth:`PagedKVCache.scatter` commits the one position each row wrote —
only after a clean step. Dead rows (null tables, token 0, position 0)
write into the null block and are never read. On the card the gather and
the decode are one captured CUDA graph (``serve.graphs.StepGraph``) over
static ``tables`` / ``tok`` / ``pos`` buffers of width ``max_live``, as
the JAX package compiles its step once: the bisection re-run and the
resume replay go through the same graph with their dead rows, the scatter
stays outside it, after a clean step, and so do the host fault sites
(``batch_step``, ``engine_step``, ``kv_alloc``, ``admission``,
``sample``), which fire per tick as before. The graph belongs to the
scheduler, since the capture holds its pool's address (the JAX package
keys its compiled step by the engine and the geometry). The private
``_graphed`` (the engine's choice; False runs the step eagerly) is the
switch the card's tests compare the two paths with. Admissions and
resumes prefill through ``Engine.prefill_request``, which on the card
replays the engine's prefill graph of the prompt's length (a length's
first prefill runs eagerly, its second captures); the caches it returns
are the engine's static caches, which ``insert_dense`` copies into the
pool before the engine runs again.

**One deliberate change of mechanism from the JAX package.** There, the
bisection re-run and the resume replay run a row ALONE on the batch-1
path (``decode_request`` on ``gather_slot``), which is bitwise the batched
computation of that row because the JAX decode is batch-invariant. The
port's decode is not: on the CPU a product at M=1 takes another path than
at M=3 (``x @ w`` differs by ~1e-7), and so does the attention at batch 1
against batch 3. What does hold, at a fixed width, is row independence:
a row's bits do not depend on the other rows' values or on its row index.
So here both single-row paths run THE SAME width-``max_live`` step with
only that row live (the others dead, as above), and commit the row's write
through the same scatter. The contract's clauses are unchanged ("survivors
bitwise", "a resumed stream bitwise identical to an uninterrupted run");
only the mechanism is. The scheduler is therefore NOT bitwise equal to the
batch-1 ``StreamFrontend`` on the CPU (greedy tokens agree and logits
differ at the 1e-7 level). Prefill stays batch-1, at admission and at
resume, so a re-prefill gives the same bits. A model whose rows share
state inside the step (MoE rows share expert capacity) breaks row
independence; the bitwise clauses are held on the dense model.

Every preemption, resume, and bisection verdict lands in the
process-global ``repro_torch.core.health.SERVE`` registry and surfaces
through ``Engine.serve_report()``.

This module is the port's copy of the JAX package's ``serve/scheduler.py``.
"""
from __future__ import annotations

import collections
import dataclasses
import functools
import time
from typing import Dict, Iterable, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.core import health
from repro_torch.serve import graphs
from repro_torch.serve.frontend import RETRYABLE_CLASSES, VirtualClock  # noqa: F401
from repro_torch.serve.kv_cache import PagedKVCache
from repro_torch.serve.requests import Overloaded, Request, RequestResult
from repro_torch.testing import faults


def _step_body(kv: PagedKVCache, model, params, static) -> dict:
    """The captured batched step: gather the rows of the static tables
    from ``kv``'s pool, decode them (a function of the pool and the model,
    not of the scheduler, so that its graph holds no reference back)."""
    logits, caches = model.decode(params, kv.gather(static["tables"]),
                                  static["tok"], static["pos"])
    return {"logits": logits[:, 0], "caches": caches}


@dataclasses.dataclass
class ContinuousConfig:
    """Scheduler knobs: the StreamConfig surface plus the KV-block budget."""

    queue_capacity: int = 16       # bounded admission queue (backpressure)
    max_live: int = 4              # rows of the shared batched decode step
    max_retries: int = 2           # per-step retry budget (retryable classes)
    backoff_base_s: float = 0.005  # first retry's backoff
    backoff_cap_s: float = 0.08    # exponential backoff cap
    default_max_new_tokens: int = 16
    default_deadline_s: Optional[float] = None  # None = no deadline
    block_size: int = 16           # KV block granularity (positions)
    num_kv_blocks: Optional[int] = None  # pool size; None = worst case
    #   (max_live * max_len / block_size — no backpressure, only recycling)
    kv_quantize: Optional[str] = None    # "int8": int8 pool + per-position
    #   f32 scales; reads dequantize, writes quantize once (serve.kv_cache)


@dataclasses.dataclass
class _QEntry:
    """A queued request: fresh, or preempted with its generated prefix."""

    req: Request
    admit_t: float
    admit_seq: int
    emitted: List[int]
    preempted: bool = False
    preemptions: int = 0
    retries: int = 0


@dataclasses.dataclass
class _CSlot:
    """One live request's state in the shared batch (row = slot index)."""

    req: Request
    row: int
    budget: int
    deadline_s: Optional[float]
    admit_t: float
    admit_seq: int
    emitted: List[int]
    retries: int = 0
    preemptions: int = 0


class ContinuousScheduler:
    """Continuous batching with paged-KV backpressure under the
    request-lifecycle contract (see the module docstring). The API mirrors
    :class:`~repro_torch.serve.frontend.StreamFrontend`:
    ``submit`` / ``step`` / ``drain`` / ``run`` / ``stats`` / ``results``.
    """

    def __init__(self, engine, cfg: ContinuousConfig = ContinuousConfig(), *,
                 clock=time.monotonic, sleep=time.sleep):
        self.engine = engine
        self.cfg = cfg
        self._clock = clock
        self._sleep = sleep
        max_len = engine.cfg.max_len
        num_blocks = cfg.num_kv_blocks
        if num_blocks is None:
            num_blocks = cfg.max_live * (max_len // cfg.block_size)
        self.kv = PagedKVCache(
            engine.model.cfg, max_live=cfg.max_live, max_len=max_len,
            block_size=cfg.block_size, num_blocks=num_blocks,
            cache_dtype=engine.cfg.cache_dtype, quantize=cfg.kv_quantize,
            device=engine.device)
        self._queue: collections.deque = collections.deque()  # _QEntry
        self._live: Dict[int, _CSlot] = {}                    # row -> slot
        self.results: Dict[int, RequestResult] = {}
        self._seen: set = set()
        self._admit_seq = 0
        # The batched step through a graph (the engine's choice; False: the
        # eager step), built at the first step.
        self._graphed = engine._graphed
        self._step_graph: Optional[graphs.StepGraph] = None

    # ----- the shared batched decode step ---------------------------------

    @torch.inference_mode()
    def _step(self, tables: torch.Tensor, tokens: np.ndarray,
              pos: np.ndarray):
        """One decode step at width ``max_live``: gather each row's blocks
        into the dense view, run the model's decode. Returns (logits
        [max_live, V], the caches holding each row's write); the pool is
        untouched until :meth:`_commit_pool`. Through the step's graph
        when ``_graphed``: its outputs are static, overwritten by the next
        step."""
        if self._graphed:
            step = self._graph()
            out = step({"tables": tables, "tok": tokens, "pos": pos})
            return out["logits"], (out["caches"], step.static["tables"],
                                   step.static["pos"])
        dev = self.engine.device
        tok = torch.as_tensor(tokens, dtype=torch.long, device=dev)
        pos_t = torch.as_tensor(pos, dtype=torch.long, device=dev)
        logits, caches = self.engine._decode(self.kv.gather(tables), tok,
                                             pos_t)
        return logits[:, 0], (caches, tables, pos_t)

    def _graph(self) -> graphs.StepGraph:
        """This scheduler's batched step as a graph over static ``tables``
        [max_live, blocks a slot], ``tok`` [max_live, 1] and ``pos``
        [max_live]: the gather from this scheduler's pool and the decode,
        captured on the card (run over the static tree on the CPU). It
        belongs to the scheduler, not to the engine: the capture holds this
        pool's address."""
        if self._step_graph is None:
            dev, width = self.engine.device, self.cfg.max_live
            static = {"tables": torch.zeros_like(self.kv.device_tables()),
                      "tok": torch.zeros((width, 1), dtype=torch.long,
                                         device=dev),
                      "pos": torch.zeros((width,), dtype=torch.long,
                                         device=dev)}
            self._step_graph = graphs.StepGraph(
                functools.partial(_step_body, self.kv, self.engine.model,
                                  self.engine.params),
                static, capture=dev.type == "cuda")
        return self._step_graph

    @torch.inference_mode()
    def _commit_pool(self, written) -> None:
        self.kv.scatter(*written)

    def _row_step(self, row: int, token: int, pos: int):
        """The single-row path: the same width-``max_live`` step with only
        ``row`` live (every other row dead: null table, token 0, pos 0),
        so the row's bits are those the shared step gives it."""
        width = self.cfg.max_live
        tables = torch.zeros_like(self.kv.device_tables())
        tables[row] = self.kv.device_tables()[row]
        tokens = np.zeros((width, 1), np.int64)
        positions = np.zeros((width,), np.int64)
        tokens[row, 0] = token
        positions[row] = pos
        return self._step(tables, tokens, positions)

    # ----- admission ------------------------------------------------------

    def submit(self, request: Request) -> Optional[Overloaded]:
        """Offer one request. None when ADMITTED; the typed
        :class:`Overloaded` result when shed — never raises for load."""
        rid = request.request_id
        if rid in self._seen:
            raise ValueError(f"duplicate request_id {rid}")
        budget = request.max_new_tokens or self.cfg.default_max_new_tokens
        if request.tokens.shape[0] + budget > self.engine.cfg.max_len:
            raise ValueError(
                f"request {rid}: prompt ({request.tokens.shape[0]}) + budget "
                f"({budget}) exceeds max_len ({self.engine.cfg.max_len})")
        self._seen.add(rid)
        try:
            faults.maybe_fail("admission")
        except Exception as exc:  # noqa: BLE001 — classified, recorded, typed
            cause = health.classify_failure(exc)
            return self._shed(request, f"admission failure ({cause}): {exc}")
        if len(self._queue) >= self.cfg.queue_capacity:
            return self._shed(
                request, f"queue full (capacity {self.cfg.queue_capacity})")
        health.SERVE.admitted(rid)
        self._queue.append(_QEntry(req=request, admit_t=self._clock(),
                                   admit_seq=self._admit_seq, emitted=[]))
        self._admit_seq += 1
        return None

    def _shed(self, request: Request, detail: str) -> Overloaded:
        health.SERVE.shed(request.request_id, detail)
        result = Overloaded(
            request_id=request.request_id, status="shed",
            tokens=np.zeros((0,), np.int32), detail=detail,
            queue_depth=len(self._queue))
        self.results[request.request_id] = result
        return result

    # ----- lifecycle helpers ----------------------------------------------

    def _finalize_slot(self, slot: _CSlot, status: str,
                       detail: str = "") -> RequestResult:
        self.kv.release(slot.row)
        self._live.pop(slot.row, None)
        return self._finalize(slot.req, status, slot.emitted, slot.admit_t,
                              slot.retries, slot.preemptions, detail)

    def _finalize_queued(self, entry: _QEntry, status: str,
                         detail: str = "") -> RequestResult:
        return self._finalize(entry.req, status, entry.emitted, entry.admit_t,
                              entry.retries, entry.preemptions, detail)

    def _finalize(self, req: Request, status: str, emitted: List[int],
                  admit_t: float, retries: int, preemptions: int,
                  detail: str) -> RequestResult:
        latency = self._clock() - admit_t
        health.SERVE.finalize(req.request_id, status, step=len(emitted),
                              tokens_emitted=len(emitted),
                              latency_s=latency, detail=detail)
        result = RequestResult(
            request_id=req.request_id, status=status,
            tokens=np.asarray(emitted, np.int32), detail=detail,
            retries=retries, latency_s=latency, preemptions=preemptions)
        self.results[req.request_id] = result
        return result

    def _preempt(self, slot: _CSlot, detail: str) -> None:
        """Park a live request back at the queue FRONT under KV pressure:
        release (scrub) its blocks, keep its tokens — transient state, never
        terminal, re-queue exempt from the admission capacity (it was
        already admitted; dropping it would break conservation)."""
        health.SERVE.preempted(slot.req.request_id, step=len(slot.emitted),
                               detail=detail)
        self.kv.release(slot.row)
        self._live.pop(slot.row, None)
        self._queue.appendleft(_QEntry(
            req=slot.req, admit_t=slot.admit_t, admit_seq=slot.admit_seq,
            emitted=list(slot.emitted), preempted=True,
            preemptions=slot.preemptions + 1, retries=slot.retries))

    def _newest_live(self) -> Optional[_CSlot]:
        if not self._live:
            return None
        return max(self._live.values(), key=lambda s: s.admit_seq)

    def _backoff(self, attempts: int) -> float:
        return min(self.cfg.backoff_base_s * (2 ** (attempts - 1)),
                   self.cfg.backoff_cap_s)

    # ----- admission stepping ---------------------------------------------

    def _free_row(self) -> Optional[int]:
        for row in range(self.cfg.max_live):
            if row not in self._live:
                return row
        return None

    def _admit_one(self, entry: _QEntry, row: int,
                   done: Dict[int, RequestResult]) -> None:
        """Move one queue entry into a batch row: allocate KV for its
        occupied positions, prefill the prompt (and replay the generated
        prefix if resuming), guarded exactly like the front end's step."""
        req = entry.req
        rid = req.request_id
        S = req.tokens.shape[0]
        k = len(entry.emitted)
        occupied = S + max(0, k - 1)   # positions written so far
        slot = _CSlot(req=req, row=row,
                      budget=req.max_new_tokens
                      or self.cfg.default_max_new_tokens,
                      deadline_s=(req.deadline_s if req.deadline_s is not None
                                  else self.cfg.default_deadline_s),
                      admit_t=entry.admit_t, admit_seq=entry.admit_seq,
                      emitted=list(entry.emitted), retries=entry.retries,
                      preemptions=entry.preemptions)
        # KV allocation first: an injected kv_alloc failure is retried with
        # capped backoff then EVICTS (typed) — under every-hit arming the
        # alternative (requeue) livelocks. Real exhaustion never lands here
        # (_admissions checks affordability before calling).
        attempts = 0
        while True:
            try:
                ok = self.kv.grow(row, occupied)
            except Exception as exc:  # noqa: BLE001 — injected alloc failure
                cause = health.classify_failure(exc)
                if cause in RETRYABLE_CLASSES \
                        and attempts < self.cfg.max_retries:
                    attempts += 1
                    backoff = self._backoff(attempts)
                    health.SERVE.retry(rid, k, cause, backoff)
                    slot.retries += 1
                    self._sleep(backoff)
                    continue
                self.kv.release(row)
                self._live[row] = slot  # so _finalize_slot pops it
                done[rid] = self._finalize_slot(
                    slot, "evicted", f"kv allocation failed ({cause}): {exc}")
                return
            if not ok:  # raced a concurrent admission; wait in queue
                self._queue.appendleft(entry)
                return
            break
        # Prefill (batch-1, as at first admission, so a re-prefill gives the
        # same bits), then insert the prompt's positions into the pool and
        # replay the resumed prefix teacher-forced through the single-row
        # path of the shared step, committing each write as the live step
        # did. A quantized pool thus quantizes every position exactly once,
        # and no dense cache is inserted after the replay. The whole
        # sequence retries as a unit (pool writes are deterministic
        # overwrites of the row's own blocks).
        attempts = 0
        while True:
            try:
                faults.maybe_fail("engine_step")
                logits, caches = self.engine.prefill_request(req.tokens)
                self.kv.insert_dense(row, caches)
                for i in range(k - 1):
                    _, written = self._row_step(row, slot.emitted[i], S + i)
                    self._commit_pool(written)
                logits = faults.corrupt("sample", logits)
                if health.numerics_guard_enabled() \
                        and health.has_nonfinite(logits):
                    raise health.NumericsError(
                        f"non-finite logits for request {rid} at admission")
            except Exception as exc:  # noqa: BLE001 — classify, retry/evict
                cause = health.classify_failure(exc)
                if cause in RETRYABLE_CLASSES \
                        and attempts < self.cfg.max_retries:
                    attempts += 1
                    backoff = self._backoff(attempts)
                    health.SERVE.retry(rid, k, cause, backoff)
                    slot.retries += 1
                    self._sleep(backoff)
                    continue
                self._live[row] = slot
                done[rid] = self._finalize_slot(
                    slot, "evicted", f"{cause}: {exc}")
                return
            break
        self._live[row] = slot
        if entry.preempted:
            health.SERVE.resumed(rid, step=k)
        else:
            health.SERVE.live(rid)
            tok = self.engine.sample_tokens(logits, [rid], 0)
            slot.emitted.append(int(tok[0]))
            if len(slot.emitted) >= slot.budget:
                done[rid] = self._finalize_slot(slot, "completed")

    def _admissions(self, done: Dict[int, RequestResult]) -> None:
        now = self._clock()
        while self._queue and len(self._live) < self.cfg.max_live:
            entry = self._queue[0]
            deadline = (entry.req.deadline_s
                        if entry.req.deadline_s is not None
                        else self.cfg.default_deadline_s)
            if deadline is not None and now - entry.admit_t > deadline:
                self._queue.popleft()
                done[entry.req.request_id] = self._finalize_queued(
                    entry, "deadline_miss",
                    f"deadline {deadline:.3f}s elapsed in queue")
                continue
            occupied = entry.req.tokens.shape[0] \
                + max(0, len(entry.emitted) - 1)
            need = self.kv.blocks_for(occupied)
            if need > self.kv.alloc.capacity:
                self._queue.popleft()
                done[entry.req.request_id] = self._finalize_queued(
                    entry, "evicted",
                    f"resource: needs {need} KV blocks, pool capacity "
                    f"{self.kv.alloc.capacity}")
                continue
            if need > self.kv.alloc.free_count:
                break  # backpressure: wait for live rows to free blocks
            self._queue.popleft()
            row = self._free_row()
            before = len(done)
            self._admit_one(entry, row, done)
            if row not in self._live and len(done) == before:
                break  # entry went back to the queue head; stop admitting

    # ----- stepping -------------------------------------------------------

    def step(self) -> Dict[int, RequestResult]:
        """One scheduler tick: admit / resume into free rows, deadline-sweep
        the batch, grow KV (preempting under exhaustion), then advance every
        live row one token through the shared batched step. Returns newly
        finalized results."""
        done: Dict[int, RequestResult] = {}
        self._admissions(done)
        now = self._clock()
        for row in sorted(self._live):
            slot = self._live[row]
            if slot.deadline_s is not None \
                    and now - slot.admit_t > slot.deadline_s:
                done[slot.req.request_id] = self._finalize_slot(
                    slot, "deadline_miss",
                    f"deadline {slot.deadline_s:.3f}s elapsed")
        self._grow_all(done)
        if self._live:
            self._batched_step(done)
        return done

    def _grow_all(self, done: Dict[int, RequestResult]) -> None:
        """Ensure every live row's next write position is block-backed,
        preempting the newest-admitted live request on real exhaustion
        (oldest rows grow first, so the victim ordering is deterministic)."""
        for slot in sorted(self._live.values(), key=lambda s: s.admit_seq):
            if slot.row not in self._live:
                continue  # preempted by an earlier grower this tick
            rid = slot.req.request_id
            write_pos = slot.req.tokens.shape[0] + len(slot.emitted) - 1
            attempts = 0
            while True:
                try:
                    ok = self.kv.grow(slot.row, write_pos + 1)
                except Exception as exc:  # noqa: BLE001 — injected kv_alloc
                    cause = health.classify_failure(exc)
                    if cause in RETRYABLE_CLASSES \
                            and attempts < self.cfg.max_retries:
                        attempts += 1
                        backoff = self._backoff(attempts)
                        health.SERVE.retry(rid, len(slot.emitted), cause,
                                           backoff)
                        slot.retries += 1
                        self._sleep(backoff)
                        continue
                    done[rid] = self._finalize_slot(
                        slot, "evicted",
                        f"kv allocation failed ({cause}): {exc}")
                    break
                if ok:
                    break
                victim = self._newest_live()
                self._preempt(
                    victim,
                    f"kv pool exhausted growing request {rid} "
                    f"(free {self.kv.alloc.free_count})")
                if victim is slot:
                    break  # self-preempted: parked, resumes later

    def _batched_step(self, done: Dict[int, RequestResult]) -> None:
        """Advance the whole batch one token: guarded shared attempt with
        classified retry, then bisection on retry exhaustion."""
        cfg = self.cfg
        tokens = np.zeros((cfg.max_live, 1), np.int64)
        pos = np.zeros((cfg.max_live,), np.int64)
        for row, slot in self._live.items():
            tokens[row, 0] = slot.emitted[-1]
            pos[row] = slot.req.tokens.shape[0] + len(slot.emitted) - 1
        live_rows = sorted(self._live)
        attempts = 0
        while True:
            try:
                faults.maybe_fail("batch_step")
                logits, written = self._step(self.kv.device_tables(), tokens,
                                             pos)
            except Exception as exc:  # noqa: BLE001 — classify, retry/bisect
                cause = health.classify_failure(exc)
                if cause in RETRYABLE_CLASSES \
                        and attempts < cfg.max_retries:
                    attempts += 1
                    backoff = self._backoff(attempts)
                    for row in live_rows:
                        slot = self._live[row]
                        health.SERVE.retry(slot.req.request_id,
                                           len(slot.emitted), cause, backoff)
                        slot.retries += 1
                    self._sleep(backoff)
                    continue
                self._bisect(done, cause, exc)
                return
            break
        # Commit only after a clean shared step: retries and bisection never
        # see a half-written pool (the step wrote into its gathered copy).
        self._commit_pool(written)
        self._commit_rows(done, live_rows, logits)

    def _bisect(self, done: Dict[int, RequestResult], cause, exc) -> None:
        """Blast-radius containment: re-run each live row alone, through
        the single-row path of the shared step (bitwise the batched
        computation for that row). A row whose re-run fails is GUILTY and
        evicted; an exonerated row's re-run result is committed directly,
        so survivors are bitwise identical to an undisturbed run."""
        for row in sorted(self._live):
            slot = self._live[row]
            rid = slot.req.request_id
            step_idx = len(slot.emitted)
            write_pos = slot.req.tokens.shape[0] + step_idx - 1
            try:
                faults.maybe_fail("batch_step")   # per-re-run probe
                logits, written = self._row_step(row, slot.emitted[-1],
                                                 write_pos)
                if health.numerics_guard_enabled() \
                        and health.has_nonfinite(logits[row]):
                    raise health.NumericsError(
                        f"non-finite logits for request {rid} "
                        f"at step {step_idx}")
            except Exception as exc2:  # noqa: BLE001 — guilty verdict
                cause2 = health.classify_failure(exc2)
                health.SERVE.bisect(rid, step_idx, "guilty",
                                    f"{cause2}: {exc2}")
                done[rid] = self._finalize_slot(
                    slot, "evicted",
                    f"bisection: batched step failed ({cause}: {exc}); "
                    f"re-run guilty ({cause2}: {exc2})")
                continue
            health.SERVE.bisect(rid, step_idx, "exonerated",
                                f"batched step failed ({cause})")
            self._commit_pool(written)
            self._commit_rows(done, [row], logits)

    def _commit_rows(self, done: Dict[int, RequestResult], rows: List[int],
                     logits_b: torch.Tensor) -> None:
        """Sample + commit one token per row of ``rows`` from its row of
        the ``[max_live, V]`` logits (per-row numerics guard first: a
        poisoned row is evicted alone, its committed write scrubbed by
        release).

        Sampling runs at the full width ``max_live`` with the rows not
        committing padded by the first committing row's (rid, step): rows
        are independent in the sampler, so padding cannot perturb a real
        row's token, and every tick samples at one width."""
        commit = []
        for row in rows:
            slot = self._live[row]
            if health.numerics_guard_enabled() \
                    and health.has_nonfinite(logits_b[row]):
                done[slot.req.request_id] = self._finalize_slot(
                    slot, "evicted",
                    f"numerics: non-finite logits at step "
                    f"{len(slot.emitted)}")
                continue
            commit.append(row)
        if not commit:
            return
        width = logits_b.shape[0]
        rids = np.full((width,), self._live[commit[0]].req.request_id,
                       np.int64)
        steps = np.full((width,), len(self._live[commit[0]].emitted),
                        np.int64)
        for row in commit:
            rids[row] = self._live[row].req.request_id
            steps[row] = len(self._live[row].emitted)
        toks = self.engine.sample_tokens(logits_b, rids, steps).cpu().numpy()
        for row in commit:
            slot = self._live[row]
            slot.emitted.append(int(toks[row]))
            if len(slot.emitted) >= slot.budget:
                done[slot.req.request_id] = self._finalize_slot(
                    slot, "completed")

    # ----- driving loops --------------------------------------------------

    def drain(self, max_ticks: int = 1_000_000) -> Dict[int, RequestResult]:
        """Step until every admitted request reaches a terminal state.

        A full drain must return EVERY block to the pool (the no-leak clause
        of the block-accounting contract): a shortfall here is a scheduler
        bug, not load — it is recorded as a ``kv_leak`` health event and
        raised, never silently absorbed into a shrunken pool."""
        done: Dict[int, RequestResult] = {}
        ticks = 0
        while self._queue or self._live:
            done.update(self.step())
            ticks += 1
            if ticks > max_ticks:
                raise RuntimeError("drain exceeded max_ticks — a request "
                                   "is not making progress")
        alloc = self.kv.alloc
        if alloc.free_count != alloc.capacity:
            leaked = alloc.capacity - alloc.free_count
            detail = (f"{leaked} of {alloc.capacity} KV blocks still held "
                      "after a full drain")
            health.record_degradation("continuous_scheduler.drain",
                                      "paged_kv", "kv_leak", "none", detail)
            raise RuntimeError(f"kv_leak: {detail}")
        return done

    def run(self, schedule: Iterable[Tuple[float, Request]],
            tick_s: float = 0.0) -> Dict[int, RequestResult]:
        """Serve a timed arrival schedule ``[(arrival_s, request), ...]``
        exactly like ``StreamFrontend.run``."""
        sched = sorted(schedule, key=lambda it: it[0])
        results: Dict[int, RequestResult] = {}
        t0 = self._clock()
        i = 0
        while i < len(sched) or self._queue or self._live:
            now = self._clock() - t0
            while i < len(sched) and sched[i][0] <= now:
                req = sched[i][1]
                i += 1
                res = self.submit(req)
                if res is not None:
                    results[req.request_id] = res
            if not self._queue and not self._live:
                if i < len(sched):   # idle: wait for the next arrival
                    self._sleep(max(sched[i][0] - now, 1e-9))
                continue
            results.update(self.step())
            if tick_s:
                self._sleep(tick_s)
        return results

    # ----- observability --------------------------------------------------

    def stats(self) -> Dict[str, int]:
        """Queue / row depths, KV-block accounting, and the registry's
        conservation counters. ``preempted_open`` is the transient
        preempted population (in the extended invariant ``admitted ==
        completed + evicted + deadline_miss + open + preempted_open``)."""
        stats = dict(health.SERVE.counters())
        stats["queued"] = sum(1 for e in self._queue if not e.preempted)
        stats["preempted_open"] = sum(1 for e in self._queue if e.preempted)
        stats["live"] = len(self._live)
        stats["kv_blocks_free"] = self.kv.alloc.free_count
        stats["kv_blocks_capacity"] = self.kv.alloc.capacity
        return stats
