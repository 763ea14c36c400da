"""Serving engines composed from Kvik policies — the counterpart of
``repro.serve.engine``.

* :class:`Engine` — the synchronous reference: admit a batch, prefill it
  (by_blocks, interruptible), decode it to EOS (find_first early exit).
* :class:`ContinuousEngine` — continuous batching: a persistent decode batch
  with per-slot state; freed slots are backfilled by admitting queued
  prompts whose chunked prefill is interleaved between decode ticks.
  Admission is the ``cap`` adaptor driven by live telemetry, and the
  :class:`~repro_torch.serve.kvcache.PageTable` accounts cache pages.

Both handle mixed-length batches: prefill gathers each row's last *real*
logit and decode runs with true per-row lengths.  Slot state and caches are
tensors on the model's device, updated in place where the JAX engines
rebuild arrays.

Recurrent-only models (xLSTM, pure Mamba stacks) hold O(1) decode state
per request, so :class:`ContinuousEngine` accounts one page per request (a
*state slot*) instead of a sequence span.  ``EngineConfig.exit_entropy``
turns on the entropy-gated decode tick.

Like the reference's, both serve decoder-only models: a model with
cross-attention or an encoder raises ``ValueError`` (:func:`check_servable`;
its path is ``ChunkedPrefill.run(batch=...)`` then ``Model.decode_step``).

``admission="simulate"`` makes the sync engine size each batch with the
:class:`AdmissionSimulator` (a static partition on the virtual-time
Runtime); :class:`ContinuousEngine` admits through ``cap`` whatever
``admission`` says, as the reference does.  The chaos and drain hooks are
``kill_slot`` (a decode lane dies; its request is re-served from scratch),
``install_signal_handlers`` (SIGTERM drains the in-flight slots) and
``handoff`` (the frozen queue moves to a fresh engine).
"""

from __future__ import annotations

import dataclasses
import math
import signal
import time
from typing import Any, Dict, List, Optional, Sequence, Set

import numpy as np
import torch

from ..core import (Cap, CostModel, Runtime, StaticPartitionPolicy,
                    WorkRange, cap)
from ..models.model import Model
from .early_exit import (DecodeStats, decode_until_eos, make_decode_block,
                         make_decode_tick, make_gated_decode_tick)
from .kvcache import PageTable, cache_slot_insert
from .prefill import ChunkedPrefill
from .slo import SLO_CLASSES, FifoServePolicy, ServePolicy


def check_servable(model: Model) -> None:
    """Raise ``ValueError`` for what the engines do not serve: a model
    with cross-attention (vision) or an encoder (whisper), whose prompts
    need their modality stub.  The reference's engines never fill the
    cross K/V (``encode_to_cache``); the port refuses instead."""
    cfg = model.cfg
    if cfg.cross_attn_period or cfg.is_encdec:
        raise ValueError(
            f"{cfg.name}: the engines serve decoder-only models; a "
            f"cross-attention / encoder-decoder model runs through "
            f"ChunkedPrefill.run(batch=...) (or Model.prefill with the "
            f"batch dict) and Model.decode_step")


class QueueFull(RuntimeError):
    """submit() refused: the waiting queue is at ``EngineConfig.max_queue``."""


@dataclasses.dataclass
class AdmissionSimulator:
    """Pick how many queued requests to admit by simulating the batch.

    Admitting ``k`` requests pads them to their max length ``S_k``; the
    padded batch is ``k × S_k`` token-items executed as a static partition
    (one chunk per request — SPMD lanes don't steal) over ``lanes`` virtual
    workers, plus a fixed per-batch ``batch_overhead`` (dispatch, cache
    init, compile-shape reuse).  Useful work is the sum of *true* prompt
    lengths.  The admitted k maximizes useful-tokens/virtual-second — small
    k wastes the overhead, large k wastes padding; the simulator finds the
    knee.  Deterministic: no RNG is consumed by the static policy.
    """

    lanes: int = 4
    per_token: float = 1.0
    batch_overhead: float = 256.0

    def choose(self, lengths: Sequence[int], max_batch: int) -> int:
        best_k, best_rate = 1, -1.0
        cost = CostModel(per_item=self.per_token, split_overhead=0.0)
        for k in range(1, min(len(lengths), max_batch) + 1):
            smax = max(lengths[:k])
            res = Runtime(self.lanes, cost,
                          StaticPartitionPolicy(num_blocks=k)).run(
                WorkRange(0, k * smax))
            useful = float(sum(lengths[:k]))
            rate = useful / (res.makespan + self.batch_overhead)
            if rate > best_rate:
                best_k, best_rate = k, rate
        return best_k


@dataclasses.dataclass
class Request:
    rid: int
    prompt: np.ndarray            # (S,) int32
    max_new: int = 64
    slo: str = "batch"            # "interactive" | "batch" | "background"
    priority: int = 0
    deadline_s: Optional[float] = None
    tenant: str = "default"
    result: Optional[np.ndarray] = None
    stats: Optional[DecodeStats] = None
    shed: bool = False
    requeues: int = 0
    t_submit: Optional[float] = None
    t_first: Optional[float] = None
    t_done: Optional[float] = None


@dataclasses.dataclass
class EngineConfig:
    max_batch: int = 8
    eos_id: int = 2
    pad_id: int = 0
    max_seq: int = 512
    admission: str = "cap"        # "cap" (FIFO up to max_batch) | "simulate"
    prefill_block_budget: Optional[int] = None
    decode_tick: int = 8
    page_size: int = 32
    num_pages: Optional[int] = None
    max_queue: Optional[int] = None
    class_caps: Optional[Dict[str, int]] = None
    # uncertainty-gated early exit (continuous engine): a lane whose
    # predictive entropy stays below ``exit_entropy`` nats for
    # ``exit_patience`` consecutive steps retires early and its slot
    # backfills.  None disables gating (the exact decode tick).
    exit_entropy: Optional[float] = None
    exit_patience: int = 2

    def __post_init__(self) -> None:
        if self.max_batch < 1:
            raise ValueError(f"max_batch must be >= 1, got {self.max_batch}")
        if self.prefill_block_budget is not None \
                and self.prefill_block_budget < 1:
            raise ValueError("prefill_block_budget must be >= 1 when set, "
                             f"got {self.prefill_block_budget}")
        if self.decode_tick < 1:
            raise ValueError(
                f"decode_tick must be >= 1, got {self.decode_tick}")
        if self.page_size < 1:
            raise ValueError(f"page_size must be >= 1, got {self.page_size}")
        if self.max_seq < 1:
            raise ValueError(f"max_seq must be >= 1, got {self.max_seq}")
        if self.max_queue is not None and self.max_queue < self.max_batch:
            raise ValueError(
                f"max_queue ({self.max_queue}) must be >= max_batch "
                f"({self.max_batch}): a full batch must be admittable")
        for c, n in (self.class_caps or {}).items():
            if c not in SLO_CLASSES:
                raise ValueError(f"unknown SLO class {c!r} in class_caps; "
                                 f"expected one of {SLO_CLASSES}")
            if n < 1:
                raise ValueError(f"class_caps[{c!r}] must be >= 1, got {n}")
        if self.exit_entropy is not None and self.exit_entropy <= 0:
            raise ValueError(
                f"exit_entropy must be > 0 nats, got {self.exit_entropy}")
        if self.exit_patience < 1:
            raise ValueError(
                f"exit_patience must be >= 1, got {self.exit_patience}")


@dataclasses.dataclass
class EngineTelemetry:
    """Live measurements the admission cap consults (EWMA-smoothed)."""

    decode_s_per_token: float = 0.0
    prefill_s_per_block: float = 0.0
    prefill_s_per_token: float = 0.0
    pages_per_request: float = 0.0
    ticks: int = 0
    decode_steps: int = 0
    useful_decoded: int = 0
    admissions: int = 0
    prefill_preemptions: int = 0
    deferred_pages: int = 0
    retired: int = 0
    cap_divides: int = 0
    cap_finishes: int = 0
    cap_live_peak: int = 0
    queue_rejections: int = 0
    shed: int = 0
    shed_by_tenant: Dict[str, int] = dataclasses.field(default_factory=dict)
    shed_by_class: Dict[str, int] = dataclasses.field(default_factory=dict)
    class_preemptions: int = 0
    policy_swaps: int = 0
    slot_deaths: int = 0          # decode lanes killed (chaos) and requeued
    early_exits: int = 0          # lanes retired by the entropy gate
    ewma: float = 0.25
    # fields already seeded by a first observation (the first sample seeds
    # the EWMA directly instead of mixing with the zero init)
    _seeded: Set[str] = dataclasses.field(default_factory=set, repr=False)

    def _mix(self, field: str, new: float) -> float:
        if field not in self._seeded:
            self._seeded.add(field)
            return new
        old = getattr(self, field)
        return (1 - self.ewma) * old + self.ewma * new

    def observe_decode(self, useful: int, seconds: float, steps: int) -> None:
        self.ticks += 1
        self.decode_steps += steps
        self.useful_decoded += useful
        self.decode_s_per_token = self._mix("decode_s_per_token",
                                            seconds / max(1, useful))

    def observe_prefill(self, blocks: int, tokens: int,
                        seconds: float) -> None:
        if blocks:
            self.prefill_s_per_block = self._mix("prefill_s_per_block",
                                                 seconds / blocks)
        if tokens:
            self.prefill_s_per_token = self._mix("prefill_s_per_token",
                                                 seconds / tokens)

    def observe_admission(self, pages: int) -> None:
        self.admissions += 1
        self.pages_per_request = self._mix("pages_per_request", float(pages))

    def observe_shed(self, req: Request) -> None:
        self.shed += 1
        self.shed_by_tenant[req.tenant] = \
            self.shed_by_tenant.get(req.tenant, 0) + 1
        self.shed_by_class[req.slo] = self.shed_by_class.get(req.slo, 0) + 1

    def on_cap_event(self, kind: str, live: int) -> None:
        if kind == "divide":
            self.cap_divides += 1
        else:
            self.cap_finishes += 1
        self.cap_live_peak = max(self.cap_live_peak, live)

    def snapshot(self) -> Dict[str, float]:
        return {f.name: getattr(self, f.name)
                for f in dataclasses.fields(self)
                if f.name not in ("ewma", "_seeded", "shed_by_tenant",
                                  "shed_by_class")}


@dataclasses.dataclass
class _PrefillResidual:
    """A preempted prefill: everything needed to resume at ``pos``."""

    batch: List[Request]
    toks: torch.Tensor
    cache: Any
    pos: int
    max_new: int
    row_lengths: List[int]
    gathered: Optional[torch.Tensor]


def _first_tokens(model: Model, logits: torch.Tensor) -> torch.Tensor:
    return torch.argmax(logits[:, :model.cfg.vocab_size],
                        dim=-1).to(torch.int32)


class Engine:
    def __init__(self, model: Model, params: Any, cfg: EngineConfig):
        check_servable(model)
        self.model = model
        self.params = params
        self.cfg = cfg
        self.prefiller = ChunkedPrefill(model, first_block=32, align=32,
                                        max_block=256)
        self._blockfn = make_decode_block(model, cfg.eos_id)
        self.queue: List[Request] = []
        self.telemetry = EngineTelemetry()
        self.admission = cap(WorkRange(0, 1 << 30), cfg.max_batch)
        self.admission_sim = AdmissionSimulator(lanes=cfg.max_batch)
        self._residual: Optional[_PrefillResidual] = None

    def submit(self, req: Request) -> None:
        if self.cfg.max_queue is not None \
                and len(self.queue) >= self.cfg.max_queue:
            self.telemetry.queue_rejections += 1
            raise QueueFull(
                f"request {req.rid}: queue is at max_queue="
                f"{self.cfg.max_queue}; shed load or retry later")
        if req.t_submit is None:
            req.t_submit = time.perf_counter()
        self.queue.append(req)

    def _next_batch(self) -> List[Request]:
        if not self.queue:
            return []
        if self.cfg.admission == "simulate":
            take = self.admission_sim.choose(
                [len(r.prompt) for r in self.queue], self.cfg.max_batch)
        else:
            take = min(len(self.queue), self.cfg.max_batch)
        batch, self.queue = self.queue[:take], self.queue[take:]
        return batch

    def step(self) -> List[Request]:
        """Serve one unit of work; returns finished reqs (possibly []).
        A preempted prefill residual resumes before any new admission."""
        if self._residual is not None:
            r, self._residual = self._residual, None
            return self._prefill_and_decode(
                r.batch, r.toks, r.cache, r.max_new, r.row_lengths,
                start=r.pos, gathered=r.gathered)
        batch = self._next_batch()
        if not batch:
            return []
        B = len(batch)
        row_lengths = [len(r.prompt) for r in batch]
        S = max(row_lengths)
        S = max(32, 1 << (S - 1).bit_length())
        max_new = max(r.max_new for r in batch)
        if S + max_new > self.cfg.max_seq:
            raise ValueError(
                f"batch needs {S} (padded prompt) + {max_new} (max_new) = "
                f"{S + max_new} cache positions but EngineConfig.max_seq is "
                f"{self.cfg.max_seq}; raise max_seq or shrink the request")
        toks = np.full((B, S), self.cfg.pad_id, np.int32)
        for i, r in enumerate(batch):
            toks[i, :len(r.prompt)] = r.prompt     # left-aligned prompts
        cache = self.model.init_cache(B, S + max_new)
        return self._prefill_and_decode(
            batch, torch.as_tensor(toks, device=self.model.device), cache,
            max_new, row_lengths, start=0)

    def _prefill_and_decode(self, batch: List[Request], toks: torch.Tensor,
                            cache: Any, max_new: int,
                            row_lengths: List[int], *, start: int,
                            gathered: Optional[torch.Tensor] = None
                            ) -> List[Request]:
        B, S = toks.shape
        logits, cache, pstats = self.prefiller.run(
            self.params, toks, cache, start=start,
            max_blocks=self.cfg.prefill_block_budget,
            row_lengths=row_lengths, gathered=gathered)
        if pstats.preempted:      # requeue the bounded residual, yield
            self._residual = _PrefillResidual(
                batch=batch, toks=toks, cache=cache,
                pos=pstats.next_start, max_new=max_new,
                row_lengths=row_lengths, gathered=logits)
            return []
        dev = self.model.device
        lengths = torch.as_tensor(row_lengths, dtype=torch.int32, device=dev)
        first = _first_tokens(self.model, logits)
        first_np = first.cpu().numpy()
        now = time.perf_counter()
        for r in batch:
            r.t_first = now
        if max_new > 1:           # `first` already counts toward max_new
            gen, cache, dstats = decode_until_eos(
                self.model, self.params, first, cache, lengths,
                eos_id=self.cfg.eos_id, max_new=max_new - 1,
                blockfn=self._blockfn)
            gen_np = gen.cpu().numpy()
        else:
            gen_np = np.full((B, 0), -1, np.int32)
            dstats = DecodeStats(all_finished=True)
        now = time.perf_counter()
        for i, r in enumerate(batch):
            row = gen_np[i]
            row = row[row >= 0][:max(0, r.max_new - 1)]
            r.result = np.concatenate(
                [first_np[i:i + 1], row.astype(np.int32)])
            useful = len(r.result)
            r.stats = DecodeStats(
                blocks=dstats.blocks, steps_run=dstats.steps_run,
                useful_tokens=useful,
                wasted_tokens=dstats.steps_run - (useful - 1),
                all_finished=bool((r.result == self.cfg.eos_id).any()))
            r.t_done = now
        return batch


@dataclasses.dataclass
class _Slot:
    """One occupied decode-batch lane."""

    req: Request
    first: int
    lease: Cap
    class_lease: Optional[Cap] = None
    emitted: List[int] = dataclasses.field(default_factory=list)
    eos_hit: bool = False
    steps: int = 0
    wasted: int = 0
    early_exit: bool = False      # retired by the entropy gate


@dataclasses.dataclass
class _PrefillJob:
    """The (single) in-flight chunked prefill, resumable across steps."""

    req: Request
    lease: Cap
    toks: torch.Tensor            # (1, S_pad)
    cache: Any                    # batch=1 scratch cache, width max_seq
    pos: int = 0
    gathered: Optional[torch.Tensor] = None
    class_lease: Optional[Cap] = None
    done_logits: Optional[torch.Tensor] = None


class ContinuousEngine:
    """Continuous batching.  Each :meth:`step` (1) tries to admit one queued
    request (cap + page gate), (2) runs at most a budget of prefill blocks
    on the in-flight prompt, (3) runs one decode tick over the live slots,
    (4) retires finished slots and returns their requests."""

    def __init__(self, model: Model, params: Any, cfg: EngineConfig,
                 policy: Optional[ServePolicy] = None):
        check_servable(model)
        self.model = model
        self.params = params
        self.cfg = cfg
        self.prefiller = ChunkedPrefill(model, first_block=32, align=32,
                                        max_block=256)
        self.queue: List[Request] = []
        self.telemetry = EngineTelemetry()
        B = cfg.max_batch
        per_slot = -(-cfg.max_seq // cfg.page_size)
        self.pages = PageTable(cfg.page_size, cfg.num_pages or B * per_slot)
        # the shared counter starts at 1 (the root task), so a threshold of
        # max_batch+1 admits max_batch leases
        self._admission: Cap = Cap(
            WorkRange(0, 1 << 30), B + 1,
            threshold_fn=self._admission_limit,
            on_event=self.telemetry.on_cap_event)
        self._class_caps: Dict[str, Cap] = {
            c: Cap(WorkRange(0, 1 << 30), n + 1)
            for c, n in (cfg.class_caps or {}).items()}
        dev = model.device
        self.cache = model.init_cache(B, cfg.max_seq)
        self.lengths = torch.zeros((B,), dtype=torch.int32, device=dev)
        self.tokens = torch.zeros((B,), dtype=torch.int32, device=dev)
        self.finished = torch.ones((B,), dtype=torch.bool, device=dev)
        self.remaining = torch.zeros((B,), dtype=torch.int32, device=dev)
        self.streak = torch.zeros((B,), dtype=torch.int32, device=dev)
        self.slots: List[Optional[_Slot]] = [None] * B
        self._job: Optional[_PrefillJob] = None
        self._parked: Optional[_PrefillJob] = None
        # recurrence-only models hold O(1) decode state per request: pages
        # become fixed-size state slots instead of seq-length KV spans
        self._state_slots = model.recurrent_only
        if cfg.exit_entropy is not None:
            self._tick = make_gated_decode_tick(
                model, cfg.eos_id, tau=cfg.exit_entropy,
                patience=cfg.exit_patience)
        else:
            self._tick = make_decode_tick(model, cfg.eos_id)
        self._policy: ServePolicy = policy or FifoServePolicy()
        self.preempted = False    # SIGTERM drain flag

    # ---------------------------------------------------------------- policy
    @property
    def policy(self) -> ServePolicy:
        return self._policy

    def set_policy(self, policy: ServePolicy) -> None:
        """Hot-swap the scheduling policy; only future admissions see it."""
        self._policy = policy
        self.telemetry.policy_swaps += 1

    # ---------------------------------------------------------------- admit
    def _slot_span(self, req: Request) -> int:
        """Worst-case cache positions the request can touch: the padded
        prefill width or true length + budget, whichever is larger.  A
        recurrent-only model's request holds one page (its state slot)
        whatever its prompt or budget."""
        if self._state_slots:
            return self.cfg.page_size
        pad = max(32, -(-len(req.prompt) // 32) * 32)
        return max(pad, len(req.prompt) + req.max_new)

    def submit(self, req: Request) -> None:
        span = self._slot_span(req)
        if span > self.cfg.max_seq:
            raise ValueError(
                f"request {req.rid}: prompt {len(req.prompt)} + max_new "
                f"{req.max_new} needs {span} cache positions but "
                f"EngineConfig.max_seq is {self.cfg.max_seq}")
        if req.slo not in SLO_CLASSES:
            raise ValueError(f"request {req.rid}: unknown SLO class "
                             f"{req.slo!r}; expected one of {SLO_CLASSES}")
        if self.cfg.max_queue is not None \
                and len(self.queue) >= self.cfg.max_queue:
            self.telemetry.queue_rejections += 1
            raise QueueFull(
                f"request {req.rid}: queue is at max_queue="
                f"{self.cfg.max_queue}; shed load or retry later")
        if req.t_submit is None:
            req.t_submit = time.perf_counter()
        self.queue.append(req)

    def _admission_limit(self) -> int:
        """Active requests + how many more the page headroom can hold at
        the measured per-request footprint, +1 for the counter's root."""
        active = sum(s is not None for s in self.slots)
        active += 1 if self._job is not None else 0
        active += 1 if self._parked is not None else 0
        ppr = self.telemetry.pages_per_request
        est = (max(1, int(math.ceil(ppr))) if ppr > 0
               else max(1, self.pages.pages_needed(self.cfg.max_seq // 4)))
        headroom = len(self.pages.free) // est
        return active + headroom + 1

    def _class_cap_ok(self, slo: str) -> bool:
        c = self._class_caps.get(slo)
        return c is None or c.should_be_divided()

    def _take_class_lease(self, slo: str) -> Optional[Cap]:
        c = self._class_caps.get(slo)
        if c is None:
            return None
        lease, rest = c.divide_at(1)
        self._class_caps[slo] = rest
        return lease

    # -------------------------------------------------------------- shedding
    def _shed_expired(self) -> List[Request]:
        """Drop queue entries already past their deadline; they are returned
        from step() with an empty result and ``shed=True``."""
        if not self.queue:
            return []
        now = time.perf_counter()
        shed: List[Request] = []
        kept: List[Request] = []
        for r in self.queue:
            if r.deadline_s is not None and r.t_submit is not None \
                    and now > r.t_submit + r.deadline_s:
                r.shed = True
                r.result = np.zeros((0,), np.int32)
                r.stats = DecodeStats(all_finished=False)
                r.t_done = now
                self.telemetry.observe_shed(r)
                shed.append(r)
            else:
                kept.append(r)
        self.queue = kept
        return shed

    def _try_admit(self) -> None:
        if self._job is not None or not self.queue:
            return
        free_slots = sum(s is None for s in self.slots)
        if free_slots <= (1 if self._parked is not None else 0):
            return                # a parked prefill keeps one lane reserved
        if not self._admission.should_be_divided():
            return
        req = None
        for qi in self._policy.order(self.queue, time.perf_counter()):
            if self._class_cap_ok(self.queue[qi].slo):
                req = self.queue[qi]
                break
        if req is None:           # every waiting class is at its cap
            return
        pages = self.pages.allocate(req.rid, self._slot_span(req))
        if pages is None:         # page exhaustion → defer admission
            self.telemetry.deferred_pages += 1
            return
        self.queue.remove(req)
        lease, rest = self._admission.divide_at(1)
        self._admission = rest
        class_lease = self._take_class_lease(req.slo)
        self.telemetry.observe_admission(len(pages))
        S_pad = max(32, -(-len(req.prompt) // 32) * 32)
        toks = np.full((1, S_pad), self.cfg.pad_id, np.int32)
        toks[0, :len(req.prompt)] = req.prompt
        self._job = _PrefillJob(
            req=req, lease=lease,
            toks=torch.as_tensor(toks, device=self.model.device),
            cache=self.model.init_cache(1, self.cfg.max_seq),
            class_lease=class_lease)

    # ---------------------------------------------------- class preemption
    def _maybe_park_prefill(self) -> None:
        """Park a lower-class in-flight prefill at its by_blocks boundary
        when interactive work is waiting and admittable."""
        job = self._job
        if (not self._policy.preempt_classes or job is None
                or self._parked is not None or job.done_logits is not None
                or job.req.slo == "interactive"):
            return
        if not any(r.slo == "interactive" for r in self.queue):
            return
        if sum(s is None for s in self.slots) < 2:
            return                # one lane for each of the two jobs
        if not self._admission.should_be_divided() \
                or not self._class_cap_ok("interactive"):
            return
        self._parked, self._job = job, None
        self.telemetry.class_preemptions += 1

    # -------------------------------------------------------------- prefill
    def _prefill_budget(self) -> Optional[int]:
        """Prefill blocks one step may spend: the configured budget,
        tightened so prefill stays comparable to one decode tick."""
        budget = self.cfg.prefill_block_budget
        t = self.telemetry
        if t.decode_s_per_token > 0 and t.prefill_s_per_block > 0:
            tick_wall = t.decode_s_per_token * self.cfg.decode_tick
            balanced = max(1, int(tick_wall / t.prefill_s_per_block))
            budget = balanced if budget is None else min(budget, balanced)
        return budget

    def _run_prefill(self) -> None:
        job = self._job
        if job is None:
            return
        if job.done_logits is not None:   # completed earlier, lane-starved
            self._install_job(job, job.done_logits)
            return
        t0 = time.perf_counter()
        logits, cache, pstats = self.prefiller.run(
            self.params, job.toks, job.cache, start=job.pos,
            max_blocks=self._prefill_budget(),
            row_lengths=[len(job.req.prompt)], gathered=job.gathered)
        self.telemetry.observe_prefill(pstats.blocks, pstats.tokens,
                                       time.perf_counter() - t0)
        if pstats.preempted:
            job.cache, job.pos, job.gathered = cache, pstats.next_start, \
                logits
            self.telemetry.prefill_preemptions += 1
            return
        job.cache = cache
        self._install_job(job, logits)

    def _install_job(self, job: _PrefillJob, logits: torch.Tensor) -> None:
        """Install a completed prefill into a free decode lane (or stash
        its logits until one frees up)."""
        free = [i for i, s in enumerate(self.slots) if s is None]
        if not free:
            job.done_logits = logits
            return
        slot = free[0]
        req = job.req
        cache_slot_insert(self.cache, job.cache, slot)
        first = int(_first_tokens(self.model, logits)[0])
        req.t_first = time.perf_counter()
        done = (first == self.cfg.eos_id) or (req.max_new <= 1)
        self.lengths[slot] = len(req.prompt)
        self.tokens[slot] = first
        self.finished[slot] = done
        self.remaining[slot] = req.max_new - 1
        self.streak[slot] = 0
        self.slots[slot] = _Slot(req=req, first=first, lease=job.lease,
                                 class_lease=job.class_lease,
                                 eos_hit=(first == self.cfg.eos_id))
        self._job = None

    # --------------------------------------------------------------- decode
    def _decode_tick(self) -> None:
        occupied = [i for i, s in enumerate(self.slots) if s is not None]
        if not occupied:
            return
        fin = self.finished.cpu().numpy()
        if all(fin[i] for i in occupied):
            return
        n = self.cfg.decode_tick
        t0 = time.perf_counter()
        gated_np = None
        if self.cfg.exit_entropy is not None:
            (self.tokens, self.cache, self.lengths, self.finished,
             self.remaining, self.streak, gated, out, wasted) = self._tick(
                self.params, self.tokens, self.cache, self.lengths,
                self.finished, self.remaining, self.streak, n)
            gated_np = gated.cpu().numpy()
        else:
            (self.tokens, self.cache, self.lengths, self.finished,
             self.remaining, out, wasted) = self._tick(
                self.params, self.tokens, self.cache, self.lengths,
                self.finished, self.remaining, n)
        out_np = out.cpu().numpy()        # waits for the tick
        self.telemetry.observe_decode(int((out_np >= 0).sum()),
                                      time.perf_counter() - t0, n)
        wasted_np = wasted.cpu().numpy()
        for i in occupied:
            s = self.slots[i]
            valid = out_np[i][out_np[i] >= 0]
            s.emitted.extend(int(t) for t in valid)
            s.steps += n
            s.wasted += int(wasted_np[i])
            if (valid == self.cfg.eos_id).any():
                s.eos_hit = True
            if gated_np is not None and bool(gated_np[i]):
                s.early_exit = True

    # --------------------------------------------------------------- retire
    def _retire(self) -> List[Request]:
        fin = self.finished.cpu().numpy()
        done: List[Request] = []
        now = time.perf_counter()
        for i, s in enumerate(self.slots):
            if s is None or not fin[i]:
                continue
            r = s.req
            toks = [s.first] + s.emitted
            r.result = np.asarray(toks[:r.max_new], np.int32)
            r.stats = DecodeStats(
                blocks=-(-s.steps // max(1, self.cfg.decode_tick)),
                steps_run=s.steps,
                useful_tokens=len(r.result),
                wasted_tokens=s.steps - (len(r.result) - 1),
                all_finished=s.eos_hit,
                early_exit=s.early_exit)
            if s.early_exit:
                self.telemetry.early_exits += 1
            r.t_done = now
            self.pages.release(r.rid)
            s.lease.on_finish()
            if s.class_lease is not None:
                s.class_lease.on_finish()
            self.slots[i] = None
            self.telemetry.retired += 1
            done.append(r)
        return done

    # ----------------------------------------------------------------- chaos
    def kill_slot(self, i: int) -> bool:
        """Chaos hook: decode lane ``i`` dies mid-decode.  Its emitted
        tokens, pages and leases are discarded and the request is requeued
        at the *front* of the waiting queue to be re-served from scratch.
        Returns False for an empty or out-of-range lane (fault plans are
        written against step indices, not live lane assignments)."""
        s = self.slots[i] if 0 <= i < len(self.slots) else None
        if s is None:
            return False
        r = s.req
        self.pages.release(r.rid)
        s.lease.on_finish()
        if s.class_lease is not None:
            s.class_lease.on_finish()
        self.slots[i] = None
        self.finished[i] = True
        self.remaining[i] = 0
        self.lengths[i] = 0
        self.streak[i] = 0
        r.requeues += 1
        r.t_first = None
        self.queue.insert(0, r)
        self.telemetry.slot_deaths += 1
        return True

    # -------------------------------------------------------------- preempt
    def install_signal_handlers(self, signals=(signal.SIGTERM,)) -> Dict:
        """Route SIGTERM to a graceful drain: the flag flips at the next
        step() boundary — in-flight slots and the in-flight prefill run to
        completion, the waiting queue is frozen for :meth:`handoff`.
        Returns the previous handlers so callers can restore them."""
        return {s: signal.signal(s, self._on_signal) for s in signals}

    def _on_signal(self, signum, frame) -> None:
        self.preempted = True

    def handoff(self) -> List[Request]:
        """Detach the waiting queue (for resubmission on a fresh engine
        after a drain).  Queued requests were never prefix-cached, so
        resubmission is exact by construction."""
        q, self.queue = self.queue, []
        return q

    # ----------------------------------------------------------------- loop
    @property
    def pending(self) -> bool:
        in_flight = (self._job is not None or self._parked is not None
                     or any(s is not None for s in self.slots))
        if self.preempted:
            return in_flight      # drain mode: the queue waits for handoff
        return bool(self.queue) or in_flight

    def step(self) -> List[Request]:
        shed: List[Request] = []
        if not self.preempted:
            shed = self._shed_expired()
            self._maybe_park_prefill()
            self._try_admit()
        if self._job is None and self._parked is not None:
            # nothing (more) to admit ahead of it: resume the parked prefill
            self._job, self._parked = self._parked, None
        self._run_prefill()
        self._decode_tick()
        return self._retire() + shed


__all__ = ["Engine", "ContinuousEngine", "EngineConfig", "EngineTelemetry",
           "Request", "AdmissionSimulator", "QueueFull", "check_servable"]
