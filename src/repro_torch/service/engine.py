"""Continuous-batching solve engine (PyTorch port of
``repro.service.engine``).

A fixed ``(n, max_batch)`` block of right-hand-side slots per registered
operator is stepped in chunks of k iterations by one program of the
operator's session (:mod:`repro_torch.core.program`: on the card one CUDA
graph per distinct chunk, captured once and replayed), whatever mix of
requests occupies the slots.  Empty slots ride along as frozen columns
(per-column budget 0), so the program's shapes never change and nothing
is captured again under load.

Between chunks the engine retires finished columns (converged, broken
down, past their per-request ``maxiter``, enforced on the device by the
per-column mask, or past their wall-clock ``deadline``) and refills the
freed slots mid-flight.  The refill is the first step of the next chunk's
schedule, from the program's constant buffers (the session's fused
``splice_step``), so a chunk boundary costs one run of the program and
one host read, with refills or without: ``stats`` counts both.  Columns
are independent ("individual" blocked mode), so multiplexing is exact: a
request's trajectory is the one it would have in a standalone
``solve_many`` column (tests/test_torch_service.py holds it to the JAX
engine's).

The host side: a right-hand side stays a numpy array until admission,
when the slots being filled are written into one host block (pinned on
the card; one right-hand side per row, so each is one contiguous copy)
that is copied to the device once, into the program's constant buffer.
After each chunk the engine reads the (m,) flag vectors as one (k, m)
tensor, one copy to the host (with ``ServiceConfig.trace_cap`` the block's
trace ring and its step count ride in the same copy, concatenated below
the flags), and the ``x`` columns of the requests it retires, transposed
on the device, in one more.

Observability (``ServiceConfig.profile_dir``): :meth:`SolveEngine.run`
drains inside a device profile capture and leaves the analysed report on
``last_profile``.

Resilience (``ServiceConfig.recovery``): the blocks step guarded (the
(11, m) health rows), every retirement carries a typed
:class:`~repro_torch.core.SolveStatus`, columns that went non-finite are
scrubbed (freeze-spliced) before their slot is reused, and failed
requests are re-enqueued with capped exponential backoff up to
``recovery.max_retries`` times (stable rid).
"""
from __future__ import annotations

import dataclasses
import os
import time
from collections import deque
from typing import Deque, Dict, List, Optional

import numpy as np
import torch

from ..core.types import SolveStatus
from ..observe import metrics as _metrics
from ..observe import profile as _profile
from ..observe.spans import span as _span
from ..observe.trace import ConvergenceTrace
from .registry import OperatorRegistry, RegisteredOperator
from .types import (RequestResult, RequestTelemetry, ServiceConfig,
                    SolveRequest)

#: the (m,) state fields read back after every chunk (guarded blocks add
#: "status"), as one stacked float64 tensor
_FLAGS = ("converged", "breakdown", "iterations", "relres", "col_maxiter")


@dataclasses.dataclass
class _Block:
    """One operator's resident (n, max_batch) block and host slot table."""

    state: Optional[dict]
    slots: List[Optional[SolveRequest]]
    #: the host block admissions are assembled in, (max_batch, n): one
    #: right-hand side per row (pinned on the card)
    staging: torch.Tensor
    #: slots whose device column is still iterating but whose request was
    #: retired on the host (deadline) or that went non-finite: they are
    #: freeze-spliced before reuse
    orphans: set = dataclasses.field(default_factory=set)

    def live(self) -> bool:
        return any(s is not None for s in self.slots)


class SolveEngine:
    """Multiplex heterogeneous solve requests onto resident blocks.

    One resident block per registered operator; :meth:`poll` services one
    operator for one chunk (round-robin over operators with work) and
    returns the requests that completed; :meth:`run` drains everything.

    ``clock`` is injectable (tests drive deadlines with a
    :class:`~repro_torch.observe.TickingClock`); monotonic seconds.

    ``stats``: ``chunks`` serviced, ``admissions`` (chunks that spliced),
    ``runs`` of the blocks' programs (graph replays on the card),
    ``host_reads`` of the flags, ``x_reads`` (copies of retiring columns'
    ``x``) and ``steps`` queued.
    """

    def __init__(self, scfg: ServiceConfig = ServiceConfig(),
                 clock=time.monotonic):
        self.scfg = scfg
        self.registry = OperatorRegistry(scfg)
        self._clock = clock
        self._queues: Dict[str, Deque[SolveRequest]] = {}
        self._blocks: Dict[str, Optional[_Block]] = {}
        self._next_rid = 0
        self._rr = 0                     # round-robin cursor
        self._expired: List[RequestResult] = []
        self.stats: Dict[str, int] = dict(chunks=0, admissions=0, runs=0,
                                          host_reads=0, x_reads=0, steps=0)
        #: the :class:`~repro_torch.observe.ProfileReport` of the latest
        #: profiled :meth:`run` (``ServiceConfig.profile_dir``)
        self.last_profile = None

    # -- registration / submission ---------------------------------------
    def register(self, op, precond=None, name: Optional[str] = None) -> str:
        """Register an operator (idempotent by content; see registry)."""
        return self._serve(self.registry.register(op, precond, name))

    def register_scenario(self, scenario, name: Optional[str] = None) -> str:
        """Register a scenario (name or :class:`repro_torch.scenarios
        .Scenario`): its plugin-built operator + precond become a resident
        block under the scenario's name."""
        return self._serve(self.registry.register_scenario(scenario, name))

    def _serve(self, name: str) -> str:
        """Give a registered name's entry a queue and a block slot."""
        canon = self.registry[name].name
        self._queues.setdefault(canon, deque())
        self._blocks.setdefault(canon, None)
        return name

    def submit(self, operator: str, b, *, tol: Optional[float] = None,
               maxiter: Optional[int] = None,
               deadline: Optional[float] = None) -> int:
        """Enqueue one right-hand side; returns the request id."""
        entry = self.registry[operator]
        if isinstance(b, torch.Tensor):
            b = b.detach().cpu().numpy()
        # staged on the host until admission: no device copy per request
        b = np.asarray(b, dtype=_np_dtype(entry.dtype))
        if b.shape != (entry.n,):
            raise ValueError(
                f"operator {operator!r} expects rhs of shape "
                f"({entry.n},); got {b.shape}")
        req = SolveRequest(operator=entry.name, b=b, tol=tol,
                           maxiter=maxiter, deadline=deadline,
                           rid=self._next_rid, t_submit=self._clock())
        self._next_rid += 1
        self._queues[entry.name].append(req)
        _metrics.ENGINE_QUEUE_DEPTH.set(len(self._queues[entry.name]),
                                        operator=entry.name)
        return req.rid

    # -- serving ---------------------------------------------------------
    def has_work(self) -> bool:
        return any(q for q in self._queues.values()) or \
            any(b is not None and b.live() for b in self._blocks.values())

    def run(self) -> List[RequestResult]:
        """Drain all queues and blocks; completed requests in retirement
        order.

        With ``ServiceConfig.profile_dir`` set, the drain runs inside a
        :mod:`repro_torch.observe.profile` capture, and the analysed report
        lands on :attr:`last_profile` and ``profile_dir/profile.json``.  The
        chunks are graph replays, so their kernels are attributed by name
        (no eager run of the drain teaches a kernel map).  Results are the
        same."""
        if not self.scfg.profile_dir:
            return self._drain()
        with _profile.capture(self.scfg.profile_dir) as cap:
            out = self._drain()
        sub = self.scfg.substrate
        rep = cap.analyze(label=f"engine/{getattr(sub, 'name', sub)}")
        rep.save(os.path.join(self.scfg.profile_dir, "profile.json"))
        self.last_profile = rep
        return out

    def _drain(self) -> List[RequestResult]:
        out: List[RequestResult] = []
        while self.has_work():
            out.extend(self.poll())
        out.extend(self._take_expired())
        return out

    def poll(self) -> List[RequestResult]:
        """Service ONE operator for one chunk; returns newly completed
        requests (possibly none).  No-op when nothing has work."""
        entries = self.registry.entries()
        for off in range(len(entries)):
            entry = entries[(self._rr + off) % len(entries)]
            if self._entry_has_work(entry):
                self._rr = (self._rr + off + 1) % len(entries)
                done = self._service_chunk(entry)
                return self._take_expired() + done
        return self._take_expired()

    # -- internals -------------------------------------------------------
    def _entry_has_work(self, entry: RegisteredOperator) -> bool:
        blk = self._blocks[entry.name]
        return bool(self._queues[entry.name]) or \
            (blk is not None and blk.live())

    def _take_expired(self) -> List[RequestResult]:
        out, self._expired = self._expired, []
        return out

    def _next_request(self, q: Deque[SolveRequest]
                      ) -> Optional[SolveRequest]:
        """Pop the next serviceable request; requests whose deadline
        elapsed while queued are retired at once (they never take a slot),
        and retried requests still inside their backoff window
        (``not_before``) rotate to the back of the queue."""
        for _ in range(len(q)):
            req = q.popleft()
            if req.deadline is not None and \
                    self._clock() - req.t_submit > req.deadline:
                now = self._clock()
                self._expired.append(RequestResult(
                    rid=req.rid, operator=req.operator,
                    x=np.zeros((req.b.shape[0],), req.b.dtype),
                    iterations=0, relres=float("inf"),
                    converged=False, breakdown=False,
                    telemetry=RequestTelemetry(
                        queue_wait_s=now - req.t_submit, service_s=0.0,
                        wall_s=now - req.t_submit, chunks_resident=0,
                        deadline_exceeded=True),
                    status=SolveStatus.DEADLINE, retries=req.retries))
                self._observe_result(self._expired[-1])
                continue
            if req.not_before and self._clock() < req.not_before:
                q.append(req)            # backing off: not eligible yet
                continue
            return req
        return None

    def _fill_vectors(self, entry, slot_iter, B, tolv, mitv, mask=None):
        """Assign queued requests (then freeze-dummies) to the given free
        slots, writing the rhs rows ``B[j]`` and per-column tol/maxiter in
        place.
        ``mask=None`` marks the initial fill (every slot is written);
        otherwise only masked columns are spliced."""
        q = self._queues[entry.name]
        blk = self._blocks[entry.name]
        for j in slot_iter:
            req = self._next_request(q)
            if req is not None:
                req.t_start = self._clock()
                B[j] = req.b
                tolv[j] = self.scfg.tol if req.tol is None else req.tol
                mitv[j] = self.scfg.maxiter if req.maxiter is None \
                    else req.maxiter
                blk.slots[j] = req
                blk.orphans.discard(j)
                if mask is not None:
                    mask[j] = True
            elif mask is not None and j in blk.orphans:
                # no request for this slot: freeze-splice the orphan
                # column (deadline-retired or poisoned)
                B[j] = 1.0            # safe nonzero rhs, budget 0
                mitv[j] = 0
                mask[j] = True
                blk.orphans.discard(j)
            elif mask is None:
                B[j] = 1.0            # initial fill: inert pad column
                mitv[j] = 0

    @staticmethod
    def _observe_result(res: RequestResult) -> None:
        """One retirement into the metrics registry; every value is known
        on the host already, so recording adds no device read."""
        _metrics.ENGINE_REQUESTS.inc(status=res.status.name)
        t = res.telemetry
        _metrics.REQUEST_QUEUE_WAIT.observe(t.queue_wait_s)
        _metrics.REQUEST_WALL.observe(t.wall_s)
        _metrics.REQUEST_CHUNKS.observe(t.chunks_resident)
        _metrics.SOLVE_ITERATIONS.observe(res.iterations)

    def _service_chunk(self, entry: RegisteredOperator
                       ) -> List[RequestResult]:
        with _span("engine.chunk", operator=entry.name):
            t0 = self._clock()
            out = self._service_chunk_inner(entry)
            _metrics.ENGINE_CHUNK_SECONDS.observe(self._clock() - t0)
        blk = self._blocks[entry.name]
        _metrics.ENGINE_QUEUE_DEPTH.set(
            len(self._queues[entry.name]), operator=entry.name)
        _metrics.ENGINE_SLOT_OCCUPANCY.set(
            0 if blk is None else sum(s is not None for s in blk.slots),
            operator=entry.name)
        return out

    def _new_block(self, entry: RegisteredOperator) -> _Block:
        m = self.scfg.max_batch
        staging = torch.zeros((m, entry.n), dtype=entry.dtype,
                              pin_memory=entry.device.type == "cuda")
        return _Block(state=None, slots=[None] * m, staging=staging)

    def _service_chunk_inner(self, entry: RegisteredOperator
                             ) -> List[RequestResult]:
        name = entry.name
        q = self._queues[name]
        blk = self._blocks[name]
        m = self.scfg.max_batch
        stats = entry.session.stats
        runs0 = stats["runs"]

        # 1) admit + step, one run of the block's program: the plain
        # chunk, or the chunk opened by the splice of the refilled slots
        if blk is None:
            if not q:
                return []
            blk = self._blocks[name] = self._new_block(entry)
            B = blk.staging.numpy()
            tolv = np.full((m,), self.scfg.tol, np.float64)
            mitv = np.zeros((m,), np.int32)
            self._fill_vectors(entry, range(m), B, tolv, mitv)
            with _span("engine.init_fill", operator=name):
                # a copy (the state must not alias the host block the next
                # admission is written into), transposed on the device
                blk.state = entry.step_fn(entry.init_fn(
                    blk.staging.to(entry.device, copy=True).t(),
                    torch.from_numpy(tolv), torch.from_numpy(mitv)))
        else:
            free = [j for j in range(m) if blk.slots[j] is None]
            mask = np.zeros((m,), bool)
            if free and (q or blk.orphans):
                B = blk.staging.numpy()
                tolv = np.zeros((m,), np.float64)
                mitv = np.zeros((m,), np.int32)
                self._fill_vectors(entry, free, B, tolv, mitv, mask=mask)
            if mask.any():
                self.stats["admissions"] += 1
                with _span("engine.splice_step", operator=name,
                           refills=int(mask.sum())):
                    blk.state = entry.splice_step_fn(
                        blk.state, torch.from_numpy(mask), blk.staging.t(),
                        torch.from_numpy(tolv), torch.from_numpy(mitv))
            else:
                with _span("engine.step", operator=name):
                    blk.state = entry.step_fn(blk.state)
        self.stats["chunks"] += 1
        self.stats["steps"] += self.scfg.chunk
        self.stats["runs"] += stats["runs"] - runs0
        for req in blk.slots:
            if req is not None:
                req.chunks_resident += 1

        # 2) retire finished / deadline-blown columns: ONE host read of the
        # (m,) flag vectors (and the typed status of a guarded block, and
        # the trace ring with its step count when tracing is on), stacked
        # into one tensor
        st = blk.state
        guarded = "status" in st
        fields = _FLAGS + (("status",) if guarded else ())
        with _span("engine.retire", operator=name):
            rows = torch.stack([st[k].to(torch.float64) for k in fields])
            if "trace" in st:
                rows = torch.cat([rows,
                                  st["i"].to(torch.float64).expand(1, m),
                                  st["trace"].reshape(-1, m)
                                  .to(torch.float64)])
            got = rows.cpu().numpy()
        self.stats["host_reads"] += 1
        conv, brk = got[0] != 0, got[1] != 0
        iters, relres, budget = got[2].astype(np.int64), got[3], got[4]
        status_arr = got[5].astype(np.int64) if guarded else None
        ring, ring_steps = None, 0
        if "trace" in st:
            ring = got[len(fields) + 1:].reshape(st["trace"].shape)
            ring_steps = int(got[len(fields), 0])
        recovery = self.scfg.recovery
        now = self._clock()
        retiring = []              # (slot, request, status, expired)
        for j, req in enumerate(blk.slots):
            if req is None:
                continue
            finished = bool(conv[j] or brk[j] or iters[j] >= budget[j])
            late = (req.deadline is not None
                    and now - req.t_submit > req.deadline)
            if not (finished or late):
                continue
            # typed retirement status: a guarded block carries the
            # in-reduction code; an unguarded one the coarse class;
            # DEADLINE trumps either
            if guarded and finished \
                    and status_arr[j] != SolveStatus.RUNNING.value:
                sts = SolveStatus(int(status_arr[j]))
            elif conv[j]:
                sts = SolveStatus.CONVERGED
            elif brk[j]:
                sts = SolveStatus.BREAKDOWN
            else:
                sts = SolveStatus.MAXITER
            expired = late and not finished
            if expired:
                sts = SolveStatus.DEADLINE
            blk.slots[j] = None
            if expired or sts == SolveStatus.NONFINITE \
                    or not np.isfinite(relres[j]):
                blk.orphans.add(j)       # freeze or scrub before reuse
            # failed requests re-enqueue with capped exponential backoff
            # (stable rid); no result for this attempt
            if recovery is not None and sts.is_failure \
                    and sts != SolveStatus.DEADLINE \
                    and req.retries < recovery.max_retries and not late:
                req.retries += 1
                back = 0.0
                if recovery.retry_backoff_s:
                    back = min(
                        recovery.retry_backoff_s * 2 ** (req.retries - 1),
                        recovery.retry_backoff_cap_s)
                req.not_before = now + back
                q.append(req)
                _metrics.ENGINE_RETRIES.inc()
                continue
            retiring.append((j, req, sts, expired))

        results: List[RequestResult] = []
        if retiring:
            cols = torch.tensor([j for j, *_ in retiring],
                                device=st["x"].device)
            x_host = st["x"].index_select(1, cols).t().contiguous() \
                .cpu().numpy()
            self.stats["x_reads"] += 1
        for c, (j, req, sts, expired) in enumerate(retiring):
            xj = x_host[c]
            if not np.isfinite(xj).all():
                # a poisoned column never hands NaN back to the caller
                # (the typed status says why)
                xj = np.where(np.isfinite(xj), xj, 0.0)
            rr_j = float(relres[j])
            # the column of the block's ring: a refilled column's earlier
            # rows were NaN'd by its splice, which per_iteration() drops
            trace = None if ring is None else ConvergenceTrace(
                np.ascontiguousarray(ring[:, :, j]), ring_steps)
            res = RequestResult(
                rid=req.rid, operator=name, x=xj,
                iterations=int(iters[j]),
                relres=rr_j if np.isfinite(rr_j) else float("inf"),
                converged=bool(conv[j]), breakdown=bool(brk[j]),
                telemetry=RequestTelemetry(
                    queue_wait_s=req.t_start - req.t_submit,
                    service_s=now - req.t_start,
                    wall_s=now - req.t_submit,
                    chunks_resident=req.chunks_resident,
                    deadline_exceeded=expired),
                status=sts, retries=req.retries, trace=trace)
            self._observe_result(res)
            results.append(res)

        # 3) drop a drained block (frozen orphans die with it)
        if not blk.live() and not q:
            self._blocks[name] = None
        return results


def _np_dtype(dtype: torch.dtype) -> np.dtype:
    return torch.empty((), dtype=dtype).numpy().dtype
