"""Process-local metrics registry with Prometheus + JSON export (PyTorch
port's own copy of ``repro.observe.metrics``, which imports no JAX).

Counters, gauges and histograms keyed by (name, label values), held in
one :class:`MetricsRegistry` (:data:`REGISTRY` is the process default).
No daemon, no HTTP server, no dependency: :func:`prometheus` renders
the standard text exposition format (scrape it, or dump it to a file —
the CI smoke job does), :func:`snapshot` a JSON-able dict.

Hot-path discipline: instruments are plain python dict updates under a
lock — never a device read.  In the port only the solve engine
(:mod:`repro_torch.service.engine`) records into them, at its chunk
boundaries, where the host already holds the flags it read, so
observability adds zero synchronizations.

The pre-declared instruments at the bottom are the stack's vocabulary
(the JAX package's names); layers import them directly (``from
repro_torch.observe.metrics import ENGINE_CHUNK_SECONDS``).
"""
from __future__ import annotations

import math
import threading
from typing import Any, Dict, Iterable, Optional, Sequence, Tuple


class _Instrument:
    """Base: one named metric family with fixed label names."""

    kind = "untyped"

    def __init__(self, name: str, help: str, labels: Sequence[str] = ()):
        self.name = name
        self.help = help
        self.labels = tuple(labels)
        self._lock = threading.Lock()

    def _key(self, labels: Dict[str, Any]) -> Tuple[str, ...]:
        if set(labels) != set(self.labels):
            raise ValueError(
                f"{self.name}: expected labels {self.labels}, "
                f"got {tuple(labels)}")
        return tuple(str(labels[k]) for k in self.labels)

    def _label_str(self, key: Tuple[str, ...]) -> str:
        if not key:
            return ""
        inner = ",".join(f'{n}="{v}"' for n, v in zip(self.labels, key))
        return "{" + inner + "}"


class Counter(_Instrument):
    """Monotonic counter: ``inc()`` only."""

    kind = "counter"

    def __init__(self, name, help, labels=()):
        super().__init__(name, help, labels)
        self._values: Dict[Tuple[str, ...], float] = {}

    def inc(self, value: float = 1.0, **labels) -> None:
        if value < 0:
            raise ValueError("counters only go up")
        key = self._key(labels)
        with self._lock:
            self._values[key] = self._values.get(key, 0.0) + value

    def value(self, **labels) -> float:
        with self._lock:
            return self._values.get(self._key(labels), 0.0)

    def _reset(self):
        with self._lock:
            self._values.clear()

    def _expose(self) -> Iterable[str]:
        with self._lock:
            for key, v in sorted(self._values.items()):
                yield f"{self.name}{self._label_str(key)} {_fmt(v)}"

    def _snapshot(self):
        with self._lock:
            return [{"labels": dict(zip(self.labels, k)), "value": v}
                    for k, v in sorted(self._values.items())]


class Gauge(_Instrument):
    """Point-in-time value: ``set()`` / ``inc()`` / ``dec()``."""

    kind = "gauge"

    def __init__(self, name, help, labels=()):
        super().__init__(name, help, labels)
        self._values: Dict[Tuple[str, ...], float] = {}

    def set(self, value: float, **labels) -> None:
        key = self._key(labels)
        with self._lock:
            self._values[key] = float(value)

    def inc(self, value: float = 1.0, **labels) -> None:
        key = self._key(labels)
        with self._lock:
            self._values[key] = self._values.get(key, 0.0) + value

    def dec(self, value: float = 1.0, **labels) -> None:
        self.inc(-value, **labels)

    def value(self, **labels) -> float:
        with self._lock:
            return self._values.get(self._key(labels), 0.0)

    _reset = Counter._reset
    _expose = Counter._expose
    _snapshot = Counter._snapshot


#: Default histogram buckets: spans ~100 µs dispatches to ~10 s solves.
DEFAULT_BUCKETS = (1e-4, 5e-4, 1e-3, 5e-3, 0.01, 0.05, 0.1, 0.5, 1.0,
                   5.0, 10.0)

#: Iteration-count buckets (for ``repro_solve_iterations`` & co.).
ITERATION_BUCKETS = (1., 2., 5., 10., 25., 50., 100., 250., 500., 1000.,
                     2500., 5000., 10000.)


class Histogram(_Instrument):
    """Cumulative-bucket histogram (Prometheus semantics)."""

    kind = "histogram"

    def __init__(self, name, help, labels=(),
                 buckets: Sequence[float] = DEFAULT_BUCKETS):
        super().__init__(name, help, labels)
        self.buckets = tuple(sorted(float(b) for b in buckets))
        self._counts: Dict[Tuple[str, ...], list] = {}
        self._sum: Dict[Tuple[str, ...], float] = {}
        self._n: Dict[Tuple[str, ...], int] = {}

    def observe(self, value: float, **labels) -> None:
        value = float(value)
        key = self._key(labels)
        with self._lock:
            counts = self._counts.setdefault(key, [0] * len(self.buckets))
            for i, b in enumerate(self.buckets):
                if value <= b:
                    counts[i] += 1
            self._sum[key] = self._sum.get(key, 0.0) + value
            self._n[key] = self._n.get(key, 0) + 1

    def count(self, **labels) -> int:
        with self._lock:
            return self._n.get(self._key(labels), 0)

    def sum(self, **labels) -> float:
        with self._lock:
            return self._sum.get(self._key(labels), 0.0)

    def _reset(self):
        with self._lock:
            self._counts.clear()
            self._sum.clear()
            self._n.clear()

    def _expose(self) -> Iterable[str]:
        with self._lock:
            for key in sorted(self._n):
                base = list(zip(self.labels, key))
                for b, c in zip(self.buckets, self._counts[key]):
                    lab = ",".join(f'{n}="{v}"' for n, v in
                                   base + [("le", _fmt(b))])
                    yield f"{self.name}_bucket{{{lab}}} {c}"
                lab_inf = ",".join(f'{n}="{v}"' for n, v in
                                   base + [("le", "+Inf")])
                yield f"{self.name}_bucket{{{lab_inf}}} {self._n[key]}"
                ls = self._label_str(key)
                yield f"{self.name}_sum{ls} {_fmt(self._sum[key])}"
                yield f"{self.name}_count{ls} {self._n[key]}"

    def _snapshot(self):
        with self._lock:
            return [{"labels": dict(zip(self.labels, k)),
                     "count": self._n[k], "sum": self._sum[k],
                     "buckets": dict(zip(map(_fmt, self.buckets),
                                         self._counts[k]))}
                    for k in sorted(self._n)]


def _fmt(v: float) -> str:
    if v == math.inf:
        return "+Inf"
    if float(v).is_integer() and abs(v) < 1e15:
        return str(int(v))
    return repr(float(v))


class MetricsRegistry:
    """Named instrument table; get-or-create semantics.

    ``counter``/``gauge``/``histogram`` return the existing instrument
    when the name is already registered (kind mismatches are loud), so
    modules can declare their instruments idempotently.  ``reset()``
    zeroes every value but keeps the instruments — the test/benchmark
    affordance.
    """

    def __init__(self):
        self._instruments: Dict[str, _Instrument] = {}
        self._lock = threading.Lock()

    def _get(self, cls, name, help, labels, **kw) -> Any:
        with self._lock:
            inst = self._instruments.get(name)
            if inst is not None:
                if not isinstance(inst, cls):
                    raise ValueError(
                        f"metric {name!r} already registered as "
                        f"{inst.kind}, not {cls.kind}")
                return inst
            inst = cls(name, help, labels, **kw)
            self._instruments[name] = inst
            return inst

    def counter(self, name, help="", labels=()) -> Counter:
        return self._get(Counter, name, help, labels)

    def gauge(self, name, help="", labels=()) -> Gauge:
        return self._get(Gauge, name, help, labels)

    def histogram(self, name, help="", labels=(),
                  buckets: Sequence[float] = DEFAULT_BUCKETS) -> Histogram:
        return self._get(Histogram, name, help, labels, buckets=buckets)

    def get(self, name: str) -> Optional[_Instrument]:
        with self._lock:
            return self._instruments.get(name)

    def reset(self) -> None:
        with self._lock:
            insts = list(self._instruments.values())
        for inst in insts:
            inst._reset()

    # -- export -----------------------------------------------------------
    def prometheus(self) -> str:
        """The standard text exposition format."""
        lines = []
        with self._lock:
            insts = sorted(self._instruments.values(),
                           key=lambda i: i.name)
        for inst in insts:
            lines.append(f"# HELP {inst.name} {inst.help}")
            lines.append(f"# TYPE {inst.name} {inst.kind}")
            lines.extend(inst._expose())
        return "\n".join(lines) + "\n"

    def snapshot(self) -> Dict[str, Any]:
        """JSON-able ``{name: {kind, help, values}}`` dict."""
        with self._lock:
            insts = sorted(self._instruments.values(),
                           key=lambda i: i.name)
        return {inst.name: {"kind": inst.kind, "help": inst.help,
                            "values": inst._snapshot()}
                for inst in insts}


#: The process-default registry every instrumented layer records into.
REGISTRY = MetricsRegistry()


def prometheus() -> str:
    return REGISTRY.prometheus()


def snapshot() -> Dict[str, Any]:
    return REGISTRY.snapshot()


# ---------------------------------------------------------------------------
# the stack's instrument vocabulary
# ---------------------------------------------------------------------------

#: Solver-session entry points served (labels never read device values
#: — outcome-by-status lives on the engine/guarded instruments, where
#: the host already holds the flags).
SOLVES = REGISTRY.counter(
    "repro_solves_total", "solver-session entry points served",
    labels=("method", "substrate", "entry"))
SESSION_CACHE = REGISTRY.counter(
    "repro_session_cache_total",
    "content-keyed session cache lookups by outcome (hit|miss)",
    labels=("outcome",))
PROGRAM_TRACES = REGISTRY.counter(
    "repro_program_traces_total",
    "program builds of session programs (the amortization metric)")
SOLVE_ITERATIONS = REGISTRY.histogram(
    "repro_solve_iterations",
    "iterations to retirement, per request/column (recorded where the "
    "host already reads the flags)", buckets=ITERATION_BUCKETS)

ENGINE_REQUESTS = REGISTRY.counter(
    "repro_engine_requests_total",
    "requests retired by the solve engine, by typed SolveStatus",
    labels=("status",))
ENGINE_RETRIES = REGISTRY.counter(
    "repro_engine_retries_total",
    "failed requests re-enqueued by the recovery policy")
ENGINE_QUEUE_DEPTH = REGISTRY.gauge(
    "repro_engine_queue_depth", "queued requests per operator",
    labels=("operator",))
ENGINE_SLOT_OCCUPANCY = REGISTRY.gauge(
    "repro_engine_slot_occupancy",
    "live request slots in the resident block, per operator",
    labels=("operator",))
ENGINE_CHUNK_SECONDS = REGISTRY.histogram(
    "repro_engine_chunk_seconds",
    "wall time of one engine chunk (dispatch + retirement read)")
REQUEST_QUEUE_WAIT = REGISTRY.histogram(
    "repro_request_queue_wait_seconds",
    "submit -> first resident in the block")
REQUEST_WALL = REGISTRY.histogram(
    "repro_request_wall_seconds", "submit -> retirement")
REQUEST_CHUNKS = REGISTRY.histogram(
    "repro_request_chunks_resident",
    "engine chunks a request stayed resident",
    buckets=(1., 2., 3., 5., 8., 13., 21., 34., 55., 89.))

RECOVERY_ACTIONS = REGISTRY.counter(
    "repro_recovery_actions_total",
    "guarded-solve recovery actions fired, by action",
    labels=("action",))
