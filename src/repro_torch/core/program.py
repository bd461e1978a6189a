"""Programs: a chunk of solver steps captured once as a CUDA graph and
replayed, the port's counterpart of ``jax.jit`` of the JAX package's
``while_loop`` body.

PyTorch runs eagerly, so a solver step dispatched from Python pays the
host's launch cost for each of its 60-170 kernels, and the card waits.  A
:class:`Program` holds one loop body (``step(state, consts, replace) ->
state``) and runs it a chunk at a time:

* on a CUDA device it keeps the state in buffers of its own (fixed
  addresses), and captures each distinct chunk, a tuple of ``replace``
  flags, one per step (the -rr replacement steps the host picked), as one
  CUDA graph whose last nodes copy the chunk's result back into those
  buffers; a chunk is then one ``replay``;
* on the CPU it is the eager chunk: the steps run one after another on the
  state as it was given, as a kernel's plain version is its CPU path.

A capture is preceded by a warm-up: the chunk runs once, eagerly, on a
scratch copy of the buffers, on the stream the capture then uses.  It
builds and loads the kernel library, runs each launcher's first-launch
set-up and readies PyTorch's own lazy state, none of which may happen
under capture.  The capture itself runs with Python's cyclic garbage
collector held off (:func:`_collector_held`).  The warm-up's launches and
the capture's recorded ones are taken back out of
:data:`repro_torch.kernels.ops.LAUNCHES` when the build ends, and every
replay adds what its capture recorded: the counters read as they would for
the eager chunk.  The same holds for the ``counters`` a
program is given (objects with a ``calls`` count, such as the
:class:`~repro_torch.core._common.SyncCounter` of a mesh session's
reductions).

The warm-up, the capture and that bookkeeping are :func:`capture`, which
the serving engine's decode program shares
(:class:`repro_torch.serve.engine.DecodeProgram`).  A capture that fails
(a step that reads the device from the host, such as a matvec calling
``.item()``) raises, naming the program's key.  A program
never falls back to the eager chunk on a CUDA device: only
:func:`_eager_chunks`, an internal switch, makes it run eagerly there: the
graph-against-eager check of the tests and ``chip_smoke.py``, and the
Newton-Krylov step's inner solve, whose matvec is a pass through a model
(:mod:`repro_torch.optim.newton_krylov` says why).

:meth:`Program.read` hands out copies of the buffers, so a state that was
returned stays as it was whatever the program replays later; a state
handed back unchanged is not copied in again (:meth:`Program.load`).

A schedule's entries are what the step receives as its third argument:
``replace`` flags for the single-RHS loops, and for the batched loop also
:data:`repro_torch.core.multirhs.SPLICE`, the refill of a masked set of
columns from constant buffers, so that a chunk that admits fresh
right-hand sides is one replay as a chunk without.

A program knows the card memory it holds (:attr:`Program.nbytes`): its
buffers exactly, and its graph pool as the rise of
``torch.cuda.memory_reserved()`` across each capture.  :meth:`Program
.release` drops its graphs, pool and buffers (the session cache's byte
budget calls it); the program rebuilds them on its next load.
"""
from __future__ import annotations

import contextlib
import gc
import weakref
from typing import Callable, Dict, Hashable, Optional, Sequence, Tuple

import torch

from ..kernels._build import LAUNCHES
from ._common import phase

#: a chunk: one ``replace`` flag per step
Schedule = Tuple[bool, ...]

_EAGER = [False]
_SIDE_STREAMS: Dict[torch.device, "torch.cuda.Stream"] = {}


@contextlib.contextmanager
def _collector_held():
    """Python's cyclic garbage collector held off for the length of a
    capture (ROADMAP C17).  A session bound to a mesh and its binding
    refer to each other, so a dropped one is left to the collector, which
    may run at any allocation, a capture's too, and ``torch.cuda.graph``
    no longer collects before a capture.  On the card a capture with a
    collector run inside it failed ("operation failed due to a previous
    error during capture"): ``tools/capture_mode_probe.py`` counts 4 of 42
    fresh sessions failed under the "global" and the "thread_local" error
    modes, each failure with one collector run inside a capture, and 0 of
    42 with the collector held.  Which CUDA call of the freed objects
    invalidates the capture is not known."""
    was = gc.isenabled()
    gc.disable()
    try:
        yield
    finally:
        if was:
            gc.enable()


@contextlib.contextmanager
def _eager_chunks():
    """Run every program's chunks eagerly, on a CUDA device too (the
    graph-against-eager check of the tests and ``chip_smoke.py``; the
    Newton-Krylov step's inner solve)."""
    prev, _EAGER[0] = _EAGER[0], True
    try:
        yield
    finally:
        _EAGER[0] = prev


def _side_stream(device: torch.device) -> "torch.cuda.Stream":
    """The stream warm-ups and captures run on (one per device)."""
    if device not in _SIDE_STREAMS:
        _SIDE_STREAMS[device] = torch.cuda.Stream(device)
    return _SIDE_STREAMS[device]


def _nbytes(tensors: dict) -> int:
    return sum(t.numel() * t.element_size() for t in tensors.values())


class Program:
    """One loop body, run a chunk at a time (see the module's docstring).

    ``step(state, consts, replace)`` returns the next state, a dict of
    tensors with the same keys, shapes and types; ``consts`` are the
    per-solve tensors the body reads but never changes (``norm_r0``,
    ``tol``, the shadow residual, -rr's ``b``; a splice's mask, block and
    budgets).  ``stats``, when given, counts the graphs captured under
    ``"graphs"`` and the chunks run under ``"runs"`` (on the card, graph
    replays).  ``counters``: objects whose ``calls`` the steps count; a
    replay adds what its capture counted.
    """

    #: the state's fields a step writes in place (the residual history and
    #: the iteration-trace ring): the eager chunk works on a copy of them,
    #: so the caller's state is left as it was
    INPLACE = ("hist", "trace")

    def __init__(self, step: Callable[[dict, dict, bool], dict], device,
                 key: Hashable = None, *,
                 stats: Optional[Dict[str, int]] = None,
                 counters: Sequence = ()):
        self.step = step
        self.counters = tuple(counters)
        self.device = torch.device(device)
        self.key = key
        self.stats = stats
        #: schedule -> (CUDA graph, launches one replay makes, the calls
        #: one replay adds to each of ``counters``)
        self.graphs: Dict[Schedule, Tuple["torch.cuda.CUDAGraph",
                                          Dict[str, int],
                                          Tuple[int, ...]]] = {}
        self.state: Dict[str, torch.Tensor] = {}
        self.consts: Dict[str, torch.Tensor] = {}
        self._buffers: Dict[str, torch.Tensor] = {}
        self._const_buffers: Dict[str, torch.Tensor] = {}
        self._handed: Dict[str, tuple] = {}
        self._pool = None
        self._pool_bytes = 0
        self._eager_bytes = 0
        self._graphed = False

    @property
    def nbytes(self) -> int:
        """The memory the program holds: its state and constant buffers,
        and on the card its graphs' pool.  The eager chunk (the CPU) keeps
        no buffers of its own: it counts the state and constants it was
        last loaded with, what its buffers would hold."""
        if self.device.type != "cuda":
            return self._eager_bytes
        return _nbytes(self._buffers) + _nbytes(self._const_buffers) \
            + self._pool_bytes

    def release(self) -> None:
        """Drop the graphs, their pool and the buffers; the next
        :meth:`load` allocates them again and the next chunks capture
        again."""
        self.graphs.clear()
        self._pool = None
        self._pool_bytes = self._eager_bytes = 0
        self._buffers.clear()
        self._const_buffers.clear()
        self.state, self.consts, self._handed = {}, {}, {}

    # -- the state ------------------------------------------------------------

    def load(self, state: dict, consts: Optional[dict] = None) -> None:
        """Start from ``state`` (with ``consts``; ``None`` keeps the
        constants loaded last); the caller's tensors are never written.
        A constant may lie on the host: it is copied to the device once,
        into its buffer on the card."""
        self._graphed = self.device.type == "cuda" and not _EAGER[0]
        if not self._graphed:
            self.state = {k: v.clone() if k in self.INPLACE else v
                          for k, v in state.items()}
            if consts is not None:
                self.consts = {k: v.to(self.device)
                               for k, v in consts.items()}
            self._eager_bytes = _nbytes(state) + _nbytes(self.consts)
            return
        handed, self._handed = self._handed, {}
        self.state = self._fill(self._buffers, state, handed)
        if consts is not None:
            self.consts = self._fill(self._const_buffers, consts, {})

    def _fill(self, bufs: dict, src: dict, handed: dict) -> dict:
        """Copy ``src`` into ``bufs``.  Once a graph is captured, its
        buffers keep their addresses: the state must keep its fields,
        shapes and types; a constant no graph read yet may be added."""
        is_state = bufs is self._buffers
        if bufs.keys() != src.keys():
            if self.graphs and is_state:
                raise ValueError(f"program {self.key!r}: state fields "
                                 f"{sorted(src)}, not {sorted(bufs)}")
            if not self.graphs:
                bufs.clear()
        for k, v in src.items():
            buf = bufs.get(k)
            if buf is None or buf.shape != v.shape or buf.dtype != v.dtype:
                if self.graphs and buf is not None:
                    raise ValueError(
                        f"program {self.key!r}: {k} is {tuple(v.shape)} "
                        f"{v.dtype}, its captured buffer "
                        f"{tuple(buf.shape)} {buf.dtype}")
                buf = bufs[k] = torch.empty(v.shape, dtype=v.dtype,
                                            device=self.device)
            elif k in handed and handed[k][0]() is v \
                    and handed[k][1] == v._version:
                continue        # what read() returned, unchanged since
            buf.copy_(v)
        return bufs

    def read(self) -> dict:
        """The current state as tensors the program never writes again."""
        if not self._graphed:
            out, self.state = self.state, {}
            return out
        out = {k: v.clone() for k, v in self._buffers.items()}
        self._handed = {k: (weakref.ref(v), v._version)
                        for k, v in out.items()}
        return out

    # -- chunks ---------------------------------------------------------------

    def run(self, schedule: Schedule) -> None:
        """Advance the state by ``len(schedule)`` steps."""
        if not self._graphed:
            self.state = self._steps(self.state, schedule)
            if self.stats is not None:
                self.stats["runs"] = self.stats.get("runs", 0) + 1
            return
        self._handed = {}
        if self.stats is not None:
            self.stats["runs"] = self.stats.get("runs", 0) + 1
        entry = self.graphs.get(schedule)
        if entry is None:
            entry = self.graphs[schedule] = self._capture(schedule)
            if self.stats is not None:
                self.stats["graphs"] = self.stats.get("graphs", 0) + 1
        graph, launches, calls = entry
        graph.replay()
        for name, count in launches.items():
            LAUNCHES[name] += count
        for counter, count in zip(self.counters, calls):
            counter.calls += count

    def _steps(self, state: dict, schedule: Schedule) -> dict:
        for replace in schedule:
            with phase("repro.step"):
                state = self.step(state, self.consts, replace)
        return state

    def _write_back(self, out: dict) -> None:
        """Copy a chunk's result into the buffers (the graph's last nodes);
        a result that is another field's buffer is copied first, since
        that buffer may be overwritten before it is read."""
        bufs = self._buffers
        if out.keys() != bufs.keys():
            raise ValueError(f"program {self.key!r}: the step returned "
                             f"{sorted(out)}, not {sorted(bufs)}")
        owner = {b.data_ptr(): k for k, b in bufs.items() if b.numel()}
        srcs = {}
        for k, v in out.items():
            if v is bufs[k]:
                continue
            if v.shape != bufs[k].shape or v.dtype != bufs[k].dtype:
                raise ValueError(
                    f"program {self.key!r}: the step turned {k} into "
                    f"{tuple(v.shape)} {v.dtype}")
            if v.numel() and owner.get(v.data_ptr(), k) != k:
                v = v.clone()
            srcs[k] = v
        for k, v in srcs.items():
            bufs[k].copy_(v)

    def _capture(self, schedule: Schedule):
        if self._pool is None:
            self._pool = torch.cuda.graph_pool_handle()

        def warm_up():
            self._steps({k: v.clone() for k, v in self._buffers.items()},
                        schedule)

        graph, launches, calls, grown = capture(
            f"program {self.key!r} (a chunk of {len(schedule)} steps)",
            self.device, self._pool, warm_up,
            lambda: self._write_back(self._steps(dict(self._buffers),
                                                 schedule)),
            self.counters)
        self._pool_bytes += grown
        return graph, launches, calls


def capture(what: str, device: torch.device, pool, warm_up: Callable[[], None],
            body: Callable[[], None], counters: Sequence = ()):
    """``body()`` captured as one CUDA graph in ``pool``, after one eager
    ``warm_up()`` (which must leave the buffers ``body`` reads as they
    were), both on the device's side stream; the capture with the cyclic
    collector held off.  Returns ``(graph, the launches one replay makes,
    the calls one replay adds to each of counters, the bytes the pool
    grew by)``; :data:`LAUNCHES` and the counters read afterwards as they
    did before.  A failure raises, naming ``what``."""
    before = dict(LAUNCHES)
    calls_before = [c.calls for c in counters]
    side = _side_stream(device)
    cur = torch.cuda.current_stream(device)
    try:
        side.wait_stream(cur)
        with torch.cuda.stream(side):
            warm_up()
        cur.wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        warm = dict(LAUNCHES)
        calls_warm = [c.calls for c in counters]
        # entering a capture empties the allocator's cache anyway; done
        # first, what the capture reserves is its pool's growth
        torch.cuda.empty_cache()
        reserved = torch.cuda.memory_reserved(device)
        with _collector_held(), torch.cuda.graph(graph, pool=pool,
                                                 stream=side):
            body()
        grown = max(0, torch.cuda.memory_reserved(device) - reserved)
        launches = {k: LAUNCHES[k] - warm[k] for k in LAUNCHES
                    if LAUNCHES[k] != warm[k]}
        calls = tuple(c.calls - w for c, w in zip(counters, calls_warm))
    except Exception as exc:
        raise RuntimeError(
            f"capturing {what} as a CUDA graph failed: {exc}") from exc
    finally:
        LAUNCHES.update(before)
        for c, n in zip(counters, calls_before):
            c.calls = n
    return graph, launches, calls, grown
