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
under capture.  The warm-up's launches and the capture's recorded ones are
taken back out of :data:`repro_torch.kernels.ops.LAUNCHES` when the build
ends, and every replay adds what its capture recorded: the counters read as
they would for the eager chunk.

A capture that fails (a step that reads the device from the host, such as
a matvec calling ``.item()``) raises, naming the program's key.  A program
never falls back to the eager chunk on a CUDA device: only
:func:`_eager_chunks`, an internal switch for the graph-against-eager check,
makes it run eagerly there.

:meth:`Program.read` hands out copies of the buffers, so a state that was
returned stays as it was whatever the program replays later; a state
handed back unchanged is not copied in again (:meth:`Program.load`).
"""
from __future__ import annotations

import contextlib
import weakref
from typing import Callable, Dict, Hashable, Optional, Tuple

import torch

from ..kernels._build import LAUNCHES

#: a chunk: one ``replace`` flag per step
Schedule = Tuple[bool, ...]

_EAGER = [False]
_SIDE_STREAMS: Dict[torch.device, "torch.cuda.Stream"] = {}


@contextlib.contextmanager
def _eager_chunks():
    """Run every program's chunks eagerly, on a CUDA device too (the
    graph-against-eager check of the tests and ``chip_smoke.py``)."""
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


class Program:
    """One loop body, run a chunk at a time (see the module's docstring).

    ``step(state, consts, replace)`` returns the next state, a dict of
    tensors with the same keys, shapes and types; ``consts`` are the
    per-solve tensors the body reads but never changes (``norm_r0``, the
    shadow residual, -rr's ``b``).  ``stats``, when given, counts the
    graphs captured under ``"graphs"``.
    """

    #: the state's fields a step writes in place (the residual history):
    #: the eager chunk works on a copy of them, so the caller's state is
    #: left as it was
    INPLACE = ("hist",)

    def __init__(self, step: Callable[[dict, dict, bool], dict], device,
                 key: Hashable = None, *,
                 stats: Optional[Dict[str, int]] = None):
        self.step = step
        self.device = torch.device(device)
        self.key = key
        self.stats = stats
        #: schedule -> (CUDA graph, launches one replay makes)
        self.graphs: Dict[Schedule, Tuple["torch.cuda.CUDAGraph",
                                          Dict[str, int]]] = {}
        self.state: Dict[str, torch.Tensor] = {}
        self.consts: Dict[str, torch.Tensor] = {}
        self._buffers: Dict[str, torch.Tensor] = {}
        self._const_buffers: Dict[str, torch.Tensor] = {}
        self._handed: Dict[str, tuple] = {}
        self._pool = None
        self._graphed = False

    # -- the state ------------------------------------------------------------

    def load(self, state: dict, consts: Optional[dict] = None) -> None:
        """Start from ``state`` (with ``consts``); the caller's tensors are
        never written."""
        consts = {} if consts is None else consts
        self._graphed = self.device.type == "cuda" and not _EAGER[0]
        if not self._graphed:
            self.state = {k: v.clone() if k in self.INPLACE else v
                          for k, v in state.items()}
            self.consts = dict(consts)
            return
        handed, self._handed = self._handed, {}
        self.state = self._fill(self._buffers, state, handed)
        self.consts = self._fill(self._const_buffers, consts, {})

    def _fill(self, bufs: dict, src: dict, handed: dict) -> dict:
        if bufs.keys() != src.keys():
            if self.graphs:
                raise ValueError(f"program {self.key!r}: state fields "
                                 f"{sorted(src)}, not {sorted(bufs)}")
            bufs.clear()
        for k, v in src.items():
            buf = bufs.get(k)
            if buf is None or buf.shape != v.shape or buf.dtype != v.dtype:
                if self.graphs:
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
            return
        self._handed = {}
        entry = self.graphs.get(schedule)
        if entry is None:
            entry = self.graphs[schedule] = self._capture(schedule)
            if self.stats is not None:
                self.stats["graphs"] = self.stats.get("graphs", 0) + 1
        graph, launches = entry
        graph.replay()
        for name, count in launches.items():
            LAUNCHES[name] += count

    def _steps(self, state: dict, schedule: Schedule) -> dict:
        for replace in schedule:
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
        before = dict(LAUNCHES)
        side = _side_stream(self.device)
        cur = torch.cuda.current_stream(self.device)
        try:
            side.wait_stream(cur)
            with torch.cuda.stream(side):
                scratch = {k: v.clone() for k, v in self._buffers.items()}
                self._steps(scratch, schedule)              # the warm-up
                del scratch
            cur.wait_stream(side)
            if self._pool is None:
                self._pool = torch.cuda.graph_pool_handle()
            graph = torch.cuda.CUDAGraph()
            warm = dict(LAUNCHES)
            with torch.cuda.graph(graph, pool=self._pool, stream=side):
                self._write_back(self._steps(dict(self._buffers), schedule))
            launches = {k: LAUNCHES[k] - warm[k] for k in LAUNCHES
                        if LAUNCHES[k] != warm[k]}
        except Exception as exc:
            raise RuntimeError(
                f"capturing program {self.key!r} (a chunk of "
                f"{len(schedule)} steps) as a CUDA graph failed: {exc}"
            ) from exc
        finally:
            LAUNCHES.update(before)
        return graph, launches
