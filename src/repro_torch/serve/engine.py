"""Batched serving engine: prefill, then greedy decode (PyTorch port of
``repro.serve.engine``).

Requests are grouped into batches of equal prompt length (length buckets)
and left-padded, so positions and caches are exact without ragged masks.
A batch runs one prefill, eagerly (the flash kernel under
``cfg.use_flash_kernel``), then one decode step per new token for all its
slots; a slot that reached its ``max_new_tokens`` or ``eos_id`` is
skipped.

The decode steps run through a :class:`DecodeProgram`, one per batch size
B, the counterpart of the JAX engine's one compiled decode program: the
``(L, B, max_len, K, hd)`` cache, the ``(B, 1)`` tokens and the 0-d
``cache_len`` live in buffers at fixed addresses.  A batch's prefill K/V
are spliced into that cache in place, the rows from the prompt's length on
zeroed (the JAX splice's zero padding).  On the card a step is one replay
of a CUDA graph captured on the program's first batch
(:func:`repro_torch.core.program.capture`): the decode, the argmax written
into the tokens buffer and ``cache_len + 1``.  The host reads the device
once per step: the B next tokens, in one copy.  On the CPU and under
:func:`~repro_torch.core.program._eager_chunks` the same step runs eagerly
on the same buffers; a failed capture raises.  Every family's step
captures: the MLA latent cache ``{"ckv", "krope"}`` is spliced and written
in place as the K/V cache is, the MoE sort dispatch reads nothing to
the host (its grouped product takes the offsets on the device), and the
hybrid family's SSM state is spliced whole and overwritten in place, its
rings (``min(max_len, sliding_window)`` rows) rolled on the device once
full; the SSM family's (xLSTM) cache is its state alone, spliced whole and
overwritten in place, so its batches take any number of new tokens.  The
audio family (whisper) prefills on all-zero frames of the prompt's length
(``(B, plen, d)``, as the JAX engine builds them), so its cross K/V hold
``plen`` rows; the program's cross buffers hold ``max_len`` rows, and a
0-d device ``enc_len`` (set at each splice) masks the rows past the
batch's to ``NEG_INF`` in the cross softmax, an exact zero weight: one
program serves every prompt length, and no zero-padded row weighs in (the
JAX engine sizes its cross K/V to each batch's ``plen``).  The VLM
family (qwen2-vl) prefills on ``prefill_step``'s default positions, t = h
= w = ``arange(plen)``: the text positions the JAX engine passes (M-RoPE
then equals RoPE); it decodes as the dense family, each step's position
``cache_len`` on all three streams.
Everything runs under ``torch.inference_mode()``.

``stats``: the wall time of each prefill (``prefill_s``, the splice
included) and of each decode step (``decode_s``: each ends in the host
read, so it is the device's time as the host sees it; a capture is not in
it), the graphs captured (``decode_graphs``) and the seconds they took,
warm-ups included (``capture_s``), and ``decode_program``: ``"graph"`` or
``"eager: <reason>"``, as :func:`decode_program_mode` chose for the last
batch.
"""
from __future__ import annotations

import dataclasses
import time
from collections import deque
from typing import Dict, List, Optional

import numpy as np
import torch

from repro_torch.core import program as _program
from repro_torch.core.types import resolve_device
from repro_torch.kernels._build import LAUNCHES
from repro_torch.models import (ModelConfig, Transformer, decode_step,
                                init_cache, init_params, prefill_step)
from repro_torch.models.transformer import (CROSS, DEC_POSITIONS, RINGS,
                                            cache_rows, state_entries)


@dataclasses.dataclass
class Request:
    prompt: List[int]
    max_new_tokens: int = 16
    temperature: float = 0.0
    rid: int = 0
    # filled by the engine:
    output: Optional[List[int]] = None


@dataclasses.dataclass(frozen=True)
class ServeConfig:
    max_batch: int = 4
    max_len: int = 256
    eos_id: int = -1          # -1: never stop early
    seed: int = 0


def decode_program_mode(cfg: ModelConfig, device) -> str:
    """How the engine runs ``cfg``'s decode steps on ``device``:
    ``"graph"`` (one CUDA-graph replay a step) or ``"eager: <reason>"``."""
    if torch.device(device).type != "cuda":
        return "eager: on the CPU each step runs as it comes"
    if _program._EAGER[0]:
        return "eager: under _eager_chunks (the graph-against-eager check)"
    return "graph"


class DecodeProgram:
    """The decode step of one batch size (see the module's docstring).
    :meth:`start` splices a batch's prefill into the buffers; :meth:`step`
    (after :meth:`capture` when graphed) advances the batch by one token
    and returns the tokens buffer, ``(B, 1)``, then holding the next
    tokens; ``logits`` is the last step's ``(B, 1, V)``.  The buffers are
    written in place: nothing is copied per step.  An audio program's
    cross K/V have ``max_len`` rows, of which ``enc_len`` (0-d, on the
    device) hold the batch's."""

    def __init__(self, params: Transformer, cfg: ModelConfig, batch: int,
                 max_len: int, device):
        self.params, self.cfg = params, cfg
        self.device = torch.device(device)
        self.key = ("decode", cfg.name, batch, max_len)
        self.cache = init_cache(cfg, batch, max_len, enc_len=max_len,
                                device=self.device)
        self.tokens = torch.zeros((batch, 1), dtype=torch.int64,
                                  device=self.device)
        self.cache_len = torch.zeros((), dtype=torch.int64,
                                     device=self.device)
        self.enc_len = torch.zeros((), dtype=torch.int64,
                                   device=self.device) \
            if CROSS[0] in self.cache else None
        self.logits: Optional[torch.Tensor] = None
        self.graphed = False
        self.graph = None
        #: the launches of the port's kernels one replay makes
        self.launches: Dict[str, int] = {}
        #: the rise of the card's reserved memory across the capture
        self.pool_bytes = 0

    @property
    def nbytes(self) -> int:
        """The cache's bytes and the graph pool's."""
        return sum(t.numel() * t.element_size()
                   for t in self.cache.values()) + self.pool_bytes

    def start(self, pcache: Dict[str, torch.Tensor], first: torch.Tensor,
              plen: int, graphed: bool) -> None:
        """Splice a prefill's ``(L, B, n, ...)`` cache (K/V, MLA's latent
        rows, or a hybrid's rings, n = ``plen`` or the window) into the
        cache (the rows from n on zeroed) and the state entries
        (:func:`~repro_torch.models.transformer.state_entries`) whole,
        ``first`` (B,) into the tokens buffer, ``plen`` into ``cache_len``
        and the cross K/V's rows into ``enc_len``; the batch's steps replay
        the graph when ``graphed``, else run eagerly."""
        whole = state_entries(self.cfg)
        for key, dst in self.cache.items():
            src = pcache[key]
            if key in whole:
                dst.copy_(src)
                continue
            n = src.shape[2]
            dst[:, :, :n].copy_(src)
            dst[:, :, n:].zero_()
        self.tokens.copy_(first.reshape(-1, 1))
        self.cache_len.fill_(plen)
        if self.enc_len is not None:
            self.enc_len.fill_(pcache[CROSS[0]].shape[2])
        self.graphed = graphed

    def _step(self, tokens: torch.Tensor, cache_len: torch.Tensor):
        logits, _ = decode_step(self.params, self.cfg, self.cache, tokens,
                                cache_len, enc_len=self.enc_len)
        tokens.copy_(logits[:, 0].argmax(dim=-1, keepdim=True))
        cache_len.add_(1)
        return logits

    def capture(self) -> float:
        """Capture the step as a CUDA graph; returns the seconds it took.
        The warm-up runs the step on copies of the tokens and ``cache_len``:
        it writes the new token's K/V row into the cache, the row the first
        replay then writes again from the same inputs (an audio step reads
        its cross K/V and writes none).  A hybrid or SSM step also advances
        its state entries, and a hybrid's may roll its rings, so the
        warm-up puts those back as it found them."""
        t0 = time.perf_counter()
        out = {}

        def body():
            out["logits"] = self._step(self.tokens, self.cache_len)

        def warm_up():
            saved = {k: self.cache[k].clone()
                     for k in state_entries(self.cfg) + RINGS
                     if k in self.cache}
            self._step(self.tokens.clone(), self.cache_len.clone())
            for k, t in saved.items():
                self.cache[k].copy_(t)

        self.graph, self.launches, _, self.pool_bytes = _program.capture(
            f"the decode program {self.key!r}", self.device,
            torch.cuda.graph_pool_handle(), warm_up, body)
        self.logits = out["logits"]
        torch.cuda.synchronize(self.device)
        return time.perf_counter() - t0

    def step(self) -> torch.Tensor:
        if not self.graphed:
            self.logits = self._step(self.tokens, self.cache_len)
            return self.tokens
        self.graph.replay()
        for name, count in self.launches.items():
            LAUNCHES[name] += count
        return self.tokens


class ServingEngine:
    """Single-device engine.  ``params``: a :class:`~repro_torch.models
    .Transformer` on ``device`` (for instance from
    :func:`repro_torch.convert.lm_params_from_numpy`); ``None`` draws one
    from a generator seeded with ``scfg.seed`` on ``device`` (``None``
    means ``"cuda"``)."""

    def __init__(self, cfg: ModelConfig, scfg: ServeConfig,
                 params: Optional[Transformer] = None, device=None):
        self.cfg = cfg
        self.scfg = scfg
        self.device = resolve_device(device)
        if params is None:
            params = init_params(cfg, torch.Generator(
                device=self.device).manual_seed(scfg.seed))
        if params.device.type != self.device.type:
            raise ValueError(f"params lie on {params.device}, the engine "
                             f"runs on {self.device}")
        self.params = params
        self.queue: deque = deque()
        self.done: List[Request] = []
        self.stats: Dict[str, object] = {
            "prefill_s": [], "decode_s": [], "decode_graphs": 0,
            "capture_s": 0.0,
            "decode_program": decode_program_mode(cfg, self.device)}
        #: batch size -> its decode program
        self.programs: Dict[int, DecodeProgram] = {}
        self._next_rid = 0

    # ------------------------------------------------------------------
    def submit(self, req: Request) -> int:
        req.rid = self._next_rid
        self._next_rid += 1
        req.output = []
        self.queue.append(req)
        return req.rid

    def run(self) -> List[Request]:
        """Process the queue to completion; returns finished requests."""
        B = self.scfg.max_batch
        with torch.inference_mode():
            while self.queue:
                first = self.queue.popleft()
                batch = [first]
                rest = deque()
                while self.queue and len(batch) < B:
                    r = self.queue.popleft()
                    if len(r.prompt) == len(first.prompt):
                        batch.append(r)
                    else:
                        rest.append(r)
                self.queue.extendleft(reversed(rest))
                self._run_batch(batch)
                self.done.extend(batch)
        return self.done

    def prefill(self, tokens: torch.Tensor):
        """``prefill_step`` of a (B, S) token batch on the engine's model:
        ``(logits (B, S, V), cache)``; an audio model's frames all-zero,
        ``(B, S, d)`` in ``cfg.dtype``, as the JAX engine's (a VLM's
        positions are the default, ``arange(S)`` on the three streams, the
        JAX engine's text positions)."""
        batch = {"tokens": tokens}
        if self.cfg.family == "audio":
            batch["frames"] = torch.zeros(
                (*tokens.shape, self.cfg.d_model), dtype=self.cfg.dtype,
                device=tokens.device)
        return prefill_step(self.params, self.cfg, batch)

    # ------------------------------------------------------------------
    def _run_batch(self, reqs: List[Request]):
        B = len(reqs)
        plen = max(len(r.prompt) for r in reqs)
        max_new = max(r.max_new_tokens for r in reqs)
        self._check_rows(plen, max_new)
        toks = np.zeros((B, plen), np.int64)
        for i, r in enumerate(reqs):
            toks[i, -len(r.prompt):] = r.prompt      # left-pad
        tokens = torch.from_numpy(toks).to(self.device)

        t0 = time.perf_counter()
        logits, pcache = self.prefill(tokens)
        cur = logits[:, -1].argmax(dim=-1)
        del logits
        prog = self._splice(pcache, cur, plen)
        del pcache
        last = cur.tolist()                          # the one host read
        self.stats["prefill_s"].append(time.perf_counter() - t0)
        for i, r in enumerate(reqs):
            r.output.append(int(last[i]))

        if max_new > 1 and prog.graphed and prog.graph is None:
            self.stats["capture_s"] += prog.capture()
            self.stats["decode_graphs"] += 1
        active = np.ones(B, bool)
        for _ in range(max_new - 1):
            if not active.any():
                break
            t0 = time.perf_counter()
            nxt = prog.step()[:, 0].tolist()         # the one host read
            self.stats["decode_s"].append(time.perf_counter() - t0)
            for i, r in enumerate(reqs):
                if not active[i]:
                    continue
                if len(r.output) >= r.max_new_tokens or \
                        (self.scfg.eos_id >= 0 and nxt[i] == self.scfg.eos_id):
                    active[i] = False
                    continue
                r.output.append(int(nxt[i]))

    def _check_rows(self, plen: int, max_new: int) -> None:
        """Refuse, before its prefill, a batch whose cache rows do not fit.
        The last decode step writes cache row plen + max_new - 2; the JAX
        engine clamps that write and overwrites the last row (ROADMAP C12).
        A hybrid's rings hold ``cache_rows(cfg, max_len)`` =
        min(max_len, window) rows: with max_len under the window the JAX
        engine would narrow attention to max_len tokens once the ring
        fills (ROADMAP C27).  The SSM family's state takes no rows, so no
        batch of it is refused.  An audio engine's ``max_len`` may not pass
        the ``DEC_POSITIONS`` rows of whisper's learned positions, which the
        JAX gather clamps past the last (ROADMAP C30)."""
        if self.cfg.family == "audio" and self.scfg.max_len > DEC_POSITIONS:
            raise ValueError(
                f"max_len {self.scfg.max_len} passes the {DEC_POSITIONS} "
                "rows of the decoder's learned positions (the JAX gather "
                "would read the last row past them: ROADMAP C30)")
        need = cache_rows(self.cfg, plen + max_new - 1)
        held = cache_rows(self.cfg, self.scfg.max_len)
        if need > held:
            raise ValueError(
                f"a prompt of {plen} tokens and {max_new} new tokens need "
                f"{need} cache rows; max_len is {self.scfg.max_len}, so the "
                f"cache holds {held} (ROADMAP C12; a hybrid's rings hold "
                "min(max_len, window) rows, and under the window the JAX "
                "engine would narrow attention to max_len tokens: C27)")

    def _splice(self, pcache: Dict[str, torch.Tensor], first: torch.Tensor,
                plen: int) -> DecodeProgram:
        """The decode program of the batch's size, its cache holding the
        length-plen prefill cache, right-padded with zeros to max_len, in
        place, and its tokens buffer ``first``."""
        B = first.shape[0]
        prog = self.programs.get(B)
        if prog is None:
            prog = self.programs[B] = DecodeProgram(
                self.params, self.cfg, B, self.scfg.max_len, self.device)
        mode = self.stats["decode_program"] = decode_program_mode(
            self.cfg, self.device)
        prog.start(pcache, first, plen, graphed=mode == "graph")
        return prog
