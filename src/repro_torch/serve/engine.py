"""Batched serving engine: prefill, then greedy decode (PyTorch port of
``repro.serve.engine``).

Requests are grouped into batches of equal prompt length (length buckets)
and left-padded, so positions and caches are exact without ragged masks.
A batch runs one prefill (the flash kernel under ``cfg.use_flash_kernel``)
and splices its KV into a ``(L, B, max_len, K, hd)`` cache, then one decode
step per new token for all its slots; a slot that reached its
``max_new_tokens`` or ``eos_id`` is skipped.  On the card the host reads
the device once per step: the argmax of every slot in one copy, while the
next step's input stays on the device.  Everything runs under
``torch.inference_mode()``.

``stats`` keeps the wall time of each prefill and each decode step (each
ends in that host read, so it is the device's time as the host sees it).
"""
from __future__ import annotations

import dataclasses
import time
from collections import deque
from typing import Dict, List, Optional

import numpy as np
import torch

from repro_torch.core.types import resolve_device
from repro_torch.models import (ModelConfig, Transformer, decode_step,
                                init_cache, init_params, prefill_step)


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
        self.stats: Dict[str, List[float]] = {"prefill_s": [],
                                              "decode_s": []}
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
        ``(logits (B, S, V), cache)``."""
        return prefill_step(self.params, self.cfg, {"tokens": tokens})

    # ------------------------------------------------------------------
    def _run_batch(self, reqs: List[Request]):
        B = len(reqs)
        plen = max(len(r.prompt) for r in reqs)
        max_new = max(r.max_new_tokens for r in reqs)
        # the last decode step writes cache row plen + max_new - 2; the JAX
        # engine clamps that write and overwrites the last row, this one
        # refuses the batch before it starts
        if plen + max_new - 1 > self.scfg.max_len:
            raise ValueError(
                f"a prompt of {plen} tokens and {max_new} new tokens need "
                f"{plen + max_new - 1} cache rows; max_len is "
                f"{self.scfg.max_len}")
        toks = np.zeros((B, plen), np.int64)
        for i, r in enumerate(reqs):
            toks[i, -len(r.prompt):] = r.prompt      # left-pad
        tokens = torch.from_numpy(toks).to(self.device)

        t0 = time.perf_counter()
        logits, pcache = self.prefill(tokens)
        cache = self._splice(pcache, B)
        del pcache
        cur = logits[:, -1].argmax(dim=-1)
        del logits
        last = cur.tolist()                          # the one host read
        self.stats["prefill_s"].append(time.perf_counter() - t0)
        for i, r in enumerate(reqs):
            r.output.append(int(last[i]))

        cache_len = plen
        active = np.ones(B, bool)
        for _ in range(max_new - 1):
            if not active.any():
                break
            t0 = time.perf_counter()
            logits, cache = decode_step(self.params, self.cfg, cache,
                                        cur[:, None], cache_len)
            cache_len += 1
            cur = logits[:, 0].argmax(dim=-1)
            nxt = cur.tolist()                       # the one host read
            self.stats["decode_s"].append(time.perf_counter() - t0)
            for i, r in enumerate(reqs):
                if not active[i]:
                    continue
                if len(r.output) >= r.max_new_tokens or \
                        (self.scfg.eos_id >= 0 and nxt[i] == self.scfg.eos_id):
                    active[i] = False
                    continue
                r.output.append(int(nxt[i]))

    def _splice(self, pcache: Dict[str, torch.Tensor],
                B: int) -> Dict[str, torch.Tensor]:
        """Right-pad the length-plen prefill cache to max_len."""
        target = init_cache(self.cfg, B, self.scfg.max_len,
                            device=self.device)
        for key, src in pcache.items():
            target[key][tuple(slice(0, n) for n in src.shape)] = src
        return target
