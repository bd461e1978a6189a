"""Data pipeline: deterministic, shardable, restartable (the port's copy of
``repro.data.pipeline``, which is numpy already: for every ``(seed, shard,
step)`` its batches are the JAX package's bit for bit).

Two sources:
* ``synthetic_token_stream`` — seeded Zipf-ish token batches (markov-mixed
  so the LM has actual structure to learn); fully deterministic in
  (seed, step), so restart-from-checkpoint replays identically and each
  data shard draws a disjoint stream (fault tolerance requirement).
* ``byte_tokenize`` + file source — byte-level tokenization of local text,
  packed into fixed-length rows.

Batches are dicts of numpy arrays matching ``repro_torch.models`` inputs
(the training loop moves them to its device).  ``make_dataset``
returns a stateless ``step -> batch`` function: the *step index is the
iterator state*, which is what makes checkpoint/restart and elastic
re-sharding trivial (no opaque iterator state to persist).
"""
from __future__ import annotations

import dataclasses
from pathlib import Path
from typing import Callable, Dict, Iterator, Optional

import numpy as np


@dataclasses.dataclass(frozen=True)
class DataConfig:
    batch_size: int = 8
    seq_len: int = 128
    vocab_size: int = 256
    seed: int = 0
    source: str = "synthetic"         # synthetic | file
    path: Optional[str] = None
    shard_index: int = 0              # this host's data shard
    shard_count: int = 1


def byte_tokenize(text: str, vocab_size: int) -> np.ndarray:
    toks = np.frombuffer(text.encode("utf-8"), dtype=np.uint8).astype(np.int32)
    return toks % vocab_size


def synthetic_token_stream(cfg: DataConfig, step: int) -> np.ndarray:
    """Deterministic (seed, shard, step) -> (B, S) int32 batch.

    Tokens follow a 2-state mixture: within a row, token t is with p=0.6 a
    function of token t-1 (affine mod V) and with p=0.4 Zipf-sampled — so
    cross-entropy has learnable structure (tests assert the loss drops).
    """
    rng = np.random.default_rng(
        np.random.SeedSequence([cfg.seed, cfg.shard_index, step]))
    B, S, V = cfg.batch_size, cfg.seq_len, cfg.vocab_size
    zipf = rng.zipf(1.5, size=(B, S)).astype(np.int64) % V
    out = np.empty((B, S), np.int64)
    out[:, 0] = zipf[:, 0]
    follow = rng.random((B, S)) < 0.6
    for t in range(1, S):
        out[:, t] = np.where(follow[:, t],
                             (out[:, t - 1] * 31 + 7) % V, zipf[:, t])
    return out.astype(np.int32)


def _file_batches(cfg: DataConfig) -> np.ndarray:
    text = Path(cfg.path).read_text(errors="replace")
    toks = byte_tokenize(text, cfg.vocab_size)
    n = (len(toks) - 1) // cfg.seq_len
    rows = toks[:n * cfg.seq_len].reshape(n, cfg.seq_len)
    return rows


def make_dataset(cfg: DataConfig, model_cfg=None) -> Callable[[int], Dict]:
    """Returns ``batch_fn(step) -> {"tokens": (B, S) int32, ...}``."""
    rows = _file_batches(cfg) if cfg.source == "file" else None

    def batch_fn(step: int) -> Dict[str, np.ndarray]:
        if cfg.source == "file":
            n = rows.shape[0]
            idx = (np.arange(cfg.batch_size)
                   + step * cfg.batch_size * cfg.shard_count
                   + cfg.shard_index * cfg.batch_size) % n
            tokens = rows[idx]
        else:
            tokens = synthetic_token_stream(cfg, step)
        batch = {"tokens": tokens}
        if model_cfg is not None and model_cfg.family == "audio":
            rng = np.random.default_rng(
                np.random.SeedSequence([cfg.seed + 1, cfg.shard_index, step]))
            batch["frames"] = rng.standard_normal(
                (cfg.batch_size, cfg.seq_len, model_cfg.d_model)
            ).astype(np.float32)
        if model_cfg is not None and model_cfg.family == "vlm":
            rng = np.random.default_rng(
                np.random.SeedSequence([cfg.seed + 2, cfg.shard_index, step]))
            n_patch = min(64, cfg.seq_len - 2)
            batch["patch_embeds"] = rng.standard_normal(
                (cfg.batch_size, n_patch, model_cfg.d_model)
            ).astype(np.float32)
            t = np.broadcast_to(np.arange(cfg.seq_len)[None, :, None],
                                (cfg.batch_size, cfg.seq_len, 3))
            batch["positions"] = np.ascontiguousarray(t, dtype=np.int32)
        return batch

    return batch_fn


def prefetch(batch_fn: Callable[[int], Dict], start_step: int = 0,
             lookahead: int = 2) -> Iterator[Dict]:
    """Simple thread prefetcher over the stateless batch function."""
    import queue
    import threading

    q: "queue.Queue" = queue.Queue(maxsize=lookahead)
    stop = threading.Event()

    def worker():
        step = start_step
        while not stop.is_set():
            q.put(batch_fn(step))
            step += 1

    t = threading.Thread(target=worker, daemon=True)
    t.start()
    try:
        while True:
            yield q.get()
    finally:
        stop.set()
