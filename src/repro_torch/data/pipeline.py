"""Data pipeline — the port of `repro.data.pipeline`, numpy as the JAX
package's is, so each (seed, step, rank) and each token file gives
byte-identical batches in both packages: deterministic synthetic tokens +
memmap binary token files, shard-aware reads, background prefetch with
double buffering.

Design for 1000+ hosts: every host computes its own slice of the global
batch from (step, dp_rank, dp_size) alone — no coordinator, no shared
filesystem contention, bit-exact resume from any step (the trainer persists
only the step number). The memmap source reads fixed-length windows from a
flat uint16/uint32 token file (the standard "packed tokens" format).
"""

from __future__ import annotations

import dataclasses
import queue
import threading
from typing import Dict, Iterator, Optional

import numpy as np

from repro_torch.configs.base import ModelConfig


@dataclasses.dataclass
class DataConfig:
    seq_len: int
    global_batch: int
    vocab_size: int
    seed: int = 0
    token_file: Optional[str] = None     # flat binary tokens; None=synthetic
    token_dtype: str = "uint16"
    prefetch: int = 2


class TokenSource:
    """Deterministic per-(step, rank) batch generation."""

    def __init__(self, cfg: DataConfig, dp_rank: int = 0, dp_size: int = 1):
        self.cfg = cfg
        self.dp_rank = dp_rank
        self.dp_size = dp_size
        if cfg.global_batch % dp_size:
            raise ValueError(f"global_batch {cfg.global_batch} does not "
                             f"split over {dp_size} ranks")
        self.local_batch = cfg.global_batch // dp_size
        self._mm = None
        if cfg.token_file:
            self._mm = np.memmap(cfg.token_file, dtype=cfg.token_dtype,
                                 mode="r")
            self._n_windows = (len(self._mm) - 1) // cfg.seq_len

    def batch_at(self, step: int) -> Dict[str, np.ndarray]:
        """tokens/labels (local_batch, seq_len) for a given global step."""
        c = self.cfg
        if self._mm is None:
            rng = np.random.default_rng(
                np.random.SeedSequence([c.seed, step, self.dp_rank]))
            toks = rng.integers(0, c.vocab_size,
                                (self.local_batch, c.seq_len + 1),
                                dtype=np.int32)
        else:
            # global window ids for this step, sliced per rank
            rng = np.random.default_rng(np.random.SeedSequence([c.seed, step]))
            wins = rng.integers(0, self._n_windows, (c.global_batch,))
            mine = wins[self.dp_rank::self.dp_size][: self.local_batch]
            toks = np.stack([
                np.asarray(self._mm[w * c.seq_len: w * c.seq_len + c.seq_len + 1],
                           dtype=np.int32)
                for w in mine])
        return {"tokens": toks[:, :-1], "labels": toks[:, 1:]}


class PrefetchIterator:
    """Background-thread prefetch with a bounded queue (double buffering)."""

    def __init__(self, source: TokenSource, start_step: int = 0):
        self.source = source
        self.step = start_step
        self._q: "queue.Queue" = queue.Queue(maxsize=source.cfg.prefetch)
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._worker, daemon=True)
        self._thread.start()

    def _worker(self):
        step = self.step
        while not self._stop.is_set():
            batch = self.source.batch_at(step)
            while not self._stop.is_set():
                try:
                    self._q.put((step, batch), timeout=0.2)
                    break
                except queue.Full:
                    continue
            step += 1

    def __iter__(self) -> Iterator:
        return self

    def __next__(self):
        step, batch = self._q.get()
        return step, batch

    def close(self):
        self._stop.set()
        try:
            while True:
                self._q.get_nowait()
        except queue.Empty:
            pass
        self._thread.join(timeout=2)


def make_stub_frontend_batch(cfg: ModelConfig, batch: Dict[str, np.ndarray],
                             rng_seed: int = 0) -> Dict[str, np.ndarray]:
    """Attach the stub modality inputs (whisper frames / vlm patches)."""
    b = batch["tokens"].shape[0]
    rng = np.random.default_rng(rng_seed)
    if cfg.family == "encdec":
        batch = dict(batch)
        batch["frames"] = rng.standard_normal(
            (b, cfg.enc_seq, cfg.d_model)).astype(np.float32) * 0.02
    elif cfg.family == "vlm":
        batch = dict(batch)
        batch["vis"] = rng.standard_normal(
            (b, cfg.n_vis_tokens, cfg.d_model)).astype(np.float32) * 0.02
        batch["tokens"] = batch["tokens"][:, : -cfg.n_vis_tokens] \
            if batch["tokens"].shape[1] > cfg.n_vis_tokens else batch["tokens"]
        batch["labels"] = batch["labels"][:, : batch["tokens"].shape[1]]
    return batch
