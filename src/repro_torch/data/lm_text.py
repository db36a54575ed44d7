"""Byte-level LM data (counterpart of ``repro.data.lm_text``): the embedded
corpus, packed into deterministic, seekable batches, sharded by host.

``batch_at(step)`` is a pure function of the step index (numpy's PCG64
seeded from ``seed + step * 1_000_003 + host``), which is what makes a
restart replay the stream exactly (``ft/runner.py``); it returns the
reference's arrays bit for bit.  The corpus is a public-domain text kept
in the source, so nothing is downloaded.  Numpy only: the launcher moves
a batch to the device.
"""

from __future__ import annotations

import dataclasses

import numpy as np

_CORPUS = (
    "Magnetic resonance fingerprinting is a quantitative imaging technique "
    "that encodes tissue parameters in transient signal evolutions. A neural "
    "network maps measured fingerprints to parameter values, replacing "
    "dictionary matching whose cost grows exponentially with dimensionality. "
    "Training the network is the bottleneck: every scanner, field strength, "
    "and sequence variation demands a retrain. Hardware acceleration of the "
    "training loop itself, with integer arithmetic and on-chip weights, "
    "turns hours into seconds and enables scanner-side personalisation. "
    "The quick brown fox jumps over the lazy dog. 0123456789. "
) * 64  # ~40 KB


@dataclasses.dataclass(frozen=True)
class TextPipeline:
    seq_len: int
    batch_size: int
    vocab_size: int = 256          # byte-level
    seed: int = 0
    n_hosts: int = 1
    host: int = 0

    def __post_init__(self):
        data = np.frombuffer(_CORPUS.encode(), dtype=np.uint8)
        object.__setattr__(self, "_tokens", data)

    @property
    def tokens_per_batch(self) -> int:
        return self.seq_len * self.batch_size

    def batch_at(self, step: int) -> dict:
        """Deterministic, seekable batch: {"tokens", "labels"}, both (B /
        n_hosts, S) int32, labels the tokens shifted by one."""
        rng = np.random.default_rng(self.seed + step * 1_000_003 + self.host)
        n = len(self._tokens) - self.seq_len - 1
        b = self.batch_size // self.n_hosts
        starts = rng.integers(0, n, size=b)
        toks = np.stack([self._tokens[s:s + self.seq_len] for s in starts])
        labs = np.stack([self._tokens[s + 1:s + self.seq_len + 1]
                         for s in starts])
        return {"tokens": toks.astype(np.int32) % self.vocab_size,
                "labels": labs.astype(np.int32) % self.vocab_size}
