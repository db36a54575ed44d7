"""The LM cells' token stream, frozen for the reference: a copy of the
port's byte-level text pipeline (the embedded public-domain text, packed
into seekable batches), written op for op as the port draws them, so that
on the same seed and step the reference reads the same tokens and labels.
Later changes to the program do not move this file.

A batch of ``batch`` sequences of ``seq`` tokens for step ``step``: numpy's
PCG64 seeded with ``seed + step * 1_000_003`` draws each sequence's start
in the text; the tokens are the text's bytes from there, the labels the
next ones, both modulo ``vocab`` (at most 256: bytes).
"""

from __future__ import annotations

import numpy as np
import torch

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


def batch(seed: int, step: int, batch: int, seq: int, vocab: int = 256,
          device=None) -> tuple:
    """(tokens, labels), each (batch, seq) int64 on ``device``."""
    text = np.frombuffer(_CORPUS.encode(), dtype=np.uint8)
    rng = np.random.default_rng(seed + step * 1_000_003)
    starts = rng.integers(0, len(text) - seq - 1, size=batch)
    toks = np.stack([text[s:s + seq] for s in starts]).astype(np.int32)
    labs = np.stack([text[s + 1:s + seq + 1] for s in starts]).astype(
        np.int32)
    return tuple(torch.from_numpy(a % vocab).long().to(device)
                 for a in (toks, labs))
