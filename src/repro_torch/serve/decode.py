"""Token serving steps (counterpart of ``repro.serve.decode``): prefill
(prompt -> KV cache + first token) and decode (one token against the KV
cache), with a greedy or temperature sampler.  Under ambient mesh rules
the prompts and the current tokens are placed on ``"batch"`` (data
parallel), as the reference's steps place them."""

from __future__ import annotations

import torch
from torch.distributed.tensor import DTensor, Replicate, Shard

from repro_torch.dist.sharding import shard


def _rows(t: torch.Tensor) -> torch.Tensor:
    return shard(t, "batch", *(None,) * (t.dim() - 1))


def greedy(logits: torch.Tensor) -> torch.Tensor:
    """The argmax over the vocab (the last dim).  A DTensor's vocab is
    gathered first: DTensor's own argmax over a split dim gathers each
    rank's (value, index) pairs into a view that fails where a rank holds
    one row (a prefill of one prompt a data rank, ``long_500k``'s batch
    of 1)."""
    if isinstance(logits, DTensor):
        last = logits.dim() - 1
        logits = logits.redistribute(logits.device_mesh, [
            Replicate() if isinstance(p, Shard) and p.dim == last else p
            for p in logits.placements])
    return torch.argmax(logits, dim=-1)


def make_prefill_step(fns):
    def prefill_step(params, batch):
        cache, logits = fns.prefill(params, {k: _rows(v)
                                             for k, v in batch.items()})
        next_tok = greedy(logits).to(torch.int32)
        return cache, next_tok, logits

    return prefill_step


def make_serve_step(fns, *, temperature: float = 0.0):
    """serve_step(params, cache, tokens, cache_len[, generator]) -> (next,
    cache).  Greedy unless ``temperature > 0`` and a ``torch.Generator`` on
    the logits' device is given; then a categorical draw from
    ``softmax(logits / temperature)``."""

    def serve_step(params, cache, tokens, cache_len, generator=None):
        logits, cache = fns.decode(params, cache, _rows(tokens), cache_len)
        if temperature > 0.0 and generator is not None:
            probs = torch.softmax(logits.float() / temperature, dim=-1)
            next_tok = torch.multinomial(probs, 1, generator=generator)[:, 0]
        else:
            next_tok = greedy(logits)
        return next_tok.to(torch.int32), cache

    return serve_step
