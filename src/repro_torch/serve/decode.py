"""Token serving steps (counterpart of ``repro.serve.decode``): prefill
(prompt -> KV cache + first token) and decode (one token against the KV
cache), with a greedy or temperature sampler."""

from __future__ import annotations

import torch


def make_prefill_step(fns):
    def prefill_step(params, batch):
        cache, logits = fns.prefill(params, batch)
        next_tok = torch.argmax(logits, dim=-1).to(torch.int32)
        return cache, next_tok, logits

    return prefill_step


def make_serve_step(fns, *, temperature: float = 0.0):
    """serve_step(params, cache, tokens, cache_len[, generator]) -> (next,
    cache).  Greedy unless ``temperature > 0`` and a ``torch.Generator`` on
    the logits' device is given; then a categorical draw from
    ``softmax(logits / temperature)``."""

    def serve_step(params, cache, tokens, cache_len, generator=None):
        logits, cache = fns.decode(params, cache, tokens, cache_len)
        if temperature > 0.0 and generator is not None:
            probs = torch.softmax(logits.float() / temperature, dim=-1)
            next_tok = torch.multinomial(probs, 1, generator=generator)[:, 0]
        else:
            next_tok = torch.argmax(logits, dim=-1)
        return next_tok.to(torch.int32), cache

    return serve_step
