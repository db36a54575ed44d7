"""Inputs of every model entry point as ``device="meta"`` tensors, and the
logical axes that place them (counterpart of ``repro.launch.input_specs``).

The spec functions describe shapes and dtypes without allocating (the
reference's ``ShapeDtypeStruct`` stand-ins); :func:`batch_axes` and
:func:`decode_axes` are what the train launcher places a batch with
(``dist.sharding.distribute_tree``).  ``kind`` is ``"train"`` (tokens and
labels) or ``"prefill"`` (tokens).
"""

from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import registry
from repro_torch.models.common import COMPUTE
from repro_torch.models.encdec import enc_len_for
from repro_torch.tree import leaves

META = torch.device("meta")


def _meta(shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device=META)


def batch_specs(cfg: ModelConfig, global_batch: int, seq_len: int,
                kind: str = "train") -> dict:
    """A train or prefill batch: token ids (labels too for training), the
    VLM's prefix embeddings, the encoder-decoder's frames."""
    b, s = global_batch, seq_len
    batch = {"tokens": _meta((b, s), torch.int64)}
    if kind == "train":
        batch["labels"] = _meta((b, s), torch.int64)
    if cfg.family == "vlm":
        batch["prefix_embeds"] = _meta((b, cfg.n_prefix_embeds, cfg.d_model),
                                       COMPUTE)
    if cfg.family == "encdec":
        batch["frames"] = _meta((b, enc_len_for(s), cfg.d_model), COMPUTE)
    return batch


def batch_axes(cfg: ModelConfig, kind: str = "train") -> dict:
    """The logical axes of :func:`batch_specs`' entries."""
    ax = {"tokens": ("batch", None)}
    if kind == "train":
        ax["labels"] = ("batch", None)
    if cfg.family == "vlm":
        ax["prefix_embeds"] = ("batch", None, None)
    if cfg.family == "encdec":
        ax["frames"] = ("batch", "act_seq", None)
    return ax


def decode_specs(cfg: ModelConfig, global_batch: int, seq_len: int,
                 tp: int) -> dict:
    """A decode step's inputs: one new token a request and a cache of
    ``seq_len`` slots (``cache_len`` is a Python int in the port)."""
    fns = registry.build(cfg, tp=tp)
    return {"cache": fns.init_cache(global_batch, seq_len, device=META),
            "tokens": _meta((global_batch,), torch.int64)}


def decode_axes(cfg: ModelConfig) -> dict:
    return {"cache": registry.cache_axes(cfg), "tokens": ("batch",)}


def params_specs(cfg: ModelConfig, tp: int):
    """The params at tensor-parallel degree ``tp``, on the meta device."""
    return registry.build(cfg, tp=tp).init(0, device=META)


def tree_nbytes(tree) -> int:
    """Bytes of every tensor of ``tree`` (the reference's ``tree_bytes``,
    whose name its dead-exports allowlist holds)."""
    return sum(t.numel() * t.element_size() for t in leaves(tree))
