"""Bytes each card holds of a model's params (and, for training, its
gradient and Adam moments) on a mesh, reckoned from the port's axes trees
and rules: no device, no allocation (meta tensors).

    PYTHONPATH=src python scripts/shard_bytes.py --arch qwen2.5-14b \\
        --mesh 1,4 --train
    PYTHONPATH=src python scripts/shard_bytes.py --arch phi3.5-moe-42b-a6.6b \\
        --mesh 1,4 --dtype bf16

The mesh is ``data,model`` (or ``pod,data,model``); heads and vocab are
padded to the ``model`` size as ``registry.build(cfg, tp)`` pads them; a
leaf's bytes on a card are its bytes over the product of the mesh dims
its logical axes shard it on (``SINGLE_POD_RULES``: ``fsdp`` and
``batch`` on ``data``, ``tp`` on ``model``).  ``--train`` counts 16 bytes
a parameter (the f32 master, its gradient and two Adam moments),
otherwise ``--dtype``'s bytes (serving).  Activations are not counted,
but ``--train --tokens B,S`` adds the loss's tensors over the vocab at a
global batch of B x S tokens (``vocab_bytes``).
"""

from __future__ import annotations

import argparse
import json
import math
import types

from repro_torch.configs import get_config
from repro_torch.dist.sharding import (MULTI_POD_RULES, SINGLE_POD_RULES,
                                       axes_to_placements, map_axes)
from repro_torch.launch.input_specs import params_specs
from repro_torch.models import registry


def per_card(arch: str, shape: tuple, bytes_per_param: float) -> dict:
    names = ("data", "model") if len(shape) == 2 else ("pod", "data",
                                                       "model")
    rules = SINGLE_POD_RULES if len(shape) == 2 else MULTI_POD_RULES
    sizes = dict(zip(names, shape))
    cfg = get_config(arch)
    tp = sizes["model"]
    params = params_specs(cfg, tp)
    axes = registry.build(cfg, tp).param_axes()
    total, card = [0], [0.0]

    def one(ax, t):
        n = t.numel()
        split = math.prod(
            sizes[m] for m, p in zip(names, axes_to_placements(ax, rules,
                                                               names))
            if p.is_shard())
        total[0] += n
        card[0] += n / split

    map_axes(one, axes, params)
    return {"arch": arch, "mesh": sizes, "params": total[0],
            "bytes_per_param": bytes_per_param,
            "gb_total": total[0] * bytes_per_param / 1e9,
            "gb_per_card": card[0] * bytes_per_param / 1e9}


def vocab_bytes(arch: str, shape: tuple, batch: int, seq: int) -> dict:
    """GB a card holds of the training loss's tensors over the vocab, which
    stays split over ``model`` (``lm.cross_entropy``, ``common.
    embed_lookup``), the rows split over the batch dims: the bf16 logits,
    their f32 copy and its gradient, and the embedding table's f32 block
    gathered over its ``fsdp`` dim for the lookup with its pending
    gradient of the same size."""
    cfg = get_config(arch)
    tp, rows_split = shape[-1], math.prod(shape[:-1])
    vocab = cfg.padded_vocab(tp) / tp
    rows = batch * seq / rows_split
    table = vocab * cfg.d_model * 4 / 1e9
    return {"tokens": [batch, seq], "logits_bf16": rows * vocab * 2 / 1e9,
            "logits_f32": rows * vocab * 4 / 1e9,
            "logits_f32_grad": rows * vocab * 4 / 1e9,
            "embed_block_f32": table, "embed_block_grad": table}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--mesh", default="1,4", help="data,model or "
                    "pod,data,model")
    ap.add_argument("--train", action="store_true",
                    help="16 bytes a parameter (f32 master, gradient, "
                         "Adam's two moments)")
    ap.add_argument("--dtype", default="bf16", choices=["bf16", "f32"])
    ap.add_argument("--tokens", default=None,
                    help="B,S: with --train, the loss's vocab tensors")
    args = ap.parse_args(argv)
    shape = tuple(int(x) for x in args.mesh.split(","))
    bpp = 16.0 if args.train else {"bf16": 2.0, "f32": 4.0}[args.dtype]
    out = per_card(args.arch, shape, bpp)
    if args.train and args.tokens:
        b, s = (int(x) for x in args.tokens.split(","))
        out["vocab_gb_per_card"] = vocab_bytes(args.arch, shape, b, s)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
