"""The LM cells' initial weights, frozen for the reference: a copy of the
port's seeded init of a mamba2 language model (the configuration file's
``assumed`` weights), written draw for draw as the port draws them, so
that on the same seed and device step 1 of the reference starts from the
weights the program should start from.  Later changes to the program do
not move this file.

One ``torch.Generator`` on ``device``, seeded with ``seed``, draws
``scale * N(0, 1)`` in float32 in this order: each layer's projections
``wx``, ``wz`` (d, di), ``wB``, ``wC`` (d, N), ``wdt`` (d, H) at 0.02,
then its conv taps ``conv_x`` (W, di), ``conv_B``, ``conv_C`` (W, N) at
0.1, then ``wo`` (di, d) at 0.02; after the layers the embedding (V, d)
at 0.02 and, for an untied head, the head (d, V) at 0.02.  Drawn
nothing: ``dt_bias`` the inverse softplus of 0.01, ``A_log`` the logs of
H points spread evenly over 1..16, ``D`` and every norm's gain ones.
"""

from __future__ import annotations

import torch


def init_params(config: dict, seed: int, device=None) -> dict:
    """The initial weights of ``config`` (a configuration file: its
    ``n_layers``, ``d_model``, ``d_inner``, ``d_state``, ``n_heads``,
    ``d_conv``, ``vocab_rows`` and ``tie_embeddings``) in the reference's
    layout (``yardstick.mamba2_ref``)."""
    d, di = config["d_model"], config["d_inner"]
    n, h, taps = config["d_state"], config["n_heads"], config["d_conv"]
    f32 = dict(dtype=torch.float32, device=device)
    gen = torch.Generator(device=device).manual_seed(seed)

    def normal(shape, scale=0.02):
        return scale * torch.randn(shape, generator=gen, **f32)

    def ones(k):
        return torch.ones((k,), **f32)

    layers = [{"norm": ones(d),
               "wx": normal((d, di)), "wz": normal((d, di)),
               "wB": normal((d, n)), "wC": normal((d, n)),
               "wdt": normal((d, h)),
               "dt_bias": torch.log(torch.expm1(torch.full((h,), 0.01,
                                                           **f32))),
               "A_log": torch.log(torch.linspace(1.0, 16.0, h, **f32)),
               "D": ones(h),
               "conv_x": normal((taps, di), 0.1),
               "conv_B": normal((taps, n), 0.1),
               "conv_C": normal((taps, n), 0.1),
               "gate_norm": ones(di), "wo": normal((di, d))}
              for _ in range(config["n_layers"])]
    out = {"embed": normal((config["vocab_rows"], d)), "layers": layers,
           "final_norm": ones(d)}
    if not config["tie_embeddings"]:
        out["head"] = normal((d, config["vocab_rows"]))
    return out
