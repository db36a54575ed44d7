"""Batched serving demo of the PyTorch port: prefill a wave of requests, then
lockstep decode, through ``repro_torch.launch.serve`` (counterpart of
``examples/serve_batch.py``).  mamba2, the default, shows the SSM's
constant-size decode state: each token updates a (B, H, P, N) state and
three conv tails per layer, whatever the prompt's length.

Run:
    PYTHONPATH=src python examples/torch_serve_batch.py            # on a card
    PYTHONPATH=src python examples/torch_serve_batch.py --device cpu
    PYTHONPATH=src python examples/torch_serve_batch.py --arch hymba-1.5b

Each request is a 48-token prompt and 24 generated tokens, on the smoke
config of the arch as the reference serves it (``--no-smoke``: full
width).  The last line is the launcher's ``token_report {json}``.
"""

import argparse

from repro_torch.launch.serve import main as serve_main


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="mamba2-1.3b")
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--smoke", action=argparse.BooleanOptionalAction,
                    default=True,
                    help="the arch's smoke config (default, as the "
                         "reference's example); --no-smoke: full width")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without a card) or cpu")
    args = ap.parse_args(argv)
    return serve_main(["--arch", args.arch, *(["--smoke"] * args.smoke),
                       "--device", args.device,
                       "--requests", str(args.requests),
                       "--prompt-len", "48", "--gen-len", "24"])


if __name__ == "__main__":
    raise SystemExit(main())
