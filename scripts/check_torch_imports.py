#!/usr/bin/env python
"""Import integrity of the PyTorch port (stdlib only: no torch, no jax).

Usage: ``python scripts/check_torch_imports.py`` from anywhere; exits 1 if
a ``repro_torch.*`` import names no module under ``src/``, or a file on
the port's side (``src/repro_torch``, ``chip_smoke.py``,
``examples/torch_*.py``, ``experiments/torch_*.py``) imports ``jax``,
``jaxlib`` or ``repro``.
"""

import pathlib
import sys

REPO_ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO_ROOT / "src"))

from repro_torch.tools.import_integrity import main  # noqa: E402

if __name__ == "__main__":
    raise SystemExit(main(REPO_ROOT))
