#!/usr/bin/env python
"""torchlint, the PyTorch port's lint (stdlib only: no torch, no jax).

Usage, from anywhere in the repo:

    python scripts/check_torch_lints.py                 # exit 1 on findings
    python scripts/check_torch_lints.py --github        # ::error annotations
    python scripts/check_torch_lints.py --format sarif  # SARIF 2.1.0
    python scripts/check_torch_lints.py --list-rules
    python scripts/check_torch_lints.py --report dead-exports \
        --allowlist scripts/torch_dead_exports_allowlist.txt
                                  # the gate: exit 1 on dead port names not
                                  # listed and on stale entries
"""

import pathlib
import sys

REPO_ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO_ROOT / "src"))

from repro_torch.tools.torchlint import main  # noqa: E402

if __name__ == "__main__":
    raise SystemExit(main(repo_root=REPO_ROOT))
