"""torchlint: static checks of the PyTorch port's contracts (counterpart of
``repro.tools.jaxlint``), stdlib ``ast`` only.

Rules (:mod:`.rules`): HOSTSYNC, TF32, GLOBALRNG, FALLBACK, CPUDEFAULT;
``docs/torchlint.md`` says what each flags and why jaxlint's other rules
have no counterpart.  Suppress a finding on its line with a reasoned
pragma (a pragma without ``-- reason`` is itself a finding)::

    x = t.item()  # torchlint: disable=HOSTSYNC -- why

Run as ``python scripts/check_torch_lints.py`` (``--github``, ``--format
sarif``, ``--list-rules``, ``--report dead-exports [--allowlist
scripts/torch_dead_exports_allowlist.txt]``).
"""

from repro_torch.tools.torchlint.core import (PRAGMA, Finding,  # noqa: F401
                                              lint_files, lint_targets, main,
                                              parse_pragmas, rule_summaries)
from repro_torch.tools.torchlint import rules  # noqa: F401 (registers them)
