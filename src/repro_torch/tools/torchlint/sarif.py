"""SARIF 2.1.0 of torchlint's findings, with the fields the reference's
``repro.tools.jaxlint.sarif`` writes: one run, one tool (``torchlint``),
one result per finding, each rule's ``ruleIndex`` into the driver's rules
(``PRAGMA`` and ``SYNTAX`` included)."""

from __future__ import annotations

_SCHEMA_URI = ("https://raw.githubusercontent.com/oasis-tcs/sarif-spec/"
              "master/Schemata/sarif-schema-2.1.0.json")


def sarif_log(findings, rules: dict | None = None) -> dict:
    """The SARIF log of ``findings``; ``rules`` name -> summary, by default
    the registry's."""
    if rules is None:
        from repro_torch.tools.torchlint.core import rule_summaries
        rules = rule_summaries()
    rules = dict(rules)
    rules.setdefault("PRAGMA", "malformed suppression pragma (no reason, "
                               "or an unknown rule)")
    rules.setdefault("SYNTAX", "syntax error prevents linting")
    ids = sorted(rules)
    index = {rid: i for i, rid in enumerate(ids)}
    return {
        "$schema": _SCHEMA_URI,
        "version": "2.1.0",
        "runs": [{
            "tool": {"driver": {
                "name": "torchlint",
                "informationUri": "docs/torchlint.md",
                "rules": [{"id": rid,
                           "shortDescription": {"text": rules[rid]}}
                          for rid in ids]}},
            "results": [{
                "ruleId": f.rule,
                "ruleIndex": index.get(f.rule, -1),
                "level": "error",
                "message": {"text": f.message},
                "locations": [{"physicalLocation": {
                    "artifactLocation": {"uri": f.path},
                    "region": {"startLine": f.line}}}],
            } for f in findings],
        }],
    }
