"""Static determinism lint for the Clonos causal-services contract.

``python -m clonos_tpu_torch lint [paths...]`` — see ``core`` for the
rule registry, ``nondet``/``tracesafe``/``concurrency``/``markers``/
``overlapwindow`` for the rule families, ``waivers`` for exemption
syntax, ``runner`` for the lint run itself. The package imports the
standard library only: it runs on any machine, with or without torch.

Importing this package registers every built-in rule; external rules
register the same way (subclass ``Rule``, decorate with
``register_rule``) before calling ``run_lint``.
"""

from clonos_tpu_torch.lint.core import (ERROR, WARNING, RULES, FileContext,
                                        Finding, Rule, all_rules,
                                        register_rule, rule_names)
# Rule modules register themselves on import — order is alphabetical
# and irrelevant; each touches only the registry.
from clonos_tpu_torch.lint import concurrency  # noqa: F401
from clonos_tpu_torch.lint import markers      # noqa: F401
from clonos_tpu_torch.lint import nondet       # noqa: F401
from clonos_tpu_torch.lint import overlapwindow  # noqa: F401
from clonos_tpu_torch.lint import tracesafe    # noqa: F401
from clonos_tpu_torch.lint.runner import (DEFAULT_WAIVER_FILE, LintResult,
                                          format_json, format_text, run_lint)

__all__ = [
    "ERROR", "WARNING", "RULES", "FileContext", "Finding", "Rule",
    "all_rules", "register_rule", "rule_names",
    "DEFAULT_WAIVER_FILE", "LintResult", "format_json", "format_text",
    "run_lint",
]
