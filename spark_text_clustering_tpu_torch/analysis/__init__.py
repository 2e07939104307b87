"""Project-native static analysis (``stc lint``) of the port, a copy of the
JAX package's ``analysis`` layers 1 and 4 pointed at
``spark_text_clustering_tpu_torch/``:

  * **AST invariant checkers** (``ast_rules``) — named STC0xx/STC1xx
    rules over the package source: sleep routing, exception taxonomy,
    fault-site and metric-name registries, host-sync freedom of the
    callables the dispatch layer instruments, persistence determinism,
    lock discipline, and a generic-Python tier (unused imports, logging
    f-strings).
  * **protocol audit** (``protocol_audit`` + ``protocol_sites``, via
    ``lint --protocol``) — STC300-305 over the fleet's threads and
    shared files.

The trace layers (the jaxpr audit's analogue and ``lint --scale``) are
ROADMAP.md queue 1 item 10c; the verb exits 2 when asked for them.

Waivers: inline ``# stc-lint: disable=RULE -- reason`` pragmas or the
port's committed ``analysis/lint_baseline.json`` allowlist; both require
a reason string.  Nothing here imports jax, makes a CUDA context or
builds a kernel library.
"""

from .findings import Baseline, Finding, apply_waivers
from .cli import add_lint_subparser, run_lint

__all__ = [
    "Finding",
    "Baseline",
    "apply_waivers",
    "run_lint",
    "add_lint_subparser",
]
