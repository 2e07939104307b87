"""Project-native static analysis (``stc lint``) of the port: the JAX
package's ``analysis`` layers 1 and 4 copied, and its layer 2 read for
torch, pointed at ``spark_text_clustering_tpu_torch/``:

  * **AST invariant checkers** (``ast_rules``) — named STC0xx/STC1xx
    rules over the package source: sleep routing, exception taxonomy,
    fault-site and metric-name registries, host-sync freedom of the
    callables the dispatch layer instruments, persistence determinism,
    lock discipline, and a generic-Python tier (unused imports, logging
    f-strings).
  * **protocol audit** (``protocol_audit`` + ``protocol_sites``, via
    ``lint --protocol``) — STC300-305 over the fleet's threads and
    shared files.

  * **trace audit** (``jaxpr_audit`` over the ``entrypoints`` registry,
    on by default, ``--no-jaxpr`` skips it) — STC200-205: each
    registered entry point called once on CPU tensors under torch's
    dispatch and function modes.
  * **scale audit** (``scale_audit``, via ``lint --scale``) — STC210-215:
    each entry point called at its declared scale shapes (k=500, V=10M,
    the pow2 bucket grids) on fake tensors, against the ``nvidia-h100``
    memory budget and the committed ``analysis/scale_baseline.json``.

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
