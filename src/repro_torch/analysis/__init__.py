"""Correctness tooling for the port's collective stack: the runtime
CommSanitizer (port of :mod:`repro.analysis.sanitizer`).  The static
comm-lint pass is not ported: the reference's ``tools/comm_lint.py`` runs
over ``src/repro_torch`` as it is."""

from . import sanitizer  # noqa: F401
from .sanitizer import (  # noqa: F401
    CommSanitizer,
    Diagnostic,
    SanitizerError,
    SanitizerReport,
    activate,
    deactivate,
    ensure_active,
    get_active,
    scoped,
)
