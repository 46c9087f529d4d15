"""slt-lint, slt-check and slt-crash over the PyTorch port (counterpart
of ``split_learning_tpu/analysis``).

Run as ``python -m split_learning_tpu_torch.analysis [paths...]`` (the
static rules; ``--check`` explores the concurrency scenarios of
scenarios.py over the port's real runtime objects, ``--crash`` adds the
crash-restart scenarios). The rule catalog lives in rules.py (SLT001-005,
011-015) and rules_torch.py (SLT006-010); the dynamic counterpart is the
lock watchdog of :mod:`split_learning_tpu_torch.obs.locks`, whose
constructors are also the model checker's seam. Stdlib-only by design,
scenarios.py (numpy, torch and the runtime, loaded only under
``--check``) aside.
"""

from split_learning_tpu_torch.analysis.engine import Finding, lint_paths, main

__all__ = ["Finding", "lint_paths", "main"]
