"""dmlclint for the PyTorch port — the project's multi-pass AST static
analyzer, run as the port's own lint gate over ``dmlc_core_tpu_torch/``
and ``chip_smoke.py``.

The passes are the reference package's, with the package's paths; two
are redesigned for torch:

- :mod:`.lockset`   — threading discipline: per-attribute lock inference for
  lock-owning classes, exception ferrying out of thread targets, and
  join-on-destroy for non-daemon threads.
- :mod:`.purity`    — torch hot-path hygiene: host syncs (``.item()``,
  ``.cpu()``, ``torch.cuda.synchronize()``, data-sized ops, ``float()`` of
  a tensor) and host branches in device-layer loops, autograd functions
  and compiled or graph-captured callables; impure and telemetry calls in
  the latter.
- :mod:`.resources` — unclosed file/socket/tempfile handles in the io layer,
  temp dirs without a ``finally`` cleanup, and the no-``print`` style rule.
- :mod:`.graph`     — the whole-repo module/call-graph core the project
  passes share: import resolution, symbol tables, cross-module call edges,
  partial/alias/annotation following.
- :mod:`.deadlock`  — interprocedural lock-order cycles and unbounded
  blocking calls made while holding a lock, over the project graph.
- :mod:`.contracts` — cross-artifact drift: every ``DMLC_*`` knob,
  ``dmlc_*`` metric, span name and fault site in code diffed against the
  tables of the port's ``CATALOG.md`` (knob/span/rule tables generated
  via ``--emit-knob-catalog`` / ``--emit-span-catalog`` /
  ``--emit-rule-catalog``).
- :mod:`.dataflow`  — the statement-level CFG (with exception edges) +
  forward may-analysis engine under the interprocedural passes.
- :mod:`.escape`    — exception-path resource escape: acquired shm
  segments / sockets / executors / mmaps / fds / temp dirs tracked along
  every path (including raise edges and failed ``__init__``s) with
  ownership-transfer modeling through the call graph.
- :mod:`.torchbound` — host<->card boundary discipline: copies to the card
  outside the ``_accounted_place`` wrapper, float casts re-inflating the
  narrow wire, and compiled callables, CUDA graphs or kernel libraries
  rebuilt per call.
- :mod:`.races` / :mod:`.wiretaint` — Eraser-style races over thread
  roots; wire-decoded values reaching allocation sizes and paths.
- :mod:`.baseline`  — the ratchet: findings are keyed
  ``<file>:<rule>:<symbol>`` against the committed ``baseline.json`` beside
  this package; new findings fail, baselined ones carry their reason.

Run with ``python -m dmlc_core_tpu_torch.analysis``; see CATALOG.md.
Standard library only, so the gate needs neither torch nor numpy.
"""

from dmlc_core_tpu_torch.analysis.driver import (ALL_RULES, Finding,
                                                 analyze_path, analyze_source,
                                                 main)

# __all__ rather than a noqa comment: pyflakes honors __all__ but not
# flake8-style noqa
__all__ = ["ALL_RULES", "Finding", "analyze_path", "analyze_source", "main"]
