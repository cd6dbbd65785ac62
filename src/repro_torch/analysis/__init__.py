# Static analysis & invariant gating for the port's tick.
"""``repro_torch.analysis`` — machine-checked structural invariants of the
torch port (the counterpart of ``repro.analysis``).

The port's scale claims rest on properties of what one tick *does*, not
just on its values: the tick must not read device data on the host (and,
on the card, should capture in a CUDA graph), its int32 state must wrap
at fleet horizons only where the baseline says, its op trace and kernel
launches must be constant in tenants and pages, and a rollout's state
must stay the same size tick over tick. torch has no jaxpr, so "the
traced program" is the op trace of one call (``walk.record``, a
``TorchDispatchMode``), plus the kernel wrappers' launch counters:

  walk         — the recorder: aten ops, dtypes, the port frame of each,
                 host reads, sync warnings, kernel launches.
  interval     — the interval algebra and its shadow over aten ops.
  op_audit     — purity, dtype, overflow, donation and launch passes, and
                 the CUDA-graph capture probe (a child process).
  constancy    — the shared "op trace invariant under parameter sweep"
                 harness (op count + op histogram + launches).
  lint         — AST rules for tick code (no Python loops over tenants
                 in core/, no host numpy or host reads inside tick
                 closures, seam keywords default to None).
  targets      — the real audit targets: the unified tick (4 policy modes
                 x both ownership providers, four hotness providers), the
                 scale point, the fleet chunk, the eight kernel wrappers,
                 and on the card the kernel-backed tick, also at C1's size.
  fixtures     — known-bad programs each pass must flag.

CLI: ``python -m repro_torch.analysis`` (see ``--help``); ``--gate`` fails
on any finding not in the committed baseline (``analysis/baseline.json``).
Entry points default to ``device="cuda"`` and raise without a card;
``--device cpu`` runs on the CPU. Nothing here imports jax or ``repro``.
"""
from repro_torch.analysis.constancy import (OpSignature, assert_op_constant,
                                            check_constant, op_signature,
                                            signature_of)
from repro_torch.analysis.findings import Finding, Report
from repro_torch.analysis.lint import lint_paths, lint_source
from repro_torch.analysis.op_audit import (donation_pass, dtype_pass,
                                           overflow_pass, purity_pass,
                                           steady_memory_pass)
from repro_torch.analysis.walk import OpTrace, record

__all__ = [
    "Finding", "Report",
    "OpSignature", "op_signature", "signature_of", "assert_op_constant",
    "check_constant",
    "OpTrace", "record",
    "purity_pass", "dtype_pass", "overflow_pass", "donation_pass",
    "steady_memory_pass",
    "lint_paths", "lint_source",
]
