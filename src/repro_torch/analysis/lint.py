"""AST-level lint for tick code (torch port of ``repro/analysis/lint.py``).

The op-trace passes see what one call *did*; the lint catches patterns
that shape what every call *will do*:

  tenant-loop   — Python ``for _ in range(<T-like>)`` in ``core/``
                  issues ops linearly in tenant count, destroying the
                  constancy invariant. (Builder-time host loops live in
                  the committed baseline with their reasons.)
  np-in-graph   — ``np.`` calls inside a closure nested in a tick/
                  ownership/strategy builder run on the host every call,
                  and so do ``.item()``, ``.tolist()``, ``.numpy()`` and
                  ``.cpu()`` there: each is a host round trip per tick in
                  torch. Tick code stays in torch ops on the device.
  seam-default  — on builder functions, optional seam parameters
                  (``detector=``, ``attrib=``, ``detect=``) must default
                  to ``None`` so every engine composes without dragging
                  in the observability subtrees.

Slugs are ``rule:qualname`` (never line numbers) so the baseline
survives unrelated edits to the same file.
"""
from __future__ import annotations

import ast
import os
from typing import List, Optional, Sequence

from repro_torch.analysis.findings import Finding, Report

# loop bounds that smell like a tenant count
_TENANT_NAMES = {"T", "n_tenants", "num_tenants", "tenants"}
# builder functions whose nested closures run every tick
_BUILDER_PREFIXES = ("make_",)
_BUILDER_SUFFIXES = ("_ownership", "_strategy", "_tick", "_provider")
# seam keywords that must default to None
_SEAM_PARAMS = {"detector", "attrib", "detect", "attribution"}
# tensor methods that copy device data to the host
_HOST_READS = {"item", "tolist", "numpy", "cpu"}


def _names_in(node: ast.AST) -> set:
    return {n.id for n in ast.walk(node) if isinstance(n, ast.Name)} | \
           {n.attr for n in ast.walk(node) if isinstance(n, ast.Attribute)}


def _is_builder(name: str) -> bool:
    return name.startswith(_BUILDER_PREFIXES) or \
        name.endswith(_BUILDER_SUFFIXES)


class _Linter(ast.NodeVisitor):
    def __init__(self, target: str, in_core: bool):
        self.target = target
        self.in_core = in_core
        self.findings: List[Finding] = []
        self.stack: List[str] = []          # enclosing function names
        self.seen_slugs = {}

    # ------------------------------------------------------------ helpers
    def _qual(self) -> str:
        return ".".join(self.stack) or "<module>"

    def _add(self, rule: str, message: str, qual: Optional[str] = None):
        base = f"{rule}:{qual or self._qual()}"
        k = self.seen_slugs.get(base, 0)
        self.seen_slugs[base] = k + 1
        slug = base if k == 0 else f"{base}#{k}"
        self.findings.append(Finding("lint", self.target, slug, message))

    # ------------------------------------------------------------- visits
    def visit_FunctionDef(self, node: ast.FunctionDef):
        self._check_seam_defaults(node)
        self.stack.append(node.name)
        self.generic_visit(node)
        self.stack.pop()

    visit_AsyncFunctionDef = visit_FunctionDef

    def _check_seam_defaults(self, node: ast.FunctionDef):
        # The seam contract binds *builders* (make_tick, make_churn_tick,
        # ...): their seams must default to None so engines compose
        # without observability subtrees. Plain runner flags (run_fleet's
        # detect=True toggle) are API surface, not graph seams.
        if not _is_builder(node.name):
            return
        args = node.args
        named = list(args.args) + list(args.kwonlyargs)
        defaults = ([None] * (len(args.args) - len(args.defaults))
                    + list(args.defaults) + list(args.kw_defaults))
        for arg, default in zip(named, defaults):
            if arg.arg not in _SEAM_PARAMS:
                continue
            ok = (isinstance(default, ast.Constant)
                  and default.value is None)
            if not ok:
                self._add(
                    "seam-default",
                    f"seam parameter `{arg.arg}` of "
                    f"{self._qual()}.{node.name} must default to None "
                    f"(engines compose without observability subtrees)",
                    qual=f"{self._qual()}.{node.name}.{arg.arg}"
                    if self.stack else f"{node.name}.{arg.arg}")

    def visit_For(self, node: ast.For):
        if self.in_core and self.stack:
            it = node.iter
            if (isinstance(it, ast.Call) and isinstance(it.func, ast.Name)
                    and it.func.id in ("range", "enumerate")):
                bound_names = set()
                for a in it.args:
                    bound_names |= _names_in(a)
                if bound_names & _TENANT_NAMES:
                    self._add(
                        "tenant-loop",
                        f"Python loop over a tenant-count bound "
                        f"({sorted(bound_names & _TENANT_NAMES)}) in "
                        f"{self._qual()} — issues ops linearly in T; use "
                        f"batched tensor ops")
        self.generic_visit(node)

    def _in_closure(self) -> bool:
        return (len(self.stack) >= 2
                and any(_is_builder(s) for s in self.stack[:-1]))

    def visit_Attribute(self, node: ast.Attribute):
        # np.* inside a closure nested in a builder: host math every call
        if (isinstance(node.value, ast.Name) and node.value.id == "np"
                and self._in_closure()):
            self._add(
                "np-in-graph",
                f"`np.{node.attr}` inside tick closure {self._qual()} — "
                f"host numpy in tick code runs on the host every call; use "
                f"torch ops on the device")
        self.generic_visit(node)

    def visit_Call(self, node: ast.Call):
        # .item()/.tolist()/.numpy()/.cpu() inside a closure nested in a
        # builder: a host round trip every call
        if (isinstance(node.func, ast.Attribute)
                and node.func.attr in _HOST_READS and self._in_closure()):
            self._add(
                "np-in-graph",
                f"`.{node.func.attr}()` inside tick closure {self._qual()} "
                f"— copies device data to the host every call (a sync per "
                f"tick)")
        self.generic_visit(node)


def lint_source(src: str, target: str, in_core: bool = False,
                ) -> List[Finding]:
    """Lint one source blob. ``target`` becomes the finding target (the
    repo-relative path for real files)."""
    tree = ast.parse(src)
    linter = _Linter(target, in_core=in_core)
    linter.visit(tree)
    return linter.findings


def lint_paths(paths: Sequence[str], report: Report,
               root: Optional[str] = None) -> None:
    """Lint .py files (directories recurse); findings append to report."""
    root = root or os.getcwd()

    def handle(path: str):
        rel = os.path.relpath(path, root)
        in_core = f"core{os.sep}" in rel or rel.startswith("core")
        with open(path) as fh:
            src = fh.read()
        try:
            report.extend(lint_source(src, rel.replace(os.sep, "/"),
                                      in_core=in_core))
        except SyntaxError as e:  # pragma: no cover
            report.add(Finding("lint", rel.replace(os.sep, "/"),
                               "syntax-error", str(e)))

    for p in paths:
        if os.path.isdir(p):
            for dirpath, _dirs, files in os.walk(p):
                for f in sorted(files):
                    if f.endswith(".py"):
                        handle(os.path.join(dirpath, f))
        elif p.endswith(".py"):
            handle(p)
