"""REP301: lock discipline for declared GUARDED_BY attributes (a copy of
``repro.analysis.locks``; the port's tables are in ``serving/maps.py``,
``gateway.py`` and ``fleet.py``).

A module declares its invariants with a literal at module scope::

    GUARDED_BY = {
        "MapService": {"_state": "_lock", "_unit_labels": "_lock"},
        "MapGateway": {"_queues": "_cond"},
    }

Within each named class, every ``self.<attr>`` read or write of a guarded
attribute must sit lexically inside a matching ``with self.<lock>:`` block
(the lexical with-stack is tracked through nested closures, so worker
closures defined under the lock are fine). ``__init__``/``__new__`` are
exempt — construction happens-before any sharing.

Deliberate unlocked access (e.g. a snapshot read where torn reads are
acceptable, or a method documented as called-with-lock-held) is annotated
``# lint: unlocked-ok(reason)`` on the flagged line.
"""

from __future__ import annotations

import ast

from repro_torch.analysis.base import Diagnostic

_EXEMPT_METHODS = {"__init__", "__new__", "__post_init__"}


def _find_guarded_by(tree: ast.AST) -> dict[str, dict[str, str]]:
    for node in ast.walk(tree):
        if isinstance(node, ast.Assign):
            for t in node.targets:
                if isinstance(t, ast.Name) and t.id == "GUARDED_BY":
                    try:
                        value = ast.literal_eval(node.value)
                    except (ValueError, SyntaxError):
                        return {}
                    if isinstance(value, dict):
                        return value
    return {}


class _ClassChecker(ast.NodeVisitor):
    """Check one class's methods against its guarded-attribute map."""

    def __init__(
        self, cls_name: str, guards: dict[str, str], path: str
    ) -> None:
        self.cls_name = cls_name
        self.guards = guards
        self.path = path
        self.diags: list[Diagnostic] = []
        self._held: list[str] = []
        self._method: str | None = None

    def check_class(self, node: ast.ClassDef) -> list[Diagnostic]:
        for item in node.body:
            if isinstance(item, (ast.FunctionDef, ast.AsyncFunctionDef)):
                if item.name in _EXEMPT_METHODS:
                    continue
                self._method = item.name
                self._held = []
                for stmt in item.body:
                    self.visit(stmt)
        return self.diags

    @staticmethod
    def _self_attr(node: ast.AST) -> str | None:
        if (
            isinstance(node, ast.Attribute)
            and isinstance(node.value, ast.Name)
            and node.value.id == "self"
        ):
            return node.attr
        return None

    def visit_With(self, node: ast.With) -> None:
        entered: list[str] = []
        for item in node.items:
            attr = self._self_attr(item.context_expr)
            if attr is not None:
                entered.append(attr)
            self.visit(item.context_expr)
        self._held.extend(entered)
        for stmt in node.body:
            self.visit(stmt)
        for _ in entered:
            self._held.pop()

    visit_AsyncWith = visit_With

    def visit_Attribute(self, node: ast.Attribute) -> None:
        attr = self._self_attr(node)
        if attr is not None:
            lock = self.guards.get(attr)
            if lock is not None and lock not in self._held:
                self.diags.append(
                    Diagnostic(
                        self.path,
                        node.lineno,
                        "REP301",
                        f"`self.{attr}` (guarded by `self.{lock}` in "
                        f"{self.cls_name}) accessed outside `with "
                        f"self.{lock}` in `{self._method}`",
                    )
                )
        self.generic_visit(node)


def check(tree: ast.AST, source: str, path: str) -> list[Diagnostic]:
    guarded = _find_guarded_by(tree)
    if not guarded:
        return []
    diags: list[Diagnostic] = []
    for node in ast.walk(tree):
        if isinstance(node, ast.ClassDef) and node.name in guarded:
            checker = _ClassChecker(node.name, guarded[node.name], path)
            diags.extend(checker.check_class(node))
    return diags
