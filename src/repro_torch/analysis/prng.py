"""REP201/REP202: draw-source discipline, the counterpart of
``repro.analysis.prng`` on the port's draw sources (``repro_torch.draws``).

* ``REP201`` — a draw source rebuilt in one function with the same
  arguments as one built before it: ``GeneratorDraws(seed)``,
  ``GeneratorDraws.for_step(seed, step)``, ``parent.fold_in(x)`` or
  ``generator.manual_seed(seed)``. Each is a function of its arguments
  alone, so the second hands out the first one's numbers again: two
  correlated streams, the counterpart of consuming one JAX key twice.
  ``spawn()`` and ``split()`` advance their parent, so two calls give two
  sources and are not findings.
* ``REP202`` — a constant seed in library (non-test) code:
  ``torch.manual_seed(<int>)``, ``torch.Generator().manual_seed(<int>)``
  or ``GeneratorDraws(<int>)``. A constant bakes one stream into the
  library and makes "seedable" runs lie; seeds are passed in as
  parameters. Tests, examples and fixtures may seed with constants.

The scan is JAX's: per function body (nested functions on their own), by
source position, with ``if``/``else`` arms scanned as exclusive branches; a
reassignment of any name a construction read clears it.
"""

from __future__ import annotations

import ast

from repro_torch.analysis.base import Diagnostic, final_attr

_FOLDS = {"fold_in"}
_SEEDERS = {"for_step", "manual_seed"}
_SOURCE = "GeneratorDraws"


def _is_testish(path: str) -> bool:
    parts = path.replace("\\", "/").split("/")
    return any(p in {"tests", "test", "fixtures", "examples"} for p in parts) or (
        parts and parts[-1].startswith(("test_", "conftest"))
    )


def _construction(node: ast.Call) -> tuple[str, frozenset[str]] | None:
    """(key, names read) of a draw-source construction, else None. The key
    is the call's text with its arguments: two equal keys build equal
    sources while none of the names changed."""
    name = final_attr(node.func)
    if name == _SOURCE or name in _SEEDERS:
        text = ast.unparse(ast.Call(ast.Name(name, ast.Load()), node.args,
                                    node.keywords))
    elif name in _FOLDS and isinstance(node.func, ast.Attribute):
        text = ast.unparse(node)
    else:
        return None
    if not (node.args or node.keywords):
        return None
    names = frozenset(n.id for n in ast.walk(node) if isinstance(n, ast.Name))
    return text, names


def _constant_seed(node: ast.Call) -> int | None:
    name = final_attr(node.func)
    if name not in {"manual_seed", _SOURCE}:
        return None
    seed = node.args[0] if node.args else next(
        (k.value for k in node.keywords if k.arg == "seed"), None)
    if isinstance(seed, ast.Constant) and isinstance(seed.value, int) \
            and not isinstance(seed.value, bool):
        return seed.value
    return None


class _FunctionScanner:
    """Branch-aware scan of one function body for rebuilt sources.

    State is ``{key: (line of the first construction, names it read)}``.
    ``if``/``else`` arms are mutually exclusive, so each is scanned against
    a copy of the incoming state and the results merged (union); assigning
    a name drops every construction that read it. Nested functions get
    their own scanner.
    """

    def __init__(self, fn, path: str) -> None:
        self.fn = fn
        self.path = path
        self.diags: list[Diagnostic] = []

    def run(self) -> list[Diagnostic]:
        state: dict[str, tuple[int, frozenset[str]]] = {}
        for stmt in self.fn.body:
            self._scan_stmt(stmt, state)
        return self.diags

    # -- expressions ------------------------------------------------------
    def _scan_expr(self, node: ast.AST | None, state) -> None:
        if node is None:
            return
        for sub in ast.walk(node):
            if not isinstance(sub, ast.Call):
                continue
            found = _construction(sub)
            if found is None:
                continue
            key, names = found
            first = state.get(key)
            if first is not None:
                self.diags.append(
                    Diagnostic(
                        self.path,
                        sub.lineno,
                        "REP201",
                        f"draw source `{key}` already built on line "
                        f"{first[0]} with the same arguments; both hand out "
                        "the same numbers (correlated streams)",
                    )
                )
            else:
                state[key] = (sub.lineno, names)

    @staticmethod
    def _reset_targets(target: ast.AST, state) -> None:
        assigned = {n.id for n in ast.walk(target) if isinstance(n, ast.Name)}
        for key in [k for k, (_, names) in state.items() if names & assigned]:
            del state[key]

    # -- statements -------------------------------------------------------
    def _scan_body(self, body, state) -> None:
        for stmt in body:
            self._scan_stmt(stmt, state)

    @staticmethod
    def _merge(into, *branches) -> None:
        merged: dict[str, tuple[int, frozenset[str]]] = {}
        for b in [dict(b) for b in branches]:
            for k, v in b.items():
                merged[k] = min(merged.get(k, v), v)
        into.clear()
        into.update(merged)

    def _scan_stmt(self, stmt: ast.stmt, state) -> None:
        if isinstance(stmt, (ast.FunctionDef, ast.AsyncFunctionDef)):
            return  # scanned independently
        if isinstance(stmt, ast.Assign):
            self._scan_expr(stmt.value, state)
            for t in stmt.targets:
                self._reset_targets(t, state)
        elif isinstance(stmt, (ast.AnnAssign, ast.AugAssign)):
            self._scan_expr(stmt.value, state)
            self._reset_targets(stmt.target, state)
        elif isinstance(stmt, ast.If):
            self._scan_expr(stmt.test, state)
            then_state = dict(state)
            else_state = dict(state)
            self._scan_body(stmt.body, then_state)
            self._scan_body(stmt.orelse, else_state)
            self._merge(state, then_state, else_state)
        elif isinstance(stmt, (ast.For, ast.AsyncFor)):
            self._scan_expr(stmt.iter, state)
            self._reset_targets(stmt.target, state)
            # One pass through the body; the loop variable changes the
            # arguments from one iteration to the next.
            self._scan_body(stmt.body, state)
            self._scan_body(stmt.orelse, state)
        elif isinstance(stmt, ast.While):
            self._scan_expr(stmt.test, state)
            self._scan_body(stmt.body, state)
            self._scan_body(stmt.orelse, state)
        elif isinstance(stmt, (ast.With, ast.AsyncWith)):
            for item in stmt.items:
                self._scan_expr(item.context_expr, state)
            self._scan_body(stmt.body, state)
        elif isinstance(stmt, ast.Try):
            self._scan_body(stmt.body, state)
            for handler in stmt.handlers:
                h_state = dict(state)
                self._scan_body(handler.body, h_state)
                self._merge(state, state, h_state)
            self._scan_body(stmt.orelse, state)
            self._scan_body(stmt.finalbody, state)
        elif isinstance(stmt, ast.Match):
            for case in stmt.cases:
                c_state = dict(state)
                self._scan_body(case.body, c_state)
                self._merge(state, state, c_state)
        else:
            for sub in ast.iter_child_nodes(stmt):
                if isinstance(sub, ast.expr):
                    self._scan_expr(sub, state)


def check(tree: ast.AST, source: str, path: str) -> list[Diagnostic]:
    diags: list[Diagnostic] = []
    testish = _is_testish(path)
    for node in ast.walk(tree):
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            diags.extend(_FunctionScanner(node, path).run())
        if not testish and isinstance(node, ast.Call):
            seed = _constant_seed(node)
            if seed is not None:
                diags.append(
                    Diagnostic(
                        path,
                        node.lineno,
                        "REP202",
                        f"hardcoded seed {seed} in library code "
                        f"(`{final_attr(node.func)}({seed})`); plumb a seed "
                        "parameter instead",
                    )
                )
    return diags
