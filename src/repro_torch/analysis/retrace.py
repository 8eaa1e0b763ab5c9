"""REP401/REP402: recompile hazards around ``torch.compile``, the
counterpart of ``repro.analysis.retrace`` (``jax.jit``).

* ``REP401`` — an inner function handed to ``torch.compile`` (as an
  argument, or as a decorator of a nested ``def``) closes over a parameter
  of its enclosing function instead of taking it as an argument. Dynamo
  guards on the captured object: every new tensor there recompiles, or, if
  the guard holds, a cached graph silently serves stale data.
* ``REP402`` — a compiled function takes a Python ``float`` parameter
  (annotated ``float`` or defaulting to a float literal). Dynamo
  specializes on Python scalars, so every distinct learning rate or
  tolerance compiles anew: pass it as a 0-d tensor or fold it into a
  config.

Conventionally static names (``self``, ``cfg``/``config`` objects, ``*_fn``
callables) are exempt from REP401: closing over static config is how the
repo keys its caches.
"""

from __future__ import annotations

import ast

from repro_torch.analysis.base import Diagnostic, dotted_name, final_attr

_STATIC_NAMES = {"self", "cls", "fn", "f"}
_STATIC_SUFFIXES = ("_fn", "cfg", "config", "_opts", "_options")


def _is_static_name(name: str) -> bool:
    return name in _STATIC_NAMES or name.endswith(_STATIC_SUFFIXES)


def _param_names(fn) -> list[str]:
    args = fn.args
    return [
        a.arg
        for a in (
            list(args.posonlyargs) + list(args.args) + list(args.kwonlyargs)
        )
    ]


def _is_compile(node: ast.expr) -> bool:
    """``torch.compile`` itself, or a call of it (``torch.compile(...)``
    as a decorator factory)."""
    if isinstance(node, ast.Call):
        node = node.func
    return dotted_name(node) == "torch.compile"


def _compiled_names(scope) -> set[str]:
    """Names of functions that ``scope`` hands to ``torch.compile``."""
    out: set[str] = set()
    for node in ast.walk(scope):
        if isinstance(node, ast.Call) and _is_compile(node.func):
            for arg in list(node.args) + [kw.value for kw in node.keywords]:
                if isinstance(arg, ast.Name):
                    out.add(arg.id)
    return out


def _decorated(fn) -> bool:
    return any(_is_compile(d) for d in fn.decorator_list)


def _float_params(fn) -> list[str]:
    args = list(fn.args.posonlyargs) + list(fn.args.args)
    defaults = [None] * (len(args) - len(fn.args.defaults)) + list(
        fn.args.defaults)
    pairs = list(zip(args, defaults)) + list(
        zip(fn.args.kwonlyargs, fn.args.kw_defaults))
    return [
        a.arg
        for a, d in pairs
        if (a.annotation is not None and final_attr(a.annotation) == "float")
        or (isinstance(d, ast.Constant) and isinstance(d.value, float))
    ]


def _captured(outer, inner) -> list[str]:
    """Non-static parameters of ``outer`` that ``inner`` reads without
    binding them itself."""
    outer_params = {p for p in _param_names(outer) if not _is_static_name(p)}
    inner_locals = set(_param_names(inner))
    for sub in ast.walk(inner):
        if isinstance(sub, (ast.Assign, ast.AugAssign, ast.AnnAssign)):
            targets = sub.targets if isinstance(sub, ast.Assign) else [
                sub.target]
            for t in targets:
                inner_locals |= {n.id for n in ast.walk(t)
                                 if isinstance(n, ast.Name)}
    return sorted({
        n.id
        for n in ast.walk(inner)
        if isinstance(n, ast.Name)
        and isinstance(n.ctx, ast.Load)
        and n.id in outer_params
        and n.id not in inner_locals
    })


def check(tree: ast.AST, source: str, path: str) -> list[Diagnostic]:
    diags: list[Diagnostic] = []
    functions = [n for n in ast.walk(tree)
                 if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef))]
    compiled_anywhere = _compiled_names(tree)

    # REP401: compiled inner functions capturing enclosing parameters.
    for outer in functions:
        passed = _compiled_names(outer)
        for inner in ast.walk(outer):
            if inner is outer or not isinstance(
                    inner, (ast.FunctionDef, ast.AsyncFunctionDef)):
                continue
            if inner.name not in passed and not _decorated(inner):
                continue
            captured = _captured(outer, inner)
            if captured:
                diags.append(
                    Diagnostic(
                        path,
                        inner.lineno,
                        "REP401",
                        f"compiled `{inner.name}` closes over data "
                        f"parameter(s) {', '.join(captured)} of "
                        f"`{outer.name}`; pass them as arguments, so the "
                        "compiled graph guards on shapes, not on one object",
                    )
                )

    # REP402: compiled functions keyed on Python floats.
    for fn in functions:
        if not (_decorated(fn) or fn.name in compiled_anywhere):
            continue
        for name in _float_params(fn):
            diags.append(
                Diagnostic(
                    path,
                    fn.lineno,
                    "REP402",
                    f"compiled `{fn.name}` takes Python float `{name}`; "
                    "torch.compile specializes on it, so every distinct "
                    "value recompiles: pass a 0-d tensor or fold it into "
                    "a config",
                )
            )
    return diags
