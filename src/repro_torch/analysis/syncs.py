"""REP101 for the port: host syncs in hot loops, the counterpart of
``repro.analysis.tracer``.

In JAX the hazard is Python control flow on a traced value. Eager PyTorch
has no tracer; its hazard is the host sync. Reading a CUDA tensor's value
on the host waits for every kernel queued before it and drains the launch
queue, so a sync inside a training or search loop costs a host round trip
every iteration, and the card idles while the host catches up. In hot code
the check flags:

* ``.item()``, ``.tolist()``, ``.cpu()``, ``.numpy()`` and ``.to("cpu")``
  of a tensor;
* ``bool()``, ``int()`` and ``float()`` of a tensor;
* an ``if``, ``while``, ``assert`` or conditional expression whose test is
  a tensor (``x is None`` and ``isinstance`` tests are exempt);
* ``torch.cuda.synchronize()``.

*Hot code* is a loop's body (and a ``while`` loop's test, and a
comprehension), and the whole body of every function that hot code calls or
names as a value (a ``wave_fn=`` seam), to a fixpoint. Calls are followed
within a module and, when the driver checks several modules together
(``project_hot``), across them through their imports.

*A tensor* is what the check can see to be one: a parameter (not one of
the conventionally static names, and not annotated with a type other than
a tensor or a ``...State`` of tensors), the result of a ``torch.`` call, a
method of a tensor (but not its metadata: ``shape``, ``numel()``, ...), an
expression over a tensor, and a call with a tensor argument, except a call
of a function of the same module, which gives a tensor where its return
annotation names one or, unannotated, where one of its ``return``
statements does. ``numpy`` and ``math`` results, and the results of the
syncs themselves, are host values.

*Syncs by design are declared, not flagged*: a module-level table

    SYNCS_BY_DESIGN = {"sharded_cascade": "why its reads are needed"}

names functions (by qualified name, ``outer.inner`` for a nested one) whose
host reads are part of the design, with the functions nested in them, and
``# lint: sync-ok(reason)`` on the flagged line declares one read. A sync
that is neither is a finding; known ones are kept in the baseline
(``analysis-baseline-torch.json``) until they are removed.
"""

from __future__ import annotations

import ast
from dataclasses import dataclass, field

from repro_torch.analysis.base import Diagnostic, dotted_name, final_attr

#: methods that read a tensor back to the host
_SYNC_METHODS = {"item", "tolist", "cpu", "numpy"}
#: builtins that read a tensor's value on the host
_SYNC_BUILTINS = {"bool", "int", "float"}

# Parameter names that by repo convention hold static Python config or
# host objects, not tensors.
_STATIC_PARAM_NAMES = {"self", "cls", "fn", "f", "body_fn", "cond_fn",
                       "device", "dtype", "mesh", "axis", "plan"}
_STATIC_PARAM_SUFFIXES = ("_fn", "cfg", "config", "_opts", "_options")

# Tensor metadata: host values, no sync.
_STATIC_ATTRS = {"shape", "ndim", "dtype", "device", "is_cuda", "layout",
                 "requires_grad", "itemsize"}
_HOST_METHODS = {"size", "dim", "numel", "nelement", "data_ptr",
                 "is_contiguous", "stride", "element_size", "get_device",
                 "is_floating_point", "storage_offset"} | _SYNC_METHODS

# Calls whose results live on the host.
_HOST_BUILTINS = {"len", "isinstance", "issubclass", "hasattr", "callable",
                  "type", "id", "range", "str", "repr", "print", "format"} \
    | _SYNC_BUILTINS
_HOST_ROOTS = {"np", "numpy", "math", "time", "os", "sys", "zlib", "json"}
_HOST_TORCH = {"device", "finfo", "iinfo", "Generator", "is_tensor",
               "get_default_dtype", "Size", "no_grad", "inference_mode",
               "manual_seed", "is_floating_point", "compile"}
_HOST_TORCH_MODULES = {"cuda", "backends", "distributed", "utils", "library"}

_DECLARATION = "SYNCS_BY_DESIGN"


def _is_static_param(name: str) -> bool:
    return name in _STATIC_PARAM_NAMES or name.endswith(
        _STATIC_PARAM_SUFFIXES)


def _holds_tensors(ann: ast.expr) -> bool:
    """An annotated parameter holds tensors when its annotation names a
    tensor or a ``...State`` (the port's NamedTuples of tensors)."""
    return any(isinstance(n, (ast.Name, ast.Attribute))
               and (final_attr(n) or "").endswith(("Tensor", "State"))
               for n in ast.walk(ann))


def param_taint(fn) -> set[str]:
    """Parameters treated as tensors: unannotated ones but the static
    names, and annotated ones whose annotation holds tensors."""
    args = fn.args
    out: set[str] = set()
    for a in (list(args.posonlyargs) + list(args.args)
              + list(args.kwonlyargs)
              + [x for x in (args.vararg, args.kwarg) if x is not None]):
        if _is_static_param(a.arg):
            continue
        if a.annotation is None or _holds_tensors(a.annotation):
            out.add(a.arg)
    return out


def _is_torch_value_call(func: ast.expr) -> bool | None:
    """True for a ``torch.`` call that makes a tensor, False for one that
    makes a host value, None for anything not rooted at ``torch``."""
    name = dotted_name(func)
    if name is None or not name.startswith("torch."):
        return None
    parts = name.split(".")
    if parts[1] in _HOST_TORCH_MODULES or parts[-1] in _HOST_TORCH:
        return False
    return True


# --------------------------------------------------------------- module index


@dataclass
class _Function:
    qualname: str
    node: ast.AST
    cls: str | None                  # the class a method belongs to
    parent: str | None               # the enclosing function's qualname


@dataclass
class ModuleIndex:
    """One module's functions, imports and call edges."""

    name: str
    path: str
    functions: dict[str, _Function] = field(default_factory=dict)
    imports: dict[str, tuple[str, str | None]] = field(default_factory=dict)
    #: (caller qualname or None, reference, lexically in a loop)
    edges: list[tuple[str | None, tuple, bool]] = field(default_factory=list)
    declared: dict[str, str] = field(default_factory=dict)


def module_name(path: str) -> str:
    """``src/repro_torch/core/afm.py`` -> ``repro_torch.core.afm``."""
    parts = path.replace("\\", "/").split("/")
    if "src" in parts:
        parts = parts[len(parts) - parts[::-1].index("src"):]
    parts[-1] = parts[-1][:-3] if parts[-1].endswith(".py") else parts[-1]
    if parts[-1] == "__init__":
        parts = parts[:-1]
    return ".".join(p for p in parts if p)


def _find_declared(tree: ast.AST) -> dict[str, str]:
    for node in getattr(tree, "body", []):
        if isinstance(node, ast.Assign) and any(
                isinstance(t, ast.Name) and t.id == _DECLARATION
                for t in node.targets):
            try:
                value = ast.literal_eval(node.value)
            except (ValueError, SyntaxError):
                return {}
            if isinstance(value, dict):
                return {str(k): str(v) for k, v in value.items()}
    return {}


class _Indexer(ast.NodeVisitor):
    """Collects functions, imports and call/reference edges of a module."""

    def __init__(self, index: ModuleIndex, is_package: bool) -> None:
        self.index = index
        self.is_package = is_package
        self._scopes: list[str] = []        # qualname parts
        self._funcs: list[str | None] = [None]
        self._cls: list[str | None] = [None]
        self._loop = 0

    # -- imports -----------------------------------------------------------
    def _package(self, level: int) -> str:
        parts = self.index.name.split(".")
        drop = level - 1 if self.is_package else level
        return ".".join(parts[:len(parts) - drop] if drop else parts)

    def visit_Import(self, node: ast.Import) -> None:
        for a in node.names:
            if a.asname:
                self.index.imports[a.asname] = (a.name, None)
            else:
                root = a.name.split(".")[0]
                self.index.imports[root] = (root, None)

    def visit_ImportFrom(self, node: ast.ImportFrom) -> None:
        base = node.module or ""
        if node.level:
            pkg = self._package(node.level)
            base = f"{pkg}.{base}" if base else pkg
        for a in node.names:
            self.index.imports[a.asname or a.name] = (base, a.name)

    # -- scopes ------------------------------------------------------------
    def _qual(self, name: str) -> str:
        return ".".join(self._scopes + [name])

    def visit_ClassDef(self, node: ast.ClassDef) -> None:
        for d in node.decorator_list:
            self.visit(d)
        self._scopes.append(node.name)
        self._cls.append(".".join(self._scopes))
        for stmt in node.body:
            self.visit(stmt)
        self._cls.pop()
        self._scopes.pop()

    def _function(self, node) -> None:
        for d in node.decorator_list:
            self.visit(d)
        qual = self._qual(node.name)
        cls = self._cls[-1] if self._funcs[-1] is None else None
        self.index.functions[qual] = _Function(qual, node, cls,
                                               self._funcs[-1])
        self._scopes.append(node.name)
        self._funcs.append(qual)
        self._cls.append(None)
        loop, self._loop = self._loop, 0
        for stmt in node.body:
            self.visit(stmt)
        self._loop = loop
        self._cls.pop()
        self._funcs.pop()
        self._scopes.pop()

    visit_FunctionDef = _function
    visit_AsyncFunctionDef = _function

    # -- loops -------------------------------------------------------------
    def visit_For(self, node) -> None:
        self.visit(node.target)
        self.visit(node.iter)
        self._loop += 1
        for stmt in node.body:
            self.visit(stmt)
        self._loop -= 1
        for stmt in node.orelse:
            self.visit(stmt)

    visit_AsyncFor = visit_For

    def visit_While(self, node: ast.While) -> None:
        self._loop += 1
        self.visit(node.test)
        for stmt in node.body:
            self.visit(stmt)
        self._loop -= 1
        for stmt in node.orelse:
            self.visit(stmt)

    def _comprehension(self, node) -> None:
        gens = node.generators
        self.visit(gens[0].iter)
        self._loop += 1
        for i, g in enumerate(gens):
            self.visit(g.target)
            if i:
                self.visit(g.iter)
            for cond in g.ifs:
                self.visit(cond)
        for part in ("elt", "key", "value"):
            if hasattr(node, part):
                self.visit(getattr(node, part))
        self._loop -= 1

    visit_ListComp = _comprehension
    visit_SetComp = _comprehension
    visit_GeneratorExp = _comprehension
    visit_DictComp = _comprehension

    # -- edges -------------------------------------------------------------
    def _ref(self, node: ast.expr) -> tuple | None:
        if isinstance(node, ast.Name):
            return ("name", node.id)
        if isinstance(node, ast.Attribute):
            if isinstance(node.value, ast.Name):
                if node.value.id == "self":
                    return ("self", node.attr)
                return ("attr", node.value.id, node.attr)
        return None

    def _edge(self, node: ast.expr) -> None:
        ref = self._ref(node)
        if ref is not None:
            self.index.edges.append((self._funcs[-1], ref, self._loop > 0))

    def visit_Call(self, node: ast.Call) -> None:
        self._edge(node.func)
        self.generic_visit(node)

    def visit_Name(self, node: ast.Name) -> None:
        if isinstance(node.ctx, ast.Load):
            self._edge(node)

    def visit_Attribute(self, node: ast.Attribute) -> None:
        if isinstance(node.ctx, ast.Load):
            self._edge(node)
        self.generic_visit(node)


def index_module(tree: ast.AST, path: str) -> ModuleIndex:
    index = ModuleIndex(module_name(path), path)
    is_package = path.replace("\\", "/").endswith("__init__.py")
    _Indexer(index, is_package).visit(tree)
    index.declared = _find_declared(tree)
    return index


def _aliases(fn: _Function | None, index: ModuleIndex) -> dict[str, set[str]]:
    """Local names bound to functions in ``fn``'s body: ``step = a if x
    else b`` -> {"step": {a's, b's qualnames}}."""
    out: dict[str, set[str]] = {}
    if fn is None:
        return out
    for node in ast.walk(fn.node):
        if isinstance(node, ast.Assign) and len(node.targets) == 1 and \
                isinstance(node.targets[0], ast.Name):
            names = {n.id for n in ast.walk(node.value)
                     if isinstance(n, ast.Name)}
            quals = {q for n in names
                     for q in _scoped(fn.qualname, n, index)}
            if quals:
                out[node.targets[0].id] = quals
    return out


def _scoped(scope: str | None, name: str, index: ModuleIndex) -> list[str]:
    """Qualnames ``name`` can mean from inside ``scope``: nested functions
    of the enclosing functions first, then module-level ones."""
    parts = scope.split(".") if scope else []
    for k in range(len(parts), -1, -1):
        qual = ".".join(parts[:k] + [name])
        if qual in index.functions:
            return [qual]
    return []


class Project:
    """Call edges of several modules, joined through their imports."""

    def __init__(self, indexes: list[ModuleIndex]) -> None:
        self.modules = {ix.name: ix for ix in indexes}

    def _lookup(self, module: str, name: str, depth: int = 0
                ) -> list[tuple[str, str]]:
        """A module-level function ``name`` of ``module``, following
        re-exports (``from x import f`` in a package)."""
        ix = self.modules.get(module)
        if ix is None or depth > 4:
            return []
        if name in ix.functions:
            return [(module, name)]
        if name in ix.imports:
            base, attr = ix.imports[name]
            if attr is not None:
                return self._lookup(base, attr, depth + 1)
        return []

    def _module_alias(self, ix: ModuleIndex, alias: str) -> str | None:
        if alias not in ix.imports:
            return None
        base, attr = ix.imports[alias]
        if attr is None:
            return base
        full = f"{base}.{attr}"
        return full if full in self.modules else None

    def resolve(self, ix: ModuleIndex, scope: str | None, ref: tuple,
                aliases: dict[str, set[str]]) -> list[tuple[str, str]]:
        kind = ref[0]
        if kind == "name":
            name = ref[1]
            local = _scoped(scope, name, ix)
            if local:
                return [(ix.name, q) for q in local]
            if name in aliases:
                return [(ix.name, q) for q in aliases[name]]
            if name in ix.imports:
                base, attr = ix.imports[name]
                if attr is not None:
                    return self._lookup(base, attr)
            return []
        if kind == "self":
            fn = ix.functions.get(scope) if scope else None
            while fn is not None and fn.cls is None and fn.parent:
                fn = ix.functions.get(fn.parent)
            if fn is not None and fn.cls is not None:
                qual = f"{fn.cls}.{ref[1]}"
                if qual in ix.functions:
                    return [(ix.name, qual)]
            return []
        module = self._module_alias(ix, ref[1])
        if module is not None:
            return self._lookup(module, ref[2])
        return []

    def hot(self) -> set[tuple[str, str]]:
        """(module, qualname) of every hot function."""
        edges: dict[tuple[str, str | None], list[tuple[str, str]]] = {}
        hot: set[tuple[str, str]] = set()
        for ix in self.modules.values():
            alias_cache: dict[str | None, dict[str, set[str]]] = {}
            for caller, ref, in_loop in ix.edges:
                if caller not in alias_cache:
                    alias_cache[caller] = _aliases(
                        ix.functions.get(caller) if caller else None, ix)
                targets = self.resolve(ix, caller, ref, alias_cache[caller])
                edges.setdefault((ix.name, caller), []).extend(targets)
                if in_loop:
                    hot.update(targets)
        todo = list(hot)
        while todo:
            key = todo.pop()
            for target in edges.get(key, ()):
                if target not in hot:
                    hot.add(target)
                    todo.append(target)
        return hot


def project_hot(indexes: list[ModuleIndex]) -> dict[str, set[str]]:
    """{path: hot qualnames of that module} over modules checked together."""
    hot = Project(indexes).hot()
    by_module: dict[str, set[str]] = {}
    for module, qual in hot:
        by_module.setdefault(module, set()).add(qual)
    return {ix.path: by_module.get(ix.name, set()) for ix in indexes}


# ------------------------------------------------------------------- taint


class _SyncChecker:
    """Walks one function's body (nested functions are their own) with
    flow-sensitive taint, reporting syncs in hot code."""

    def __init__(self, fn: _Function | None, body: list, taint: set[str],
                 hot: bool, path: str, index: ModuleIndex,
                 returns: dict[str, bool], report: bool = True) -> None:
        self.fn = fn
        self.index = index
        self.returns = returns
        self.returned = False          # some return statement gives a tensor
        self.name = fn.qualname if fn is not None else "<module>"
        self.body = body
        self.tainted = set(taint)
        self.ever = set(taint)
        self.hot = hot
        self.path = path
        self.diags: list[Diagnostic] = []
        self._report = report
        self._in_loop = 0

    def run(self) -> list[Diagnostic]:
        self._stmts(self.body)
        return self.diags

    # -- taint -------------------------------------------------------------
    def tensor(self, node: ast.AST | None) -> bool:
        if node is None:
            return False
        if isinstance(node, ast.Name):
            return node.id in self.tainted
        if isinstance(node, ast.Attribute):
            if node.attr in _STATIC_ATTRS:
                return False
            return self.tensor(node.value)
        if isinstance(node, ast.Subscript):
            return self.tensor(node.value)
        if isinstance(node, ast.Call):
            return self._call_tensor(node)
        if isinstance(node, ast.Compare) and all(
                isinstance(op, (ast.Is, ast.IsNot)) for op in node.ops):
            return False               # identity: never reads a value
        if isinstance(node, (ast.Constant, ast.Lambda, ast.JoinedStr)):
            return False
        if isinstance(node, (ast.ListComp, ast.SetComp, ast.GeneratorExp,
                             ast.DictComp)):
            return False
        return any(self.tensor(c) for c in ast.iter_child_nodes(node)
                   if isinstance(c, ast.expr))

    def _call_tensor(self, node: ast.Call) -> bool:
        func = node.func
        torch_call = _is_torch_value_call(func)
        if torch_call is not None:
            return torch_call
        if isinstance(func, ast.Name) and func.id in _HOST_BUILTINS:
            return False
        if isinstance(func, ast.Name):
            local = _scoped(self.fn.qualname if self.fn else None, func.id,
                            self.index)
            if local:                  # a function of this module
                ret = self.index.functions[local[0]].node.returns
                if ret is not None:    # its annotation says what it gives
                    return _holds_tensors(ret)
                return self.returns.get(local[0], True)
        root = func
        while isinstance(root, ast.Attribute):
            root = root.value
        if isinstance(root, ast.Name) and root.id in _HOST_ROOTS:
            return False
        if isinstance(func, ast.Attribute):
            if func.attr in _HOST_METHODS:
                return False
            if self.tensor(func.value):
                return True
        args = list(node.args) + [kw.value for kw in node.keywords]
        return any(self.tensor(a.value if isinstance(a, ast.Starred) else a)
                   for a in args)

    def _bind(self, target: ast.AST, tainted: bool) -> None:
        if isinstance(target, ast.Name):
            if tainted:
                self.tainted.add(target.id)
                self.ever.add(target.id)
            else:
                self.tainted.discard(target.id)
        elif isinstance(target, (ast.Tuple, ast.List)):
            for elt in target.elts:
                self._bind(elt.value if isinstance(elt, ast.Starred)
                           else elt, tainted)

    def _assign(self, target: ast.AST, value: ast.expr) -> None:
        """``a, b = x, y`` binds element by element; otherwise every name
        takes the value's taint."""
        if (isinstance(target, (ast.Tuple, ast.List))
                and isinstance(value, (ast.Tuple, ast.List))
                and len(target.elts) == len(value.elts)
                and not any(isinstance(e, ast.Starred)
                            for e in target.elts + value.elts)):
            for t, v in zip(target.elts, value.elts):
                self._assign(t, v)
        else:
            self._bind(target, self.tensor(value))

    # -- findings ----------------------------------------------------------
    def _flag(self, node: ast.AST, what: str) -> None:
        if self._report and (self.hot or self._in_loop):
            where = "a loop of" if not self.hot else "hot function"
            self.diags.append(Diagnostic(
                self.path, node.lineno, "REP101",
                f"{what} reads a tensor back to the host in {where} "
                f"`{self.name}` (a device sync each iteration); if it is "
                f"by design, declare it ({_DECLARATION} or "
                f"`# lint: sync-ok(reason)`)"))

    @staticmethod
    def _exempt(test: ast.AST) -> bool:
        """``x is None`` / ``isinstance(x, T)`` never read a value."""
        if isinstance(test, ast.Compare) and all(
                isinstance(op, (ast.Is, ast.IsNot)) for op in test.ops):
            return True
        if isinstance(test, ast.Call) and final_attr(test.func) in {
                "isinstance", "callable", "hasattr"}:
            return True
        if isinstance(test, ast.BoolOp):
            return all(_SyncChecker._exempt(v) for v in test.values)
        if isinstance(test, ast.UnaryOp) and isinstance(test.op, ast.Not):
            return _SyncChecker._exempt(test.operand)
        return False

    def _test(self, node, test: ast.expr, kind: str) -> None:
        if not self._exempt(test) and self.tensor(test):
            self._flag(node, f"`{kind}` on a tensor")

    def _expr(self, node: ast.AST | None) -> None:
        """Scan an expression for sync sites; a comprehension in it is a
        loop (its element and conditions run once an item)."""
        if node is None:
            return
        if isinstance(node, ast.keyword):
            self._expr(node.value)
            return
        if isinstance(node, (ast.ListComp, ast.SetComp, ast.GeneratorExp,
                             ast.DictComp)):
            self._expr(node.generators[0].iter)
            self._in_loop += 1
            for i, g in enumerate(node.generators):
                if i:
                    self._expr(g.iter)
                self._bind(g.target, self.tensor(g.iter))
                for cond in g.ifs:
                    self._expr(cond)
                    self._test(cond, cond, "if")
            for part in ("elt", "key", "value"):
                self._expr(getattr(node, part, None))
            self._in_loop -= 1
            return
        if isinstance(node, ast.IfExp):
            self._test(node, node.test, "if")
        if isinstance(node, ast.Call):
            self._call(node)
        for child in ast.iter_child_nodes(node):
            if isinstance(child, (ast.expr, ast.keyword)):
                self._expr(child)

    def _call(self, node: ast.Call) -> None:
        func = node.func
        if isinstance(func, ast.Attribute) and self.tensor(func.value):
            if func.attr in _SYNC_METHODS:
                self._flag(node, f"`.{func.attr}()`")
            elif func.attr == "to" and any(
                    isinstance(a, ast.Constant) and a.value == "cpu"
                    for a in list(node.args)
                    + [k.value for k in node.keywords]):
                self._flag(node, '`.to("cpu")`')
        if (isinstance(func, ast.Name) and func.id in _SYNC_BUILTINS
                and node.args and self.tensor(node.args[0])):
            self._flag(node, f"`{func.id}()` of a tensor")
        if (dotted_name(func) or "").endswith("cuda.synchronize"):
            self._flag(node, "`torch.cuda.synchronize()`")

    # -- statements --------------------------------------------------------
    def _stmts(self, body) -> None:
        for stmt in body:
            self._stmt(stmt)

    def _loop_body(self, run) -> None:
        """Loop bodies run twice: the first pass, silent, carries the taint
        of one iteration's assignments into the next."""
        self._in_loop += 1
        report, self._report = self._report, False
        run()
        self._report = report
        run()
        self._in_loop -= 1

    def _stmt(self, stmt: ast.stmt) -> None:
        if isinstance(stmt, (ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.ClassDef)):
            for d in stmt.decorator_list:
                self._expr(d)
            return
        if isinstance(stmt, ast.Assign):
            self._expr(stmt.value)
            for t in stmt.targets:
                self._assign(t, stmt.value)
        elif isinstance(stmt, ast.AugAssign):
            self._expr(stmt.value)
            self._bind(stmt.target, self.tensor(stmt.value)
                       or self.tensor(stmt.target))
        elif isinstance(stmt, ast.AnnAssign):
            self._expr(stmt.value)
            if stmt.value is not None:
                self._bind(stmt.target, self.tensor(stmt.value))
        elif isinstance(stmt, ast.If):
            self._expr(stmt.test)
            self._test(stmt, stmt.test, "if")
            self._stmts(stmt.body)
            self._stmts(stmt.orelse)
        elif isinstance(stmt, (ast.For, ast.AsyncFor)):
            self._expr(stmt.iter)

            def body():
                self._bind(stmt.target, self.tensor(stmt.iter))
                self._stmts(stmt.body)
            self._loop_body(body)
            self._stmts(stmt.orelse)
        elif isinstance(stmt, ast.While):
            def body():
                self._expr(stmt.test)
                self._test(stmt, stmt.test, "while")
                self._stmts(stmt.body)
            self._loop_body(body)
            self._stmts(stmt.orelse)
        elif isinstance(stmt, ast.Assert):
            self._expr(stmt.test)
            self._test(stmt, stmt.test, "assert")
        elif isinstance(stmt, (ast.With, ast.AsyncWith)):
            for item in stmt.items:
                self._expr(item.context_expr)
                if item.optional_vars is not None:
                    self._bind(item.optional_vars,
                               self.tensor(item.context_expr))
            self._stmts(stmt.body)
        elif isinstance(stmt, ast.Try):
            self._stmts(stmt.body)
            for handler in stmt.handlers:
                self._stmts(handler.body)
            self._stmts(stmt.orelse)
            self._stmts(stmt.finalbody)
        elif isinstance(stmt, ast.Return):
            self._expr(stmt.value)
            self.returned |= self.tensor(stmt.value)
        elif isinstance(stmt, ast.Match):
            self._expr(stmt.subject)
            for case in stmt.cases:
                self._stmts(case.body)
        else:
            for sub in ast.iter_child_nodes(stmt):
                if isinstance(sub, ast.expr):
                    self._expr(sub)


def check(tree: ast.AST, source: str, path: str,
          hot: set[str] | None = None) -> list[Diagnostic]:
    """Findings of one module. ``hot`` is the module's hot functions as the
    driver found them across the modules checked together; without it,
    calls are followed within this module only."""
    index = index_module(tree, path)
    if hot is None:
        hot = project_hot([index])[path]
    # which functions of the module return a tensor: a fixpoint from
    # "none", so a call of a host helper (a predicate, a shape) stays host
    returns = {qual: False for qual in index.functions}
    for _ in range(8):
        runs = _walk_functions(index, hot, path, returns, report=False)
        new = {qual: run.returned for qual, run in runs.items()}
        if new == returns:
            break
        returns = new
    body = list(getattr(tree, "body", []))
    diags = _SyncChecker(None, body, set(), False, path, index,
                         returns).run()
    for node in body:
        if isinstance(node, ast.Assign) and any(
                isinstance(t, ast.Name) and t.id == _DECLARATION
                for t in node.targets):
            for name in sorted(set(index.declared) - set(index.functions)):
                diags.append(Diagnostic(
                    path, node.lineno, "REP101",
                    f"{_DECLARATION} names `{name}`, which is not a "
                    f"function of this module"))
    for qual, run in _walk_functions(index, hot, path, returns,
                                     report=True).items():
        if not _declared(qual, index.declared):
            diags += run.diags
    return diags


def _declared(qual: str, declared: dict[str, str]) -> bool:
    """A declared function covers the functions nested in it."""
    return any(qual == d or qual.startswith(d + ".") for d in declared)


def _walk_functions(index: ModuleIndex, hot: set[str], path: str,
                    returns: dict[str, bool], report: bool
                    ) -> dict[str, _SyncChecker]:
    """One checker run per function, parents before their nested functions
    (the index's order), each nested function starting from what its
    parent had tainted."""
    runs: dict[str, _SyncChecker] = {}
    for qual, fn in index.functions.items():
        taint = param_taint(fn.node)
        if fn.parent is not None and fn.parent in runs:
            own = {a.arg for a in ast.walk(fn.node.args)
                   if isinstance(a, ast.arg)}
            taint |= runs[fn.parent].ever - own
        run = _SyncChecker(fn, fn.node.body, taint, qual in hot, path,
                           index, returns, report)
        run.run()
        runs[qual] = run
    return runs
