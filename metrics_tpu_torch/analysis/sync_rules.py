"""hotlint rules HL001-HL006: host-sync and dispatch-economy discipline, in torch idioms (counterpart of
``metrics_tpu/analysis/sync_rules.py``).

A CUDA update that reads the card on the host (``.item()``, ``bool(t)``, a data-dependent output size) makes
the host wait for every launch queued before it, and the training step with it. hotlint polices the eager
host code of the hot path (``metric.py``, ``collections.py``, ``engine/``, ``wrappers/replicated.py``,
``parallel/sync.py``, ``observe/``), where such a read is legal Python but a silent stall.

The sanctioned escape hatch is an *annotated* transfer: the ``# hotlint: intentional-transfer`` marker on
the line or the line above, or code inside ``with _transfer_scope(site):`` (``engine/stream.py``), which
counts the transfer and, under CUDA's sync debug mode, lets it happen. The dynamic cross-check
(:mod:`metrics_tpu_torch.analysis.transfer_contracts`) proves the static verdict: everything not so
annotated must survive ``torch.cuda.set_sync_debug_mode("error")`` on the card.

=======  ======================================================================
code     invariant
=======  ======================================================================
HL001    no implicit host read of a device value: ``float()/int()/bool()``,
         ``.item()``, ``.tolist()``, ``.cpu()``, ``.numpy()``, ``np.asarray(t)``;
         and no op whose output size depends on the data, which reads it on
         CUDA: ``torch.bincount``, ``torch.unique``, ``nonzero``/``argwhere``,
         one-argument ``torch.where``, boolean-mask indexing,
         ``masked_select``, ``repeat_interleave`` of a tensor without
         ``output_size``
HL002    no Python truthiness or branching on a device tensor
HL003    no per-element Python loop over a device tensor
HL004    no per-call ``torch.compile`` or op registration inside a function
         body (``torch.compile(f)(x)``, ``torch.library.custom_op`` /
         ``torch.library.Library`` built per call)
HL005    every blocking call (``torch.cuda.synchronize``, ``.synchronize()``)
         carries a ``# hotlint: intentional-transfer`` annotation
HL006    no host allocation from device buffers inside per-tick engine paths
         (methods reachable from tick/submit/compute/aggregate/_flush_pending)
=======  ======================================================================
"""

from __future__ import annotations

import ast
from typing import Callable, Dict, Iterator, List, Optional, Set, Tuple

from metrics_tpu_torch.analysis.contexts import ArrayTaint, Violation, _isinstance_narrowed_names
from metrics_tpu_torch.analysis.engine import ModuleInfo, SourceMarkers, _dotted, _v

__all__ = ["SYNC_RULES", "classify_transfers", "INTENTIONAL_TRANSFER_MARKER"]

INTENTIONAL_TRANSFER_MARKER = "intentional-transfer"

# ------------------------------------------------------------------- hot scope
_HOT_FILES = {
    "metrics_tpu_torch/metric.py",
    "metrics_tpu_torch/collections.py",
    "metrics_tpu_torch/wrappers/replicated.py",
    "metrics_tpu_torch/parallel/sync.py",
}
_HOT_DIRS = ("metrics_tpu_torch/engine/", "metrics_tpu_torch/observe/")
# benchmarks, profilers and report generators: blocking on the card is their job
_EXEMPT_FILES = {
    "metrics_tpu_torch/engine/smoke.py",
    "metrics_tpu_torch/observe/costs.py",
    "metrics_tpu_torch/observe/overhead.py",
    "metrics_tpu_torch/observe/profile.py",
    "metrics_tpu_torch/observe/explain.py",
}


def _is_hot(path: str) -> bool:
    if path in _EXEMPT_FILES:
        return False
    return path in _HOT_FILES or any(path.startswith(d) for d in _HOT_DIRS)


def _functions(mod: ModuleInfo) -> Iterator[Tuple[ast.AST, str]]:
    """Every top-level function and method with its qualified name (nested defs belong to their owner)."""

    def walk(node: ast.AST, prefix: str) -> Iterator[Tuple[ast.AST, str]]:
        for child in ast.iter_child_nodes(node):
            if isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef)):
                yield child, f"{prefix}{child.name}"
            elif isinstance(child, ast.ClassDef):
                yield from walk(child, f"{prefix}{child.name}.")

    yield from walk(mod.tree, "")


def _compiled_fn_ids(mod: ModuleInfo) -> Set[int]:
    """Functions decorated with ``torch.compile``: their bodies are traced, not run eagerly."""
    ids: Set[int] = set()
    for node in ast.walk(mod.tree):
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            for dec in node.decorator_list:
                if _dotted(dec.func if isinstance(dec, ast.Call) else dec) in ("torch.compile", "compile"):
                    ids.add(id(node))
    return ids


def _scoped_lines(fn: ast.AST) -> Set[int]:
    """Lines inside ``with _transfer_scope(...)`` blocks: annotated transfers by construction."""
    lines: Set[int] = set()
    for node in ast.walk(fn):
        if isinstance(node, (ast.With, ast.AsyncWith)) and any(
            isinstance(item.context_expr, ast.Call) and _dotted(item.context_expr.func).endswith("transfer_scope")
            for item in node.items
        ):
            for sub in ast.walk(node):
                if hasattr(sub, "lineno"):
                    lines.add(sub.lineno)
    return lines


# ---------------------------------------------------------- device-source test
# attribute names that are, by engine convention, device-resident buffers
_DEVICE_ATTRS = frozenset({"stacked"})
_FETCH_SUFFIXES = ("_host_fetch", "_host_value")


def _contains_fetch(e: ast.AST) -> bool:
    for node in ast.walk(e):
        if isinstance(node, ast.Call) and _dotted(node.func).endswith(_FETCH_SUFFIXES):
            return True
    return False


def _is_device_producing_call(call: ast.Call) -> bool:
    d = _dotted(call.func)
    parts = d.split(".")
    if parts[0] == "F":
        return True
    if parts[0] != "torch":
        return False
    if len(parts) > 2 and parts[1] in ("cuda", "distributed", "library", "utils", "autograd", "backends",
                                       "profiler", "func", "jit", "compiler"):
        return False
    return parts[-1] not in ("finfo", "iinfo", "device", "Size", "is_tensor", "is_floating_point",
                             "is_complex", "get_default_dtype", "no_grad", "inference_mode", "Generator",
                             "manual_seed", "result_type", "promote_types", "can_cast", "compile")


def _device_expr(e: ast.expr, taint: ArrayTaint) -> bool:
    """Does this expression plausibly hold (or contain) a device tensor? A ``torch.*``/``F.*`` producing call
    anywhere in the subtree, a subscript of an engine device buffer (``bucket.stacked[k]``), or the
    function's :class:`ArrayTaint`. An explicit fetch (``_host_fetch``) anywhere neutralizes it."""
    if _contains_fetch(e):
        return False
    for node in ast.walk(e):
        if isinstance(node, ast.Call) and _is_device_producing_call(node):
            return True
        if (
            isinstance(node, ast.Subscript)
            and isinstance(node.value, ast.Attribute)
            and node.value.attr in _DEVICE_ATTRS
        ):
            return True
    return taint.is_array_expr(e)


_CONCRETIZING_BUILTINS = frozenset({"float", "int", "bool"})
_CONCRETIZING_METHODS = frozenset({"item", "tolist", "cpu", "numpy"})
_NP_CASTS = frozenset({"np.asarray", "np.array", "np.ascontiguousarray"})
# data-dependent output sizes: the op reads the data on the host before it can allocate its result
_SIZE_FNS = frozenset({"torch.bincount", "torch.unique", "torch.unique_consecutive", "torch.nonzero",
                       "torch.argwhere", "torch.masked_select"})
_SIZE_METHODS = frozenset({"bincount", "unique", "unique_consecutive", "nonzero", "argwhere", "masked_select"})
_MASK_FNS = frozenset({"isfinite", "isnan", "isinf", "logical_not", "logical_and", "logical_or",
                       "logical_xor", "isclose", "isin", "eq", "ne", "gt", "lt", "ge", "le"})


def _mask_names(fn: ast.AST, taint: ArrayTaint) -> Set[str]:
    """Names assigned a boolean device tensor (a comparison, ``~``, ``&``/``|`` of masks, a mask function)."""
    names: Set[str] = set()
    for _ in range(2):
        for node in ast.walk(fn):
            if isinstance(node, ast.Assign) and _is_mask(node.value, taint, names):
                for t in node.targets:
                    if isinstance(t, ast.Name):
                        names.add(t.id)
    return names


def _is_mask(e: ast.expr, taint: ArrayTaint, names: Set[str]) -> bool:
    if isinstance(e, ast.Name):
        return e.id in names
    if isinstance(e, ast.Compare):
        if all(isinstance(op, (ast.Is, ast.IsNot, ast.In, ast.NotIn)) for op in e.ops):
            return False
        return taint.is_array_expr(e.left) or any(taint.is_array_expr(c) for c in e.comparators)
    if isinstance(e, ast.UnaryOp) and isinstance(e.op, ast.Invert):
        return _is_mask(e.operand, taint, names) or taint.is_array_expr(e.operand)
    if isinstance(e, ast.BinOp) and isinstance(e.op, (ast.BitAnd, ast.BitOr, ast.BitXor)):
        return _is_mask(e.left, taint, names) or _is_mask(e.right, taint, names)
    if isinstance(e, ast.Call):
        d = _dotted(e.func)
        leaf = d.rsplit(".", 1)[-1] if d else (e.func.attr if isinstance(e.func, ast.Attribute) else "")
        if leaf in _MASK_FNS and (d.startswith("torch.") or (isinstance(e.func, ast.Attribute)
                                                            and taint.is_array_expr(e.func.value))):
            return True
        if isinstance(e.func, ast.Attribute) and e.func.attr == "bool" and taint.is_array_expr(e.func.value):
            return True
    return False


def _sync_hazards(fn: ast.AST, taint: ArrayTaint, skip_lines: Set[int],
                  marks: Optional[SourceMarkers]) -> Iterator[Tuple[ast.AST, str]]:
    """Every implicit host read HL001 names in ``fn``: (node, what)."""
    masks = _mask_names(fn, taint)
    for node in ast.walk(fn):
        line = getattr(node, "lineno", 0)
        if line in skip_lines or (marks is not None and marks.has_marker(line, INTENTIONAL_TRANSFER_MARKER)):
            continue
        if isinstance(node, ast.Subscript):
            idx = node.slice
            parts = idx.elts if isinstance(idx, ast.Tuple) else [idx]
            if any(_is_mask(p, taint, masks) for p in parts) and _device_expr(node.value, taint):
                yield node, "boolean-mask indexing"
            continue
        if not isinstance(node, ast.Call):
            continue
        d = _dotted(node.func)
        if d in _CONCRETIZING_BUILTINS and len(node.args) == 1:
            if _device_expr(node.args[0], taint):
                yield node, f"{d}()"
        elif d in _SIZE_FNS:
            yield node, f"{d}()"
        elif d == "torch.where" and len(node.args) == 1:
            yield node, "torch.where(cond)"
        elif d in ("torch.repeat_interleave",) and not any(k.arg == "output_size" for k in node.keywords):
            if len(node.args) == 1 or (len(node.args) > 1 and _device_expr(node.args[1], taint)):
                yield node, "torch.repeat_interleave() without output_size"
        elif isinstance(node.func, ast.Attribute) and node.func.attr in _CONCRETIZING_METHODS:
            if _device_expr(node.func.value, taint):
                yield node, f".{node.func.attr}()"
        elif isinstance(node.func, ast.Attribute) and node.func.attr in _SIZE_METHODS:
            if node.func.attr in ("bincount", "unique", "masked_select") or _device_expr(node.func.value, taint):
                yield node, f".{node.func.attr}()"
        elif isinstance(node.func, ast.Attribute) and node.func.attr == "repeat_interleave":
            if (not any(k.arg == "output_size" for k in node.keywords) and node.args
                    and _device_expr(node.args[0], taint) and _device_expr(node.func.value, taint)):
                yield node, ".repeat_interleave() without output_size"
        elif d in _NP_CASTS and node.args and _device_expr(node.args[0], taint):
            yield node, f"{d}()"


# =========================================================================== HL001
def rule_hl001_implicit_host_sync(mod: ModuleInfo) -> List[Violation]:
    if not _is_hot(mod.path):
        return []
    out: List[Violation] = []
    marks = SourceMarkers(mod.source)
    compiled = _compiled_fn_ids(mod)
    for fn, qual in _functions(mod):
        if id(fn) in compiled:
            continue
        taint = ArrayTaint(fn)
        for node, what in _sync_hazards(fn, taint, _scoped_lines(fn), marks):
            out.append(_v(mod, node, "HL001",
                          f"`{what}` on a device value blocks host dispatch: the host waits for the card; "
                          "route it through an annotated transfer", qual))
    return out


# =========================================================================== HL002
def rule_hl002_device_truthiness(mod: ModuleInfo) -> List[Violation]:
    if not _is_hot(mod.path):
        return []
    out: List[Violation] = []
    compiled = _compiled_fn_ids(mod)
    for fn, qual in _functions(mod):
        if id(fn) in compiled:
            continue
        taint = ArrayTaint(fn)
        scoped = _scoped_lines(fn)

        def check(test: ast.expr, node: ast.AST, kind: str, narrowed: Set[str]) -> None:
            if _contains_fetch(test) or node.lineno in scoped:
                return
            if taint.is_value_dependent_test(test, set(narrowed)):
                out.append(_v(mod, node, "HL002",
                              f"`{kind}` on a device-tensor value blocks until the device catches up: "
                              "compute the predicate on host state or fetch explicitly", qual))

        def visit(stmts: List[ast.stmt], narrowed: Set[str]) -> None:
            for node in stmts:
                if isinstance(node, ast.If):
                    check(node.test, node, "if", narrowed)
                    visit(node.body, narrowed | _isinstance_narrowed_names(node.test))
                    visit(node.orelse, narrowed)
                elif isinstance(node, ast.While):
                    check(node.test, node, "while", narrowed)
                    visit(node.body, narrowed)
                    visit(node.orelse, narrowed)
                elif isinstance(node, ast.Assert):
                    check(node.test, node, "assert", narrowed)
                else:
                    for field_body in ("body", "orelse", "finalbody"):
                        sub = getattr(node, field_body, None)
                        if isinstance(sub, list):
                            visit(sub, narrowed)
                    for handler in getattr(node, "handlers", []) or []:
                        visit(handler.body, narrowed)

        visit(list(getattr(fn, "body", [])), set())
    return out


# =========================================================================== HL003
def rule_hl003_per_element_loops(mod: ModuleInfo) -> List[Violation]:
    if not _is_hot(mod.path):
        return []
    out: List[Violation] = []
    compiled = _compiled_fn_ids(mod)
    for fn, qual in _functions(mod):
        if id(fn) in compiled:
            continue
        taint = ArrayTaint(fn)
        scoped = _scoped_lines(fn)
        for node in ast.walk(fn):
            if not isinstance(node, (ast.For, ast.AsyncFor)) or node.lineno in scoped:
                continue
            if _contains_fetch(node.iter):
                continue
            if _device_expr(node.iter, taint):
                out.append(_v(mod, node, "HL003",
                              "Python loop over a device tensor issues one dispatch (or host read) per "
                              "element: vectorize, or fetch the whole tensor once", qual))
    return out


# =========================================================================== HL004
_PER_CALL_FACTORIES = ("torch.compile", "torch.library.custom_op", "torch.library.Library")


def rule_hl004_per_call_compile(mod: ModuleInfo) -> List[Violation]:
    if not _is_hot(mod.path):
        return []
    out: List[Violation] = []

    def is_factory(e: ast.AST) -> bool:
        return isinstance(e, ast.Call) and _dotted(e.func) in _PER_CALL_FACTORIES

    for fn, qual in _functions(mod):
        for node in ast.walk(fn):
            if isinstance(node, ast.Call) and is_factory(node.func):
                out.append(_v(mod, node, "HL004",
                              f"per-call `{_dotted(node.func.func)}(f)(...)` builds a fresh program every "
                              "invocation: cache the compiled callable", qual))
            elif isinstance(node, ast.Attribute) and is_factory(node.value):
                out.append(_v(mod, node, "HL004",
                              f"`{_dotted(node.value.func)}(...).{node.attr}` builds an uncached program "
                              "inside a function body: hoist or cache it", qual))
    return out


# =========================================================================== HL005
_BLOCKING_CALLS = ("torch.cuda.synchronize",)
_BLOCKING_METHODS = frozenset({"synchronize"})


def rule_hl005_unannotated_blocking(mod: ModuleInfo) -> List[Violation]:
    if not _is_hot(mod.path):
        return []
    out: List[Violation] = []
    marks = SourceMarkers(mod.source)
    for fn, qual in _functions(mod):
        for node in ast.walk(fn):
            if not isinstance(node, ast.Call):
                continue
            d = _dotted(node.func)
            blocking = d in _BLOCKING_CALLS or (
                isinstance(node.func, ast.Attribute) and node.func.attr in _BLOCKING_METHODS
            )
            if blocking and not marks.has_marker(node.lineno, INTENTIONAL_TRANSFER_MARKER):
                out.append(_v(mod, node, "HL005",
                              f"blocking call `{d or node.func.attr}` without a "
                              f"`# hotlint: {INTENTIONAL_TRANSFER_MARKER}` annotation: say why this sync is "
                              "intentional (and scope it)", qual))
    return out


# =========================================================================== HL006
_TICK_ROOTS = frozenset({"tick", "submit", "compute", "compute_all", "aggregate", "_flush_pending"})
_NP_ALLOCATORS = frozenset({
    "np.stack", "np.asarray", "np.array", "np.ascontiguousarray",
    "np.concatenate", "np.copy", "np.vstack", "np.hstack",
})


def _self_call_graph(cls: ast.ClassDef) -> Dict[str, Set[str]]:
    graph: Dict[str, Set[str]] = {}
    for stmt in cls.body:
        if not isinstance(stmt, (ast.FunctionDef, ast.AsyncFunctionDef)):
            continue
        callees: Set[str] = set()
        for node in ast.walk(stmt):
            if (
                isinstance(node, ast.Call)
                and isinstance(node.func, ast.Attribute)
                and isinstance(node.func.value, ast.Name)
                and node.func.value.id == "self"
            ):
                callees.add(node.func.attr)
        graph[stmt.name] = callees
    return graph


def _tick_reachable(cls: ast.ClassDef) -> Set[str]:
    graph = _self_call_graph(cls)
    seen: Set[str] = set()
    frontier = [r for r in _TICK_ROOTS if r in graph]
    while frontier:
        name = frontier.pop()
        if name in seen:
            continue
        seen.add(name)
        frontier.extend(c for c in graph.get(name, ()) if c not in seen and c in graph)
    return seen


def _host_proven_names(fn: ast.AST) -> Set[str]:
    names: Set[str] = set()
    for _ in range(2):
        for node in ast.walk(fn):
            if isinstance(node, ast.Assign) and _host_proven(node.value, names):
                for t in node.targets:
                    if isinstance(t, ast.Name):
                        names.add(t.id)
            elif isinstance(node, ast.For) and _host_proven(node.iter, names):
                if isinstance(node.target, ast.Name):
                    names.add(node.target.id)
            elif isinstance(node, (ast.ListComp, ast.GeneratorExp, ast.SetComp, ast.DictComp)):
                for comp in node.generators:
                    if _host_proven(comp.iter, names) and isinstance(comp.target, ast.Name):
                        names.add(comp.target.id)
    return names


def _host_proven(e: ast.expr, names: Set[str]) -> bool:
    """Conservatively: does this expression provably hold host (numpy) data?"""
    if isinstance(e, ast.Constant):
        return True
    if isinstance(e, ast.Name):
        return e.id in names
    if isinstance(e, ast.Starred):
        return _host_proven(e.value, names)
    if isinstance(e, (ast.List, ast.Tuple, ast.Set)):
        return all(_host_proven(x, names) for x in e.elts)
    if isinstance(e, (ast.ListComp, ast.GeneratorExp, ast.SetComp)):
        local = set(names)
        for comp in e.generators:
            if _host_proven(comp.iter, local) and isinstance(comp.target, ast.Name):
                local.add(comp.target.id)
        return _host_proven(e.elt, local)
    if isinstance(e, ast.IfExp):
        return _host_proven(e.body, names) and _host_proven(e.orelse, names)
    if isinstance(e, ast.Dict):
        return all(_host_proven(v, names) for v in e.values)
    if isinstance(e, (ast.Subscript, ast.Attribute)):
        return _host_proven(e.value, names)
    if isinstance(e, ast.BinOp):
        return _host_proven(e.left, names) and _host_proven(e.right, names)
    if isinstance(e, ast.Call):
        d = _dotted(e.func)
        return d.startswith("np.") or d.endswith(_FETCH_SUFFIXES)
    return False


def rule_hl006_host_alloc_in_tick(mod: ModuleInfo) -> List[Violation]:
    if not mod.path.startswith("metrics_tpu_torch/engine/") or not _is_hot(mod.path):
        return []
    out: List[Violation] = []
    marks = SourceMarkers(mod.source)
    for cls in (n for n in mod.tree.body if isinstance(n, ast.ClassDef)):
        reachable = _tick_reachable(cls)
        if not reachable:
            continue
        for stmt in cls.body:
            if not isinstance(stmt, (ast.FunctionDef, ast.AsyncFunctionDef)) or stmt.name not in reachable:
                continue
            host_names = _host_proven_names(stmt)
            scoped = _scoped_lines(stmt)
            qual = f"{cls.name}.{stmt.name}"
            for node in ast.walk(stmt):
                if not isinstance(node, ast.Call) or _dotted(node.func) not in _NP_ALLOCATORS:
                    continue
                if not node.args or _host_proven(node.args[0], host_names) or _contains_fetch(node.args[0]):
                    continue
                if node.lineno in scoped or marks.has_marker(node.lineno, INTENTIONAL_TRANSFER_MARKER):
                    continue
                out.append(_v(mod, node, "HL006",
                              f"`{_dotted(node.func)}(...)` inside a per-tick engine path allocates host "
                              "memory from values not proven host-resident: fetch once through an annotated "
                              "transfer, then build from host buffers", qual))
    return out


SYNC_RULES: Dict[str, Callable[[ModuleInfo], List[Violation]]] = {
    "HL001": rule_hl001_implicit_host_sync,
    "HL002": rule_hl002_device_truthiness,
    "HL003": rule_hl003_per_element_loops,
    "HL004": rule_hl004_per_call_compile,
    "HL005": rule_hl005_unannotated_blocking,
    "HL006": rule_hl006_host_alloc_in_tick,
}


# ----------------------------------------------------------------- classifier
def _state_attr_names(cls: ast.ClassDef) -> Tuple[str, ...]:
    names: Set[str] = set()
    for call in (n for n in ast.walk(cls) if isinstance(n, ast.Call)):
        if isinstance(call.func, ast.Attribute) and call.func.attr == "add_state":
            if call.args and isinstance(call.args[0], ast.Constant) and isinstance(call.args[0].value, str):
                names.add(call.args[0].value)
    return tuple(sorted(names))


def _fn_hazards(fn: ast.AST, label: str, state_attrs: Tuple[str, ...] = ()) -> List[str]:
    taint = ArrayTaint(fn, state_attrs=state_attrs)
    hazards = [f"{label}: {what} on device value" for _node, what in _sync_hazards(fn, taint, set(), None)]
    for node in ast.walk(fn):
        if isinstance(node, (ast.If, ast.While, ast.Assert)) and taint.is_value_dependent_test(node.test):
            hazards.append(f"{label}: branch on device value")
    return hazards


def class_sync_hazards(cls: ast.ClassDef) -> List[str]:
    """Statically visible host reads inside a metric class's ``update``/``_update_impl`` bodies."""
    hazards: List[str] = []
    state_attrs = _state_attr_names(cls)
    for stmt in cls.body:
        if isinstance(stmt, (ast.FunctionDef, ast.AsyncFunctionDef)) and stmt.name in ("update", "_update_impl"):
            hazards.extend(_fn_hazards(stmt, stmt.name, state_attrs))
    return hazards


def _callees(fn_node: ast.AST, fn_obj: Callable[..., object], cls: Optional[type] = None) -> List[Callable[..., object]]:
    """The package's functions a body calls: ``f(...)`` and ``module.f(...)`` resolved in the function's
    module globals (a decorated function's own, past its wrapper), and ``self.m(...)`` resolved on ``cls`` (a
    method of a class below ``Metric``)."""
    import inspect

    glb = getattr(inspect.unwrap(fn_obj), "__globals__", {})
    out = []
    for node in ast.walk(fn_node):
        if not isinstance(node, ast.Call):
            continue
        target = None
        if isinstance(node.func, ast.Name):
            target = glb.get(node.func.id)
        elif isinstance(node.func, ast.Attribute) and isinstance(node.func.value, ast.Name):
            if node.func.value.id == "self" and cls is not None:
                for klass in cls.__mro__:
                    if klass.__name__ == "Metric" and klass.__module__.endswith("metric"):
                        break
                    if node.func.attr in klass.__dict__:
                        target = klass.__dict__[node.func.attr]
                        break
            else:
                owner = glb.get(node.func.value.id)
                if inspect.ismodule(owner):
                    target = getattr(owner, node.func.attr, None)
        if inspect.isfunction(target) and target.__module__.startswith("metrics_tpu_torch."):
            out.append(target)
    return out


def _parse_function(fn_obj: Callable[..., object]) -> Optional[ast.AST]:
    import inspect
    import textwrap

    try:
        node = ast.parse(textwrap.dedent(inspect.getsource(fn_obj))).body[0]
    except (OSError, TypeError, SyntaxError, IndexError):
        return None
    return node if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)) else None


def classify_transfers(cls: type) -> Tuple[bool, str]:
    """Static transfer verdict for a runtime class: (clean, hazards).

    Walks the MRO below :class:`metrics_tpu_torch.metric.Metric`, collects :func:`class_sync_hazards` of
    every class body's update, and follows the update's calls into the package's functions (validation,
    formatting, the functional kernels), transitively: the port's host reads live there, where the JAX
    package's compiled update has none to follow. Clean means *no statically visible host read anywhere on
    the update path*, the claim the runtime leg of :mod:`metrics_tpu_torch.analysis.transfer_contracts`
    re-proves.
    """
    import inspect
    import textwrap

    hazards: List[str] = []
    frontier: List[Callable[..., object]] = []
    for klass in cls.__mro__:
        if klass.__module__ in ("builtins", "abc"):
            continue
        if klass.__name__ == "Metric" and klass.__module__.endswith("metric"):
            break  # the runtime base owns the protocol; its body is not a subject
        try:
            node = ast.parse(textwrap.dedent(inspect.getsource(klass))).body[0]
        except (OSError, TypeError, SyntaxError, IndexError):
            continue
        if not isinstance(node, ast.ClassDef):
            continue
        hazards.extend(f"{klass.__name__}: {h}" for h in class_sync_hazards(node))
        for stmt in node.body:
            if isinstance(stmt, (ast.FunctionDef, ast.AsyncFunctionDef)) and stmt.name in ("update", "_update_impl"):
                fn_obj = klass.__dict__.get(stmt.name)
                if inspect.isfunction(fn_obj):
                    frontier.extend(_callees(stmt, fn_obj, cls))
    seen: Set[int] = set()
    while frontier:
        fn_obj = frontier.pop()
        if id(fn_obj) in seen:
            continue
        seen.add(id(fn_obj))
        fn_node = _parse_function(fn_obj)
        if fn_node is None:
            continue
        hazards.extend(f"{fn_obj.__name__}: " + h.split(": ", 1)[1] for h in _fn_hazards(fn_node, "body"))
        frontier.extend(_callees(fn_node, fn_obj, cls))
    return (not hazards, "; ".join(hazards))


# one line per rule for `--list-rules`
SUMMARIES = {
    "HL001": "implicit host read of a device value (.item()/float()/.tolist()/.cpu(), data-dependent sizes)",
    "HL002": "Python truthiness/branching on a device tensor in hot host code",
    "HL003": "per-element Python loop over a device tensor (one dispatch per element)",
    "HL004": "per-call torch.compile or op registration inside a function body",
    "HL005": "blocking call without a `# hotlint: intentional-transfer` annotation",
    "HL006": "host allocation from device buffers inside per-tick engine paths",
}
