"""jitlint rules JL001-JL006: tracer safety, recompilation, the state contract, dtype promotion, side effects
and namespace consistency, in torch idioms (counterpart of ``metrics_tpu/analysis/rules.py``).

A *traced context* is an update or compute body of a class that registers its own tensor states, or a
module-level function of ``functional/``/``ops/`` (:func:`~metrics_tpu_torch.analysis.contexts.find_traced_contexts`).
The port runs those bodies eagerly, but the fleet engine and the replica wrappers run an update under
``torch.func.vmap``, where a host read of a batched tensor raises; a user may also ``torch.compile`` a
functional kernel, where a host read breaks the graph. The tracer guard is
:func:`metrics_tpu_torch.utils.checks._is_traced`: a body that consults it branches on tracedness itself.

=======  ======================================================================
code     invariant
=======  ======================================================================
JL001    no host read of a tensor in traced code: ``float()/int()/bool()``,
         ``.item()``, ``if``/``while`` on tensor-valued expressions
JL002    no recompilation hazards: ``torch.compile`` of a function with str/bool
         config params (each distinct value is a guard failure and a new
         graph; bind them with ``functools.partial`` first); no
         f-string/``str()`` of a tensor in traced code
JL003    Metric state contract: every ``add_state`` name is used,
         ``dist_reduce_fx`` declared, host-side updates (``np.*``,
         ``.item()``/``.tolist()``/``.cpu()``/``.numpy()``, ``_host_fetch``)
         marked ``__jit_ineligible__`` (or carried by a list state)
JL004    no dtype-promotion hazards in traced code: ``np.`` calls on tensors,
         explicit float64/complex128 dtypes
JL005    no side effects in traced code: ``print``, ``torch.cuda.synchronize``
         and ``.synchronize()``, ``io_callback``/``host_callback``
JL006    namespace consistency: ``__all__`` present in functional package
         inits, every listed name bound, every public import exported
=======  ======================================================================
"""

from __future__ import annotations

import ast
from typing import Callable, Dict, List, Optional, Set

from metrics_tpu_torch.analysis.contexts import (
    ArrayTaint,
    TracedContext,
    Violation,
    _class_is_jit_ineligible,
    class_list_state_names,
    self_state_seeds,
)
from metrics_tpu_torch.analysis.engine import ModuleInfo, _dotted, _v

__all__ = ["ModuleInfo", "ALL_RULES"]

# the port's kernel timers and kernel-variant tools live in ops/, beside the kernels they time: host code, never traced
_HOST_TOOLS = frozenset({"metrics_tpu_torch/ops/profile.py", "metrics_tpu_torch/ops/variants.py"})
_TENSOR_TYPES = ("Tensor", "torch.Tensor")


def _contexts(mod: ModuleInfo) -> List[TracedContext]:
    return [] if mod.path in _HOST_TOOLS else mod.traced_contexts


def _non_tensor_names(fn: ast.AST) -> Dict[int, Set[str]]:
    """id(node) -> names proven not to be tensors there: the branch of ``if not isinstance(x, Tensor)`` (or the
    ``else`` of ``isinstance(x, Tensor)``, as a statement or an expression), where a host input is converted."""
    regions: Dict[int, Set[str]] = {}
    for node in ast.walk(fn):
        if not isinstance(node, (ast.If, ast.IfExp)):
            continue
        test, negated = node.test, False
        if isinstance(test, ast.UnaryOp) and isinstance(test.op, ast.Not):
            test, negated = test.operand, True
        if not (isinstance(test, ast.Call) and _dotted(test.func) == "isinstance" and len(test.args) == 2
                and isinstance(test.args[0], ast.Name) and _dotted(test.args[1]) in _TENSOR_TYPES):
            continue
        branch = node.body if negated else node.orelse
        for stmt in branch if isinstance(branch, list) else [branch]:
            for n in ast.walk(stmt):
                regions.setdefault(id(n), set()).add(test.args[0].id)
    return regions


# =========================================================================== JL001
def rule_jl001_tracer_concretization(mod: ModuleInfo) -> List[Violation]:
    out: List[Violation] = []
    for ctx in _contexts(mod):
        if ctx.concreteness_aware:
            continue  # the body branches on tracedness itself
        taint = ArrayTaint(ctx.node, state_attrs=self_state_seeds(ctx))
        for node in ast.walk(ctx.node):
            if isinstance(node, (ast.If, ast.While)):
                if taint.is_value_dependent_test(node.test):
                    kw = "while" if isinstance(node, ast.While) else "if"
                    out.append(_v(mod, node, "JL001",
                                  f"`{kw}` on a tensor-valued expression reads it on the host and fails under vmap "
                                  "(use torch.where or hoist to eager validation)", ctx.qualname))
            elif isinstance(node, ast.Call):
                fn = node.func
                if isinstance(fn, ast.Name) and fn.id in ("float", "int", "bool") and node.args:
                    if taint.is_array_expr(node.args[0]):
                        out.append(_v(mod, node, "JL001",
                                      f"`{fn.id}()` of a tensor reads it on the host and fails under vmap",
                                      ctx.qualname))
                elif isinstance(fn, ast.Attribute) and fn.attr == "item" and not node.args:
                    if taint.is_array_expr(fn.value):
                        out.append(_v(mod, node, "JL001",
                                      "`.item()` synchronizes with the card and fails under vmap", ctx.qualname))
    return out


# =========================================================================== JL002
_CONFIG_ANNOTATIONS = ("str", "bool", "Literal")
_COMPILERS = ("torch.compile", "compile")


def _param_needs_binding(arg: ast.arg, default: Optional[ast.expr]) -> bool:
    """A str/bool configuration parameter, on which a compiled graph specializes."""
    if isinstance(default, ast.Constant) and isinstance(default.value, (str, bool)):
        return True
    if arg.annotation is not None and any(tok in ast.unparse(arg.annotation) for tok in _CONFIG_ANNOTATIONS):
        return True
    return False


def _function_params_with_defaults(fn: ast.FunctionDef):
    """(arg, default or None) over the positional and keyword-only parameters."""
    pos = fn.args.posonlyargs + fn.args.args
    defaults = [None] * (len(pos) - len(fn.args.defaults)) + list(fn.args.defaults)
    yield from zip(pos, defaults)
    yield from zip(fn.args.kwonlyargs, fn.args.kw_defaults)


def rule_jl002_recompilation(mod: ModuleInfo) -> List[Violation]:
    out: List[Violation] = []
    functions = {n.name: n for n in mod.tree.body if isinstance(n, ast.FunctionDef)}

    def check_compile(node: ast.AST, target: ast.FunctionDef, bound: Set[str], where: str) -> None:
        for arg, default in _function_params_with_defaults(target):
            if arg.arg in bound or arg.arg == "self":
                continue
            if _param_needs_binding(arg, default):
                out.append(_v(mod, node, "JL002",
                              f"torch.compile of `{target.name}` leaves config param `{arg.arg}` free: the graph "
                              "guards on its value and recompiles for each one (bind it with functools.partial "
                              "before compiling)", where))

    # decorator form: @torch.compile / @torch.compile(...)
    for fn in (n for n in mod.nodes if isinstance(n, ast.FunctionDef)):
        for dec in fn.decorator_list:
            head = _dotted(dec.func if isinstance(dec, ast.Call) else dec)
            if head in _COMPILERS:
                check_compile(dec, fn, set(), fn.name)

    # call form: torch.compile(f) or torch.compile(functools.partial(f, mode=...)) of a module-level def
    for call in (n for n in mod.nodes if isinstance(n, ast.Call)):
        if _dotted(call.func) not in _COMPILERS or not call.args:
            continue
        first, bound = call.args[0], set()
        if isinstance(first, ast.Call) and _dotted(first.func) in ("functools.partial", "partial") and first.args:
            bound = {kw.arg for kw in first.keywords if kw.arg}
            first = first.args[0]
        if isinstance(first, ast.Name) and first.id in functions:
            check_compile(call, functions[first.id], bound, "<module>")

    # f-string / str() of tensors inside traced contexts
    for ctx in _contexts(mod):
        if ctx.concreteness_aware:
            continue  # formatting happens on the eager branch
        taint = ArrayTaint(ctx.node, state_attrs=self_state_seeds(ctx))
        # a `raise` message formats the tensor's repr once, on the way out: exempt
        in_raise: Set[int] = set()
        for stmt in ast.walk(ctx.node):
            if isinstance(stmt, ast.Raise):
                in_raise.update(id(n) for n in ast.walk(stmt))
        for node in ast.walk(ctx.node):
            if id(node) in in_raise:
                continue
            if isinstance(node, ast.JoinedStr):
                for part in node.values:
                    if isinstance(part, ast.FormattedValue) and taint.is_array_expr(part.value):
                        out.append(_v(mod, node, "JL002",
                                      "f-string interpolation of a tensor reads it on the host (and breaks a "
                                      "compiled graph)", ctx.qualname))
                        break
            elif isinstance(node, ast.Call) and isinstance(node.func, ast.Name) and node.func.id == "str":
                if node.args and taint.is_array_expr(node.args[0]):
                    out.append(_v(mod, node, "JL002", "`str()` of a tensor reads it on the host", ctx.qualname))
    return out


# =========================================================================== JL003
_HOST_CALL_ROOTS = ("np", "numpy")
_HOST_METHODS = ("tolist", "item", "cpu", "numpy")
_HOST_FETCHES = ("_host_fetch", "_host_value")


def _update_host_ops(update: ast.FunctionDef) -> List[ast.AST]:
    hits: List[ast.AST] = []
    for node in ast.walk(update):
        if isinstance(node, ast.Call):
            head = _dotted(node.func)
            if head.split(".")[0] in _HOST_CALL_ROOTS and head.count("."):
                hits.append(node)
            elif isinstance(node.func, ast.Attribute) and node.func.attr in _HOST_METHODS:
                hits.append(node)
            elif head.rsplit(".", 1)[-1] in _HOST_FETCHES:
                hits.append(node)
    return hits


def rule_jl003_state_contract(mod: ModuleInfo) -> List[Violation]:
    out: List[Violation] = []
    for cls in (n for n in mod.nodes if isinstance(n, ast.ClassDef)):
        add_state_calls = [
            c for c in ast.walk(cls)
            if isinstance(c, ast.Call)
            and isinstance(c.func, ast.Attribute) and c.func.attr == "add_state"
            and isinstance(c.func.value, ast.Name) and c.func.value.id == "self"
        ]
        if not add_state_calls:
            continue
        qual = cls.name
        update = next((s for s in cls.body if isinstance(s, ast.FunctionDef) and s.name == "update"), None)

        state_names: Dict[str, ast.Call] = {}
        for call in add_state_calls:
            has_reduce = len(call.args) >= 3 or any(kw.arg == "dist_reduce_fx" for kw in call.keywords)
            name_node = call.args[0] if call.args else None
            if isinstance(name_node, ast.Constant) and isinstance(name_node.value, str):
                state_names[name_node.value] = call
                if not has_reduce:
                    out.append(_v(mod, call, "JL003",
                                  f"state `{name_node.value}` registered without an explicit dist_reduce_fx "
                                  "(distributed sync semantics must be declared)", qual))
            elif not has_reduce:
                out.append(_v(mod, call, "JL003", "add_state without an explicit dist_reduce_fx", qual))

        if update is not None and state_names:
            # a use anywhere in the class counts: update may delegate to helpers, and dict-style access
            # (`self._state["name"]`, an f-string suffix such as f"{key}_features_sum") is idiomatic
            declaration_nodes = {id(c.args[0]) for c in add_state_calls if c.args}
            used_attrs: Set[str] = set()
            str_constants: Set[str] = set()
            fstr_suffixes: Set[str] = set()
            for n in ast.walk(cls):
                if isinstance(n, ast.Attribute) and isinstance(n.value, ast.Name) and n.value.id == "self":
                    used_attrs.add(n.attr)
                elif isinstance(n, ast.Constant) and isinstance(n.value, str) and id(n) not in declaration_nodes:
                    str_constants.add(n.value)
                elif isinstance(n, ast.JoinedStr):
                    for part in n.values:
                        if isinstance(part, ast.Constant) and isinstance(part.value, str):
                            fstr_suffixes.add(part.value)
            for sname, call in state_names.items():
                used = (sname in used_attrs or sname in str_constants
                        or any(suf and sname.endswith(suf) for suf in fstr_suffixes))
                if not used:
                    out.append(_v(mod, call, "JL003", f"state `{sname}` is never read or written outside add_state",
                                  qual))

        # a host-side update must be marked ineligible (or ride a list state): the fleet engine vmaps the rest
        if update is not None and not _class_is_jit_ineligible(cls) and not class_list_state_names(cls):
            for hit in _update_host_ops(update):
                out.append(_v(mod, hit, "JL003",
                              "host-side op in `update` of a jit-eligible metric (the engine batches it under "
                              "vmap) — set `__jit_ineligible__ = True` or register a list state", f"{qual}.update"))
    return out


# =========================================================================== JL004
# np.<attr> reads that are plain constants or dtypes: fine in traced code
_NP_SAFE_ATTRS = frozenset({
    "pi", "e", "inf", "nan", "newaxis", "euler_gamma",
    "float32", "float64", "int32", "int64", "uint8", "uint32", "uint64",
    "bool_", "int8", "int16", "uint16", "complex64", "complex128", "dtype",
    "ndarray", "integer", "floating", "number",
})
_WIDE_DTYPES = ("float64", "complex128")


def rule_jl004_dtype_promotion(mod: ModuleInfo) -> List[Violation]:
    out: List[Violation] = []
    for ctx in _contexts(mod):
        if ctx.concreteness_aware:
            continue
        taint = ArrayTaint(ctx.node, state_attrs=self_state_seeds(ctx))
        host_inputs = _non_tensor_names(ctx.node)

        def tensor(e: ast.expr, where: ast.AST) -> bool:
            return taint.is_array_expr(e) and not (isinstance(e, ast.Name) and e.id in host_inputs.get(id(where), ()))

        for node in ast.walk(ctx.node):
            if not isinstance(node, ast.Call):
                continue
            head = _dotted(node.func)
            root, _, attr = head.partition(".")
            if root in _HOST_CALL_ROOTS and attr and attr.split(".")[0] not in _NP_SAFE_ATTRS:
                # np.* over static configuration (a constant table) is fine, and so is np.* converting a host
                # input in its non-tensor branch; np.* over a tensor reads it
                feeds_tensor = any(tensor(a, node) for a in node.args) or any(
                    kw.arg != "dtype" and tensor(kw.value, node) for kw in node.keywords)
                if feeds_tensor:
                    out.append(_v(mod, node, "JL004",
                                  f"`{head}(...)` applied to a tensor copies it to the host and computes in "
                                  "float64 there (use torch)", ctx.qualname))
            for kw in node.keywords:
                if kw.arg == "dtype":
                    text = _dotted(kw.value) or (
                        kw.value.value if isinstance(kw.value, ast.Constant) and isinstance(kw.value.value, str)
                        else "")
                    if any(w in str(text) for w in _WIDE_DTYPES):
                        out.append(_v(mod, node, "JL004",
                                      f"explicit {text} dtype promotes the kernel to 64 bits (the float32 regime "
                                      "keeps float32)", ctx.qualname))
    return out


# =========================================================================== JL005
_SIDE_EFFECT_CALLS = ("jax.experimental.io_callback", "io_callback",
                      "jax.experimental.host_callback.call", "host_callback.call")
_BLOCKING_CALLS = ("torch.cuda.synchronize",)


def rule_jl005_side_effects(mod: ModuleInfo) -> List[Violation]:
    out: List[Violation] = []
    for ctx in _contexts(mod):
        for node in ast.walk(ctx.node):
            if not isinstance(node, ast.Call):
                continue
            head = _dotted(node.func)
            if head == "print":
                out.append(_v(mod, node, "JL005",
                              "`print` in traced code reads its tensors on the host and breaks a compiled graph",
                              ctx.qualname))
            elif head in _BLOCKING_CALLS or (isinstance(node.func, ast.Attribute)
                                              and node.func.attr in ("synchronize", "block_until_ready")):
                out.append(_v(mod, node, "JL005",
                              f"`{head or node.func.attr}()` is a host sync in traced code", ctx.qualname))
            elif head in _SIDE_EFFECT_CALLS:
                out.append(_v(mod, node, "JL005", f"`{head}` is an impure host callback in a traced region",
                              ctx.qualname))
    return out


# =========================================================================== JL006
def _all_literal_names(tree: ast.Module) -> Optional[List[ast.Constant]]:
    for stmt in tree.body:
        targets = stmt.targets if isinstance(stmt, ast.Assign) else (
            [stmt.target] if isinstance(stmt, ast.AnnAssign) else [])
        if any(isinstance(t, ast.Name) and t.id == "__all__" for t in targets):
            value = stmt.value
            if isinstance(value, (ast.List, ast.Tuple)):
                return [e for e in value.elts if isinstance(e, ast.Constant) and isinstance(e.value, str)]
    return None


def _bound_names(tree: ast.Module) -> Set[str]:
    names: Set[str] = set()
    for stmt in tree.body:
        if isinstance(stmt, (ast.Import, ast.ImportFrom)):
            for alias in stmt.names:
                if alias.name != "*":
                    names.add(alias.asname or alias.name.split(".")[0])
        elif isinstance(stmt, (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef)):
            names.add(stmt.name)
        elif isinstance(stmt, ast.Assign):
            names.update(t.id for t in stmt.targets if isinstance(t, ast.Name))
        elif isinstance(stmt, ast.AnnAssign) and isinstance(stmt.target, ast.Name):
            names.add(stmt.target.id)
    return names


def rule_jl006_namespace(mod: ModuleInfo) -> List[Violation]:
    if not mod.is_package_init:
        return []
    out: List[Violation] = []
    all_names = _all_literal_names(mod.tree)
    if all_names is None:
        if mod.is_functional:  # only functional-layer packages are held to the export contract
            out.append(_v(mod, mod.tree, "JL006", "package __init__ has no literal __all__"))
        return out
    bound = _bound_names(mod.tree)
    listed = set()
    for const in all_names:
        listed.add(const.value)
        if const.value not in bound:
            out.append(_v(mod, const, "JL006", f"`{const.value}` listed in __all__ but never bound"))
    for stmt in mod.tree.body:
        if isinstance(stmt, ast.ImportFrom) and stmt.module and "metrics_tpu" in stmt.module:
            for alias in stmt.names:
                name = alias.asname or alias.name
                if name.startswith("_") or alias.name == "*":
                    continue
                if name not in listed:
                    out.append(_v(mod, stmt, "JL006",
                                  f"public import `{name}` missing from __all__ (silent namespace drift)"))
    return out


ALL_RULES: Dict[str, Callable[[ModuleInfo], List[Violation]]] = {
    "JL001": rule_jl001_tracer_concretization,
    "JL002": rule_jl002_recompilation,
    "JL003": rule_jl003_state_contract,
    "JL004": rule_jl004_dtype_promotion,
    "JL005": rule_jl005_side_effects,
    "JL006": rule_jl006_namespace,
}

SUMMARIES = {
    "JL001": "host read of a tensor (float/int/bool, .item(), if/while on tensors) in traced code",
    "JL002": "recompilation hazard: torch.compile with free str/bool config params / str() of tensors",
    "JL003": "Metric state contract: unused states, missing dist_reduce_fx, unmarked host updates",
    "JL004": "dtype-promotion hazard: np. calls on tensors or explicit 64-bit dtypes in traced code",
    "JL005": "side effects in traced code: print, synchronize, io_callback/host_callback",
    "JL006": "namespace consistency: __all__ present, every name bound, public imports exported",
}
