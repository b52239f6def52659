"""Lint core: violations, suppressions, the update/compute bodies a rule looks at, and tensor taint
(counterpart of ``metrics_tpu/analysis/contexts.py``).

The rule-code tables, :class:`Violation` keys and the suppression grammar are the JAX package's, so that a
baseline or a ``# hotlint: disable=HL001`` comment reads the same in both packages. What a rule treats as
a device value differs: here it is a ``torch.Tensor``, produced by ``torch.*`` and ``F.*`` calls and by
tensor methods, where the JAX package's is a ``jnp``/``lax`` array.

A *traced context* is the JAX package's notion (an update or compute body a trace may run, a functional
kernel). Every port update runs eagerly, and only the fleet engine and the replica wrappers run one under
``torch.func.vmap``; the numerical rules (NL001-NL003, NL005) keep the JAX package's choice of bodies, which
is the same source shape in both packages.
"""

from __future__ import annotations

import ast
import re
from dataclasses import dataclass
from typing import List, Optional, Sequence, Set, Tuple

__all__ = [
    "Violation",
    "Suppressions",
    "TracedContext",
    "find_traced_contexts",
    "ArrayTaint",
    "LINT_PREFIXES",
    "RULE_CODES",
    "DIST_RULE_CODES",
    "MEM_RULE_CODES",
    "SYNC_RULE_CODES",
    "NUM_RULE_CODES",
    "RACE_RULE_CODES",
]

RULE_CODES = ("JL001", "JL002", "JL003", "JL004", "JL005", "JL006")
DIST_RULE_CODES = ("DL001", "DL002", "DL003", "DL004", "DL005")
MEM_RULE_CODES = ("ML001", "ML002", "ML003", "ML004", "ML005", "ML006")
SYNC_RULE_CODES = ("HL001", "HL002", "HL003", "HL004", "HL005", "HL006")
NUM_RULE_CODES = ("NL001", "NL002", "NL003", "NL004", "NL005", "NL006")
RACE_RULE_CODES = ("RC001", "RC002", "RC003", "RC004", "RC005", "RC006")

# one suppression grammar for every prefix; a prefix may carry codes of any pass (codes are unique)
LINT_PREFIXES = ("jitlint", "distlint", "donlint", "hotlint", "numlint", "racelint")
_PREFIX_ALT = "|".join(LINT_PREFIXES)
_SUPPRESS_RE = re.compile(rf"#\s*(?:{_PREFIX_ALT}):\s*disable=([A-Za-z0-9_,\s]+)")
_SUPPRESS_FILE_RE = re.compile(rf"#\s*(?:{_PREFIX_ALT}):\s*disable-file=([A-Za-z0-9_,\s]+)")


@dataclass(frozen=True)
class Violation:
    """One rule hit, addressable for both human output and the baseline."""

    path: str  # repo-relative posix path
    line: int
    col: int
    rule: str
    message: str
    context: str = "<module>"  # qualified name of the enclosing def/class

    def key(self) -> str:
        """Line-number-free identity used by the baseline (stable across edits)."""
        return f"{self.path}::{self.rule}::{self.context}"

    def render(self) -> str:
        return f"{self.path}:{self.line}:{self.col}: {self.rule} {self.message} [{self.context}]"


class Suppressions:
    """Per-line ``# hotlint: disable=HL001[,NL004|all]`` comments, read through
    :class:`metrics_tpu_torch.analysis.engine.SourceMarkers` (one tokenize pass per module)."""

    def __init__(self, source: str) -> None:
        from metrics_tpu_torch.analysis.engine import SourceMarkers  # local: avoid an import cycle

        self._markers = SourceMarkers(source)

    def is_suppressed(self, line: int, rule: str) -> bool:
        return self._markers.is_suppressed(line, rule)


@dataclass
class TracedContext:
    """An update, compute or functional-kernel body the numerical rules look at."""

    node: ast.AST  # FunctionDef | AsyncFunctionDef
    qualname: str
    kind: str  # "update" | "compute" | "kernel"
    concreteness_aware: bool = False  # references _is_traced
    owner_class: Optional[ast.ClassDef] = None


def _class_is_jit_ineligible(cls: ast.ClassDef) -> bool:
    """True if the class marks itself ``__jit_ineligible__ = True`` in its own body."""
    for stmt in cls.body:
        if isinstance(stmt, ast.Assign):
            targets, value = stmt.targets, stmt.value
        elif isinstance(stmt, ast.AnnAssign) and stmt.value is not None:
            targets, value = [stmt.target], stmt.value
        else:
            continue
        for t in targets:
            if isinstance(t, ast.Name) and t.id == "__jit_ineligible__":
                if isinstance(value, ast.Constant) and bool(value.value):
                    return True
    return False


def class_list_state_names(cls: ast.ClassDef) -> Set[str]:
    """State names registered with a ``[]`` default anywhere in the class body."""
    names: Set[str] = set()
    for call in (n for n in ast.walk(cls) if isinstance(n, ast.Call)):
        if not (isinstance(call.func, ast.Attribute) and call.func.attr == "add_state"):
            continue
        args = call.args
        default = args[1] if len(args) > 1 else next(
            (kw.value for kw in call.keywords if kw.arg == "default"), None
        )
        if isinstance(default, ast.List) and not default.elts:
            if args and isinstance(args[0], ast.Constant) and isinstance(args[0].value, str):
                names.add(args[0].value)
    return names


_NON_ARRAY_TYPE_NAMES = frozenset(
    {"int", "float", "bool", "str", "bytes", "list", "tuple", "dict", "set", "type(None)"}
)


def _isinstance_narrowed_names(expr: ast.expr) -> Set[str]:
    """Names proven non-tensor by an ``isinstance(name, int/str/...)`` check."""
    if not (
        isinstance(expr, ast.Call)
        and isinstance(expr.func, ast.Name)
        and expr.func.id == "isinstance"
        and len(expr.args) == 2
        and isinstance(expr.args[0], ast.Name)
    ):
        return set()
    types = expr.args[1]
    candidates = types.elts if isinstance(types, ast.Tuple) else [types]
    if all(isinstance(t, ast.Name) and t.id in _NON_ARRAY_TYPE_NAMES for t in candidates):
        return {expr.args[0].id}
    return set()


def _references_tracer_guard(fn: ast.AST) -> bool:
    for node in ast.walk(fn):
        if isinstance(node, ast.Name) and node.id == "_is_traced":
            return True
        if isinstance(node, ast.Attribute) and node.attr in ("Tracer", "_is_traced"):
            return True
    return False


def find_traced_contexts(tree: ast.Module, is_functional_module: bool) -> List[TracedContext]:
    """Update/compute bodies of classes that register their own tensor states, and (in a functional module)
    every module-level function."""
    out: List[TracedContext] = []

    def visit_class(cls: ast.ClassDef, prefix: str) -> None:
        if _class_is_jit_ineligible(cls) or class_list_state_names(cls):
            return
        has_own_states = any(
            isinstance(n, ast.Call) and isinstance(n.func, ast.Attribute) and n.func.attr == "add_state"
            for n in ast.walk(cls)
        )
        if not has_own_states:
            return  # states live in a base class elsewhere: unknowable statically
        for stmt in cls.body:
            if isinstance(stmt, (ast.FunctionDef, ast.AsyncFunctionDef)) and stmt.name in ("update", "compute"):
                out.append(
                    TracedContext(
                        node=stmt,
                        qualname=f"{prefix}{cls.name}.{stmt.name}",
                        kind=stmt.name,
                        concreteness_aware=_references_tracer_guard(stmt),
                        owner_class=cls,
                    )
                )

    for stmt in tree.body:
        if isinstance(stmt, ast.ClassDef):
            visit_class(stmt, "")
        elif isinstance(stmt, (ast.FunctionDef, ast.AsyncFunctionDef)) and is_functional_module:
            out.append(
                TracedContext(
                    node=stmt,
                    qualname=stmt.name,
                    kind="kernel",
                    concreteness_aware=_references_tracer_guard(stmt),
                )
            )
    return out


# --------------------------------------------------------------------------- taint
# calls under these roots produce tensors (``torch.cuda``/``torch.distributed`` & co. below do not)
_ARRAY_MODULE_ROOTS = ("torch", "F")
_TORCH_HOST_NAMESPACES = frozenset({
    "cuda", "distributed", "library", "utils", "autograd", "backends", "profiler", "jit", "compiler",
    "testing", "hub", "onnx", "overrides", "func",
})
# a tensor annotation marks a value that lives on the device; ``np.ndarray`` annotations mark host arrays
_ARRAY_ANNOTATIONS = ("Tensor",)
# attribute reads that are host values (static under vmap) and never taint
_STATIC_ATTRS = frozenset({"shape", "ndim", "dtype", "device", "is_cuda", "requires_grad", "layout"})
# torch functions whose result is a host value
_STATIC_ARRAY_FNS = frozenset({
    "finfo", "iinfo", "dtype", "device", "Size", "result_type", "promote_types", "can_cast",
    "is_tensor", "is_floating_point", "is_complex", "is_nonzero", "numel", "get_default_dtype",
    "no_grad", "inference_mode", "enable_grad", "Generator", "manual_seed", "broadcast_shapes",
    "size", "dim", "element_size", "nelement", "is_contiguous", "data_ptr", "get_device", "stride",
})
# tensor methods whose result is still a tensor on the same device
_ARRAY_METHODS = frozenset({
    "sum", "mean", "max", "min", "prod", "reshape", "flatten", "ravel", "squeeze", "unsqueeze",
    "transpose", "clip", "clamp", "cumsum", "cumprod", "any", "all", "argmax", "argmin", "argsort",
    "sort", "round", "take", "repeat", "swapaxes", "conj", "real", "imag", "T", "mT", "dot", "std",
    "var", "item", "tolist", "float", "double", "half", "long", "int", "bool", "to", "view", "view_as",
    "expand", "expand_as", "clone", "detach", "contiguous", "abs", "exp", "log", "sqrt", "pow",
    "gather", "index_select", "masked_fill", "scatter", "scatter_add", "index_add", "index_put",
    "permute", "eq", "ne", "gt", "lt", "ge", "le", "sign", "isnan", "isfinite", "isinf", "topk",
    "new_zeros", "new_ones", "new_full", "new_empty", "new_tensor", "type", "type_as", "logical_not",
    "logical_and", "logical_or", "where", "norm", "amax", "amin", "nansum", "square", "neg",
    "reciprocal", "unbind", "split", "chunk", "narrow", "flip", "roll", "diff", "matmul", "mm",
    "bmm", "mul", "add", "sub", "div", "floor", "ceil", "log1p", "expm1", "sigmoid", "softmax",
    "log_softmax", "tril", "triu", "diagonal", "diag", "trace", "numpy", "cpu", "cuda", "unique",
    "nonzero", "bincount", "masked_select", "repeat_interleave", "count_nonzero",
})


def _annotation_is_array(ann: Optional[ast.expr]) -> bool:
    if ann is None:
        return False
    text = ast.unparse(ann)
    return any(token in text for token in _ARRAY_ANNOTATIONS)


class ArrayTaint:
    """Conservative intra-function inference of which names hold device tensors.

    Seeds: parameters annotated ``Tensor`` and ``self.<state>`` reads of registered states. Propagation:
    assignments whose right side is tensor-valued (``torch.*``/``F.*`` calls, arithmetic over tainted
    operands, subscripts and tensor methods of tainted values). ``.shape``/``.dtype``/``.device`` reads are
    host values and break the chain.
    """

    def __init__(self, fn: ast.AST, extra_seeds: Sequence[str] = (), state_attrs: Sequence[str] = ()) -> None:
        self.tainted: Set[str] = set(extra_seeds)
        self.state_attrs: Set[str] = set(state_attrs)
        args = getattr(fn, "args", None)
        if args is not None:
            for a in list(args.posonlyargs) + list(args.args) + list(args.kwonlyargs):
                if _annotation_is_array(a.annotation):
                    self.tainted.add(a.arg)
            for va in (args.vararg, args.kwarg):
                if va is not None and _annotation_is_array(va.annotation):
                    self.tainted.add(va.arg)
        for _ in range(2):  # fixpoint over assignments: two passes cover straight-line reuse
            for node in ast.walk(fn):
                if isinstance(node, ast.Assign):
                    if self.is_array_expr(node.value):
                        for t in node.targets:
                            self._taint_target(t)
                elif isinstance(node, ast.AnnAssign) and node.value is not None:
                    if _annotation_is_array(node.annotation) or self.is_array_expr(node.value):
                        self._taint_target(node.target)
                elif isinstance(node, ast.AugAssign):
                    if self.is_array_expr(node.value) or self.is_array_expr(node.target):
                        self._taint_target(node.target)

    def _taint_target(self, target: ast.expr) -> None:
        if isinstance(target, ast.Name):
            self.tainted.add(target.id)
        elif isinstance(target, (ast.Tuple, ast.List)):
            for elt in target.elts:
                self._taint_target(elt)

    def is_array_expr(self, e: ast.expr) -> bool:
        """Does this expression plausibly evaluate to a device tensor?"""
        if isinstance(e, ast.Name):
            return e.id in self.tainted
        if isinstance(e, ast.Attribute):
            if e.attr in _STATIC_ATTRS:
                return False
            if isinstance(e.value, ast.Name) and e.value.id == "self":
                return e.attr in self.state_attrs
            return self.is_array_expr(e.value) and e.attr in _ARRAY_METHODS | {"real", "imag", "T", "mT"}
        if isinstance(e, ast.Subscript):
            return self.is_array_expr(e.value)
        if isinstance(e, ast.BinOp):
            return self.is_array_expr(e.left) or self.is_array_expr(e.right)
        if isinstance(e, ast.UnaryOp):
            return self.is_array_expr(e.operand)
        if isinstance(e, ast.IfExp):
            return self.is_array_expr(e.body) or self.is_array_expr(e.orelse)
        if isinstance(e, ast.Call):
            return self._is_array_call(e)
        if isinstance(e, ast.Compare):
            if all(isinstance(op, (ast.Is, ast.IsNot, ast.In, ast.NotIn)) for op in e.ops):
                return False
            return self.is_array_expr(e.left) or any(self.is_array_expr(c) for c in e.comparators)
        if isinstance(e, (ast.Tuple, ast.List)):
            return any(self.is_array_expr(x) for x in e.elts)
        return False

    def _is_array_call(self, call: ast.Call) -> bool:
        fn = call.func
        if isinstance(fn, ast.Attribute):
            if fn.attr in _STATIC_ARRAY_FNS:
                return False
            chain: List[str] = [fn.attr]
            root = fn.value
            while isinstance(root, ast.Attribute):
                chain.append(root.attr)
                root = root.value
            if isinstance(root, ast.Name) and root.id in _ARRAY_MODULE_ROOTS:
                sub = chain[-1] if len(chain) > 1 else ""
                return sub not in _TORCH_HOST_NAMESPACES
            if fn.attr in _ARRAY_METHODS and self.is_array_expr(fn.value):
                return fn.attr not in ("item", "tolist", "numpy", "cpu")  # those leave the device (rule-handled)
        return False

    def is_value_dependent_test(self, test: ast.expr, narrowed: Optional[Set[str]] = None) -> bool:
        """Would branching on this expression read a device value on the host?"""
        narrowed = narrowed if narrowed is not None else set()
        if isinstance(test, ast.Compare):
            if all(isinstance(op, (ast.Is, ast.IsNot, ast.In, ast.NotIn)) for op in test.ops):
                return False
            operands = [test.left, *test.comparators]
            return any(
                self.is_array_expr(o) and not (isinstance(o, ast.Name) and o.id in narrowed)
                for o in operands
            )
        if isinstance(test, ast.BoolOp):
            local = set(narrowed)
            for v in test.values:
                if self.is_value_dependent_test(v, local):
                    return True
                if isinstance(test.op, ast.And):
                    local |= _isinstance_narrowed_names(v)
            return False
        if isinstance(test, ast.UnaryOp) and isinstance(test.op, ast.Not):
            return self.is_value_dependent_test(test.operand, narrowed)
        if isinstance(test, ast.Name) and test.id in narrowed:
            return False
        return self.is_array_expr(test)


def self_state_seeds(ctx: TracedContext) -> Tuple[str, ...]:
    """Registered state names of a metric context, for :class:`ArrayTaint`'s ``state_attrs``."""
    if ctx.owner_class is None:
        return ()
    names: Set[str] = set()
    for call in (n for n in ast.walk(ctx.owner_class) if isinstance(n, ast.Call)):
        if isinstance(call.func, ast.Attribute) and call.func.attr == "add_state":
            if call.args and isinstance(call.args[0], ast.Constant) and isinstance(call.args[0].value, str):
                names.add(call.args[0].value)
    return tuple(sorted(names))
