"""donlint rules ML001-ML006: escape and alias analysis of metric state tensors, in torch idioms (counterpart of
``metrics_tpu/analysis/mem_rules.py``).

The JAX package donates the state buffers to its jitted update, so a reference that survives the dispatch
reads a deleted buffer. The port donates nothing: an update replaces its tensor states. The hazard has a torch
form all the same. A state tensor that escapes ``update`` or ``compute`` (returned, captured by a closure,
stashed in a non-state attribute, spliced into another metric's ``__dict__['_state']``) is an alias, and it
changes under its holder as soon as any later update mutates the state in place (``add_``, ``index_add_``,
``copy_``, ``+=`` on a tensor). Two states bound to one tensor, or a ``reset`` that re-binds the registered
default itself, make one in-place fold corrupt the other state or every later reset. The severing call is
``.clone()`` (``.detach().clone()``), where the JAX rules read ``jnp.copy``:

=======  ======================================================================
code     invariant
=======  ======================================================================
ML001    a state tensor must not escape ``update``: no ``return`` of state
         reads, no closure capture, no stashing into non-state instance
         attributes, and no splicing external references into a metric's
         ``__dict__['_state']`` without a clone or the escape latch
ML002    two state names must not bind one tensor (shared ``add_state``
         default, ``self.a = self.b``, chained assigns)
ML003    a list state whose ``update`` only ever appends fixed-shape scalars is
         shape-stackable: it could be a tensor state, and as a list it keeps
         the class out of the fleet engine's vmapped buckets
ML004    ``donate_states=False`` opt-outs (accepted and kept by the port) must
         carry a justifying comment on (or immediately above) the same line
ML005    ``compute`` must not stash state reads into instance attributes
ML006    a ``reset`` override must not re-bind states to the shared default
         tensors (``self._defaults[...]``) or to one shared local — delegate to
         ``super().reset()``
=======  ======================================================================

Each rule is a callable ``rule(module: ModuleInfo) -> list[Violation]``, registered in :data:`MEM_RULES`; the
shared engine applies ``# donlint: disable=…`` suppressions and
``metrics_tpu_torch/analysis/baselines/donlint_baseline.json`` afterwards. The dynamic complement, 3-update
loops cross-checking this module's :func:`classify_donation` against ``observe/costs.py``'s
``_donation_eligible`` and the runtime lifecycle, is :mod:`metrics_tpu_torch.analysis.donation_contracts`.
"""

from __future__ import annotations

import ast
from typing import Callable, Dict, List, Optional, Sequence, Set, Tuple

from metrics_tpu_torch.analysis.contexts import Violation, _class_is_jit_ineligible, class_list_state_names
from metrics_tpu_torch.analysis.dist_rules import _is_self_state, _metric_classes, _method, _state_names
from metrics_tpu_torch.analysis.engine import ModuleInfo, SourceMarkers, _dotted, _v

__all__ = ["MEM_RULES", "class_donation_blockers", "classify_donation"]


# --------------------------------------------------------------------------- helpers
# calls that sever an alias: the result is a fresh tensor (torch.as_tensor, .detach() and .to() are absent:
# they may return the same storage)
_COPY_LEAVES = frozenset({"clone", "copy", "deepcopy", "array"})


def _is_copy_call(e: ast.expr) -> bool:
    if not isinstance(e, ast.Call):
        return False
    fn = e.func
    name = _dotted(fn)
    if name:
        return name.rsplit(".", 1)[-1] in _COPY_LEAVES
    return isinstance(fn, ast.Attribute) and fn.attr in _COPY_LEAVES


def _state_reads_uncopied(node: Optional[ast.AST], states: Set[str]) -> List[ast.Attribute]:
    """``self.<state>`` reads in a subtree that are NOT wrapped in a copy call."""
    found: List[ast.Attribute] = []
    if node is None:
        return found

    def visit(n: ast.AST) -> None:
        if isinstance(n, ast.Call) and _is_copy_call(n):
            return  # .clone() / .copy() / deepcopy(...) sever the alias
        if isinstance(n, ast.Attribute) and _is_self_state(n, states):
            found.append(n)
            return
        for child in ast.iter_child_nodes(n):
            visit(child)

    visit(node)
    return found


def _donation_exposed(cls: ast.ClassDef) -> bool:
    """Is this class's update one the engine batches (host-side classes never are)?"""
    return not _class_is_jit_ineligible(cls) and not class_donation_blockers(cls)


def _comment_lines(source: str) -> Set[int]:
    """Commented line numbers, from the shared one-pass comment scan."""
    return SourceMarkers(source).comment_lines()


def _owner_map(tree: ast.Module) -> Dict[int, str]:
    """id(node) → qualified name of the enclosing def/class (DL004's scheme)."""
    owner: Dict[int, str] = {}

    def walk(node: ast.AST, qual: str) -> None:
        for child in ast.iter_child_nodes(node):
            q = qual
            if isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef)):
                q = f"{qual}.{child.name}" if qual != "<module>" else child.name
            owner[id(child)] = qual
            walk(child, q)

    walk(tree, "<module>")
    return owner


def _stash_violations(
    mod: ModuleInfo, fn: ast.FunctionDef, states: Set[str], rule: str, qual: str, where: str
) -> List[Violation]:
    """Assignments/appends inside ``fn`` that park a state read in an instance slot."""
    out: List[Violation] = []
    for node in ast.walk(fn):
        if isinstance(node, ast.Assign):
            for target in node.targets:
                if (
                    isinstance(target, ast.Attribute)
                    and isinstance(target.value, ast.Name)
                    and target.value.id == "self"
                    and target.attr not in states
                ):
                    reads = _state_reads_uncopied(node.value, states)
                    if reads:
                        out.append(_v(mod, node, rule,
                                      f"`{where}` stashes state `{reads[0].attr}` into instance attribute "
                                      f"`self.{target.attr}` without a clone — the held alias changes under "
                                      "its holder when a later update mutates the state in place (.clone() it, "
                                      "or keep it as a registered state)", qual))
        elif isinstance(node, ast.Call) and isinstance(node.func, ast.Attribute) and node.func.attr == "append":
            holder = node.func.value
            if isinstance(holder, ast.Attribute) and isinstance(holder.value, ast.Name) and holder.value.id == "self":
                reads = [r for a in node.args for r in _state_reads_uncopied(a, states)]
                if reads:
                    out.append(_v(mod, node, rule,
                                  f"`{where}` appends state `{reads[0].attr}` to `self.{holder.attr}` "
                                  "without a clone — the container holds an alias a later in-place "
                                  "update will change", qual))
    return out


# =========================================================================== ML001
def _is_state_dict_ref(e: ast.expr) -> bool:
    """``<obj>.__dict__["_state"]`` — the raw state dict, latch not consulted."""
    return (
        isinstance(e, ast.Subscript)
        and isinstance(e.value, ast.Attribute)
        and e.value.attr == "__dict__"
        and isinstance(e.slice, ast.Constant)
        and e.slice.value == "_state"
    )


# either flag marks the states as shared with a holder outside the metric
_LATCH_FLAGS = ("_state_escaped", "_group_shared")


def _sets_escape_latch(fn: ast.AST) -> bool:
    """Does this function participate in the latch protocol (sets a latch flag)?"""
    for n in ast.walk(fn):
        if isinstance(n, ast.Assign):
            for t in n.targets:
                if isinstance(t, ast.Attribute) and t.attr in _LATCH_FLAGS:
                    return True
                if (
                    isinstance(t, ast.Subscript)
                    and isinstance(t.slice, ast.Constant)
                    and t.slice.value in _LATCH_FLAGS
                ):
                    return True
    return False


def _reads_metric_state(e: Optional[ast.expr]) -> bool:
    """Does this expression read ``<obj>.metric_state``?

    The property arms the escape latch on every object it is read from, so
    values built from it are safe to splice.
    """
    if e is None:
        return False
    return any(
        isinstance(n, ast.Attribute) and n.attr == "metric_state" for n in ast.walk(e)
    )


def rule_ml001_update_escape(mod: ModuleInfo) -> List[Violation]:
    """No state tensor may escape ``update`` (or be spliced into one).

    Three in-class escape routes — returning a state read, capturing one in a
    nested function/lambda, stashing one in a non-state instance attribute —
    plus the cross-object route: writing external references directly into a
    metric's ``__dict__['_state']`` bypasses ``__setattr__``'s escape latch, so
    two holders share one tensor that an in-place update changes under both.
    """
    out: List[Violation] = []
    for cls, calls in _metric_classes(mod):
        states = set(_state_names(calls))
        update = _method(cls, "update")
        if update is None or not states or not _donation_exposed(cls):
            continue
        qual = f"{cls.name}.update"
        for node in ast.walk(update):
            if isinstance(node, ast.Return) and node.value is not None:
                reads = _state_reads_uncopied(node.value, states)
                if reads:
                    out.append(_v(mod, node, "ML001",
                                  f"update returns state `{reads[0].attr}` without a clone — the caller holds "
                                  "an alias a later in-place update changes (return .clone() or read the "
                                  "state from compute instead)", qual))
            elif isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef, ast.Lambda)) and node is not update:
                body = node.body if isinstance(node, ast.Lambda) else node
                reads = _state_reads_uncopied(body, states)
                if reads:
                    out.append(_v(mod, node, "ML001",
                                  f"nested function captures state `{reads[0].attr}` by closure — the "
                                  "closure cell outlives the update and sees later in-place changes "
                                  "(pass the value as an argument or clone it first)", qual))
        out.extend(_stash_violations(mod, update, states, "ML001", qual, "update"))

    # cross-object splices: anywhere in the package except the runtime itself,
    # which owns the _state/_state_escaped protocol
    if mod.path != "metrics_tpu_torch/metric.py" and "__dict__" in mod.source:
        owner = _owner_map(mod.tree)
        for fn in (n for n in mod.nodes if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef))):
            if _sets_escape_latch(fn):
                continue  # the site marks the states shared; the splice is safe
            for node in ast.walk(fn):
                spliced_value: Optional[ast.expr] = None
                if isinstance(node, ast.Assign):
                    for target in node.targets:
                        if _is_state_dict_ref(target) or (
                            isinstance(target, ast.Subscript) and _is_state_dict_ref(target.value)
                        ):
                            spliced_value = node.value
                elif (
                    # the dict-method form: <obj>.__dict__["_state"].update(values)
                    isinstance(node, ast.Call)
                    and isinstance(node.func, ast.Attribute)
                    and node.func.attr == "update"
                    and _is_state_dict_ref(node.func.value)
                    and node.args
                ):
                    spliced_value = node.args[0]
                if spliced_value is None:
                    continue
                if _is_copy_call(spliced_value) or _reads_metric_state(spliced_value):
                    continue  # fresh tensors, or sources latched by the property read
                out.append(_v(mod, node, "ML001",
                              "writes into a metric's __dict__['_state'] without a clone or the "
                              "_state_escaped latch — the spliced tensor is shared, and an in-place "
                              "update of either holder changes the other (.clone() the value "
                              "or set _state_escaped=True alongside the splice)",
                              owner.get(id(node), fn.name)))
    return out


# =========================================================================== ML002
def rule_ml002_state_aliasing(mod: ModuleInfo) -> List[Violation]:
    """Two state names must never bind one tensor: an in-place fold of one changes the other."""
    out: List[Violation] = []
    for cls, calls in _metric_classes(mod):
        states = set(_state_names(calls))
        # (a) one expression object registered as the default of several states
        by_default: Dict[str, List[str]] = {}
        for sname, call in _state_names(calls).items():
            default = call.args[1] if len(call.args) > 1 else next(
                (kw.value for kw in call.keywords if kw.arg == "default"), None
            )
            if isinstance(default, ast.Name):
                by_default.setdefault(default.id, []).append(sname)
        for var, group in sorted(by_default.items()):
            if len(group) >= 2:
                out.append(_v(mod, cls, "ML002",
                              f"states {', '.join(f'`{g}`' for g in sorted(group))} share one default "
                              f"tensor (`{var}`) — an in-place fold of one changes the other; give each "
                              "state its own default (or .clone() the shared value per add_state)",
                              cls.name))
        # (b)/(c) state-to-state and chained assignments in any method body
        for fn in (s for s in cls.body if isinstance(s, ast.FunctionDef)):
            qual = f"{cls.name}.{fn.name}"
            for node in ast.walk(fn):
                if not isinstance(node, ast.Assign):
                    continue
                state_targets = [t for t in node.targets if _is_self_state(t, states)]
                if len(state_targets) >= 2:
                    names = ", ".join(f"`{t.attr}`" for t in state_targets)  # type: ignore[union-attr]
                    out.append(_v(mod, node, "ML002",
                                  f"chained assignment binds states {names} to one tensor — an in-place "
                                  "fold of one changes both; assign each state separately", qual))
                elif (
                    state_targets
                    and _is_self_state(node.value, states)
                    and node.value.attr != state_targets[0].attr  # type: ignore[union-attr]
                ):
                    out.append(_v(mod, node, "ML002",
                                  f"state `{state_targets[0].attr}` aliased to state "  # type: ignore[union-attr]
                                  f"`{node.value.attr}` — two names, one tensor; clone explicitly "  # type: ignore[union-attr]
                                  "(.clone()) if a snapshot is intended", qual))
    return out


# =========================================================================== ML003
_SCALAR_REDUCTIONS = frozenset({
    "sum", "mean", "max", "min", "prod", "median", "std", "var",
    "count_nonzero", "nansum", "nanmean", "all", "any",
})


def _fixed_shape_expr(e: ast.expr, fixed_locals: Optional[Set[str]] = None) -> bool:
    """Conservatively: does this expression have the same shape every batch?"""
    if isinstance(e, ast.Constant):
        return isinstance(e.value, (bool, int, float, complex))
    if isinstance(e, ast.Name):
        return bool(fixed_locals) and e.id in fixed_locals
    if isinstance(e, ast.Call):
        fn = e.func
        name = _dotted(fn)
        leaf = name.rsplit(".", 1)[-1] if name else (fn.attr if isinstance(fn, ast.Attribute) else "")
        if leaf in _SCALAR_REDUCTIONS:
            # an axis/dim argument keeps a batch-shaped remainder — not a scalar
            if any(kw.arg in ("axis", "dim", "keepdims", "where") for kw in e.keywords):
                return False
            return len(e.args) <= 1
        return False
    if isinstance(e, ast.BinOp):
        return _fixed_shape_expr(e.left, fixed_locals) and _fixed_shape_expr(e.right, fixed_locals)
    if isinstance(e, ast.UnaryOp):
        return _fixed_shape_expr(e.operand, fixed_locals)
    return False


def _fixed_shape_locals(fn: ast.FunctionDef) -> Set[str]:
    """Locals bound exactly once in ``fn``, to a fixed-shape expression.

    One dataflow step, resolved to a fixpoint so ``a = x.sum(); b = a * 2``
    marks both. Any second binding (reassignment, loop/with/comprehension
    target, unpacking) disqualifies the name — its shape is no longer provable.
    """
    bind_counts: Dict[str, int] = {}
    candidates: Dict[str, ast.expr] = {}
    for node in ast.walk(fn):
        targets: List[ast.expr] = []
        if isinstance(node, ast.Assign):
            targets = list(node.targets)
        elif isinstance(node, (ast.AugAssign, ast.AnnAssign, ast.For, ast.comprehension)):
            targets = [node.target]
        elif isinstance(node, ast.withitem) and node.optional_vars is not None:
            targets = [node.optional_vars]
        for t in targets:
            for leaf in ast.walk(t):
                if isinstance(leaf, ast.Name):
                    bind_counts[leaf.id] = bind_counts.get(leaf.id, 0) + 1
        if isinstance(node, ast.Assign) and len(node.targets) == 1 and isinstance(node.targets[0], ast.Name):
            candidates[node.targets[0].id] = node.value
    fixed: Set[str] = set()
    changed = True
    while changed:
        changed = False
        for name, value in candidates.items():
            if name in fixed or bind_counts.get(name, 0) != 1:
                continue
            if _fixed_shape_expr(value, fixed):
                fixed.add(name)
                changed = True
    return fixed


def rule_ml003_stackable_list_state(mod: ModuleInfo) -> List[Violation]:
    """A list state fed only fixed-shape scalars could be a tensor state.

    ``_has_list_state`` keeps the whole class out of the fleet engine's vmapped
    buckets. When every ``append`` pushes a value whose shape never varies
    (scalar reductions of the batch), the list is just a growable stack of
    equal cells: a tensor state with an additive/extremal fold (or a
    ``cat``-reduced tensor) restores batched updates. Variable-length appends
    (filtered/ragged batches) are left alone.
    """
    out: List[Violation] = []
    for cls, calls in _metric_classes(mod):
        list_states = class_list_state_names(cls)
        if not list_states:
            continue
        update = _method(cls, "update")
        if update is None:
            continue
        qual = f"{cls.name}.update"
        fixed_locals = _fixed_shape_locals(update)
        appends: Dict[str, List[ast.Call]] = {}
        for node in ast.walk(update):
            if (
                isinstance(node, ast.Call)
                and isinstance(node.func, ast.Attribute)
                and node.func.attr == "append"
                and _is_self_state(node.func.value, list_states)
            ):
                appends.setdefault(node.func.value.attr, []).append(node)  # type: ignore[union-attr]
        for sname in sorted(appends):
            nodes = appends[sname]
            if all(len(n.args) == 1 and _fixed_shape_expr(n.args[0], fixed_locals) for n in nodes):
                out.append(_v(mod, nodes[0], "ML003",
                              f"list state `{sname}` only ever appends fixed-shape scalars — as a list it "
                              "keeps the whole class out of the engine's batched buckets; register it as a "
                              f"tensor state instead (e.g. add_state('{sname}', torch.tensor(0.0), 'sum') "
                              "with an additive fold, or dist_reduce_fx='cat' over a stacked tensor)", qual))
    return out


# =========================================================================== ML004
def rule_ml004_unjustified_optout(mod: ModuleInfo) -> List[Violation]:
    """``donate_states=False`` is an opt-out; it must say why.

    The port accepts and keeps the keyword (the JAX package reallocates the
    state on every jitted step under it). An unexplained opt-out rots: nobody
    can tell whether it is load-bearing. A comment on the keyword's line (or
    the line above) counts as the reason.
    """
    out: List[Violation] = []
    if "donate_states" not in mod.source:
        return out
    comments: Optional[Set[int]] = None
    owner: Optional[Dict[int, str]] = None
    for call in (n for n in mod.nodes if isinstance(n, ast.Call)):
        for kw in call.keywords:
            if kw.arg != "donate_states":
                continue
            if not (isinstance(kw.value, ast.Constant) and kw.value.value is False):
                continue
            if comments is None:
                comments = _comment_lines(mod.source)
                owner = _owner_map(mod.tree)
            line = kw.value.lineno
            if line in comments or (line - 1) in comments:
                continue
            out.append(_v(mod, kw.value, "ML004",
                          "donate_states=False without a justifying comment — say why on this line "
                          "(or drop it)",
                          (owner or {}).get(id(call), "<module>")))
    return out


# =========================================================================== ML005
def rule_ml005_compute_holds_references(mod: ModuleInfo) -> List[Violation]:
    """``compute`` must not park state reads in instance attributes.

    A stashed read is an alias that outlives the call: any later in-place
    update changes it under its holder. Returning state-derived *values* is
    fine — the latch covers the transient read.
    """
    out: List[Violation] = []
    for cls, calls in _metric_classes(mod):
        states = set(_state_names(calls))
        compute = _method(cls, "compute")
        if compute is None or not states or not _donation_exposed(cls):
            continue
        out.extend(_stash_violations(mod, compute, states, "ML005", f"{cls.name}.compute", "compute"))
    return out


# =========================================================================== ML006
def _delegates_reset(fn: ast.FunctionDef) -> bool:
    for n in ast.walk(fn):
        if (
            isinstance(n, ast.Call)
            and isinstance(n.func, ast.Attribute)
            and n.func.attr == "reset"
            and isinstance(n.func.value, ast.Call)
            and isinstance(n.func.value.func, ast.Name)
            and n.func.value.func.id == "super"
        ):
            return True
    return False


def rule_ml006_reset_aliases_defaults(mod: ModuleInfo) -> List[Violation]:
    """A ``reset`` override must not re-bind states onto shared tensors.

    The base ``reset`` binds each state to a clone of its registered default.
    A hand-rolled ``self.x = self._defaults['x']`` (or binding several states
    to one local) makes the default itself the state: the first in-place
    update corrupts it, and every later reset resurrects the corruption.
    """
    out: List[Violation] = []
    for cls, calls in _metric_classes(mod):
        states = set(_state_names(calls))
        reset = _method(cls, "reset")
        if reset is None or not states or _delegates_reset(reset):
            continue
        qual = f"{cls.name}.reset"
        local_binds: Dict[str, List[str]] = {}
        for node in ast.walk(reset):
            if not isinstance(node, ast.Assign):
                continue
            state_targets = [t for t in node.targets if _is_self_state(t, states)]
            if not state_targets:
                continue
            value = node.value
            defaults_reads = [
                n for n in ast.walk(value)
                if isinstance(n, ast.Attribute) and n.attr == "_defaults"
                and isinstance(n.value, ast.Name) and n.value.id == "self"
            ]
            if defaults_reads and not _is_copy_call(value):
                out.append(_v(mod, node, "ML006",
                              f"reset re-binds state `{state_targets[0].attr}` to the shared "  # type: ignore[union-attr]
                              "default tensor (self._defaults) without a clone — an in-place update "
                              "would corrupt the default and every later reset; delegate to "
                              "super().reset() or bind self._defaults[...].clone()", qual))
            elif isinstance(value, ast.Name):
                for t in state_targets:
                    local_binds.setdefault(value.id, []).append(t.attr)  # type: ignore[union-attr]
        for var, bound in sorted(local_binds.items()):
            if len(bound) >= 2:
                out.append(_v(mod, reset, "ML006",
                              f"reset binds states {', '.join(f'`{b}`' for b in sorted(bound))} to one "
                              f"local (`{var}`) — two state names share one tensor after reset; build "
                              "each state its own tensor (or delegate to super().reset())", qual))
    return out


MEM_RULES: Dict[str, Callable[[ModuleInfo], List[Violation]]] = {
    "ML001": rule_ml001_update_escape,
    "ML002": rule_ml002_state_aliasing,
    "ML003": rule_ml003_stackable_list_state,
    "ML004": rule_ml004_unjustified_optout,
    "ML005": rule_ml005_compute_holds_references,
    "ML006": rule_ml006_reset_aliases_defaults,
}


# ----------------------------------------------------------- static classifier
# Used by analysis/donation_contracts.py as one of the three sources of truth: a purely syntactic per-class
# donation verdict over the runtime MRO.
def _unconditional_calls(cls: ast.ClassDef) -> List[ast.Call]:
    """Calls that run on EVERY construction: direct statements of a method body.

    A registration under ``if``/``for``/``try`` is configuration-dependent —
    the classifier deliberately treats it as *uncertain*, and uncertainty
    resolves to eligible (the dynamic harness observes the configuration that
    actually gets built; a false "ineligible" would be a permanent
    disagreement for every array-state default config).
    """
    calls: List[ast.Call] = []
    for fn in (s for s in cls.body if isinstance(s, ast.FunctionDef)):
        for stmt in fn.body:
            if isinstance(stmt, ast.Expr) and isinstance(stmt.value, ast.Call):
                calls.append(stmt.value)
    return calls


def class_donation_blockers(cls: ast.ClassDef) -> List[str]:
    """Static donation blockers declared in ONE class body (AST view).

    Mirrors ``observe.costs._donation_eligible`` off the source: unconditional list
    states and ``donate_states=False`` opt-outs. Conditional registrations
    (``if thresholds is None: add_state(.., [])``) are uncertain → eligible.
    """
    blockers: List[str] = []
    list_names: List[str] = []
    for call in _unconditional_calls(cls):
        if isinstance(call.func, ast.Attribute) and call.func.attr == "add_state":
            default = call.args[1] if len(call.args) > 1 else next(
                (kw.value for kw in call.keywords if kw.arg == "default"), None
            )
            if isinstance(default, ast.List) and not default.elts:
                if call.args and isinstance(call.args[0], ast.Constant) and isinstance(call.args[0].value, str):
                    list_names.append(call.args[0].value)
        # a literal [] forwarded to super().__init__ becomes a list-state
        # default in the base's add_state (the BaseAggregator pattern)
        elif (
            isinstance(call.func, ast.Attribute)
            and call.func.attr == "__init__"
            and isinstance(call.func.value, ast.Call)
            and isinstance(call.func.value.func, ast.Name)
            and call.func.value.func.id == "super"
            and any(
                isinstance(a, ast.List) and not a.elts
                for a in [*call.args, *(kw.value for kw in call.keywords)]
            )
        ):
            blockers.append("list default forwarded to base __init__")
    if list_names:
        blockers.insert(0, "list state(s): " + ", ".join(sorted(list_names)))
    for call in (n for n in ast.walk(cls) if isinstance(n, ast.Call)):
        for kw in call.keywords:
            if kw.arg == "donate_states" and isinstance(kw.value, ast.Constant) and kw.value.value is False:
                blockers.append("donate_states=False opt-out")
    return blockers


def classify_donation(cls: type) -> Tuple[bool, str]:
    """Static donation verdict for a runtime class: (eligible, why-not).

    Walks the MRO below :class:`metrics_tpu_torch.metric.Metric`, parses each class
    body, and collects :func:`class_donation_blockers`. Eligible means *no
    statically visible blocker anywhere in the hierarchy* — the conditions
    ``observe.costs._donation_eligible`` evaluates on an instance, read off
    the source instead.
    """
    import inspect
    import textwrap

    blockers: List[str] = []
    for klass in cls.__mro__:
        if klass.__module__ in ("builtins", "abc"):
            continue
        if klass.__name__ == "Metric" and klass.__module__.endswith("metric"):
            break  # the runtime base owns the protocol; its body is not a subject
        try:
            node = ast.parse(textwrap.dedent(inspect.getsource(klass))).body[0]
        except (OSError, TypeError, SyntaxError, IndexError):
            continue
        if isinstance(node, ast.ClassDef):
            blockers.extend(f"{klass.__name__}: {b}" for b in class_donation_blockers(node))
    return (not blockers, "; ".join(blockers))


SUMMARIES = {
    "ML001": "state tensor escapes update without a clone (return/closure/stash/external splice)",
    "ML002": "two state names bind one tensor — an in-place fold changes both",
    "ML003": "append-only fixed-shape list state could be a tensor state (keeps the class unbatched)",
    "ML004": "donate_states=False opt-out without a justifying comment",
    "ML005": "compute stashes state reads into instance attributes without a clone",
    "ML006": "reset re-binds states to shared default tensors instead of super().reset()",
}
