"""distlint rules DL001-DL005: merge soundness and collective safety, in torch idioms (counterpart of
``metrics_tpu/analysis/dist_rules.py``).

The distributed story (DESIGN §10) rests on the algebra of each state's
reduction: per-shard partial states fold through ``_merge_state_dicts`` /
``sync_states`` and must reach the same answer as a single-pass compute. That
holds only when the reduction is associative+commutative (DrJAX arxiv
2403.07128; EQuARX arxiv 2506.17615 make the same observation for MapReduce
aggregation and all-reduce approximation in JAX). These rules make the
assumption *checked* instead of implicit:

=======  ======================================================================
code     invariant
=======  ======================================================================
DL001    a custom (non-literal) ``dist_reduce_fx`` passed to ``add_state`` must
         declare ``merge_associative=`` — unknown algebra cannot be synced
         safely
DL002    ``update`` must fold new batches into state through a known
         merge-sound operation (additive/extremal/concat/logical, or the
         in-place ``add_``/``sub_``/``index_add_``/``scatter_add_``); any
         other read-modify-write makes per-shard partials diverge from the
         single-pass answer (classes overriding ``_merge_state_dicts`` carry
         their own verified merge algebra and are checked dynamically instead)
DL003    ``compute`` must not depend on ``_update_count`` or on positional
         indexing of list states — both change meaning under merge (counts
         add, shard segments permute)
DL004    raw ``torch.distributed`` collectives (``all_reduce``,
         ``all_gather``, ``broadcast``, ``reduce_scatter``, ``all_to_all``…)
         belong in ``parallel/sync.py``; ad-hoc collectives bypass the
         reduction registry and the ``merge_associative`` guard
DL005    a ``merge_state`` override must handle every registered state (or
         delegate to the base merge); silently dropping one loses shard data
=======  ======================================================================

Each rule is a callable ``rule(module: ModuleInfo) -> list[Violation]``,
registered in :data:`DIST_RULES`; the shared engine applies ``# distlint:
disable=…`` suppressions and ``metrics_tpu_torch/analysis/baselines/distlint_baseline.json`` afterwards.
The dynamic complement — actually exercising split-update-merge vs single-pass
per exported class — is :mod:`metrics_tpu_torch.analysis.merge_contracts`.
"""

from __future__ import annotations

import ast
from typing import Callable, Dict, List, Optional, Set, Tuple

from metrics_tpu_torch.analysis.contexts import Violation
from metrics_tpu_torch.analysis.engine import ModuleInfo, _dotted, _v

__all__ = ["DIST_RULES"]


# --------------------------------------------------------------------------- helpers
def _metric_classes(mod: ModuleInfo) -> List[Tuple[ast.ClassDef, List[ast.Call]]]:
    """Classes that register state via ``self.add_state`` — the Metric surface (found once per module)."""
    found = mod.memo.get("metric_classes")
    if found is None:
        found = []
        if "add_state" in mod.source:
            for cls in (n for n in mod.nodes if isinstance(n, ast.ClassDef)):
                calls = [
                    c for c in ast.walk(cls)
                    if isinstance(c, ast.Call)
                    and isinstance(c.func, ast.Attribute) and c.func.attr == "add_state"
                    and isinstance(c.func.value, ast.Name) and c.func.value.id == "self"
                ]
                if calls:
                    found.append((cls, calls))
        mod.memo["metric_classes"] = found
    return found  # type: ignore[return-value]


def _state_names(add_state_calls) -> Dict[str, ast.Call]:
    names: Dict[str, ast.Call] = {}
    for call in add_state_calls:
        if call.args and isinstance(call.args[0], ast.Constant) and isinstance(call.args[0].value, str):
            names[call.args[0].value] = call
    return names


def _reduce_fx_node(call: ast.Call) -> Optional[ast.expr]:
    """The dist_reduce_fx argument of an ``add_state`` call (3rd positional or kw)."""
    if len(call.args) >= 3:
        return call.args[2]
    for kw in call.keywords:
        if kw.arg == "dist_reduce_fx":
            return kw.value
    return None


def _method(cls: ast.ClassDef, name: str) -> Optional[ast.FunctionDef]:
    return next((s for s in cls.body if isinstance(s, ast.FunctionDef) and s.name == name), None)


# =========================================================================== DL001
def rule_dl001_undeclared_reduce_algebra(mod: ModuleInfo) -> List[Violation]:
    """Custom ``dist_reduce_fx`` callables must declare ``merge_associative=``.

    A literal ``"sum"``/``"mean"``/``"min"``/``"max"``/``"cat"`` or literal
    ``None`` has known algebra; a lambda, function reference, or runtime
    variable does not — the sync layer cannot know whether gather-then-fold is
    shard-order-independent, so the author must say so (``add_state(...,
    merge_associative=True/False)``).
    """
    out: List[Violation] = []
    for cls, calls in _metric_classes(mod):
        for call in calls:
            fx = _reduce_fx_node(call)
            if fx is None:  # omitted entirely — JL003's concern
                continue
            if isinstance(fx, ast.Constant) and (fx.value is None or isinstance(fx.value, str)):
                continue  # known builtin algebra
            if any(kw.arg == "merge_associative" for kw in call.keywords):
                continue
            sname = call.args[0].value if (
                call.args and isinstance(call.args[0], ast.Constant) and isinstance(call.args[0].value, str)
            ) else "<dynamic>"
            fx_txt = _dotted(fx) or type(fx).__name__
            out.append(_v(mod, call, "DL001",
                          f"state `{sname}` registers a non-literal dist_reduce_fx ({fx_txt}) without "
                          "`merge_associative=` — declare whether the reduction is "
                          "associative+commutative so distributed sync can be checked (DESIGN §10)",
                          cls.name))
    return out


# =========================================================================== DL002
# top-level fold operations proven merge-sound: folding batch b into state s via
# one of these commutes with the cross-shard merge of the same reduction
_SOUND_FOLD_FNS = frozenset({
    "maximum", "minimum", "fmax", "fmin", "max", "min",
    "concatenate", "cat", "append", "add", "logical_or", "logical_and",
    "bitwise_or", "bitwise_and",
})
# in-place folds of a tensor state that are merge-sound (additive or logical)
_SOUND_INPLACE = frozenset({
    "add_", "sub_", "index_add_", "scatter_add_", "logical_or_", "logical_and_", "bitwise_or_", "bitwise_and_",
})


def _names_read_in(expr: ast.expr) -> Set[str]:
    """``self.<attr>`` reads appearing anywhere in an expression."""
    reads: Set[str] = set()
    for n in ast.walk(expr):
        if isinstance(n, ast.Attribute) and isinstance(n.value, ast.Name) and n.value.id == "self":
            reads.add(n.attr)
    return reads


def _is_self_state(e: ast.expr, states: Set[str]) -> bool:
    return (
        isinstance(e, ast.Attribute)
        and isinstance(e.value, ast.Name)
        and e.value.id == "self"
        and e.attr in states
    )


def _fold_is_sound(value: ast.expr, target_state: str, states: Set[str]) -> bool:
    """Is ``self.<target_state> = <value>`` a known merge-sound fold?"""
    # self.x = self.x + expr  /  expr + self.x  (commutative additive fold)
    if isinstance(value, ast.BinOp):
        if isinstance(value.op, ast.Add):
            return _is_self_state(value.left, {target_state}) or _is_self_state(value.right, {target_state})
        # self.x = self.x - expr accumulates a negated sum — still additive
        if isinstance(value.op, (ast.Sub,)):
            return _is_self_state(value.left, {target_state})
        return False
    if isinstance(value, ast.Call):
        fn = value.func
        name = fn.attr if isinstance(fn, ast.Attribute) else (fn.id if isinstance(fn, ast.Name) else "")
        if name in _SOUND_FOLD_FNS:
            return True
        return False
    return False


def rule_dl002_nonadditive_rmw(mod: ModuleInfo) -> List[Violation]:
    """``update`` read-modify-writes of state must go through a sound fold.

    ``self.x = f(self.x, batch)`` for arbitrary ``f`` (``torch.where`` selection,
    multiplication, subtraction with the state on the right, a helper call)
    produces per-shard partials whose merge is not the single-pass answer —
    *when the class merges by its declared per-state reductions*. A class that
    overrides ``_merge_state_dicts`` supplies its own merge algebra (e.g. the
    decay-to-common-reference-time folds in ``windows/``, DESIGN §20); the
    additive-idiom heuristic no longer applies and the obligation moves to the
    dynamic merge harness (``merge_contracts`` + the time-shifted check),
    which exercises exactly that override per exported class.
    """
    out: List[Violation] = []
    for cls, calls in _metric_classes(mod):
        states = set(_state_names(calls))
        update = _method(cls, "update")
        if update is None or not states:
            continue
        if _method(cls, "_merge_state_dicts") is not None:
            continue  # custom merge algebra — verified dynamically, not by idiom
        qual = f"{cls.name}.update"
        for node in ast.walk(update):
            if (isinstance(node, ast.Call) and isinstance(node.func, ast.Attribute)
                    and _is_self_state(node.func.value, states) and node.func.attr.endswith("_")
                    and not node.func.attr.startswith("_") and node.func.attr not in _SOUND_INPLACE):
                sname = node.func.value.attr  # type: ignore[union-attr]
                out.append(_v(mod, node, "DL002",
                              f"state `{sname}` folded in place with `{node.func.attr}`, which is not a known "
                              "merge-sound fold — per-shard partials will not merge to the single-pass answer",
                              qual))
            elif isinstance(node, ast.AugAssign):
                if _is_self_state(node.target, states) and not isinstance(node.op, (ast.Add, ast.Sub)):
                    sname = node.target.attr  # type: ignore[union-attr]
                    out.append(_v(mod, node, "DL002",
                                  f"state `{sname}` folded with a non-additive augmented assignment "
                                  f"({type(node.op).__name__}) — per-shard partials will not merge to "
                                  "the single-pass answer", qual))
            elif isinstance(node, ast.Assign):
                for target in node.targets:
                    if not _is_self_state(target, states):
                        continue
                    sname = target.attr  # type: ignore[union-attr]
                    if sname not in _names_read_in(node.value):
                        continue  # overwrite from batch only — not a RMW fold
                    if not _fold_is_sound(node.value, sname, states):
                        op = (
                            _dotted(node.value.func) if isinstance(node.value, ast.Call) else
                            type(node.value).__name__
                        )
                        out.append(_v(mod, node, "DL002",
                                      f"state `{sname}` read-modify-written through `{op}` which is not a "
                                      "known merge-sound fold (additive/extremal/concat/logical) — use "
                                      "torch.maximum/minimum/+/cat or declare the class "
                                      "full_state_update", qual))
    return out


# =========================================================================== DL003
def rule_dl003_merge_fragile_compute(mod: ModuleInfo) -> List[Violation]:
    """``compute`` must not read ``_update_count`` or index list states positionally.

    ``_update_count`` sums across merged shards — a compute dividing by it
    double-normalizes mean-reduced states; ``self.values[0]``/``[-1]`` pick a
    *shard-order-dependent* element once segments from other shards are
    concatenated in.
    """
    out: List[Violation] = []
    for cls, calls in _metric_classes(mod):
        compute = _method(cls, "compute")
        if compute is None:
            continue
        qual = f"{cls.name}.compute"
        list_states = {
            name for name, call in _state_names(calls).items()
            if isinstance(
                call.args[1] if len(call.args) > 1 else next(
                    (kw.value for kw in call.keywords if kw.arg == "default"), None
                ),
                ast.List,
            )
        }
        for node in ast.walk(compute):
            if isinstance(node, ast.Attribute) and node.attr in ("_update_count", "update_count"):
                out.append(_v(mod, node, "DL003",
                              "`compute` reads `_update_count`, which sums across merged shards — "
                              "normalization by it is wrong after merge_state (keep a dedicated "
                              "weight/count state instead)", qual))
            elif isinstance(node, ast.Subscript) and _is_self_state(node.value, list_states):
                idx = node.slice
                if isinstance(idx, ast.Constant) and isinstance(idx.value, int):
                    sname = node.value.attr  # type: ignore[union-attr]
                    out.append(_v(mod, node, "DL003",
                                  f"`compute` indexes list state `{sname}` positionally ([{idx.value}]) — "
                                  "element order is shard-order-dependent after merge "
                                  "(reduce with dim_zero_cat first)", qual))
                elif isinstance(idx, ast.UnaryOp) and isinstance(idx.op, ast.USub):
                    sname = node.value.attr  # type: ignore[union-attr]
                    out.append(_v(mod, node, "DL003",
                                  f"`compute` indexes list state `{sname}` positionally (negative index) — "
                                  "element order is shard-order-dependent after merge", qual))
    return out


# =========================================================================== DL004
_COLLECTIVES = frozenset({
    "all_reduce", "all_gather", "all_gather_object", "all_gather_into_tensor", "broadcast",
    "broadcast_object_list", "reduce", "reduce_scatter", "reduce_scatter_tensor", "all_to_all",
    "all_to_all_single", "gather", "gather_object", "scatter", "scatter_object_list",
})
_SYNC_MODULE = "metrics_tpu_torch/parallel/sync.py"
_DIST_MODULE = "torch.distributed"


def rule_dl004_raw_collectives(mod: ModuleInfo) -> List[Violation]:
    """``torch.distributed`` collectives outside ``parallel/sync.py`` bypass the sync layer.

    ``sync_states`` is the single place reductions lower to collectives — it
    consults the reduction registry and the ``merge_associative`` declarations
    (DL001). An ad-hoc ``dist.all_reduce`` inside a metric hard-codes the process group
    and skips both checks.
    """
    if mod.path.endswith(_SYNC_MODULE) or mod.path == _SYNC_MODULE:
        return []
    out: List[Violation] = []

    # map each call to its enclosing def/class qualname for the violation key
    owner: Dict[int, str] = {}

    def walk(node: ast.AST, qual: str) -> None:
        for child in ast.iter_child_nodes(node):
            q = qual
            if isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef)):
                q = f"{qual}.{child.name}" if qual != "<module>" else child.name
            if isinstance(child, ast.Call):
                owner[id(child)] = qual
            walk(child, q)

    walk(mod.tree, "<module>")
    aliases = _dist_aliases(mod.tree)
    for call in (n for n in mod.nodes if isinstance(n, ast.Call)):
        head = _dotted(call.func)
        prefix, _, leaf = head.rpartition(".")
        if leaf not in _COLLECTIVES:
            continue
        # the bare-name form counts only when imported from torch.distributed
        if not (prefix in aliases or (not prefix and _imports_from_dist(mod.tree, leaf))):
            continue
        out.append(_v(mod, call, "DL004",
                      f"raw collective `{head}` outside parallel/sync.py — route through "
                      "sync_states/allreduce_over_mesh so the reduction registry and "
                      "merge_associative guard apply", owner.get(id(call), "<module>")))
    return out


def _dist_aliases(tree: ast.Module) -> Set[str]:
    """Dotted names bound to ``torch.distributed`` (``torch.distributed`` itself, ``dist`` & co.)."""
    aliases = {_DIST_MODULE}
    for stmt in ast.walk(tree):
        if isinstance(stmt, ast.Import):
            aliases.update(a.asname for a in stmt.names if a.name == _DIST_MODULE and a.asname)
        elif isinstance(stmt, ast.ImportFrom) and stmt.module == "torch":
            aliases.update(a.asname or a.name for a in stmt.names if a.name == "distributed")
    return aliases


def _imports_from_dist(tree: ast.Module, name: str) -> bool:
    for stmt in ast.walk(tree):
        if isinstance(stmt, ast.ImportFrom) and stmt.module and stmt.module.startswith(_DIST_MODULE):
            if any((alias.asname or alias.name) == name for alias in stmt.names):
                return True
    return False


# =========================================================================== DL005
_MERGE_DELEGATES = ("merge_state", "_merge_state_dicts")


def rule_dl005_merge_override_drops_state(mod: ModuleInfo) -> List[Violation]:
    """A ``merge_state`` override must touch every registered state or delegate.

    An override that rebuilds state by hand and forgets one registered name
    silently drops that state's shard contribution — exactly the failure mode
    the OO merge path exists to prevent.
    """
    out: List[Violation] = []
    for cls, calls in _metric_classes(mod):
        merge = _method(cls, "merge_state")
        if merge is None:
            continue
        states = _state_names(calls)
        if not states:
            continue
        # delegation to the base merge (or the shared dict merge) covers all states
        delegates = any(
            isinstance(n, ast.Call)
            and isinstance(n.func, ast.Attribute)
            and n.func.attr in _MERGE_DELEGATES
            for n in ast.walk(merge)
        )
        if delegates:
            continue
        touched: Set[str] = set()
        for n in ast.walk(merge):
            if isinstance(n, ast.Attribute):
                touched.add(n.attr)
            elif isinstance(n, ast.Constant) and isinstance(n.value, str):
                touched.add(n.value)
        for sname, call in states.items():
            if sname not in touched:
                out.append(_v(mod, merge, "DL005",
                              f"merge_state override never references registered state `{sname}` — "
                              "incoming shard data for it is silently dropped (delegate to "
                              "super().merge_state or merge every state explicitly)", cls.name))
    return out


DIST_RULES: Dict[str, Callable[[ModuleInfo], List[Violation]]] = {
    "DL001": rule_dl001_undeclared_reduce_algebra,
    "DL002": rule_dl002_nonadditive_rmw,
    "DL003": rule_dl003_merge_fragile_compute,
    "DL004": rule_dl004_raw_collectives,
    "DL005": rule_dl005_merge_override_drops_state,
}


SUMMARIES = {
    "DL001": "custom dist_reduce_fx without a declared merge_associative= algebra",
    "DL002": "update folds state through an operation outside the merge-sound set",
    "DL003": "compute depends on _update_count or positional list-state indexing",
    "DL004": "raw torch.distributed collective outside parallel/sync.py bypasses the reduction registry",
    "DL005": "merge_state override silently drops a registered state",
}
