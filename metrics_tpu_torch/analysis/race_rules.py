"""racelint rules RC001-RC006: concurrency and ordering discipline for the control plane, in torch idioms
(counterpart of ``metrics_tpu/analysis/race_rules.py``).

The host side is concurrent: the ``serve/`` selectors reactor acks records
only after an fsync, the autonomic observe→act loop mutates engine state from
outside the tick, and the sharded tick assembles one shard's waves while the
previous shard's launches run on its card. None of
that is a tracer error (jitlint), a host sync (hotlint) or a numerics bug
(numlint) — it is *ordering*: who may write which attribute from which
control-plane context, what must hit disk before what is acknowledged, and
which buffers are off-limits while a dispatch is in flight. racelint is the
static half of that contract; the dynamic half
(:mod:`metrics_tpu_torch.analysis.interleave_contracts`) drives the real server,
engine and autonomic controller through thousands of permuted and adversarial
segment interleavings and asserts the same invariants at runtime.

Control-plane contexts are derived per class from the self-call graph, seeded
at the entry points each loop owns and assigned by priority (reactor >
autonomic > tick > poll) so a shared helper lands in exactly one context:

* **reactor**  — ``poll`` / ``adopt`` / ``serve_in_thread`` / ``_accept`` /
  ``_read``: the selectors loop and everything it reaches.
* **autonomic** — ``step`` / ``shed``: the observe→act reflexes.
* **tick**     — ``tick`` / ``submit`` / ``add_session`` / ``expire`` /
  ``reset`` / ``serve_mark`` / ``checkpoint`` / ``restore`` / ``preexpand`` /
  ``resize``: the mutating engine entry points.
* **poll**     — ``compute`` / ``compute_all`` / ``aggregate`` / ``stats`` /
  ``session_health`` / ...: the read paths a dashboard may call concurrently.

The sanctioned annotation is a *declared single writer*::

    # racelint: single-writer — reactor owns this; tick only reads it back
    self._resolved[producer] = pseq

The marker (same line or the line above, hotlint HL005's adjacency) satisfies
RC001 at the write site; placing it on the attribute's ``__init__``
declaration declares the whole attribute. ``# racelint: disable=RC00N`` rides
the shared dual-prefix suppression grammar like every other pass.

Each rule is a callable ``rule(module: ModuleInfo) -> list[Violation]``
registered in :data:`RACE_RULES`; the scope is the concurrent control plane —
``metrics_tpu_torch/serve/`` and ``metrics_tpu_torch/engine/`` (``engine/smoke.py``, the
single-threaded bench harness, is exempt).

=======  ======================================================================
code     invariant
=======  ======================================================================
RC001    no shared mutable attribute written from more than one control-plane
         context: a ``self.X`` store reachable from both the reactor and the
         tick (or any other context pair) is a lost-update/torn-read hazard
         once ``serve_in_thread`` runs the reactor beside a foreground tick —
         route through one owner or declare it
         (``# racelint: single-writer[ — why]``)
RC002    durability ordering: (a) in ``serve/``, an ack flush
         (``_flush_writes``) lexically reachable after an apply
         (``_process``/``_apply``) with no WAL sync (``_sync_wals``/
         ``.sync()``) between them acks records the disk has not seen; (b) a
         watermark advance (a store to ``*serve_mark*``/``*watermark*``/
         ``*_resolved*`` whose value carries a ``pseq``/``seq``) must be
         lexically dominated by the durable append/mark it summarizes
         (``serve_mark``/``serve_watermark``/``_log``/``.append``/``.sync``)
RC003    no mutation of double-buffered wave state while a dispatch may be in
         flight: a value staged by ``_stage_flush()`` that has been handed to
         ``_dispatch_flush``/``_dispatch_shard``/``engine_update_fused``, or a
         host tensor handed to ``.to(..., non_blocking=True)`` /
         ``copy_(..., non_blocking=True)`` (the copy engine reads a pinned
         source after the call returns), may not be mutated (``x[...] =``,
         ``.append``/``.clear``/..., an in-place tensor method) until a sync
         point (``torch.cuda.synchronize``, ``Event``/``Stream.synchronize``,
         ``.cpu()``/``.item()``, ``_host_fetch``) or a re-stage — rebinding the
         *name* is fine, mutating the *buffer* races the launch
RC004    autonomic actions act only through the declared surface: every
         engine-mutating call from ``autonomic.py`` (receiver ``self.engine``/
         ``engine``/``eng``, method not in the read-only set) must be named in
         the module's literal ``AUTONOMIC_ENGINE_ALLOWLIST``, and every reflex
         method making one must consult the rate-limit/dry-run gate
         (``self._allowed`` / ``self.dry_run``) itself or be called only from
         methods that do
RC005    re-entrancy latch on journal appends: in a class with replay exposure
         (a ``restore``/``reconnect``/``replay*`` method, or a ``_replaying``
         latch in use), every method performing a direct WAL append
         (``*._wal.append(...)``) must consult the ``_replaying`` latch — the
         ``death[replay]`` bug class: replayed applies re-journaling
         themselves double the journal on every recovery
RC006    no iteration over a ``self`` container the loop body mutates through
         a callee: ``for k in self.X`` (or ``.items()/.values()/.keys()``)
         where the body structurally mutates ``self.X`` directly or calls a
         method that (transitively) does — snapshot with ``list(...)`` first,
         the idiom the reactor already uses
=======  ======================================================================
"""

from __future__ import annotations

import ast
from typing import Dict, Iterator, List, Optional, Set, Tuple

from metrics_tpu_torch.analysis.contexts import Violation
from metrics_tpu_torch.analysis.engine import ModuleInfo, SourceMarkers, _dotted, _v
from metrics_tpu_torch.analysis.sync_rules import _functions, _self_call_graph

__all__ = ["RACE_RULES", "SUMMARIES", "SINGLE_WRITER_MARKER", "method_contexts"]

# the RC001 annotation grammar: `# racelint: single-writer[ — why]`
SINGLE_WRITER_MARKER = "single-writer"

# ------------------------------------------------------------------ scope
_SCOPE_DIRS = ("metrics_tpu_torch/serve/", "metrics_tpu_torch/engine/")
# single-threaded bench harness: it *measures* the control plane, serially
_EXEMPT_FILES = {"metrics_tpu_torch/engine/smoke.py"}


def _in_scope(path: str) -> bool:
    if path in _EXEMPT_FILES:
        return False
    return any(path.startswith(d) for d in _SCOPE_DIRS)


# ------------------------------------------------------- context classifier
# Priority-ordered: a method reachable from several loops belongs to the
# HIGHEST-priority one (reactor > autonomic > tick > poll), so one shared
# helper never smears every attribute it touches across contexts.
_CONTEXT_ROOTS: Tuple[Tuple[str, frozenset], ...] = (
    ("reactor", frozenset({"poll", "adopt", "serve_in_thread", "_accept", "_read"})),
    ("autonomic", frozenset({"step", "shed"})),
    ("tick", frozenset({
        "tick", "submit", "add_session", "expire", "reset", "serve_mark",
        "checkpoint", "restore", "preexpand", "resize",
    })),
    ("poll", frozenset({
        "compute", "compute_all", "aggregate", "stats", "session_health",
        "session_ids", "loose_session_ids", "serve_watermark",
        "serve_watermarks", "snapshot",
    })),
)


def method_contexts(cls: ast.ClassDef) -> Dict[str, str]:
    """Assign each method of ``cls`` to at most one control-plane context."""
    graph = _self_call_graph(cls)
    assigned: Dict[str, str] = {}
    for ctx, roots in _CONTEXT_ROOTS:
        frontier = sorted(r for r in roots if r in graph and r not in assigned)
        while frontier:
            name = frontier.pop()
            if name in assigned:
                continue
            assigned[name] = ctx
            frontier.extend(c for c in sorted(graph.get(name, ()))
                            if c in graph and c not in assigned)
    return assigned


def _classes(mod: ModuleInfo) -> Iterator[ast.ClassDef]:
    for node in ast.walk(mod.tree):
        if isinstance(node, ast.ClassDef):
            yield node


def _methods(cls: ast.ClassDef) -> Iterator[ast.FunctionDef]:
    for stmt in cls.body:
        if isinstance(stmt, (ast.FunctionDef, ast.AsyncFunctionDef)):
            yield stmt


def _attr_store_name(t: ast.expr) -> Optional[str]:
    """``self.X`` / ``self.X[...]`` store target → ``X`` (else None)."""
    if isinstance(t, ast.Attribute) and isinstance(t.value, ast.Name) and t.value.id == "self":
        return t.attr
    if isinstance(t, ast.Subscript) and isinstance(t.value, ast.Attribute):
        return _attr_store_name(t.value)
    return None


def _flat_targets(node: ast.Assign) -> Iterator[ast.expr]:
    for t in node.targets:
        if isinstance(t, (ast.Tuple, ast.List)):
            yield from t.elts
        else:
            yield t


def _self_writes(fn: ast.AST) -> Iterator[Tuple[str, ast.AST]]:
    """Every ``(attr, node)`` stored through ``self`` anywhere in ``fn``."""
    for node in ast.walk(fn):
        if isinstance(node, ast.Assign):
            for t in _flat_targets(node):
                attr = _attr_store_name(t)
                if attr:
                    yield attr, node
        elif isinstance(node, (ast.AugAssign, ast.AnnAssign)):
            attr = _attr_store_name(node.target)
            if attr:
                yield attr, node
        elif isinstance(node, ast.Delete):
            for t in node.targets:
                attr = _attr_store_name(t)
                if attr:
                    yield attr, node


def _call_name(node: ast.Call) -> str:
    if isinstance(node.func, ast.Attribute):
        return node.func.attr
    if isinstance(node.func, ast.Name):
        return node.func.id
    return ""


# =========================================================================== RC001
def rule_rc001_multi_context_writes(mod: ModuleInfo) -> List[Violation]:
    if not _in_scope(mod.path):
        return []
    out: List[Violation] = []
    marks = SourceMarkers(mod.source)
    for cls in _classes(mod):
        ctx_of = method_contexts(cls)
        if len(set(ctx_of.values())) < 2:
            continue  # a single-loop class cannot race with itself
        declared: Set[str] = set()
        for meth in _methods(cls):
            if meth.name != "__init__":
                continue
            for attr, node in _self_writes(meth):
                if marks.has_marker(node.lineno, SINGLE_WRITER_MARKER, prefix="racelint"):
                    declared.add(attr)
        writes: Dict[str, Dict[str, List[Tuple[str, ast.AST]]]] = {}
        for meth in _methods(cls):
            ctx = ctx_of.get(meth.name)
            if ctx is None or meth.name == "__init__":
                continue
            for attr, node in _self_writes(meth):
                writes.setdefault(attr, {}).setdefault(ctx, []).append((meth.name, node))
        for attr in sorted(writes):
            by_ctx = writes[attr]
            if len(by_ctx) < 2 or attr in declared:
                continue
            ctxs = "/".join(sorted(by_ctx))
            for ctx in sorted(by_ctx):
                for meth_name, node in by_ctx[ctx]:
                    if marks.has_marker(node.lineno, SINGLE_WRITER_MARKER, prefix="racelint"):
                        continue
                    out.append(_v(mod, node, "RC001",
                                  f"`self.{attr}` is written from {len(by_ctx)} control-plane "
                                  f"contexts ({ctxs}) — lost updates once the reactor runs in a "
                                  f"thread; route through one owner or declare "
                                  f"`# racelint: {SINGLE_WRITER_MARKER}`",
                                  f"{cls.name}.{meth_name}"))
    return out


# =========================================================================== RC002
_APPLY_CALLS = frozenset({"_process", "_apply"})
_DURABLE_CALLS = frozenset({"_sync_wals", "sync", "fsync"})
_ACK_CALLS = frozenset({"_flush_writes"})
_WATERMARK_HINTS = ("serve_mark", "watermark", "_resolved")
_SEQ_NAMES = frozenset({"pseq", "seq"})
_DOMINATOR_SUFFIXES = ("serve_mark", "serve_watermark", "_log")
_DOMINATOR_NAMES = frozenset({"append", "sync", "fsync"})


def _mentions_seq(e: ast.expr) -> bool:
    for node in ast.walk(e):
        if isinstance(node, ast.Name) and node.id in _SEQ_NAMES:
            return True
        if isinstance(node, ast.Attribute) and node.attr in _SEQ_NAMES:
            return True
    return False


def rule_rc002_durability_ordering(mod: ModuleInfo) -> List[Violation]:
    if not _in_scope(mod.path):
        return []
    out: List[Violation] = []
    in_serve = mod.path.startswith("metrics_tpu_torch/serve/")
    for fn, qual in _functions(mod):
        applies: List[int] = []
        syncs: List[int] = []
        acks: List[Tuple[int, ast.Call]] = []
        dominators: List[int] = []
        stores: List[Tuple[int, ast.AST, str]] = []
        for node in ast.walk(fn):
            if isinstance(node, ast.Call):
                name = _call_name(node)
                if name in _APPLY_CALLS:
                    applies.append(node.lineno)
                if name in _DURABLE_CALLS:
                    syncs.append(node.lineno)
                if name in _ACK_CALLS:
                    acks.append((node.lineno, node))
                if name.endswith(_DOMINATOR_SUFFIXES) or name in _DOMINATOR_NAMES:
                    dominators.append(node.lineno)
            elif isinstance(node, (ast.Assign, ast.AugAssign)):
                targets = _flat_targets(node) if isinstance(node, ast.Assign) else [node.target]
                for t in targets:
                    attr = _attr_store_name(t)
                    if attr and any(h in attr for h in _WATERMARK_HINTS):
                        value = node.value
                        if value is not None and _mentions_seq(value):
                            stores.append((node.lineno, node, attr))
        if in_serve:
            for line, node in acks:
                before = [a for a in applies if a < line]
                if before and not any(max(before) < s < line for s in syncs):
                    out.append(_v(mod, node, "RC002",
                                  "ack flush reachable after an apply with no WAL sync between "
                                  "them — a crash here loses records the peer believes durable "
                                  "(fsync-before-ack, DESIGN §26)", qual))
        for line, node, attr in stores:
            if not any(d < line for d in dominators):
                out.append(_v(mod, node, "RC002",
                              f"watermark advance `self.{attr}` is not dominated by the durable "
                              "append/mark it summarizes — on replay the watermark claims "
                              "records the journal never saw", qual))
    return out


# =========================================================================== RC003
_STAGE_SUFFIX = "_stage_flush"
_DISPATCH_CALLS = frozenset({
    "_dispatch_flush", "_dispatch_shard", "engine_update_fused", "engine_update",
})
# a host wait on the card: every launch and copy queued before it has finished
_SYNC_CALLS = frozenset({"synchronize", "cpu", "item", "tolist", "_host_fetch"})
_ASYNC_COPIES = frozenset({"to", "copy_"})
_STRUCT_MUTATORS = frozenset({
    "append", "clear", "extend", "update", "pop", "popitem", "remove", "insert",
})


def _base_name(e: ast.expr) -> Optional[str]:
    """The root ``Name`` of an attribute/subscript chain (``a[0].rows`` → ``a``)."""
    while isinstance(e, (ast.Attribute, ast.Subscript)):
        e = e.value
    return e.id if isinstance(e, ast.Name) else None


def _names_in(e: ast.AST) -> Set[str]:
    return {n.id for n in ast.walk(e) if isinstance(n, ast.Name)}


def _async_copy_source(node: ast.Call) -> Optional[str]:
    """The named host source of ``src.to(..., non_blocking=True)`` / ``dst.copy_(src, non_blocking=True)``."""
    if not (isinstance(node.func, ast.Attribute) and node.func.attr in _ASYNC_COPIES):
        return None
    if not any(kw.arg == "non_blocking" and isinstance(kw.value, ast.Constant) and kw.value.value is True
               for kw in node.keywords):
        return None
    if node.func.attr == "to":
        src = node.func.value
    elif node.args:
        src = node.args[0]
    else:
        return None
    return src.id if isinstance(src, ast.Name) else None


def _is_mutator(name: str) -> bool:
    """A container mutator, or an in-place tensor method (``fill_``, ``copy_``, ``add_``...)."""
    return name in _STRUCT_MUTATORS or (name.endswith("_") and not name.startswith("_"))


def rule_rc003_staged_buffer_mutation(mod: ModuleInfo) -> List[Violation]:
    if not _in_scope(mod.path):
        return []
    out: List[Violation] = []
    for fn, qual in _functions(mod):
        events: List[Tuple[int, str, ast.AST]] = []
        for node in ast.walk(fn):
            line = getattr(node, "lineno", None)
            if line is None:
                continue
            if isinstance(node, (ast.Assign, ast.AugAssign, ast.Call)):
                events.append((line, "", node))
        events.sort(key=lambda ev: ev[0])

        roots: Dict[str, Set[str]] = {}      # name -> staged root names it may hold
        inflight: Dict[str, int] = {}        # staged root -> dispatch line

        def staged_refs(e: ast.AST) -> Set[str]:
            refs: Set[str] = set()
            for n in _names_in(e):
                refs |= roots.get(n, set())
            return refs

        for line, _, node in events:
            if isinstance(node, ast.Call):
                name = _call_name(node)
                source = _async_copy_source(node)
                if name in _SYNC_CALLS:
                    inflight.clear()
                elif source is not None:
                    roots.setdefault(source, {source})
                    for r in roots[source]:
                        inflight[r] = line
                elif name in _DISPATCH_CALLS:
                    hit: Set[str] = set()
                    for arg in list(node.args) + [kw.value for kw in node.keywords]:
                        hit |= staged_refs(arg)
                    for r in hit:
                        inflight[r] = line
                elif isinstance(node.func, ast.Attribute) and _is_mutator(node.func.attr):
                    base = _base_name(node.func.value)
                    if base is not None:
                        for r in roots.get(base, set()):
                            if r in inflight:
                                out.append(_v(mod, node, "RC003",
                                              f"`.{node.func.attr}()` on staged wave state "
                                              f"`{base}` while its dispatch (line "
                                              f"{inflight[r]}) may be in flight — the buffer is "
                                              "not yours until the sync point", qual))
            elif isinstance(node, ast.Assign):
                # mutation through a subscript/attribute store on a staged name
                plain_rebinds: List[str] = []
                for t in _flat_targets(node):
                    if isinstance(t, (ast.Subscript, ast.Attribute)):
                        base = _base_name(t)
                        if base is not None:
                            for r in roots.get(base, set()):
                                if r in inflight:
                                    out.append(_v(mod, node, "RC003",
                                                  f"store into staged wave state `{base}` while "
                                                  f"its dispatch (line {inflight[r]}) may be in "
                                                  "flight — wait for the sync point or re-stage",
                                                  qual))
                    elif isinstance(t, ast.Name):
                        plain_rebinds.append(t.id)
                # track staging and aliasing (rebinding a name is always safe)
                value = node.value
                is_stage = isinstance(value, ast.Call) and _call_name(value).endswith(_STAGE_SUFFIX)
                for tname in plain_rebinds:
                    if is_stage:
                        roots[tname] = {tname}
                        inflight.pop(tname, None)  # fresh double buffer
                    else:
                        refs = staged_refs(value)
                        if refs:
                            roots[tname] = refs
                        else:
                            roots.pop(tname, None)
            elif isinstance(node, ast.AugAssign):
                if isinstance(node.target, (ast.Subscript, ast.Attribute)):
                    base = _base_name(node.target)
                    if base is not None:
                        for r in roots.get(base, set()):
                            if r in inflight:
                                out.append(_v(mod, node, "RC003",
                                              f"in-place update of staged wave state `{base}` "
                                              f"while its dispatch (line {inflight[r]}) may be "
                                              "in flight", qual))
    return out


# =========================================================================== RC004
_ENGINE_RECEIVERS = frozenset({"engine", "eng"})
_ENGINE_READS = frozenset({
    "stats", "loose_session_ids", "serve_watermark", "serve_watermarks",
    "session_ids", "session_health", "shard_of", "snapshot", "compute",
    "compute_all",
})
_GATE_ATTRS = frozenset({"_allowed", "dry_run"})
_ALLOWLIST_NAME = "AUTONOMIC_ENGINE_ALLOWLIST"


def _declared_allowlist(tree: ast.Module) -> Optional[Set[str]]:
    for stmt in tree.body:
        if isinstance(stmt, ast.Assign):
            for t in stmt.targets:
                if isinstance(t, ast.Name) and t.id == _ALLOWLIST_NAME:
                    if isinstance(stmt.value, (ast.Tuple, ast.List, ast.Set)):
                        return {e.value for e in stmt.value.elts
                                if isinstance(e, ast.Constant) and isinstance(e.value, str)}
    return None


def _engine_mutator_calls(fn: ast.AST) -> Iterator[Tuple[str, ast.Call]]:
    for node in ast.walk(fn):
        if not (isinstance(node, ast.Call) and isinstance(node.func, ast.Attribute)):
            continue
        base = node.func.value
        is_engine = (isinstance(base, ast.Name) and base.id in _ENGINE_RECEIVERS) or (
            isinstance(base, ast.Attribute) and base.attr == "engine"
            and isinstance(base.value, ast.Name) and base.value.id == "self"
        )
        if is_engine and node.func.attr not in _ENGINE_READS:
            yield node.func.attr, node


def _references_gate(fn: ast.AST) -> bool:
    return any(
        isinstance(node, ast.Attribute) and node.attr in _GATE_ATTRS
        and isinstance(node.value, ast.Name) and node.value.id == "self"
        for node in ast.walk(fn)
    )


def rule_rc004_autonomic_surface(mod: ModuleInfo) -> List[Violation]:
    if not (_in_scope(mod.path) and mod.path.endswith("autonomic.py")):
        return []
    out: List[Violation] = []
    allowlist = _declared_allowlist(mod.tree)

    def check_allowlist(name: str, node: ast.Call, qual: str) -> None:
        if allowlist is None:
            out.append(_v(mod, node, "RC004",
                          f"engine-mutating call `{name}()` but the module declares no "
                          f"`{_ALLOWLIST_NAME}` — declare the action surface so that "
                          "it (and this rule) can hold the line", qual))
        elif name not in allowlist:
            out.append(_v(mod, node, "RC004",
                          f"`{name}()` mutates engine internals not on "
                          f"`{_ALLOWLIST_NAME}` — autonomic reflexes act only through the "
                          "declared surface", qual))

    # module-level helpers: mechanism, allowlist-checked only (the class
    # reflexes that invoke them own the gate)
    for stmt in mod.tree.body:
        if isinstance(stmt, (ast.FunctionDef, ast.AsyncFunctionDef)):
            for name, node in _engine_mutator_calls(stmt):
                check_allowlist(name, node, stmt.name)

    for cls in _classes(mod):
        graph = _self_call_graph(cls)
        callers: Dict[str, Set[str]] = {}
        for m, callees in graph.items():
            for c in callees:
                callers.setdefault(c, set()).add(m)
        gate_direct = {m.name: _references_gate(m) for m in _methods(cls)}

        def gated(name: str, seen: Optional[Set[str]] = None) -> bool:
            if gate_direct.get(name):
                return True
            seen = seen or set()
            if name in seen:
                return False
            ups = callers.get(name, set())
            return bool(ups) and all(gated(u, seen | {name}) for u in ups)

        for meth in _methods(cls):
            if meth.name == "__init__":
                continue
            for name, node in _engine_mutator_calls(meth):
                qual = f"{cls.name}.{meth.name}"
                check_allowlist(name, node, qual)
                if not gated(meth.name):
                    out.append(_v(mod, node, "RC004",
                                  f"`{name}()` mutates the engine without consulting the "
                                  "rate-limit/dry-run gate (`self._allowed` / `self.dry_run`) "
                                  "on any path — an ungated reflex can thrash the fleet", qual))
    return out


# =========================================================================== RC005
_REPLAYISH_EXACT = frozenset({"restore", "reconnect"})
_REPLAY_LATCH = "_replaying"


def _is_replayish(name: str) -> bool:
    return name in _REPLAYISH_EXACT or name.startswith(("replay", "_replay"))


def _wal_append_calls(fn: ast.AST) -> Iterator[ast.Call]:
    for node in ast.walk(fn):
        if (
            isinstance(node, ast.Call)
            and isinstance(node.func, ast.Attribute)
            and node.func.attr == "append"
            and "_wal" in _dotted(node.func.value)
        ):
            yield node


def _references_latch(fn: ast.AST) -> bool:
    return any(
        isinstance(node, ast.Attribute) and node.attr == _REPLAY_LATCH
        for node in ast.walk(fn)
    )


def rule_rc005_replay_reentrancy(mod: ModuleInfo) -> List[Violation]:
    if not _in_scope(mod.path):
        return []
    out: List[Violation] = []
    for cls in _classes(mod):
        methods = list(_methods(cls))
        exposed = any(_is_replayish(m.name) for m in methods) or any(
            _references_latch(m) for m in methods
        ) or _REPLAY_LATCH in mod.source
        if not exposed:
            continue
        for meth in methods:
            appends = list(_wal_append_calls(meth))
            if appends and not _references_latch(meth):
                for node in appends:
                    out.append(_v(mod, node, "RC005",
                                  "WAL append without consulting the `_replaying` latch in a "
                                  "replay-exposed class — a replayed apply re-journals itself "
                                  "and doubles the journal on every recovery (the "
                                  "`death[replay]` bug class)", f"{cls.name}.{meth.name}"))
    return out


# =========================================================================== RC006
_ITER_VIEWS = frozenset({"items", "values", "keys"})
_SNAPSHOT_WRAPPERS = frozenset({"list", "tuple", "sorted", "set", "frozenset", "dict"})
_RC006_MUTATORS = frozenset({
    "pop", "popitem", "append", "clear", "update", "remove", "insert",
    "extend", "setdefault", "discard", "add",
})


def _iterated_self_attr(iter_expr: ast.expr) -> Optional[str]:
    """``self.X`` / ``self.X.items()/values()/keys()`` loop iterables → ``X``."""
    e = iter_expr
    if (
        isinstance(e, ast.Call)
        and isinstance(e.func, ast.Attribute)
        and e.func.attr in _ITER_VIEWS
        and not e.args
    ):
        e = e.func.value
    if isinstance(e, ast.Attribute) and isinstance(e.value, ast.Name) and e.value.id == "self":
        return e.attr
    return None


def _direct_struct_mutations(fn: ast.AST) -> Set[str]:
    """Attrs of ``self`` this function structurally mutates (not rebinds)."""
    muts: Set[str] = set()
    for node in ast.walk(fn):
        if isinstance(node, ast.Call) and isinstance(node.func, ast.Attribute):
            if node.func.attr in _RC006_MUTATORS:
                recv = node.func.value
                if isinstance(recv, ast.Attribute) and isinstance(recv.value, ast.Name) \
                        and recv.value.id == "self":
                    muts.add(recv.attr)
        elif isinstance(node, ast.Assign):
            for t in _flat_targets(node):
                if isinstance(t, ast.Subscript):
                    attr = _attr_store_name(t)
                    if attr:
                        muts.add(attr)
        elif isinstance(node, ast.Delete):
            for t in node.targets:
                if isinstance(t, ast.Subscript):
                    attr = _attr_store_name(t)
                    if attr:
                        muts.add(attr)
    return muts


def rule_rc006_iterate_while_mutate(mod: ModuleInfo) -> List[Violation]:
    if not _in_scope(mod.path):
        return []
    out: List[Violation] = []
    for cls in _classes(mod):
        graph = _self_call_graph(cls)
        direct = {m.name: _direct_struct_mutations(m) for m in _methods(cls)}

        reach_cache: Dict[str, Set[str]] = {}

        def reach_mut(name: str) -> Set[str]:
            if name in reach_cache:
                return reach_cache[name]
            reach_cache[name] = set()  # cycle guard
            acc = set(direct.get(name, set()))
            for callee in graph.get(name, ()):
                if callee in direct:
                    acc |= reach_mut(callee)
            reach_cache[name] = acc
            return acc

        for meth in _methods(cls):
            for node in ast.walk(meth):
                if not isinstance(node, (ast.For, ast.AsyncFor)):
                    continue
                it = node.iter
                if isinstance(it, ast.Call) and isinstance(it.func, ast.Name) \
                        and it.func.id in _SNAPSHOT_WRAPPERS:
                    continue  # snapshot idiom: iterate a copy
                attr = _iterated_self_attr(it)
                if attr is None:
                    continue
                body_mut = any(
                    attr in _direct_struct_mutations(stmt) for stmt in node.body
                )
                via: Optional[str] = None
                if not body_mut:
                    for sub in node.body:
                        for call in ast.walk(sub):
                            if (
                                isinstance(call, ast.Call)
                                and isinstance(call.func, ast.Attribute)
                                and isinstance(call.func.value, ast.Name)
                                and call.func.value.id == "self"
                                and attr in reach_mut(call.func.attr)
                            ):
                                via = call.func.attr
                                break
                        if via:
                            break
                if body_mut or via:
                    how = f"via `self.{via}()`" if via else "directly"
                    out.append(_v(mod, node, "RC006",
                                  f"iterating `self.{attr}` while the loop body mutates it "
                                  f"{how} — snapshot with `list(...)` first (the reactor's "
                                  "swap/copy idiom)", f"{cls.name}.{meth.name}"))
    return out


RACE_RULES = {
    "RC001": rule_rc001_multi_context_writes,
    "RC002": rule_rc002_durability_ordering,
    "RC003": rule_rc003_staged_buffer_mutation,
    "RC004": rule_rc004_autonomic_surface,
    "RC005": rule_rc005_replay_reentrancy,
    "RC006": rule_rc006_iterate_while_mutate,
}

SUMMARIES = {
    "RC001": "shared attribute written from more than one control-plane context",
    "RC002": "ack/watermark advance not dominated by its fsync/WAL append",
    "RC003": "staged wave buffer mutated while its dispatch may be in flight",
    "RC004": "autonomic action off the declared allowlist or rate-limit/dry-run gate",
    "RC005": "WAL append without the _replaying re-entrancy latch",
    "RC006": "iterating a self container a reachable callee mutates",
}
