"""Lint engine: walk source trees, run rules, apply suppressions and baselines (counterpart of
``metrics_tpu/analysis/engine.py``).

A baseline records *intentional* exceptions keyed by ``path::rule::context`` with an occurrence count; line
numbers are left out so that unrelated edits do not invalidate it. A run fails only on violations above the
baselined count for their key, and a baseline entry that matches nothing any more is reported as stale.

Every baseline file of the port (the lint passes', the contracts', the cost ratchet's and the telemetry
budget's) is one JSON document with a ``"comment"`` and one section per owner; :func:`load_baseline_section`
and :func:`write_baseline_section` are its only read and write path.
"""

from __future__ import annotations

import ast
import io
import json
import os
import tokenize
from collections import Counter
from dataclasses import dataclass, field
from typing import Callable, Dict, Iterable, List, Optional, Sequence, Set, Tuple

from metrics_tpu_torch.analysis.contexts import (
    _SUPPRESS_FILE_RE,
    _SUPPRESS_RE,
    SYNC_RULE_CODES,
    TracedContext,
    Violation,
    find_traced_contexts,
)
from metrics_tpu_torch.utils.io import atomic_write_text

__all__ = [
    "LintResult",
    "SourceMarkers",
    "lint_file",
    "lint_paths",
    "load_baseline",
    "load_baseline_section",
    "write_baseline",
    "write_baseline_section",
    "diff_against_baseline",
]

# the package's own directory and the repository root above it (the root every lint path is relative to)
PACKAGE_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REPO_ROOT = os.path.dirname(PACKAGE_DIR)


@dataclass
class ModuleInfo:
    """Everything a rule needs to know about one source file."""

    path: str  # repo-relative posix path
    tree: ast.Module
    source: str
    is_functional: bool  # under metrics_tpu_torch/functional/ or metrics_tpu_torch/ops/
    is_package_init: bool

    _contexts: Optional[List[TracedContext]] = field(default=None, repr=False)
    _nodes: Optional[List[ast.AST]] = field(default=None, repr=False)
    memo: Dict[str, object] = field(default_factory=dict, repr=False)  # per-module results rules share

    @property
    def traced_contexts(self) -> List[TracedContext]:
        if self._contexts is None:
            self._contexts = find_traced_contexts(self.tree, self.is_functional)
        return self._contexts

    @property
    def nodes(self) -> List[ast.AST]:
        """Every node of the tree, in ``ast.walk`` order (walked once per module)."""
        if self._nodes is None:
            self._nodes = list(ast.walk(self.tree))
        return self._nodes


def _v(mod: ModuleInfo, node: ast.AST, rule: str, msg: str, context: str = "<module>") -> Violation:
    return Violation(
        path=mod.path,
        line=getattr(node, "lineno", 1),
        col=getattr(node, "col_offset", 0),
        rule=rule,
        message=msg,
        context=context,
    )


def _dotted(e: ast.expr) -> str:
    """Best-effort dotted-name rendering (``'torch.bincount'``); ``''`` if not a name chain."""
    parts: List[str] = []
    while isinstance(e, ast.Attribute):
        parts.append(e.attr)
        e = e.value
    if isinstance(e, ast.Name):
        parts.append(e.id)
        return ".".join(reversed(parts))
    return ""


def _registry() -> Dict[str, Callable[[ModuleInfo], List[Violation]]]:
    """Every rule by code, across the six packs (imported here, not at the top: the rule modules import this
    one); the codes are unique, so ``--rules JL001,DL004,ML002`` selects across packs."""
    from metrics_tpu_torch.analysis.dist_rules import DIST_RULES
    from metrics_tpu_torch.analysis.mem_rules import MEM_RULES
    from metrics_tpu_torch.analysis.num_rules import NUM_RULES
    from metrics_tpu_torch.analysis.race_rules import RACE_RULES
    from metrics_tpu_torch.analysis.rules import ALL_RULES
    from metrics_tpu_torch.analysis.sync_rules import SYNC_RULES

    return {**ALL_RULES, **DIST_RULES, **MEM_RULES, **SYNC_RULES, **NUM_RULES, **RACE_RULES}


class SourceMarkers:
    """Every comment-derived fact the static passes need, from ONE ``tokenize`` pass: per-line and file-wide
    suppressions for every prefix of :data:`~metrics_tpu_torch.analysis.contexts.LINT_PREFIXES`, the set
    of commented lines, and annotation markers such as ``# hotlint: intentional-transfer`` (on a line or the
    line above). A ``#`` inside a string is never a suppression; broken source falls back to a per-line
    scan."""

    def __init__(self, source: str) -> None:
        self.comment_text: Dict[int, str] = {}
        try:
            for tok in tokenize.generate_tokens(io.StringIO(source).readline):
                if tok.type == tokenize.COMMENT:
                    self.comment_text[tok.start[0]] = tok.string
        except (tokenize.TokenError, IndentationError, SyntaxError):
            for i, text in enumerate(source.splitlines(), start=1):
                if "#" in text:
                    self.comment_text[i] = text[text.index("#"):]
        self._by_line: Dict[int, Set[str]] = {}
        self._file_wide: Set[str] = set()
        for lineno in sorted(self.comment_text):
            text = self.comment_text[lineno]
            m = _SUPPRESS_FILE_RE.search(text)
            if m:
                self._file_wide |= {c.strip().upper() for c in m.group(1).split(",") if c.strip()}
                continue
            m = _SUPPRESS_RE.search(text)
            if m:
                self._by_line[lineno] = {c.strip().upper() for c in m.group(1).split(",") if c.strip()}

    def is_suppressed(self, line: int, rule: str) -> bool:
        rule = rule.upper()
        if rule in self._file_wide or "ALL" in self._file_wide:
            return True
        codes = self._by_line.get(line)
        return bool(codes) and (rule in codes or "ALL" in codes)

    def comment_lines(self) -> Set[int]:
        """Lines carrying any comment."""
        return set(self.comment_text)

    def has_marker(self, line: int, marker: str, prefix: str = "hotlint") -> bool:
        """Is ``# <prefix>: <marker>`` present on ``line`` or the line above?"""
        needle = f"{prefix}: {marker}"
        return any(needle in self.comment_text.get(ln, "") for ln in (line, line - 1))


# directories whose members are functional kernels
_FUNCTIONAL_ROOTS = ("metrics_tpu_torch/functional", "metrics_tpu_torch/ops")
_SKIP_DIRS = {"__pycache__", ".git", "_build", "build", "dist"}


@dataclass
class LintResult:
    violations: List[Violation] = field(default_factory=list)
    suppressed: int = 0  # inline `# hotlint: disable=` hits
    files_scanned: int = 0
    parse_errors: List[str] = field(default_factory=list)

    def by_rule(self) -> Dict[str, int]:
        return dict(Counter(v.rule for v in self.violations))


def _relpath(path: str, root: Optional[str]) -> str:
    if root:
        try:
            return os.path.relpath(path, root).replace(os.sep, "/")
        except ValueError:
            pass
    return path.replace(os.sep, "/")


# parsed modules by (path, repo-relative path, mtime, size): the six passes over one tree parse each file once
_PARSED: Dict[Tuple[str, str, int, int], Tuple[ModuleInfo, SourceMarkers]] = {}


def _parsed(path: str, rel: str) -> Tuple[ModuleInfo, SourceMarkers]:
    st = os.stat(path)
    key = (os.path.abspath(path), rel, st.st_mtime_ns, st.st_size)
    hit = _PARSED.get(key)
    if hit is None:
        with open(path, "r", encoding="utf-8") as fh:
            source = fh.read()
        mod = ModuleInfo(
            path=rel,
            tree=ast.parse(source, filename=path),
            source=source,
            is_functional=any(rel.startswith(r) or f"/{r.split('/')[-1]}/" in rel for r in _FUNCTIONAL_ROOTS),
            is_package_init=os.path.basename(path) == "__init__.py",
        )
        hit = _PARSED[key] = (mod, SourceMarkers(source))
    return hit


def lint_file(path: str, root: Optional[str] = None, rules: Optional[Sequence[str]] = None) -> LintResult:
    """Lint one Python source file; ``root`` anchors the repo-relative path. ``rules`` defaults to
    hotlint's codes."""
    result = LintResult(files_scanned=1)
    rel = _relpath(path, root)
    try:
        mod, suppress = _parsed(path, rel)
    except (OSError, SyntaxError) as exc:
        result.parse_errors.append(f"{rel}: {exc}")
        return result
    registry = _registry()
    for code in rules or SYNC_RULE_CODES:
        rule = registry.get(code.upper())
        if rule is None:
            continue
        for violation in rule(mod):
            if suppress.is_suppressed(violation.line, violation.rule):
                result.suppressed += 1
            else:
                result.violations.append(violation)
    return result


def _iter_py_files(target: str) -> Iterable[str]:
    if os.path.isfile(target):
        yield target
        return
    for dirpath, dirnames, filenames in os.walk(target):
        dirnames[:] = sorted(d for d in dirnames if d not in _SKIP_DIRS)
        for name in sorted(filenames):
            if name.endswith(".py"):
                yield os.path.join(dirpath, name)


def lint_paths(targets: Sequence[str], root: Optional[str] = None, rules: Optional[Sequence[str]] = None) -> LintResult:
    """Lint files and directories; results merged in deterministic path order."""
    merged = LintResult(files_scanned=0)
    root = root or os.getcwd()
    for target in targets:
        for path in _iter_py_files(target):
            one = lint_file(path, root=root, rules=rules)
            merged.violations.extend(one.violations)
            merged.suppressed += one.suppressed
            merged.files_scanned += one.files_scanned
            merged.parse_errors.extend(one.parse_errors)
    merged.violations.sort(key=lambda v: (v.path, v.line, v.col, v.rule))
    return merged


# --------------------------------------------------------------------------- baseline
def load_baseline_section(path: str, section: str) -> Dict[str, object]:
    """One named section of a baseline JSON document ({} when absent)."""
    if not os.path.exists(path):
        return {}
    with open(path, "r", encoding="utf-8") as fh:
        data = json.load(fh)
    value = data.get(section, {})
    return dict(value) if isinstance(value, dict) else {}


def write_baseline_section(
    path: str,
    section: str,
    values: Dict[str, object],
    comment: str,
    seed: Optional[Dict[str, object]] = None,
) -> Dict[str, object]:
    """Rewrite one section (and the comment), keeping every sibling section, atomically; ``seed`` gives
    sections to create when the file lacks them (an existing sibling wins over its seed)."""
    payload: Dict[str, object] = {"comment": comment, section: values}
    for k, v in (seed or {}).items():
        payload.setdefault(k, v)
    if os.path.exists(path):
        try:
            with open(path, "r", encoding="utf-8") as fh:
                existing = json.load(fh)
            for k, v in existing.items():
                if k not in ("comment", section):
                    payload[k] = v
        except (OSError, ValueError):
            pass
    atomic_write_text(path, json.dumps(payload, indent=2, sort_keys=True) + "\n")
    return values


def load_baseline(path: str, section: str = "entries") -> Dict[str, int]:
    """A static pass's section as ``key -> count``; an entry may also be ``{"count": n, "reason": ...}``."""
    out: Dict[str, int] = {}
    for k, v in load_baseline_section(path, section).items():
        out[str(k)] = int(v["count"]) if isinstance(v, dict) else int(v)  # type: ignore[index,arg-type]
    return out


def write_baseline(
    path: str, violations: Sequence[Violation], section: str = "entries",
    reasons: Optional[Dict[str, str]] = None,
) -> Dict[str, int]:
    """Record ``violations`` as the section's counts; a key with a reason in ``reasons`` (or already in the
    file) is written as ``{"count": n, "reason": ...}``."""
    entries = dict(sorted(Counter(v.key() for v in violations).items()))
    known = dict(reasons or {})
    for k, v in load_baseline_section(path, section).items():
        if isinstance(v, dict) and "reason" in v:
            known.setdefault(str(k), str(v["reason"]))
    values: Dict[str, object] = {
        k: ({"count": n, "reason": known[k]} if k in known else n) for k, n in entries.items()
    }
    write_baseline_section(
        path,
        section,
        values,
        "lint baseline: intentional exceptions, keyed path::rule::context, each with its reason. "
        "Regenerate with `python -m metrics_tpu_torch.analysis.cli --pass <name> --update-baseline`.",
    )
    return entries


def diff_against_baseline(
    violations: Sequence[Violation], baseline: Dict[str, int]
) -> Tuple[List[Violation], int, List[str]]:
    """Split into (new, baselined_count, stale_baseline_keys)."""
    budget = dict(baseline)
    new: List[Violation] = []
    baselined = 0
    for v in violations:
        k = v.key()
        if budget.get(k, 0) > 0:
            budget[k] -= 1
            baselined += 1
        else:
            new.append(v)
    stale = sorted(k for k, remaining in budget.items() if remaining == baseline.get(k, 0) and baseline.get(k, 0) > 0)
    return new, baselined, stale
