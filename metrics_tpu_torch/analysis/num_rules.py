"""numlint rules NL001-NL006: numerical soundness over long horizons, in torch idioms (counterpart of
``metrics_tpu/analysis/num_rules.py``).

A fleet metric streams updates for days: a float32 running sum loses ulps per tick, an int32 counter wraps
near 2^31 updates, and a single-pass variance ``E[x^2]-E[x]^2`` cancels once the data mean dwarfs its spread.
numlint is the static half of the precision contract; the dynamic half
(:mod:`metrics_tpu_torch.analysis.precision_contracts`) replays every registry class against a float64
oracle and through adversarial regimes, and requires the static verdict, the declared tolerance and the
runtime error to agree.

The sanctioned annotation is a *declared horizon or tolerance* on the state::

    self.add_state("total", torch.zeros((), dtype=torch.int32), "sum",
                   precision={"horizon": 2**31, "note": "pinned for parity"})

(``Metric.add_state(..., precision=...)``: ``"compensated"`` for a Neumaier pair, or a dict with
``horizon``/``rtol``/``note``), or the comment ``# numlint: horizon=<bound>`` on the ``add_state`` line or
the line above. The rules read the same source shapes as the JAX package's, with the torch names for its
``jnp`` ones: ``torch.div`` for ``jnp.divide``, ``.to(dtype)``/``.float()``/``.int()`` for ``.astype``,
``torch.clamp`` for ``jnp.clip``, ``torch.acos`` for ``jnp.arccos``, ``torch.pow`` for ``jnp.power``.
NL001-NL003 apply in the numerical scope (``functional/``, ``ops/``, ``sketches/``, ``windows/``,
``aggregation.py``); NL004-NL006 read state declarations package-wide.

=======  ======================================================================
code     invariant
=======  ======================================================================
NL001    no unguarded traced division: a raw ``/`` (or ``torch.div``) whose
         denominator is an array value not proven nonzero — route through
         ``_safe_divide`` (documented 0/0 and x/0 contract) or guard with
         ``+ eps`` / ``torch.clamp(d, tiny)`` / the ``torch.where(d == 0, 1, d)``
         safe-denominator idiom. Denominators built *only* from count-named
         values under monotone non-negative composition (``num_obs``,
         ``weight.sum()``, ``num_prior + num_obs``) ride the caller-count
         contract — the empty-state 0/0 belongs to ``_safe_divide`` at the
         aggregate boundary, not to every kernel
NL002    no catastrophic-cancellation moment forms in traced code:
         ``E[x²] − E[x]²`` (and the ``E[xy] − E[x]E[y]`` covariance shape)
         cancels at large offsets — use shifted data, Welford/Chan pairwise
         moments, or a compensated fold (mitigation is recognized by
         shifted/welford/m2/compensated naming in the enclosing kernel)
NL003    no unclamped domain-edge math on computed values: ``log``/``sqrt``/
         ``arccos``/fractional ``power`` of a difference or ratio that
         rounding can push out of domain, and ``exp`` of a raw unbounded
         input (no max-shift / clip / logsumexp discipline)
NL004    no undeclared narrow accumulators: ``add_state`` with a pinned
         int32-or-narrower counter or a pinned float32 running sum under
         ``dist_reduce_fx="sum"`` must widen (regime-following default or a
         ``count_dtype()``-style helper), compensate (``<name>_comp``
         companion or ``precision="compensated"``), or declare its horizon
         (``precision={"horizon": ...}`` / ``# numlint: horizon=``)
NL005    no dtype demotion inside a state fold: a down-width ``.astype`` on
         the value folded back into ``self.<state>`` (silently demoting the
         accumulator in the float64 regime) unless it re-pins the state's own declared
         dtype; no mixed-dtype ``torch.where`` folding a float constant into an
         int-defaulted state (weak-type promotion rewrites the accumulator
         dtype mid-stream)
NL006    float-sum states declared ``merge_associative=True`` carry a declared
         reassociation tolerance (``precision={"rtol": ...}`` or
         ``precision="compensated"`` or class-level ``__precision_rtol__``) —
         float addition is not associative, so the distlint algebra claim is
         only honest with an error bound attached
=======  ======================================================================
"""

from __future__ import annotations

import ast
import re
from dataclasses import dataclass
from typing import Callable, Dict, Iterator, List, Optional, Sequence, Set, Tuple

from metrics_tpu_torch.analysis.contexts import ArrayTaint, Violation, self_state_seeds
from metrics_tpu_torch.analysis.engine import ModuleInfo, _dotted, _v

__all__ = ["NUM_RULES", "classify_precision", "HORIZON_MARKER"]

# the NL004 comment-annotation grammar: `# numlint: horizon=<bound>[ — why]`
HORIZON_MARKER = "horizon="

# ------------------------------------------------------------ numerical scope
# NL001–NL003 police traced arithmetic and apply only where the heavy math
# lives; NL004–NL006 police `add_state` declarations and run package-wide.
_NUM_DIRS = (
    "metrics_tpu_torch/functional/",
    "metrics_tpu_torch/ops/",
    "metrics_tpu_torch/sketches/",
    "metrics_tpu_torch/windows/",
)
_NUM_FILES = {"metrics_tpu_torch/aggregation.py"}


def _in_num_scope(path: str) -> bool:
    return path in _NUM_FILES or any(path.startswith(d) for d in _NUM_DIRS)


def _markers(mod: ModuleInfo):
    from metrics_tpu_torch.analysis.engine import SourceMarkers  # local: avoid import cycle

    return SourceMarkers(mod.source)


# ------------------------------------------------------------------- helpers
# c1/c2/c3 are the SSIM-family stabilizer constants — positive by construction
_EPS_NAME_RE = re.compile(r"(eps|epsilon|tiny|smooth|stabil|^c[123]$)", re.IGNORECASE)
# kernels whose naming announces a cancellation-safe formulation
_NL002_MITIGATION_RE = re.compile(
    r"(welford|shifted|shift_|kahan|neumaier|compensat|center|two_pass|pairwise|\bm2\b|_m2)",
    re.IGNORECASE,
)

# torch's aliases too: torch.int is int32, torch.short int16, torch.half float16, torch.float float32
_NARROW_INTS = frozenset({"int8", "int16", "int32", "uint8", "uint16", "uint32", "int", "short"})
_NARROW_FLOATS = frozenset({"float16", "bfloat16", "float32", "half", "float"})
# dtype-casting methods and the dtype each one casts to
_CAST_METHODS = {"float": "float32", "half": "float16", "bfloat16": "bfloat16", "int": "int32", "short": "int16"}


def _last_name(e: ast.expr) -> str:
    """Trailing identifier of a Name/Attribute chain ('' otherwise)."""
    if isinstance(e, ast.Attribute):
        return e.attr
    if isinstance(e, ast.Name):
        return e.id
    return ""


def _positive_const(e: ast.expr) -> bool:
    if isinstance(e, ast.Constant):
        return isinstance(e.value, (int, float)) and e.value > 0
    # torch.ones_like(d): the torch spelling of the constant 1 in where(d == 0, 1, d)
    if isinstance(e, ast.Call) and _last_name(e.func) in ("ones_like", "new_ones"):
        return True
    # torch.inf / np.inf / math.inf — the where(d > 0, d, inf) guard idiom
    return _last_name(e) == "inf"


def _eps_like(e: ast.expr) -> bool:
    """An expression that is, by construction or naming, a tiny positive guard."""
    if _positive_const(e):
        return True
    name = _last_name(e)
    if name and _EPS_NAME_RE.search(name):
        return True
    # torch.finfo(x.dtype).eps / .tiny / .smallest_normal
    if isinstance(e, ast.Attribute) and e.attr in ("eps", "tiny", "smallest_normal"):
        return True
    if isinstance(e, ast.Call):
        fn_name = _last_name(e.func)
        if fn_name and _EPS_NAME_RE.search(fn_name):
            return True
    return False


def _proven_nonzero(e: ast.expr, proven: Set[str]) -> bool:
    """Is this denominator structurally guaranteed nonzero?

    Recognized proofs: nonzero constants; ``x + eps`` guards (positive constant
    or eps-named operand); ``torch.clamp(x, tiny)`` / ``torch.clamp(x, a_min>0)``;
    ``torch.exp``/``torch.cosh`` (mathematically positive); the
    ``torch.where(d == 0, 1, d)`` safe-denominator idiom; names assigned from a
    proven expression earlier in the function; negation/products thereof.
    """
    if isinstance(e, ast.Constant):
        return isinstance(e.value, (int, float)) and e.value != 0
    if isinstance(e, ast.Name):
        return e.id in proven or bool(_EPS_NAME_RE.search(e.id))
    if _eps_like(e):
        return True
    if isinstance(e, ast.UnaryOp) and isinstance(e.op, (ast.USub, ast.UAdd)):
        return _proven_nonzero(e.operand, proven)
    if isinstance(e, ast.BinOp):
        if isinstance(e.op, ast.Add):
            return _eps_like(e.left) or _eps_like(e.right) or _proven_nonzero(e.left, proven) or _proven_nonzero(e.right, proven)
        if isinstance(e.op, (ast.Mult, ast.Pow)):
            return _proven_nonzero(e.left, proven) and _proven_nonzero(e.right, proven)
    if isinstance(e, ast.Call):
        fn = _last_name(e.func)
        if fn in ("exp", "exp2", "expm1", "cosh", "square_plus", "softplus") or fn.startswith("_exp"):
            return True  # mathematically positive (underflow notwithstanding)
        if fn and fn.startswith("_safe"):
            return True
        if fn in ("maximum", "clip", "clamp", "clamp_min"):
            operands = list(e.args) + [kw.value for kw in e.keywords if kw.arg in ("a_min", "min")]
            return any(_eps_like(a) for a in operands)
        if fn == "where" and len(e.args) == 3:
            # torch.where(d == 0, 1.0, d) / where(d > 0, d, inf): a positive branch
            return _positive_const(e.args[1]) or _positive_const(e.args[2])
        # magnitude-preserving wrappers: f(x) nonzero whenever x is
        if fn in ("sqrt", "asarray", "array", "float32", "float64", "square") and e.args:
            return _proven_nonzero(e.args[0], proven)
        # sum/prod of a proven-positive elementwise value (HLL's Σ 2^-reg)
        if fn in ("sum", "prod"):
            if e.args:
                return _proven_nonzero(e.args[0], proven)
            if isinstance(e.func, ast.Attribute):
                return _proven_nonzero(e.func.value, proven)
    return False


# Count-contract naming: a denominator every leaf of which is count-named is
# the *empty-state* concern (0/0 before any update), owned by `_safe_divide`
# at the aggregate boundary and by each kernel's caller contract — not a
# precision hazard NL001 can improve on. Only monotone non-negative
# composition (+, *, indexing, .sum()) preserves the contract: a subtraction
# over counts (`nb - 1`) can cross zero and stays flagged.
_COUNT_CONTRACT_RE = re.compile(
    r"(num|count|total|\bobs\b|_obs|obs_|weight|denom|len\b|_len|size|batch|freq"
    r"|^n$|^n[_0-9]|^nb$|^ks$)",
    re.IGNORECASE,
)


def _count_contract(e: ast.expr) -> bool:
    if isinstance(e, ast.Constant):
        return isinstance(e.value, (int, float)) and e.value > 0
    if isinstance(e, (ast.Name, ast.Attribute)):
        name = _last_name(e)
        return bool(name and _COUNT_CONTRACT_RE.search(name))
    if isinstance(e, ast.Subscript):
        return _count_contract(e.value)
    if isinstance(e, ast.UnaryOp) and isinstance(e.op, ast.UAdd):
        return _count_contract(e.operand)
    if isinstance(e, ast.BinOp) and isinstance(e.op, (ast.Add, ast.Mult)):
        return _count_contract(e.left) and _count_contract(e.right)
    if isinstance(e, ast.Call):
        fn = _last_name(e.func)
        if fn in ("sum", "prod"):
            if e.args:
                return _count_contract(e.args[0])
            if isinstance(e.func, ast.Attribute):
                return _count_contract(e.func.value)
        if fn in ("asarray", "array", "astype", "to", "float32", "float64", "maximum", "as_tensor",
                  "tensor") and e.args:
            return _count_contract(e.args[0])
    return False


def _nonzero_names(fn: ast.AST) -> Set[str]:
    """Names assigned from a proven-nonzero expression (two-pass fixpoint)."""
    proven: Set[str] = set()
    for _ in range(2):
        for node in ast.walk(fn):
            if isinstance(node, ast.Assign) and _proven_nonzero(node.value, proven):
                for t in node.targets:
                    if isinstance(t, ast.Name):
                        proven.add(t.id)
    return proven


# =========================================================================== NL001
def rule_nl001_unguarded_division(mod: ModuleInfo) -> List[Violation]:
    if not _in_num_scope(mod.path):
        return []
    out: List[Violation] = []
    for ctx in mod.traced_contexts:
        taint = ArrayTaint(ctx.node, state_attrs=self_state_seeds(ctx))
        proven = _nonzero_names(ctx.node)
        for node in ast.walk(ctx.node):
            denom: Optional[ast.expr] = None
            if isinstance(node, ast.BinOp) and isinstance(node.op, ast.Div):
                denom = node.right
            elif isinstance(node, ast.AugAssign) and isinstance(node.op, ast.Div):
                denom = node.value
            elif (
                isinstance(node, ast.Call)
                and _dotted(node.func) in ("torch.div", "torch.divide", "torch.true_divide")
                and len(node.args) == 2
            ):
                denom = node.args[1]
            if denom is None:
                continue
            if not taint.is_array_expr(denom):
                continue  # Python-scalar denominators are eager-validated
            if _proven_nonzero(denom, proven) or _count_contract(denom):
                continue
            out.append(_v(mod, node, "NL001",
                          f"unguarded traced division by `{ast.unparse(denom)}` — use "
                          "_safe_divide or prove the denominator nonzero "
                          "(+eps / torch.clamp / where-guard)", ctx.qualname))
    return out


# =========================================================================== NL002
def _is_squared(e: ast.expr) -> Optional[ast.expr]:
    """The base of an ``x**2`` / ``torch.square(x)`` / ``x*x`` form, else None."""
    if isinstance(e, ast.BinOp) and isinstance(e.op, ast.Pow):
        if isinstance(e.right, ast.Constant) and e.right.value == 2:
            return e.left
    if isinstance(e, ast.Call) and _last_name(e.func) == "square" and len(e.args) == 1:
        return e.args[0]
    if isinstance(e, ast.BinOp) and isinstance(e.op, ast.Mult):
        try:
            if ast.unparse(e.left) == ast.unparse(e.right):
                return e.left
        except Exception:  # pragma: no cover - unparse is total on parsed trees
            pass
    return None


_MEAN_NAME_RE = re.compile(r"(mean|avg|average|mu\b|_bar\b|bar_)", re.IGNORECASE)
_SQ_NAME_RE = re.compile(r"(sq|square|xx|yy|x2|y2)", re.IGNORECASE)
_COUNT_NAME_RE = re.compile(r"(^n$|^n_|num|count|total|obs|weight|denom)", re.IGNORECASE)


def _mean_like(e: ast.expr) -> bool:
    """``sum_x / n`` or a mean/avg-named value."""
    name = _last_name(e)
    if name and _MEAN_NAME_RE.search(name):
        return True
    if isinstance(e, ast.BinOp) and isinstance(e.op, ast.Div):
        return bool(_COUNT_NAME_RE.search(_last_name(e.right) or ast.unparse(e.right)))
    if isinstance(e, ast.Call) and _last_name(e.func) in ("mean", "average"):
        return True
    return False


def _second_moment_like(e: ast.expr) -> bool:
    """``sum_sq / n`` — a raw second moment (squared-sum over a count)."""
    if isinstance(e, ast.BinOp) and isinstance(e.op, ast.Div):
        num_name = _last_name(e.left) or ast.unparse(e.left)
        if _is_squared(e.left) is not None or _SQ_NAME_RE.search(num_name):
            return bool(_COUNT_NAME_RE.search(_last_name(e.right) or ast.unparse(e.right)))
    name = _last_name(e)
    if name and _SQ_NAME_RE.search(name) and _MEAN_NAME_RE.search(name):
        return True
    if isinstance(e, ast.Call) and _last_name(e.func) == "mean" and e.args:
        return _is_squared(e.args[0]) is not None
    return False


def rule_nl002_catastrophic_cancellation(mod: ModuleInfo) -> List[Violation]:
    if not _in_num_scope(mod.path):
        return []
    out: List[Violation] = []
    for ctx in mod.traced_contexts:
        seg = ast.get_source_segment(mod.source, ctx.node) or ""
        if _NL002_MITIGATION_RE.search(seg) or _NL002_MITIGATION_RE.search(ctx.qualname):
            continue  # shifted/Welford/compensated formulation announced
        for node in ast.walk(ctx.node):
            if not (isinstance(node, ast.BinOp) and isinstance(node.op, ast.Sub)):
                continue
            sq_base = _is_squared(node.right)
            variance_form = sq_base is not None and _mean_like(sq_base) and _second_moment_like(node.left)
            covariance_form = (
                sq_base is None
                and isinstance(node.right, ast.BinOp)
                and isinstance(node.right.op, ast.Mult)
                and _mean_like(node.right.left)
                and _mean_like(node.right.right)
                and isinstance(node.left, ast.BinOp)
                and isinstance(node.left.op, ast.Div)
                and bool(_COUNT_NAME_RE.search(_last_name(node.left.right) or ""))
            )
            if variance_form or covariance_form:
                shape = "E[x²]−E[x]²" if variance_form else "E[xy]−E[x]E[y]"
                out.append(_v(mod, node, "NL002",
                              f"single-pass {shape} cancels catastrophically at large offsets "
                              "— use shifted data or Welford/Chan pairwise moments", ctx.qualname))
    return out


# =========================================================================== NL003
_DOMAIN_FNS = frozenset({"log", "log2", "log10", "sqrt", "arccos", "arcsin", "arccosh", "arctanh",
                         "acos", "asin", "acosh", "atanh", "rsqrt"})
_CLAMP_FNS = frozenset({
    "clip", "maximum", "minimum", "abs", "absolute", "square", "where",
    "softplus", "logaddexp", "logsumexp", "relu", "sigmoid", "clamp", "clamp_min", "clamp_max",
})


def _arg_is_clamped(arg: ast.expr) -> bool:
    for node in ast.walk(arg):
        if isinstance(node, ast.Call) and _last_name(node.func) in _CLAMP_FNS:
            return True
        if isinstance(node, ast.BinOp) and isinstance(node.op, ast.Add):
            if _eps_like(node.left) or _eps_like(node.right):
                return True
    return False


def _cancellation_risk(arg: ast.expr) -> bool:
    """A difference — or a ratio/product containing one — that rounding can
    push across the domain edge. A plain ratio of same-signed values
    (``log(maxval² / mse)``, ``sqrt(chi2 / n)``) cannot change sign by
    rounding and is not flagged."""
    if isinstance(arg, ast.BinOp) and isinstance(arg.op, ast.Sub):
        return True
    return any(
        isinstance(n, ast.BinOp) and isinstance(n.op, ast.Sub) for n in ast.walk(arg)
    )


def rule_nl003_unclamped_domain_edge(mod: ModuleInfo) -> List[Violation]:
    if not _in_num_scope(mod.path):
        return []
    out: List[Violation] = []
    for ctx in mod.traced_contexts:
        taint = ArrayTaint(ctx.node, state_attrs=self_state_seeds(ctx))
        for node in ast.walk(ctx.node):
            if not isinstance(node, ast.Call) or not node.args:
                continue
            fn = _last_name(node.func)
            arg = node.args[0]
            if fn in _DOMAIN_FNS:
                # rounding pushes a computed difference out of domain:
                # sqrt(1 - cos²) < 0, log(var) at E[x²]→E[x]², arccos(dot) > 1
                if (
                    isinstance(arg, ast.BinOp)
                    and _cancellation_risk(arg)
                    and taint.is_array_expr(arg)
                    and not _arg_is_clamped(arg)
                ):
                    out.append(_v(mod, node, "NL003",
                                  f"`{fn}` of a computed difference — rounding can leave "
                                  "the domain; clip/clamp the argument first", ctx.qualname))
            elif fn in ("power", "pow", "float_power") and len(node.args) == 2:
                exponent = node.args[1]
                fractional = not (isinstance(exponent, ast.Constant) and isinstance(exponent.value, int))
                if (
                    fractional
                    and isinstance(arg, ast.BinOp)
                    and _cancellation_risk(arg)
                    and taint.is_array_expr(arg)
                    and not _arg_is_clamped(arg)
                ):
                    out.append(_v(mod, node, "NL003",
                                  "fractional `power` of a computed difference — rounding "
                                  "can leave the domain; clip the base first", ctx.qualname))
            elif fn == "exp":
                # exp of a raw unbounded input overflows; exp(x - max)/clip
                # style shifts are the sanctioned discipline
                bare = arg
                if isinstance(bare, ast.UnaryOp) and isinstance(bare.op, ast.USub):
                    bare = bare.operand
                if isinstance(bare, (ast.Name, ast.Attribute)) and taint.is_array_expr(bare):
                    out.append(_v(mod, node, "NL003",
                                  "`exp` of a raw unbounded input — shift by the max "
                                  "(logsumexp discipline) or clip before exponentiating",
                                  ctx.qualname))
    return out


# ====================================================== state declarations (NL004+)
@dataclass
class _StateDecl:
    """One statically-visible ``add_state`` call."""

    call: ast.Call
    owner: str  # enclosing class qualname ('' at module level)
    name: Optional[str]  # state name when a literal
    default: Optional[ast.expr]
    reduce_literal: Optional[str]  # "sum"/"mean"/... when a literal string
    reduce_known: bool  # False when dist_reduce_fx is a variable/callable
    merge_associative: Optional[bool]  # literal True/False when visible
    precision: Optional[ast.expr]  # the precision= keyword value


def _arg_or_kw(call: ast.Call, index: int, kw_name: str) -> Optional[ast.expr]:
    if len(call.args) > index:
        return call.args[index]
    for kw in call.keywords:
        if kw.arg == kw_name:
            return kw.value
    return None


def _state_decls(mod: ModuleInfo) -> List[_StateDecl]:
    decls: List[_StateDecl] = []

    def visit(node: ast.AST, prefix: str) -> None:
        for child in ast.iter_child_nodes(node):
            if isinstance(child, ast.ClassDef):
                visit(child, f"{prefix}{child.name}.")
                continue
            for call in (n for n in ast.walk(child) if isinstance(n, ast.Call)):
                if not (isinstance(call.func, ast.Attribute) and call.func.attr == "add_state"):
                    continue
                name_expr = _arg_or_kw(call, 0, "name")
                reduce_expr = _arg_or_kw(call, 2, "dist_reduce_fx")
                assoc_expr = _arg_or_kw(call, 4, "merge_associative")
                reduce_literal = (
                    reduce_expr.value
                    if isinstance(reduce_expr, ast.Constant) and isinstance(reduce_expr.value, str)
                    else None
                )
                decls.append(_StateDecl(
                    call=call,
                    owner=prefix.rstrip("."),
                    name=name_expr.value if isinstance(name_expr, ast.Constant) and isinstance(name_expr.value, str) else None,
                    default=_arg_or_kw(call, 1, "default"),
                    reduce_literal=reduce_literal,
                    reduce_known=reduce_expr is None or isinstance(reduce_expr, ast.Constant),
                    merge_associative=(
                        assoc_expr.value
                        if isinstance(assoc_expr, ast.Constant) and isinstance(assoc_expr.value, bool)
                        else None
                    ),
                    precision=_arg_or_kw(call, 5, "precision"),
                ))

    visit(mod.tree, "")
    return decls


def _dtype_token(e: ast.expr) -> Optional[str]:
    """'int32'-style token from ``torch.int32`` / ``"int32"`` / bare ``int32``."""
    if isinstance(e, ast.Constant) and isinstance(e.value, str):
        return e.value
    if isinstance(e, ast.Name) and e.id in ("float", "int"):
        return {"float": "float64", "int": "int64"}[e.id]  # Python's float and int as a torch dtype
    name = _last_name(e)
    return name or None


def _pinned_dtype(default: Optional[ast.expr]) -> Optional[str]:
    """The narrow dtype a state default is explicitly pinned to, if any.

    Unpinned defaults (``torch.zeros(())``, ``torch.asarray(0)``) follow the float64
    regime where a helper (``acc_dtype()``, ``count_dtype()``) picks them, and are the
    sanctioned 'widened' form NL004 asks for.
    """
    if default is None:
        return None
    for node in ast.walk(default):
        if isinstance(node, ast.keyword) and node.arg == "dtype":
            if isinstance(node.value, ast.Call):
                # dtype=count_dtype(): a widening helper, not a pin
                return None
            token = _dtype_token(node.value)
            if token in _NARROW_INTS | _NARROW_FLOATS:
                return token
        if isinstance(node, ast.Call):
            fn = node.func
            if isinstance(fn, ast.Attribute) and fn.attr in ("astype", "to", "type") and node.args:
                token = _dtype_token(node.args[0])
                if token in _NARROW_INTS | _NARROW_FLOATS:
                    return token
            # positional dtype: jnp.zeros((4,), jnp.float32) in the JAX package's source shape
            if _last_name(fn) in ("zeros", "ones", "full", "asarray", "array") and len(node.args) >= 2:
                token = _dtype_token(node.args[-1])
                if token in _NARROW_INTS | _NARROW_FLOATS:
                    return token
    return None


def _precision_declares_rtol(precision: Optional[ast.expr]) -> bool:
    if precision is None:
        return False
    if isinstance(precision, ast.Constant) and precision.value == "compensated":
        return True
    if isinstance(precision, ast.Dict):
        return any(
            isinstance(k, ast.Constant) and k.value == "rtol" for k in precision.keys
        )
    return False


def _class_declares_rtol(mod: ModuleInfo, owner: str) -> bool:
    """Class-level ``__precision_rtol__ = <float>`` in the owning class body."""
    if not owner:
        return False
    leaf = owner.split(".")[-1]
    for node in ast.walk(mod.tree):
        if isinstance(node, ast.ClassDef) and node.name == leaf:
            for stmt in node.body:
                if isinstance(stmt, ast.Assign) and any(
                    isinstance(t, ast.Name) and t.id == "__precision_rtol__" for t in stmt.targets
                ):
                    return True
    return False


# =========================================================================== NL004
def rule_nl004_narrow_accumulators(mod: ModuleInfo) -> List[Violation]:
    decls = _state_decls(mod)
    if not decls:
        return []
    markers = _markers(mod)
    comp_pairs = {d.name for d in decls if d.name and d.name.endswith("_comp")}
    out: List[Violation] = []
    for d in decls:
        if d.precision is not None:
            continue  # declared horizon/tolerance/compensation
        if markers.has_marker(d.call.lineno, HORIZON_MARKER, prefix="numlint"):
            continue
        if d.name and (d.name.endswith("_comp") or f"{d.name}_comp" in comp_pairs):
            continue  # a Neumaier pair is a compensated accumulator
        if not d.reduce_known or d.reduce_literal != "sum":
            continue  # only the sum algebra accumulates without bound
        dtype = _pinned_dtype(d.default)
        if dtype is None:
            continue  # regime-following default: widened, the fix NL004 asks for
        label = d.name or "<dynamic>"
        ctx = d.owner or "<module>"
        if dtype in _NARROW_INTS:
            out.append(_v(mod, d.call, "NL004",
                          f"state `{label}` is a pinned {dtype} sum-counter — wraps near "
                          "2^31 updates; widen (regime-following default / count_dtype()) "
                          "or declare precision={'horizon': ...}", ctx))
        elif dtype in _NARROW_FLOATS:
            out.append(_v(mod, d.call, "NL004",
                          f"state `{label}` is a pinned {dtype} running sum — loses ulps "
                          "every tick on long horizons; widen, compensate "
                          "(precision='compensated') or declare a horizon", ctx))
    return out


# =========================================================================== NL005
def _int_defaulted_states(mod: ModuleInfo, owner_class: Optional[ast.ClassDef]) -> Set[str]:
    """States whose default is integer-valued (pinned int dtype or int literal)."""
    if owner_class is None:
        return set()
    names: Set[str] = set()
    for call in (n for n in ast.walk(owner_class) if isinstance(n, ast.Call)):
        if not (isinstance(call.func, ast.Attribute) and call.func.attr == "add_state"):
            continue
        name_expr = _arg_or_kw(call, 0, "name")
        default = _arg_or_kw(call, 1, "default")
        if not (isinstance(name_expr, ast.Constant) and isinstance(name_expr.value, str)) or default is None:
            continue
        dtype = _pinned_dtype(default)
        is_int = dtype in _NARROW_INTS or dtype in ("int64", "uint64")
        if dtype is None:
            consts = [n.value for n in ast.walk(default) if isinstance(n, ast.Constant)]
            is_int = bool(consts) and all(isinstance(c, int) and not isinstance(c, bool) for c in consts)
        if is_int:
            names.add(name_expr.value)
    return names


def _declared_dtypes(owner_class: Optional[ast.ClassDef]) -> Dict[str, str]:
    """state name -> its add_state-pinned dtype token (for the re-pin exemption)."""
    if owner_class is None:
        return {}
    pins: Dict[str, str] = {}
    for call in (n for n in ast.walk(owner_class) if isinstance(n, ast.Call)):
        if not (isinstance(call.func, ast.Attribute) and call.func.attr == "add_state"):
            continue
        name_expr = _arg_or_kw(call, 0, "name")
        if isinstance(name_expr, ast.Constant) and isinstance(name_expr.value, str):
            dtype = _pinned_dtype(_arg_or_kw(call, 1, "default"))
            if dtype:
                pins[name_expr.value] = dtype
    return pins


def _cast_token(sub: ast.AST) -> Optional[str]:
    """The dtype a cast call casts to (``.to(torch.int32)``, ``.type(...)``, ``.astype(...)``, ``.float()``),
    else None."""
    if not (isinstance(sub, ast.Call) and isinstance(sub.func, ast.Attribute)):
        return None
    if sub.func.attr in ("astype", "to", "type") and sub.args:
        token = _dtype_token(sub.args[0])
        return token if token and not token.startswith(("cuda", "cpu", "device")) else None
    if sub.func.attr == "to":
        for kw in sub.keywords:
            if kw.arg == "dtype":
                return _dtype_token(kw.value)
        return None
    if sub.func.attr in _CAST_METHODS and not sub.args:
        return _CAST_METHODS[sub.func.attr]
    return None


def rule_nl005_fold_demotion(mod: ModuleInfo) -> List[Violation]:
    out: List[Violation] = []
    for ctx in mod.traced_contexts:
        if ctx.kind != "update":
            continue  # only update folds back into state
        state_names = set(self_state_seeds(ctx))
        if not state_names:
            continue
        pins = _declared_dtypes(ctx.owner_class)
        int_states = _int_defaulted_states(mod, ctx.owner_class)
        for node in ast.walk(ctx.node):
            targets: List[ast.expr] = []
            if isinstance(node, ast.Assign):
                targets, value = node.targets, node.value
            elif isinstance(node, ast.AugAssign):
                targets, value = [node.target], node.value
            else:
                continue
            folded = [
                t.attr for t in targets
                if isinstance(t, ast.Attribute) and isinstance(t.value, ast.Name)
                and t.value.id == "self" and t.attr in state_names
            ]
            if not folded:
                continue
            for sub in ast.walk(value):
                token = _cast_token(sub)
                if token is not None:
                    if token in _NARROW_INTS | _NARROW_FLOATS and not any(
                        pins.get(s) == token for s in folded
                    ):
                        out.append(_v(mod, sub, "NL005",
                                      f"down-width cast to {token} inside the fold into "
                                      f"state `{folded[0]}`: demotes the accumulator in the float64 "
                                      "regime (cast matches no declared state dtype)", ctx.qualname))
                elif (
                    isinstance(sub, ast.Call)
                    and _last_name(sub.func) == "where"
                    and len(sub.args) == 3
                ):
                    branches = sub.args[1:3]
                    float_const = any(
                        isinstance(b, ast.Constant) and isinstance(b.value, float) for b in branches
                    )
                    int_state_branch = any(
                        isinstance(b, ast.Attribute) and isinstance(b.value, ast.Name)
                        and b.value.id == "self" and b.attr in int_states
                        for b in branches
                    )
                    if float_const and int_state_branch:
                        out.append(_v(mod, sub, "NL005",
                                      "mixed-dtype `where` folds a float constant against an "
                                      "int-defaulted state — weak-type promotion rewrites the "
                                      "accumulator dtype mid-stream", ctx.qualname))
    return out


# =========================================================================== NL006
def _default_is_floatish(default: Optional[ast.expr]) -> bool:
    if default is None:
        return False
    dtype = _pinned_dtype(default)
    if dtype is not None:
        return dtype in _NARROW_FLOATS
    for node in ast.walk(default):
        if isinstance(node, ast.keyword) and node.arg == "dtype":
            token = _dtype_token(node.value)
            if token and token.startswith(("int", "uint", "bool")):
                return False
        if isinstance(node, ast.Constant) and isinstance(node.value, float):
            return True
        if isinstance(node, ast.Call) and _last_name(node.func) in ("zeros", "ones", "full"):
            return len(node.args) < 2 and not any(kw.arg == "dtype" for kw in node.keywords)
    return False


def rule_nl006_undeclared_reassociation(mod: ModuleInfo) -> List[Violation]:
    decls = _state_decls(mod)
    if not decls:
        return []
    out: List[Violation] = []
    for d in decls:
        if d.merge_associative is not True:
            continue  # only an explicit associativity claim needs a tolerance
        if d.reduce_literal in ("max", "min"):
            continue  # exactly reassociation-invariant algebras
        if not _default_is_floatish(d.default):
            continue  # int/bit-pattern states reassociate exactly
        if _precision_declares_rtol(d.precision) or _class_declares_rtol(mod, d.owner):
            continue
        label = d.name or "<dynamic>"
        out.append(_v(mod, d.call, "NL006",
                      f"float state `{label}` claims merge_associative=True without a "
                      "reassociation tolerance — declare precision={'rtol': ...} (or "
                      "'compensated' / class __precision_rtol__)", d.owner or "<module>"))
    return out


NUM_RULES: Dict[str, Callable[[ModuleInfo], List[Violation]]] = {
    "NL001": rule_nl001_unguarded_division,
    "NL002": rule_nl002_catastrophic_cancellation,
    "NL003": rule_nl003_unclamped_domain_edge,
    "NL004": rule_nl004_narrow_accumulators,
    "NL005": rule_nl005_fold_demotion,
    "NL006": rule_nl006_undeclared_reassociation,
}


# ------------------------------------------------------------------ classify
def classify_precision(cls: type) -> Tuple[bool, str]:
    """Static precision verdict for a runtime class: (clean, hazards).

    Walks the MRO below :class:`metrics_tpu_torch.metric.Metric` exactly like
    ``classify_transfers`` and runs the state-declaration rules (NL004/NL005/
    NL006) plus the cancellation rule (NL002) over each class body, then
    chases one level of module-level callees (the functional kernels a
    ``compute`` delegates to) for NL002 — the cancellation almost always
    lives in ``functional/``, not the class body. Clean means *no statically
    visible precision hazard anywhere in the hierarchy* — the claim the
    runtime adversarial-regime leg of
    :mod:`metrics_tpu_torch.analysis.precision_contracts` re-proves dynamically.
    Inline ``# numlint:`` suppressions and markers in the source are honored,
    mirroring what a whole-file lint run would conclude.
    """
    import inspect
    import sys
    import textwrap

    from metrics_tpu_torch.analysis.engine import SourceMarkers  # local: avoid import cycle

    def _lint(source: str, tree: ast.Module, label: str, codes: Sequence[str]) -> Iterator[str]:
        # the synthetic path sits inside the numerical scope so the scoped
        # rules (NL002) treat MRO slices the way a whole-file run treats the
        # kernels they came from
        mod = ModuleInfo(
            path=f"metrics_tpu_torch/functional/<{label}>",
            tree=tree,
            source=source,
            is_functional=tree.body and isinstance(tree.body[0], (ast.FunctionDef, ast.AsyncFunctionDef)),
            is_package_init=False,
        )
        markers = SourceMarkers(source)
        for code in codes:
            for v in NUM_RULES[code](mod):
                if not markers.is_suppressed(v.line, v.rule):
                    yield f"{label}: {v.rule} {v.message}"

    hazards: List[str] = []
    seen_callees: Set[int] = set()
    for klass in cls.__mro__:
        if klass.__module__ in ("builtins", "abc"):
            continue
        if klass.__name__ == "Metric" and klass.__module__.endswith("metric"):
            break  # the runtime base owns the protocol; its body is not a subject
        try:
            source = textwrap.dedent(inspect.getsource(klass))
            tree = ast.parse(source)
        except (OSError, TypeError, SyntaxError):
            continue
        hazards.extend(_lint(source, tree, klass.__name__, ("NL002", "NL004", "NL005", "NL006")))
        # one level of callee-chasing: module-level kernels referenced by name
        home = sys.modules.get(klass.__module__)
        for name in sorted({n.id for n in ast.walk(tree) if isinstance(n, ast.Name)}):
            fn_obj = getattr(home, name, None)
            if not inspect.isfunction(fn_obj) or id(fn_obj) in seen_callees:
                continue
            if not getattr(fn_obj, "__module__", "").startswith("metrics_tpu_torch"):
                continue
            seen_callees.add(id(fn_obj))
            try:
                fn_source = textwrap.dedent(inspect.getsource(fn_obj))
                fn_tree = ast.parse(fn_source)
            except (OSError, TypeError, SyntaxError):
                continue
            hazards.extend(_lint(fn_source, fn_tree, fn_obj.__name__, ("NL002",)))
    return (not hazards, "; ".join(hazards))


# one line per rule for `--list-rules`
SUMMARIES = {
    "NL001": "unguarded traced division by an array denominator not proven nonzero",
    "NL002": "catastrophic-cancellation moment form (E[x^2]-E[x]^2) in traced code",
    "NL003": "unclamped domain-edge math (log/sqrt/arccos/exp) on computed values",
    "NL004": "pinned-narrow accumulator without widening, compensation, or a declared horizon",
    "NL005": "dtype demotion inside a state fold / mixed-dtype where into an int state",
    "NL006": "associative float-sum merge without a declared reassociation tolerance",
}
