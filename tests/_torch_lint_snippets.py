"""The JAX package's rule-test snippets and their torch rewrites, shared by the port's static-analysis tests.

:func:`snippets` harvests every ``run_lint(tmp_path, <source>, rel=..., rules=[...])`` of a JAX rule-test file
(the source a string literal, a class constant or a module constant, and a ``SEEDS`` table of
``(rule, rel, source, count)``); :func:`to_torch` rewrites a snippet's JAX spellings into their torch
counterparts; :func:`lint` lints one snippet with either package's engine.
"""

from __future__ import annotations

import ast
import os
import re
import textwrap

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# the JAX spellings of the rule tests and their torch counterparts, applied in order; `jax.device_get` is the
# JAX package's explicit fetch (HL001-HL003, HL006) and its blocking call (HL005), which are two calls here
_COMMON = [
    (r"from jax import lax", "import torch.distributed"),
    (r"from jax\.lax import p(sum|mean|max|min)", "from torch.distributed import all_reduce"),
    (r"lax\.p(?:sum|mean|max|min)\(([^,()]*), ['\"][^'\"]*['\"]\)", r"torch.distributed.all_reduce(\1)"),
    (r"\bp(?:sum|mean|max|min)\((\w+), ['\"][^'\"]*['\"]\)", r"all_reduce(\1)"),
    (r"jnp\.copy\(([^()]*(?:\([^()]*\))?[^()]*)\)", r"\1.clone()"),
    (r"jnp\.issubdtype\((\w+)\.dtype, jnp\.floating\)", r"\1.is_floating_point()"),
    (r"import jax\.numpy as jnp", "import torch"),
    (r"from jax import Array", "from torch import Tensor"),
    (r"\bArray\b", "Tensor"),
    (r"import jax\b", "import torch"),
    (r"jnp\.maximum\(d, jnp\.finfo\(x\.dtype\)\.tiny\)", "torch.clamp(d, min=torch.finfo(x.dtype).tiny)"),
    (r"jnp\.clip\(", "torch.clamp("),
    (r"jnp\.divide\(", "torch.div("),
    (r"jnp\.zeros\(\(([^()]*)\), jnp\.(\w+)\)", r"torch.zeros((\1), dtype=torch.\2)"),
    (r"\.astype\(", ".to("),
    (r"jnp\.", "torch."),
    (r"@jax\.jit", "@torch.compile"),
    (r"jax\.jit\(", "torch.compile("),
    (r"(\w+)\.block_until_ready\(\)", r"torch.cuda.synchronize(\1.device)"),
    (r"metrics_tpu\.", "metrics_tpu_torch."),
]
_FETCH = [(r"jax\.device_get\(([^()]*(?:\([^()]*\))?[^()]*)\)", r"_host_fetch(\1, 'test')")]
_BLOCK = [(r"jax\.device_get\(", "torch.cuda.synchronize(")]


def to_torch(source: str, rules) -> str:
    table = (_BLOCK if rules == ["HL005"] else _FETCH) + _COMMON
    for pattern, repl in table:
        source = re.sub(pattern, repl, source)
    return source


def snippets(test_file: str, default_rel: str, codes, skip=()):
    """Every ``run_lint`` snippet of a JAX rule-test file as ``pytest.param(source, rel, rules)``; a test named in
    ``skip`` is left out."""
    tree = ast.parse(open(os.path.join(ROOT, "tests", test_file)).read())
    class_consts = {st.targets[0].id: st.value.value for node in ast.walk(tree) if isinstance(node, ast.ClassDef)
                    for st in node.body if isinstance(st, ast.Assign) and isinstance(st.value, ast.Constant)}
    mod_consts = {st.targets[0].id: st.value.value for st in tree.body
                  if isinstance(st, ast.Assign) and isinstance(st.targets[0], ast.Name)
                  and isinstance(st.value, ast.Constant)}

    def const(e):
        if isinstance(e, ast.Constant):
            return e.value
        if isinstance(e, ast.Name):
            return mod_consts.get(e.id)
        return class_consts.get(getattr(e, "attr", ""))

    out = []
    for fn in (n for n in ast.walk(tree) if isinstance(n, ast.FunctionDef) and n.name.startswith("test_")):
        if fn.name in skip:
            continue
        for call in ast.walk(fn):
            if not (isinstance(call, ast.Call) and isinstance(call.func, ast.Name) and call.func.id == "run_lint"):
                continue
            if len(call.args) < 2:
                continue
            source = const(call.args[1])
            kw = {k.arg: k.value for k in call.keywords}
            rel = const(kw["rel"]) if "rel" in kw else default_rel
            rules = [const(e) for e in kw["rules"].elts] if isinstance(kw.get("rules"), ast.List) else None
            if isinstance(source, str) and isinstance(rel, str) and None not in (rules or ()):
                out.append(pytest.param(source, rel, rules or list(codes), id=f"{fn.name}:{rel.rsplit('/', 1)[-1]}"))
    # a SEEDS table of (rule, rel, source, count): each row is one more snippet
    for st in tree.body:
        if isinstance(st, ast.Assign) and getattr(st.targets[0], "id", "") == "SEEDS":
            for i, row in enumerate(st.value.elts):
                rule, rel, source = (const(e) for e in row.elts[:3])
                out.append(pytest.param(source, rel, [rule], id=f"SEEDS[{i}]:{rule}"))
    return out


def lint(engine, tmp_path, source, rel, rules):
    path = tmp_path / rel
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(textwrap.dedent(source))
    res = engine.lint_file(str(path), root=str(tmp_path), rules=rules)
    return [v.rule for v in res.violations], res.suppressed
