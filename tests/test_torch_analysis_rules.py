"""The port's jitlint (JL001-JL006), distlint (DL001-DL005), donlint (ML001-ML006) and racelint (RC001-RC006)
against the JAX package's: the same codes and suppressions on the torch rewrite of every snippet of this
package's rule tests, and the torch forms each rule gains (``torch.compile`` bindings, host inputs converted in
their non-tensor branch, in-place folds, ``torch.distributed`` aliases, ``.clone()``, copies that run after
``non_blocking=True`` returns)."""

from __future__ import annotations

import textwrap

import pytest

from metrics_tpu.analysis import contexts as jctx
from metrics_tpu.analysis import engine as jeng
from metrics_tpu_torch.analysis import contexts as tctx, engine as teng

from _torch_lint_snippets import lint, snippets, to_torch

# snippets whose torch rewrite has no meaning, each with its reason
NO_TORCH_MEANING = {
    # torch.compile takes no static_argnames: it specializes every str/bool argument by itself, recompiling per
    # value, which is what the port's JL002 reports; binding the config with functools.partial clears it
    "test_jit_with_static_argnames_is_clean",
}

SNIPPETS = (snippets("test_jitlint_rules.py", "pkg/functional/mod.py", jctx.RULE_CODES, skip=NO_TORCH_MEANING)
            + snippets("test_distlint_rules.py", "pkg/mod.py", jctx.DIST_RULE_CODES)
            + snippets("test_donlint_rules.py", "pkg/mod.py", jctx.MEM_RULE_CODES)
            + snippets("test_race_rules.py", "metrics_tpu/serve/mod.py", jctx.RACE_RULE_CODES))


def _port_rel(rel: str) -> str:
    return rel.replace("metrics_tpu/", "metrics_tpu_torch/")


@pytest.mark.parametrize("source,rel,rules", SNIPPETS)
def test_rules_fire_as_the_jax_package_s_on_the_torch_rewrite(tmp_path, source, rel, rules):
    """The port's JL/DL/ML/RC rules report the same codes (and suppressions) on the torch rewrite of a JAX
    rule-test snippet as the JAX package's rules on the original."""
    want = lint(jeng, tmp_path / "jax", source, rel, rules)
    got = lint(teng, tmp_path / "torch", to_torch(source, rules), _port_rel(rel), rules)
    assert got == want, to_torch(source, rules)


def test_the_rewrite_covers_every_rule(tmp_path):
    """About 125 snippets, and every code of the four packs fires on at least one of them in the port."""
    assert len(SNIPPETS) >= 120
    fired = set()
    for i, p in enumerate(SNIPPETS):
        source, rel, rules = p.values
        fired.update(lint(teng, tmp_path / str(i), to_torch(source, rules), _port_rel(rel), rules)[0])
    assert fired >= set(tctx.RULE_CODES) | set(tctx.DIST_RULE_CODES) | set(tctx.MEM_RULE_CODES) | set(
        tctx.RACE_RULE_CODES)


# ------------------------------------------------------------------------------------ the torch forms
def _codes(tmp_path, source, rel, rules):
    return lint(teng, tmp_path, textwrap.dedent(source), rel, rules)[0]


@pytest.mark.parametrize("source,want", [
    ("""
        import torch

        @torch.compile
        def kernel(x: torch.Tensor, mode: str = "macro") -> torch.Tensor:
            return x
     """, ["JL002"]),
    ("""
        import functools
        import torch

        def kernel(x: torch.Tensor, mode: str = "macro") -> torch.Tensor:
            return x

        fast = torch.compile(kernel)
        bound = torch.compile(functools.partial(kernel, mode="macro"))
     """, ["JL002"]),
    ("""
        import numpy as np
        import torch
        from torch import Tensor

        def kernel(x: Tensor) -> Tensor:
            if not isinstance(x, Tensor):
                x = torch.from_numpy(np.asarray(x))
            y = x if isinstance(x, Tensor) else torch.from_numpy(np.asarray(x))
            return np.log(y)
     """, ["JL004"]),
    ("""
        import torch

        def kernel(x: torch.Tensor) -> torch.Tensor:
            torch.cuda.synchronize()
            return x
     """, ["JL005"]),
])
def test_jitlint_reads_torch_forms(tmp_path, source, want):
    """A compiled function's free config param (bound by functools.partial: clean); np.* converting a host input
    in its non-tensor branch (clean) against np.* of a tensor; a synchronize in a kernel."""
    assert _codes(tmp_path, source, "pkg/functional/mod.py", list(tctx.RULE_CODES)) == want


def test_jitlint_leaves_the_port_s_kernel_timers_alone(tmp_path):
    source = "import torch\n\ndef time_ms(fn):\n    torch.cuda.synchronize()\n    print(fn)\n"
    assert _codes(tmp_path / "a", source, "metrics_tpu_torch/ops/profile.py", ["JL005"]) == []
    assert _codes(tmp_path / "b", source, "metrics_tpu_torch/ops/other.py", ["JL005"]) == ["JL005"] * 2


@pytest.mark.parametrize("source,want", [
    ("import torch.distributed as dist\n\ndef f(x):\n    dist.all_reduce(x)\n", ["DL004"]),
    ("from torch import distributed as tdist\n\ndef f(x):\n    tdist.broadcast(x, 0)\n", ["DL004"]),
    ("import torch\n\ndef f(x):\n    torch.distributed.all_gather_object([None], x)\n", ["DL004"]),
    ("from torch.distributed import reduce_scatter\n\ndef f(o, x):\n    reduce_scatter(o, x)\n", ["DL004"]),
    ("def all_reduce(x):\n    return x\n\ndef f(x):\n    return all_reduce(x)\n", []),
])
def test_distlint_reads_torch_distributed(tmp_path, source, want):
    assert _codes(tmp_path, source, "metrics_tpu_torch/engine/mod.py", ["DL004"]) == want
    assert _codes(tmp_path / "s", source, "metrics_tpu_torch/parallel/sync.py", ["DL004"]) == []


def test_distlint_reads_in_place_folds(tmp_path):
    source = """
        import torch

        class M(Metric):
            def __init__(self):
                self.add_state("total", torch.tensor(0.0), dist_reduce_fx="sum")
                self.add_state("prod", torch.tensor(1.0), dist_reduce_fx="sum")

            def update(self, x):
                self.total.add_(x.sum())
                self.prod.mul_(x.prod())
    """
    assert _codes(tmp_path, source, "pkg/mod.py", ["DL002"]) == ["DL002"]


@pytest.mark.parametrize("ret,want", [("self.total", ["ML001"]), ("self.total.clone()", []),
                                      ("self.total.detach().clone()", []), ("self.total.detach()", ["ML001"])])
def test_donlint_severs_an_alias_with_clone(tmp_path, ret, want):
    source = f"""
        import torch

        class M(Metric):
            def __init__(self):
                self.add_state("total", torch.tensor(0.0), dist_reduce_fx="sum")

            def update(self, x):
                self.total = self.total + x.sum()
                return {ret}
    """
    assert _codes(tmp_path, source, "pkg/mod.py", ["ML001"]) == want


@pytest.mark.parametrize("body,want", [
    # the copy engine reads a pinned source after the call returns: a mutation before a sync races it
    ("host = torch.zeros(4).pin_memory()\n        dev = host.to('cuda', non_blocking=True)\n        host[0] = 1.0",
     ["RC003"]),
    ("host = torch.zeros(4).pin_memory()\n        dst.copy_(host, non_blocking=True)\n        host.fill_(0.0)",
     ["RC003"]),
    ("host = torch.zeros(4).pin_memory()\n        dev = host.to('cuda', non_blocking=True)\n"
     "        torch.cuda.synchronize()\n        host[0] = 1.0", []),
    ("host = torch.zeros(4).pin_memory()\n        dev = host.to('cuda', non_blocking=True)\n"
     "        host = torch.zeros(4)\n        host[0] = 1.0", []),
    # a fresh pinned tensor that no name holds (the engine's wave staging) is clean
    ("dev = torch.zeros(4).pin_memory().to('cuda', non_blocking=True)\n        dev[0] = 1.0", []),
    ("host = torch.zeros(4)\n        dev = host.to('cuda')\n        host[0] = 1.0", []),
])
def test_racelint_holds_a_non_blocking_copy_in_flight(tmp_path, body, want):
    source = f"import torch\n\nclass Engine:\n    def tick(self, dst):\n        {body}\n"
    assert _codes(tmp_path, source, "metrics_tpu_torch/engine/mod.py", ["RC003"]) == want


def test_the_sharded_engine_routes_its_collectives_through_the_sync_layer():
    """DL004 is clean on the sharded engine without a baseline entry: its all-reduces go through
    ``parallel/sync.py``."""
    import os

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    res = teng.lint_file(os.path.join(root, "metrics_tpu_torch", "engine", "sharded.py"), root=root, rules=["DL004"])
    assert res.violations == [] and res.suppressed == 0
    src = open(os.path.join(root, "metrics_tpu_torch", "engine", "sharded.py")).read()
    assert "dist.all_reduce" not in src and "_all_reduce_in_place" in src
