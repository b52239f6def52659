"""The port's static analysis against the JAX package's: hotlint (HL001-HL006) and numlint (NL001-NL006) on a
torch rewrite of every snippet of this package's rule tests, the lint engine's baseline arithmetic and
suppression grammar on identical inputs, and all six passes clean over the port's own source against the port's
baselines (each entry with its reason). The other four packs' snippets are in ``test_torch_analysis_rules.py``."""

from __future__ import annotations

import json
import os
import textwrap

import pytest

from metrics_tpu.analysis import contexts as jctx
from metrics_tpu.analysis import engine as jeng
from metrics_tpu_torch.analysis import cli, contexts as tctx, engine as teng

from _torch_lint_snippets import lint, snippets, to_torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_to_torch, _snippets, _lint = to_torch, snippets, lint

SNIPPETS = (_snippets("test_sync_rules.py", "metrics_tpu/engine/mod.py", jctx.SYNC_RULE_CODES)
            + _snippets("test_num_rules.py", "metrics_tpu/functional/kern.py", jctx.NUM_RULE_CODES))


@pytest.mark.parametrize("source,rel,rules", SNIPPETS)
def test_rules_fire_as_the_jax_package_s_on_the_torch_rewrite(tmp_path, source, rel, rules):
    """The port's HL/NL rules report the same codes (and suppressions) on the torch rewrite of a JAX rule-test
    snippet as the JAX package's rules on the original."""
    want = _lint(jeng, tmp_path / "jax", source, rel, rules)
    got = _lint(teng, tmp_path / "torch", _to_torch(source, rules), rel.replace("metrics_tpu/", "metrics_tpu_torch/"),
                rules)
    assert got == want, _to_torch(source, rules)


def test_the_rewrite_covers_every_rule():
    rules = {r for p in SNIPPETS for r in p.values[2]}
    assert rules == set(tctx.SYNC_RULE_CODES) | set(tctx.NUM_RULE_CODES)
    assert len(SNIPPETS) == 65


# ---------------------------------------------------------------------------------------- the engine
def _violations(mod):
    return [mod.Violation(path=f"metrics_tpu_torch/m{i % 3}.py", line=i, col=0, rule=("HL001", "NL004")[i % 2],
                          message="m", context=("f", "C.update")[i % 2]) for i in range(9)]


@pytest.mark.parametrize("budget", [{}, {"metrics_tpu_torch/m0.py::HL001::f": 1},
                                    {"metrics_tpu_torch/m1.py::NL004::C.update": 5, "gone::HL001::x": 2},
                                    {"metrics_tpu_torch/m2.py::HL001::f": 1, "metrics_tpu_torch/m0.py::HL001::f": 2}])
def test_diff_against_baseline_is_the_jax_package_s(budget):
    j = jeng.diff_against_baseline(_violations(jctx), dict(budget))
    t = teng.diff_against_baseline(_violations(tctx), dict(budget))
    assert ([v.key() for v in t[0]], t[1], t[2]) == ([v.key() for v in j[0]], j[1], j[2])
    assert [v.render() for v in t[0]] == [v.render() for v in j[0]]


def test_codes_prefixes_and_suppressions_parse_alike():
    for name in ("RULE_CODES", "DIST_RULE_CODES", "MEM_RULE_CODES", "SYNC_RULE_CODES", "NUM_RULE_CODES",
                 "RACE_RULE_CODES", "LINT_PREFIXES"):
        assert getattr(tctx, name) == getattr(jctx, name), name
    source = textwrap.dedent("""
        x = 1  # hotlint: disable=HL001,NL004
        y = "# numlint: disable=NL001"
        # racelint: disable-file=RC002
        z = 2  # donlint: disable=all
        w = 3  # hotlint: intentional-transfer — batched read
    """)
    jm, tm = jeng.SourceMarkers(source), teng.SourceMarkers(source)
    for line in range(1, 8):
        for rule in ("HL001", "NL004", "NL001", "RC002", "ML001"):
            assert tm.is_suppressed(line, rule) == jm.is_suppressed(line, rule), (line, rule)
        assert tm.has_marker(line, "intentional-transfer") == jm.has_marker(line, "intentional-transfer")
    assert tm.comment_lines() == jm.comment_lines()


def test_baseline_sections_round_trip_between_packages(tmp_path):
    """A section written by either package's engine reads back alike in both, siblings kept."""
    path = str(tmp_path / "b.json")
    jeng.write_baseline_section(path, "merge", {"CatMetric": "CAT_ORDER_SENSITIVE"}, "c", seed={"entries": {}})
    teng.write_baseline(path, _violations(tctx)[:3], section="entries", reasons={"metrics_tpu_torch/m0.py::HL001::f": "r"})
    assert teng.load_baseline_section(path, "merge") == jeng.load_baseline_section(path, "merge")
    assert teng.load_baseline(path) == {"metrics_tpu_torch/m0.py::HL001::f": 1,
                                        "metrics_tpu_torch/m1.py::NL004::C.update": 1,
                                        "metrics_tpu_torch/m2.py::HL001::f": 1}
    assert json.load(open(path))["entries"]["metrics_tpu_torch/m0.py::HL001::f"] == {"count": 1, "reason": "r"}


# ---------------------------------------------------------------------------------------- the port's source
@pytest.mark.parametrize("name", ["jitlint", "distlint", "donlint", "hotlint", "numlint", "racelint"])
def test_the_port_is_clean_against_its_baselines(name, capsys):
    """Each pass over the whole package: no new violation, no stale entry, every entry with a reason; the
    baselines live inside the package."""
    assert cli.main(["--pass", name, "--format", "json"]) == 0
    report = json.loads(capsys.readouterr().out)
    assert report["status"] == "ok" and report["new"] == [] and report["stale_baseline_keys"] == []
    path = cli._PASSES[name]["baseline"]
    assert path.startswith(os.path.join(ROOT, "metrics_tpu_torch", "analysis", "baselines"))
    section = cli._PASSES[name].get("section", "entries")
    entries = teng.load_baseline_section(path, section)
    assert report["baselined"] == sum(v["count"] for v in entries.values())
    assert all(isinstance(v, dict) and v["reason"] for v in entries.values())


def test_list_rules_names_every_code(capsys):
    """Every code of the six packs, and the JAX package's dynamic passes in its cheap-first order (the port's
    merge pass, which the JAX command line lacks, before transfer)."""
    from metrics_tpu.analysis import cli as jcli

    assert cli.main(["--list-rules", "--format", "json"]) == 0
    listing = json.loads(capsys.readouterr().out)
    for name, codes in (("jitlint", tctx.RULE_CODES), ("distlint", tctx.DIST_RULE_CODES),
                        ("donlint", tctx.MEM_RULE_CODES), ("hotlint", tctx.SYNC_RULE_CODES),
                        ("numlint", tctx.NUM_RULE_CODES), ("racelint", tctx.RACE_RULE_CODES)):
        assert sorted(listing["passes"][name]) == list(codes), name
    assert [p for p in listing["dynamic"] if p != "merge"] == list(jcli._DYNAMIC)
    assert listing["dynamic"].index("merge") == listing["dynamic"].index("transfer") - 1
    assert sorted(cli._PASSES) == sorted(jcli._PASSES)


def test_a_planted_host_read_fails_hotlint(tmp_path, capsys):
    """A new ``.item()`` in an engine file is a new violation (exit 1); its annotation clears it."""
    mod = tmp_path / "metrics_tpu_torch" / "engine" / "planted.py"
    mod.parent.mkdir(parents=True)
    mod.write_text("import torch\n\ndef f(x):\n    return torch.sum(x).item()\n")
    assert cli.main([str(mod), "--root", str(tmp_path), "--pass", "hotlint", "--no-baseline"]) == 1
    assert "HL001" in capsys.readouterr().out
    mod.write_text("import torch\n\ndef f(x):\n    # hotlint: intentional-transfer: test\n"
                   "    return torch.sum(x).item()\n")
    assert cli.main([str(mod), "--root", str(tmp_path), "--pass", "hotlint", "--no-baseline"]) == 0


@pytest.mark.parametrize("name,flagged", [("MeanSquaredError", False), ("BinaryAccuracy", True),
                                          ("MeanMetric", True), ("StreamingAUROC", False)])
def test_classify_transfers_follows_the_update_path(name, flagged):
    """The static leg sees the host reads of the update's callees (validation's distinct-value read, the
    aggregators' NaN check), and none where there is none."""
    import metrics_tpu_torch as M
    from metrics_tpu_torch.analysis.sync_rules import classify_transfers

    cls = getattr(M, name, None) or getattr(M.classification, name)
    clean, detail = classify_transfers(cls)
    assert clean is not flagged, detail
