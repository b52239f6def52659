"""The port's curve family on the exact path (``thresholds=None``: the samples are kept and the curve runs
over every distinct score) against the JAX package's; inputs and tolerances as
``tests/test_torch_curve_cases.py`` sets them out."""

from __future__ import annotations

import pytest

from tests.test_torch_curve_cases import FAMILIES, check_family


@pytest.mark.parametrize("kind", ["probs", "logits"])
@pytest.mark.parametrize("ignore_index", [None, -1])
@pytest.mark.parametrize("task", ["binary", "multiclass", "multilabel"])
@pytest.mark.parametrize("family", list(FAMILIES))
def test_family_matches_reference_exact(family, task, ignore_index, kind):
    check_family(family, task, None, ignore_index, kind)
