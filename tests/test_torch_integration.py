"""``MetricLogbook`` on the port against the JAX package's.

The same per-batch values go through both logbooks: epoch values and the
history agree within rtol 1e-6 (means of a few float32 values), a collection's
results appear under both packages' keys, and a plain PyTorch training loop's
logged loss follows the losses it computed.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import metrics_tpu.aggregation as ja
import metrics_tpu.classification as jc
from metrics_tpu.collections import MetricCollection as JCollection
from metrics_tpu.integration import MetricLogbook as JBook
from metrics_tpu_torch import MeanMetric, MetricCollection, SumMetric
from metrics_tpu_torch.classification import MulticlassAccuracy
from metrics_tpu_torch.integration import MetricLogbook


def _mean():
    return MeanMetric(device="cpu")


def test_epoch_values_do_not_leak_across_epochs_and_match_reference():
    book, ref = MetricLogbook(), JBook()
    for values in ([1.0, 2.0, 3.0], [10.0, 20.0]):
        for v in values:
            book.update("loss", _mean, torch.tensor(v))
            ref.update("loss", ja.MeanMetric, jnp.asarray(v))
        out, want = book.epoch_end(), ref.epoch_end()
        assert float(out["loss"]) == pytest.approx(np.mean(values)) == pytest.approx(float(want["loss"]))
    assert [float(h["loss"]) for h in book.history] == [2.0, 15.0] == [float(h["loss"]) for h in ref.history]


def test_log_batch_returns_step_value_and_accumulates():
    book = MetricLogbook()
    b1 = book.log_batch("s", lambda: SumMetric(device="cpu"), torch.tensor([1.0, 2.0]))
    b2 = book.log_batch("s", lambda: SumMetric(device="cpu"), torch.tensor([3.0]))
    assert float(b1) == 3.0 and float(b2) == 3.0
    assert float(book.epoch_end()["s"]) == 6.0
    with pytest.warns(UserWarning):
        assert float(book.epoch_end()["s"]) == 0.0
    assert "s" in book and "t" not in book
    with pytest.raises(ValueError, match="Metric/MetricCollection"):
        book.log("bad", lambda: 3)


def test_collection_logging_keys_match_reference():
    book, ref = MetricLogbook(), JBook()
    preds, target = [0, 1, 2, 1], [0, 1, 1, 1]
    book.update("val", MetricCollection([MulticlassAccuracy(num_classes=3, average="micro", device="cpu")]),
                torch.tensor(preds), torch.tensor(target))
    ref.update("val", JCollection([jc.MulticlassAccuracy(num_classes=3, average="micro")]), jnp.asarray(preds),
               jnp.asarray(target))
    out, want = book.epoch_end(), ref.epoch_end()
    assert sorted(out) == sorted(want)
    assert float(out["val"]["MulticlassAccuracy"]) == pytest.approx(0.75)
    assert float(out["val_MulticlassAccuracy"]) == pytest.approx(float(want["val_MulticlassAccuracy"]))


def test_epoch_context_manager():
    book = MetricLogbook()
    with book.epoch():
        book.update("m", _mean, torch.tensor([4.0]))
    assert float(book.history[-1]["m"]) == 4.0
    assert book["m"].update_count == 0


def test_training_loop_with_logbook():
    """A plain PyTorch SGD loop (the JAX package's test uses optax): the logged loss matches the manual trace."""
    rng = np.random.RandomState(0)
    x = torch.from_numpy(rng.rand(64, 3).astype(np.float32))
    y = x @ torch.tensor([[1.0], [-2.0], [0.5]])
    w = torch.zeros(3, 1, requires_grad=True)
    opt = torch.optim.SGD([w], lr=0.5)
    book, manual = MetricLogbook(), []
    for _ in range(3):
        losses = []
        for i in range(0, 64, 16):
            loss = torch.mean((x[i:i + 16] @ w - y[i:i + 16]) ** 2)
            opt.zero_grad()
            loss.backward()
            opt.step()
            book.update("train_mse", _mean, loss.detach())
            losses.append(float(loss.detach()))
        book.epoch_end()
        manual.append(np.mean(losses))
    np.testing.assert_allclose([float(h["train_mse"]) for h in book.history], manual, rtol=1e-6)
    assert manual[-1] < manual[0]
