"""Plotting helpers (counterpart of ``metrics_tpu/utils/plot.py``): ``plot_single_or_multi_val``,
``plot_confusion_matrix`` and ``plot_curve`` draw with matplotlib on the host, and raise without it.

Tensors, on any device, are read back to numpy arrays first; the drawing is the JAX package's.
"""

from __future__ import annotations

from typing import Any, Optional, Sequence, Tuple

import numpy as np
import torch

from metrics_tpu_torch.utils.imports import _MATPLOTLIB_AVAILABLE


def _to_host(value: Any) -> Any:
    """Every tensor in ``value`` (through dicts, lists and tuples) as a numpy array."""
    if isinstance(value, torch.Tensor):
        value = value.detach().cpu()
        return (value.float() if value.dtype == torch.bfloat16 else value).numpy()
    if isinstance(value, dict):
        return {k: _to_host(v) for k, v in value.items()}
    if isinstance(value, (list, tuple)):
        return type(value)(_to_host(v) for v in value)
    return value


def _error_on_missing_matplotlib() -> None:
    if not _MATPLOTLIB_AVAILABLE:
        raise ModuleNotFoundError(
            "Plot function expects `matplotlib` to be installed. Please install with `pip install matplotlib`"
        )


def plot_single_or_multi_val(
    val,
    ax=None,
    higher_is_better: Optional[bool] = None,
    lower_bound: Optional[float] = None,
    upper_bound: Optional[float] = None,
    legend_name: Optional[str] = None,
    name: Optional[str] = None,
):
    """Plot a single scalar, a vector of per-class values, or a sequence over steps.

    Scalars and per-class vectors are marker points; lists are time series over
    a visible "Step" axis; known bounds draw dashed lines with an "Optimal value"
    annotation on the better one; the metric name labels the y-axis.
    """
    _error_on_missing_matplotlib()
    import matplotlib.pyplot as plt

    val = _to_host(val)
    fig, ax = (ax.get_figure(), ax) if ax is not None else plt.subplots()
    ax.get_xaxis().set_visible(False)

    def _series_axis(n_steps: int) -> None:
        ax.get_xaxis().set_visible(True)
        ax.set_xlabel("Step")
        ax.set_xticks(np.arange(n_steps))

    if isinstance(val, (list, tuple)) and val and isinstance(val[0], dict):
        # a time series of result dicts: one series per key
        val = {k: np.stack([np.asarray(v[k]) for v in val]) for k in val[0]}
    if isinstance(val, dict):
        for i, (key, item) in enumerate(val.items()):
            arr = np.atleast_1d(np.asarray(item))
            if arr.size == 1:
                ax.plot(i, arr.item(), marker="o", markersize=10, label=key)
            else:
                ax.plot(np.arange(len(arr)), arr, marker="o", markersize=10, linestyle="-", label=key)
                _series_axis(len(arr))
    elif isinstance(val, (list, tuple)):
        arr = np.asarray([np.asarray(v) for v in val])
        if arr.ndim == 1:
            ax.plot(np.arange(len(arr)), arr, marker="o", markersize=10, linestyle="-", label=legend_name or "")
        else:  # per-step multi-value results → one series per component
            for ci in range(arr.shape[-1]):
                ax.plot(np.arange(arr.shape[0]), arr[:, ci], marker="o", markersize=10, linestyle="-",
                        label=f"{legend_name} {ci}" if legend_name else f"{ci}")
        _series_axis(arr.shape[0])
    elif hasattr(val, "ndim") and np.asarray(val).ndim > 0 and np.asarray(val).size > 1:
        # ONE multi-element result (per-class/per-output): separate marker points
        arr = np.asarray(val).reshape(-1)
        for i, v in enumerate(arr):
            ax.plot(i, v, marker="o", markersize=10, linestyle="None",
                    label=f"{legend_name} {i}" if legend_name else f"{i}")
    else:
        ax.plot([np.asarray(val).item()], marker="o", markersize=10)

    ylim = ax.get_ylim()
    if lower_bound is not None and upper_bound is not None:
        factor = 0.1 * (upper_bound - lower_bound)
    else:
        factor = 0.1 * (ylim[1] - ylim[0])
    ax.set_ylim(
        bottom=lower_bound - factor if lower_bound is not None else ylim[0] - factor,
        top=upper_bound + factor if upper_bound is not None else ylim[1] + factor,
    )
    ax.grid(True)
    if name:
        ax.set_ylabel(name)

    xlim = ax.get_xlim()
    xfactor = 0.1 * (xlim[1] - xlim[0])
    y_lines = [b for b in (lower_bound, upper_bound) if b is not None]
    if y_lines:
        ax.hlines(y_lines, xlim[0], xlim[1], linestyles="dashed", colors="k")
    if higher_is_better is not None:
        if lower_bound is not None and not higher_is_better:
            ax.set_xlim(xlim[0] - xfactor, xlim[1])
            ax.text(xlim[0], lower_bound, s="Optimal \n value", horizontalalignment="center",
                    verticalalignment="center")
        if upper_bound is not None and higher_is_better:
            ax.set_xlim(xlim[0] - xfactor, xlim[1])
            ax.text(xlim[0], upper_bound, s="Optimal \n value", horizontalalignment="center",
                    verticalalignment="center")

    handles, labels = ax.get_legend_handles_labels()
    if handles and any(labels):
        ax.legend(handles, labels, loc="upper center", bbox_to_anchor=(0.5, 1.15), ncol=3,
                  fancybox=True, shadow=True)
    return fig, ax


def plot_confusion_matrix(
    confmat,
    ax=None,
    add_text: bool = True,
    labels: Optional[Sequence[str]] = None,
    cmap: Optional[str] = None,
):
    """Plot a (C, C) or (L, 2, 2) confusion matrix."""
    _error_on_missing_matplotlib()
    import matplotlib.pyplot as plt

    confmat = np.asarray(_to_host(confmat))
    if confmat.ndim == 3:
        nb, fig_label = confmat.shape[0], labels or [str(i) for i in range(confmat.shape[0])]
        if ax is not None:
            axs = np.atleast_1d(np.asarray(ax, dtype=object))
            if len(axs) != nb:
                raise ValueError(f"Expected {nb} axes for a ({nb}, 2, 2) confusion matrix, got {len(axs)}")
            fig = axs[0].get_figure()
        else:
            fig, axs = plt.subplots(nrows=1, ncols=nb, figsize=(4 * nb, 4))
            axs = np.atleast_1d(axs)
        for i in range(nb):
            ax_i = axs[i]
            ax_i.imshow(confmat[i], cmap=cmap)
            ax_i.set_title(f"Label {fig_label[i]}")
            if add_text:
                for r in range(2):
                    for c in range(2):
                        ax_i.text(c, r, str(round(confmat[i, r, c].item(), 2)), ha="center", va="center")
        return fig, axs
    fig, ax = (ax.get_figure(), ax) if ax is not None else plt.subplots()
    im = ax.imshow(confmat, cmap=cmap)
    fig.colorbar(im, ax=ax)
    n = confmat.shape[0]
    tick_labels = labels or [str(i) for i in range(n)]
    ax.set_xticks(range(n), tick_labels)
    ax.set_yticks(range(n), tick_labels)
    ax.set_xlabel("Predicted")
    ax.set_ylabel("True")
    if add_text:
        for r in range(n):
            for c in range(n):
                # round(val, 2): ints stay ints, normalized floats keep 2 decimals
                ax.text(c, r, str(round(confmat[r, c].item(), 2)), ha="center", va="center")
    return fig, ax


def plot_curve(
    curve: Tuple,
    score=None,
    ax=None,
    label_names: Optional[Tuple[str, str]] = None,
    legend_name: Optional[str] = None,
    name: Optional[str] = None,
):
    """Plot an (x, y[, thresholds]) curve, e.g. ROC or PR."""
    _error_on_missing_matplotlib()
    import matplotlib.pyplot as plt

    curve, score = _to_host(tuple(curve)), _to_host(score)
    fig, ax = (ax.get_figure(), ax) if ax is not None else plt.subplots()
    if isinstance(curve[0], (list, tuple)) and not hasattr(curve[0], "ndim"):
        # exact-path multiclass/multilabel curves are ragged: one array per class,
        # potentially different lengths — never stack, plot per class
        for i, (xi, yi) in enumerate(zip(curve[0], curve[1])):
            ax.plot(np.asarray(xi), np.asarray(yi), label=f"{legend_name or 'class'} {i}")
        ax.legend()
    else:
        x, y = np.asarray(curve[0]), np.asarray(curve[1])
        if x.ndim == 2:
            for i in range(x.shape[0]):
                ax.plot(x[i], y[i], label=f"{legend_name or 'class'} {i}")
            ax.legend()
        else:
            lbl = None
            if score is not None:
                lbl = f"AUC={float(np.asarray(score)):.3f}"
            ax.plot(x, y, label=lbl)
            if lbl:
                ax.legend()
    if label_names:
        ax.set_xlabel(label_names[0])
        ax.set_ylabel(label_names[1])
    if name:
        ax.set_title(name)
    ax.grid(True, alpha=0.3)
    return fig, ax
