"""Prediction-MSE observability (counterpart of
``lipvq_tpu/utils/vis_utils.py``; reference PolicyAlgo.compute_mse_visualize,
robomimic/algo/algo.py:424-504): run the policy over windows sampled from
the dataset, compare its actions with the dataset's, and report the MSE and
``action_accuracy@{1e-3,1e-4,1e-5}`` (the share of elements whose squared
error lies below each threshold), optionally with a plot of each action
dimension (where matplotlib is installed).
"""

from __future__ import annotations

import os

import numpy as np

MSE_THRESHOLDS = (1e-3, 1e-4, 1e-5)


def compute_mse_metrics(pred_actions: np.ndarray, true_actions: np.ndarray) -> dict:
    """pred/true [N, A] (or [N, T, A] flattened by the caller)."""
    err2 = (pred_actions - true_actions) ** 2
    out = {"action_mse": float(err2.mean())}
    for th in MSE_THRESHOLDS:
        out[f"action_accuracy@{th}"] = float((err2 < th).mean())
    return out


def compute_mse_visualize(model, dataset, num_samples: int = 20,
                          savedir: str | None = None, context_loader=None) -> dict:
    """Predict the actions of ``num_samples`` evenly spaced dataset windows
    and compare them with the dataset's: an ICL policy conditions on one
    context batch drawn from ``context_loader`` and is held to the first
    step of each window, a plain policy to the last."""
    n = min(num_samples, len(dataset))
    idx = np.linspace(0, len(dataset) - 1, n).astype(int)
    preds, trues = [], []
    context_batch = None
    if context_loader is not None:
        context_batch = model.process_batch_for_training(next(iter(context_loader)))
    for i in idx:
        item = dataset[int(i)]
        batch = {"obs": {k: v[None] for k, v in item["obs"].items()},
                 "actions": item["actions"][None]}
        pb = model.process_batch_for_training(batch)
        if context_batch is not None:
            ac = model.get_action(pb["obs"], context_batch)
            true = pb["actions"][:, 0] if pb["actions"].ndim == 3 else pb["actions"]
        else:
            ac = model.get_action(pb["obs"])
            true = pb["actions"][:, -1] if pb["actions"].ndim == 3 else pb["actions"]
        preds.append(np.asarray(ac))
        trues.append(np.asarray(true))
    pred = np.concatenate(preds, axis=0)
    true = np.concatenate(trues, axis=0)
    metrics = compute_mse_metrics(pred, true)
    if savedir is not None:
        _plot(pred, true, savedir)
    return metrics


def _plot(pred: np.ndarray, true: np.ndarray, savedir: str) -> None:
    """One panel per action dimension, dataset against prediction, into
    ``savedir/model_prediction.png``; nothing where matplotlib is absent."""
    try:
        import matplotlib
    except ImportError:
        return
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    os.makedirs(savedir, exist_ok=True)
    a_dim = pred.shape[-1]
    fig, axes = plt.subplots(a_dim, 1, figsize=(8, 2 * a_dim), squeeze=False)
    for d in range(a_dim):
        axes[d][0].plot(true[:, d], label="actual")
        axes[d][0].plot(pred[:, d], label="predicted")
        axes[d][0].set_ylabel(f"dim {d}")
    axes[0][0].legend()
    fig.tight_layout()
    fig.savefig(os.path.join(savedir, "model_prediction.png"))
    plt.close(fig)
