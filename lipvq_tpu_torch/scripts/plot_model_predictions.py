"""Plot predicted vs. ground-truth actions for a checkpoint (counterpart of
``lipvq_tpu/scripts/plot_model_predictions.py``).

Counterpart of reference scripts/plot_model_predictions.py:1-213: load a
policy checkpoint, run it open-loop over dataset trajectories, and plot
per-dimension predicted/actual action curves (the qualitative companion to
the ``action_accuracy@eps`` metrics in ``compute_mse_visualize``, reference
algo.py:424-504). The demos come from a numpy export (``data/export.py``),
the policy runs on the card unless ``--device cpu``, and each prediction is
one ``get_action`` call on a window of ``context_length`` steps (one K1
launch for a LipVQ policy). The figures are drawn with matplotlib; where it
is not installed, with PIL (the same files, a plainer drawing).

    python -m lipvq_tpu_torch.scripts.plot_model_predictions \\
        --ckpt model.ckpt --dataset demos_export/ --output plots/ --n_demos 2
"""

from __future__ import annotations

import argparse
import os

import numpy as np


def plot_predictions(ckpt_path: str, dataset_path: str, output_dir: str,
                     n_demos: int = 2, device=None) -> list:
    """One PNG per demo (the first ``n_demos`` by name, as h5py lists
    them) with each action dimension's actual and predicted curve; returns
    the paths. The policy loads on ``device`` (CUDA when None)."""
    from lipvq_tpu_torch.data.export import Export
    from lipvq_tpu_torch.utils.file_utils import policy_from_checkpoint

    model, ckpt = policy_from_checkpoint(ckpt_path, device=device)
    del ckpt
    t = model.context_length

    export = Export(dataset_path)
    out_paths = []
    os.makedirs(output_dir, exist_ok=True)
    demos = sorted(export.demos)[:n_demos]
    for demo in demos:
        acts = np.asarray(export.load(demo, "actions"), np.float32)
        n = len(acts)
        if n < t:
            continue
        obs_keys = set(export.keys(demo, "obs"))
        arrays = {k: export.load(demo, f"obs/{k}") for k in model.obs_shapes
                  if k in obs_keys}
        # build sliding windows of obs and predict each step
        preds = []
        for i in range(t, n):
            obs = {}
            ok = True
            for k in model.obs_shapes:
                if k == "lang_emb":
                    obs[k] = np.zeros(
                        (1, t) + tuple(model.obs_shapes[k]), np.float32
                    )
                    continue
                if k not in arrays:
                    ok = False
                    break
                obs[k] = np.asarray(arrays[k][i - t:i], np.float32)[None]
            if not ok:
                break
            ctx = {
                "obs": obs,
                "actions": acts[i - t:i][None],
            }
            a = np.asarray(model.get_action(obs, ctx))[0]
            preds.append(a)
        if not preds:
            continue
        preds = np.stack(preds)
        actual = acts[t:t + len(preds)]
        path = os.path.join(output_dir, f"{demo}_predictions.png")
        _plot(path, f"{demo}: predicted vs actual actions", actual, preds)
        out_paths.append(path)
    return out_paths


def _plot(path: str, title: str, actual: np.ndarray, preds: np.ndarray) -> None:
    d = min(preds.shape[1], actual.shape[1])
    try:
        import matplotlib
    except ModuleNotFoundError:
        _plot_pil(path, title, actual[:, :d], preds[:, :d])
        return
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    fig, axes = plt.subplots(d, 1, figsize=(8, 1.6 * d), sharex=True)
    if d == 1:
        axes = [axes]
    for dim in range(d):
        axes[dim].plot(actual[:, dim], label="actual", lw=1)
        axes[dim].plot(preds[:, dim], label="predicted", lw=1)
        axes[dim].set_ylabel(f"a[{dim}]")
    axes[0].legend(loc="upper right")
    axes[-1].set_xlabel("step")
    fig.suptitle(title)
    fig.tight_layout()
    fig.savefig(path, dpi=80)
    plt.close(fig)


def _plot_pil(path: str, title: str, actual: np.ndarray, preds: np.ndarray) -> None:
    """The same panels drawn with PIL: one 640 x 128 panel per dimension,
    actual in blue, predicted in orange, each panel scaled to its range."""
    from PIL import Image, ImageDraw

    width, panel, top, margin = 640, 128, 24, 40
    n, d = actual.shape
    img = Image.new("RGB", (width, top + panel * d), "white")
    draw = ImageDraw.Draw(img)
    draw.text((margin, 6), title, fill="black")
    xs = margin + np.arange(n) * (width - 2 * margin) / max(n - 1, 1)
    for dim in range(d):
        y0 = top + dim * panel
        lo = float(min(actual[:, dim].min(), preds[:, dim].min()))
        hi = float(max(actual[:, dim].max(), preds[:, dim].max()))
        scale = (panel - 16) / (hi - lo if hi > lo else 1.0)
        draw.rectangle((margin, y0 + 4, width - margin, y0 + panel - 4), outline="gray")
        draw.text((4, y0 + panel // 2 - 6), f"a[{dim}]", fill="black")
        for series, colour in ((actual, (31, 119, 180)), (preds, (255, 127, 14))):
            ys = y0 + panel - 8 - (series[:, dim] - lo) * scale
            draw.line(list(zip(xs.tolist(), ys.tolist())), fill=colour, width=1)
    img.save(path)


def main():
    parser = argparse.ArgumentParser()
    parser.add_argument("--ckpt", type=str, required=True)
    parser.add_argument("--dataset", type=str, required=True,
                        help="a numpy export (python -m lipvq_tpu_torch.data.export in.hdf5 out/)")
    parser.add_argument("--output", type=str, required=True)
    parser.add_argument("--n_demos", type=int, default=2)
    parser.add_argument("--device", type=str, default=None,
                        help="cpu to run the policy on the CPU (default: CUDA)")
    args = parser.parse_args()
    paths = plot_predictions(args.ckpt, args.dataset, args.output,
                             args.n_demos, device=args.device)
    print(f"wrote {len(paths)} plots to {args.output}")


if __name__ == "__main__":
    main()
