"""Replay an export's demos through the environment, by stored states or by
stored actions, and optionally write a video (the port's twin of
``lipvq_tpu/scripts/playback_dataset.py``; reference
scripts/playback_dataset.py).

    python -m lipvq_tpu_torch.scripts.playback_dataset \\
        --dataset datasets/kitchen/OpenDrawer --n 3 [--use-actions] \\
        [--video_path out.mp4]
"""

from __future__ import annotations

import argparse
import json

from lipvq_tpu_torch.data.export import Export
from lipvq_tpu_torch.envs.env_factory import create_env_from_metadata
from lipvq_tpu_torch.scripts.dataset_states_to_obs import read_demo


def playback_trajectory(env, demo: dict, use_actions: bool = False,
                        video_writer=None, video_skip: int = 5):
    """Replay ``demo`` (``read_demo(export, name)``): step its actions from
    ``env.reset()``, or restore each stored state; a frame every
    ``video_skip`` steps goes to ``video_writer``. Returns the steps
    replayed."""
    n = int(demo["num_samples"])
    if use_actions:
        env.reset()
        actions = demo["actions"]
        for t in range(n):
            env.step(actions[t])
            if video_writer is not None and t % video_skip == 0:
                video_writer.append_data(
                    env.render(mode="rgb_array", height=256, width=256)
                )
    else:
        states = demo["states"]
        init = {"states": states[0]}
        if demo.get("model_file") is not None:
            init["model"] = demo["model_file"]
        env.reset_to(init)
        for t in range(n):
            env.reset_to({"states": states[t]})
            if video_writer is not None and t % video_skip == 0:
                video_writer.append_data(
                    env.render(mode="rgb_array", height=256, width=256)
                )
    return n


def main(args=None):
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--dataset", type=str, required=True)
    parser.add_argument("--n", type=int, default=3)
    parser.add_argument("--use-actions", action="store_true")
    parser.add_argument("--video_path", type=str, default=None)
    parser.add_argument("--video_skip", type=int, default=5)
    parser.add_argument("--filter_key", type=str, default=None)
    ns = parser.parse_args(args)

    export = Export(ns.dataset)
    env_meta = json.loads(export.data_attrs["env_args"])
    env = create_env_from_metadata(env_meta, render_offscreen=True)
    if ns.filter_key:
        demos = export.mask(ns.filter_key)
    else:
        demos = sorted(export.demos, key=lambda e: int(e[5:]))
    writer = None
    if ns.video_path:
        import imageio

        writer = imageio.get_writer(ns.video_path, fps=20)
    replayed = {}
    for d in demos[: ns.n]:
        replayed[d] = playback_trajectory(
            env, read_demo(export, d), use_actions=ns.use_actions,
            video_writer=writer, video_skip=ns.video_skip,
        )
        print(f"{d}: replayed {replayed[d]} steps")
    if writer is not None:
        writer.close()
    return replayed


if __name__ == "__main__":
    main()
