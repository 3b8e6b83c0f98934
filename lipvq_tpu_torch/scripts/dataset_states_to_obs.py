"""Extract observations from the stored states of an export's demos (the
port's twin of ``lipvq_tpu/scripts/dataset_states_to_obs.py``; reference
robocasa/scripts/dataset_states_to_obs.py:445-530).

N extractor processes pull demo names from a work queue and replay each
demo's stored sim states through their own env, made by
``create_env_from_metadata`` from the export's ``env_args``. A worker that
meets an exception recreates its env and carries on (reference
robomimic :386-399). One writer process owns the output export and writes
each demo under its own name, so the input's ``mask`` lists name the same
demos there. Reads and writes exports (``data/export.py``); the same demos
give the arrays of the JAX script's HDF5 file.

    python -m lipvq_tpu_torch.scripts.dataset_states_to_obs \\
        --dataset datasets/kitchen/OpenDrawer --output_name OpenDrawer_obs \\
        --num_procs 4
"""

from __future__ import annotations

import argparse
import json
import multiprocessing as mp
import os

import numpy as np

from lipvq_tpu_torch.data.export import Export, ExportWriter


def read_demo(export: Export, name: str) -> dict:
    """A demo's stored ``states`` and ``actions`` and the attributes replay
    needs (``num_samples``, ``model_file``, ``ep_meta``)."""
    attrs = export.demo_attrs(name)
    return {"states": export.load(name, "states"), "actions": export.load(name, "actions"),
            "num_samples": attrs.get("num_samples"), "model_file": attrs.get("model_file"),
            "ep_meta": attrs.get("ep_meta")}


def extract_trajectory(env, demo: dict, camera_names=(), camera_height=128,
                       camera_width=128):
    """Replay states; collect obs at every step (reference
    extract_trajectory)."""
    states = demo["states"]
    n = states.shape[0]
    traj = {"obs": [], "actions": demo["actions"], "states": states,
            "rewards": np.zeros(n, np.float32),
            "dones": np.zeros(n, np.float32)}
    init = {"states": states[0]}
    if demo.get("model_file"):
        init["model"] = demo["model_file"]
    if demo.get("ep_meta"):
        init["ep_meta"] = demo["ep_meta"]
    env.reset_to(init)
    for t in range(n):
        env.reset_to({"states": states[t]})
        ob = env.get_observation()
        for cam in camera_names:
            ob[f"{cam}_image"] = env.render(
                mode="rgb_array", height=camera_height, width=camera_width,
                camera_name=cam,
            )
        traj["obs"].append(ob)
        succ = env.is_success()
        traj["rewards"][t] = float(succ["task"])
        traj["dones"][t] = float(t == n - 1)
    # list-of-dicts -> dict-of-arrays
    keys = traj["obs"][0].keys()
    traj["obs"] = {k: np.stack([o[k] for o in traj["obs"]]) for k in keys}
    return traj


def _worker(env_meta, dataset_path, work_queue, out_queue, camera_names,
            camera_height, camera_width):
    from lipvq_tpu_torch.envs.env_factory import create_env_from_metadata

    env = create_env_from_metadata(env_meta, render_offscreen=bool(camera_names))
    export = Export(dataset_path)
    while True:
        item = work_queue.get()
        if item is None:
            break
        demo_name = item
        try:
            demo = read_demo(export, demo_name)
            traj = extract_trajectory(
                env, demo, camera_names, camera_height, camera_width
            )
            attrs = {
                "num_samples": int(traj["actions"].shape[0]),
                "ep_meta": export.demo_attrs(demo_name).get("ep_meta", "{}"),
            }
            out_queue.put((demo_name, traj, attrs))
        except Exception as e:  # recreate env and continue (reference :386-399)
            print(f"[worker] {demo_name} failed ({type(e).__name__}: {e}); "
                  "recreating env")
            try:
                env = create_env_from_metadata(
                    env_meta, render_offscreen=bool(camera_names)
                )
            except Exception:
                pass
            out_queue.put((demo_name, None, None))


def _writer(output_path, env_meta, total, out_queue, done_event):
    writer = ExportWriter(output_path)
    written = 0
    failed = []
    for _ in range(total):
        demo_name, traj, attrs = out_queue.get()
        if traj is None:
            failed.append(demo_name)
            continue
        arrays = {k: traj[k] for k in ("actions", "states", "rewards", "dones")}
        arrays.update({f"obs/{k}": v for k, v in traj["obs"].items()})
        writer.add_demo(demo_name, attrs, arrays)
        written += 1
    writer.finish({"env_args": json.dumps(env_meta), "total": written}, {})
    print(f"[writer] wrote {written}/{total} demos "
          f"({len(failed)} failed: {failed[:5]})")
    done_event.set()


def dataset_states_to_obs_multiprocessing(
    dataset_path: str, output_path: str, num_procs: int = 2,
    camera_names=(), camera_height: int = 128, camera_width: int = 128,
    filter_key: str | None = None, randomize_cameras: bool = False,
):
    export = Export(dataset_path)
    env_meta = json.loads(export.data_attrs["env_args"])
    if randomize_cameras:
        # reference dataset_states_to_obs.py:349-350
        env_meta.setdefault("env_kwargs", {})["randomize_cameras"] = True
    if filter_key:
        demos = export.mask(filter_key)
    else:
        demos = sorted(export.demos, key=lambda e: int(e[5:]))

    ctx = mp.get_context("spawn")
    work_queue = ctx.Queue()
    out_queue = ctx.Queue()
    done = ctx.Event()
    for d in demos:
        work_queue.put(d)
    for _ in range(num_procs):
        work_queue.put(None)

    writer = ctx.Process(
        target=_writer, args=(output_path, env_meta, len(demos), out_queue, done),
    )
    writer.start()
    workers = [
        ctx.Process(
            target=_worker,
            args=(env_meta, dataset_path, work_queue, out_queue,
                  tuple(camera_names), camera_height, camera_width),
        )
        for _ in range(num_procs)
    ]
    for w in workers:
        w.start()
    for w in workers:
        w.join()
    done.wait()
    writer.join()


def main(args=None):
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--dataset", type=str, required=True)
    parser.add_argument("--output_name", type=str, required=True)
    parser.add_argument("--num_procs", type=int, default=2)
    parser.add_argument("--camera_names", type=str, nargs="*", default=[])
    parser.add_argument("--camera_height", type=int, default=128)
    parser.add_argument("--camera_width", type=int, default=128)
    parser.add_argument("--filter_key", type=str, default=None)
    # reference dataset_states_to_obs.py:663
    parser.add_argument("--randomize_cameras", action="store_true")
    ns = parser.parse_args(args)
    output_path = os.path.join(
        os.path.dirname(os.path.abspath(ns.dataset)), ns.output_name
    )
    dataset_states_to_obs_multiprocessing(
        ns.dataset, output_path, num_procs=ns.num_procs,
        camera_names=ns.camera_names, camera_height=ns.camera_height,
        camera_width=ns.camera_width, filter_key=ns.filter_key,
        randomize_cameras=ns.randomize_cameras,
    )
    return output_path


if __name__ == "__main__":
    main()
