"""Scripted demonstration collection (counterpart of
``lipvq_tpu/scripts/collect_demos.py``; reference
robocasa/scripts/collect_demos.py).

``scripted_policy`` drives the synthetic env's effector to its goal with
exploration noise; a kitchen task takes its privileged scripted expert
(``robocasa/sim/scripted.py``) through ``policy_factory``, rebuilt for each
episode. ``collect_demo`` records one episode, optionally with DART noise
on the executed action and random dwells (holds); ``write_demos``
writes the episodes as a dataset **export** (``data/export.py``) with the
arrays the JAX package writes into its HDF5 file: ``actions``, ``rewards``,
``dones``, ``states``, ``obs/<key>``, ``next_obs/<key>`` (obs shifted by
one step, the last repeated), each demo's ``num_samples`` and ``ep_meta``
(with ``lang``), a kitchen demo's ``model_file`` (the scene's XML, for an
exact ``reset_to``) and the file's ``env_args`` and ``total``. The same
seeds give the same arrays as the JAX package, bit for bit.

    python -m lipvq_tpu_torch.scripts.collect_demos --env SyntheticKitchen \\
        --n_demos 20 --output demos_export

``--device keyboard`` collects by teleoperation instead: the terminal
keyboard of ``robocasa/sim/devices.py`` (raw stdin) drives each episode
until the task succeeds, the env is done, or the device's controls end it
(``q`` ends an episode, ``.`` marks it a success); ``--device spacemouse``
needs the ``hid`` package and raises without it. The episodes go through
the same export writer, as the JAX script's go into its HDF5 file.
"""

from __future__ import annotations

import argparse
import json

import numpy as np

from lipvq_tpu_torch.data.export import ExportWriter
from lipvq_tpu_torch.envs.env_factory import create_env


def scripted_policy(obs: dict, rng) -> np.ndarray:
    """Go-to-goal controller for the synthetic env with exploration noise."""
    pos = obs["robot0_eef_pos"]
    target = obs["object"][:3]
    a = np.zeros(12, np.float32)
    a[:3] = np.clip((target - pos) / 0.05, -1, 1)
    a[:3] += rng.normal(0, 0.1, 3)
    return np.clip(a, -1, 1)


def collect_demo(env, policy_fn, max_steps: int, rng, policy_factory=None,
                 action_noise: float = 0.0, dwell_prob: float = 0.0, dwell_max: int = 8):
    """One episode -> (trajectory dict, success).

    ``policy_factory(env)``, where given, builds the episode's expert after
    the reset (a kitchen expert plans from the episode's fixtures); its
    ``get_action`` replaces ``policy_fn`` and the episode ends when it has
    ``finished``.

    ``action_noise`` > 0 injects DART noise: the recorded label is the
    expert's clean action while the executed one is perturbed, so the corpus
    covers the off-path states a BC policy drifts into. ``dwell_prob`` > 0
    injects dwells: the robot holds for 3..``dwell_max`` steps while the
    recorded label stays the expert's action captured at the dwell's entry,
    so progress is not tied to time. The discrete channels 6 and 11 (grip,
    base-mode flag) stay crisp under both."""
    obs = env.reset()
    if policy_factory is not None:
        expert = policy_factory(env)

        def policy_fn(o, _rng):
            return expert.get_action(o)

    traj = {"obs": [], "actions": [], "rewards": [], "dones": [],
            "states": [], "lang": getattr(env, "ep_lang_str", None)}
    dwell_left = 0
    dwell_label = None
    success = False
    for _ in range(max_steps):
        if dwell_left > 0:
            a = dwell_label
            dwell_left -= 1
            in_dwell = True
        else:
            a = np.asarray(policy_fn(obs, rng), dtype=float)
            in_dwell = dwell_prob > 0.0 and rng.random() < dwell_prob
            if in_dwell:
                dwell_left = int(rng.integers(3, dwell_max + 1)) - 1
                dwell_label = a
        traj["obs"].append(obs)
        traj["states"].append(env.get_state())
        exec_a = a
        if in_dwell:
            exec_a = np.zeros_like(a)
            exec_a[6] = a[6]
            if a.shape[0] > 11:
                exec_a[11] = a[11]
        elif action_noise > 0.0:
            exec_a = np.clip(a + rng.normal(0.0, action_noise, size=a.shape), -1.0, 1.0)
            exec_a[6] = a[6]
            if a.shape[0] > 11:
                exec_a[11] = a[11]
        obs, r, done, info = env.step(exec_a)
        traj["actions"].append(a)
        traj["rewards"].append(r)
        success = info.get("is_success", {}).get("task", False)
        traj["dones"].append(float(done or success))
        if done or success:
            break
        if policy_factory is not None and expert.finished:
            break
    return traj, bool(success)


def _flat_states(states: list, n: int) -> np.ndarray:
    """The JAX package's ``states`` dataset: a dict state's values
    concatenated, kitchen-style ``{"states": ...}`` the flat sim state."""
    if states and isinstance(states[0], dict):
        if "states" in states[0]:
            return np.stack([np.asarray(s["states"]) for s in states])
        return np.stack([np.concatenate([np.ravel(v) for v in s.values()]) for s in states])
    return np.stack(states) if states[0] is not None else np.zeros((n, 1), np.float32)


def write_demos(path: str, env, trajs: list[dict], lang: str | None = None,
                write_next_obs: bool = True) -> str:
    """Write ``trajs`` as an export at ``path`` (a directory);
    ``write_next_obs`` stores the obs shifted by one step (the last
    repeated) for the algorithms that read ``next_obs``."""
    writer = ExportWriter(path)
    total = 0
    for i, traj in enumerate(trajs):
        n = len(traj["actions"])
        arrays = {"actions": np.stack(traj["actions"]),
                  "rewards": np.asarray(traj["rewards"], np.float32),
                  "dones": np.asarray(traj["dones"], np.float32),
                  "states": _flat_states(traj["states"], n).astype(np.float32)}
        keys = traj["obs"][0].keys()
        for k in keys:
            arr = np.stack([o[k] for o in traj["obs"]])
            arrays[f"obs/{k}"] = arr
            if write_next_obs:
                arrays[f"next_obs/{k}"] = np.concatenate([arr[1:], arr[-1:]], axis=0)
        ep_meta = dict(traj.get("ep_meta") or {})
        ep_meta["lang"] = (traj.get("lang") or lang or getattr(env, "ep_lang_str", None)
                           or "demo")
        attrs = {}
        states = traj["states"]
        if states and isinstance(states[0], dict) and "states" in states[0] \
                and states[0].get("model"):
            # the kitchen's model XML, the same within a demo
            attrs["model_file"] = states[0]["model"]
        attrs.update(num_samples=n, ep_meta=json.dumps(ep_meta))
        writer.add_demo(f"demo_{i}", attrs, arrays)
        total += n
    return writer.finish({"env_args": json.dumps(env.serialize()), "total": total}, {})


def main(args=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--env", type=str, default="SyntheticKitchen")
    parser.add_argument("--n_demos", type=int, default=20)
    parser.add_argument("--max_steps", type=int, default=200)
    parser.add_argument("--output", type=str, required=True,
                        help="directory to write the export into")
    parser.add_argument("--device", type=str, default="scripted",
                        choices=["scripted", "keyboard", "spacemouse"])
    parser.add_argument("--only_success", action="store_true")
    parser.add_argument("--seed", type=int, default=0)
    ns = parser.parse_args(args)

    env = create_env(ns.env, seed=ns.seed)

    if ns.device != "scripted":
        # terminal teleop (reference collect_demos.py:481-491 uses robosuite's
        # Keyboard / SpaceMouse; this one reads raw stdin)
        from lipvq_tpu_torch.robocasa.sim.devices import make_device

        device = make_device(ns.device)
        trajs, n_success = [], 0
        print("teleop: wasd/rf move arm, space grip, b base mode, "
              "q end episode, . mark success")
        while len(trajs) < ns.n_demos:
            obs = env.reset()
            print(f"episode {len(trajs)}: {env.ep_lang_str}")
            device.start_control()
            traj = {"obs": [], "actions": [], "rewards": [], "dones": [],
                    "states": [], "lang": getattr(env, "ep_lang_str", None)}
            try:
                for _ in range(ns.max_steps):
                    a, ctrl = device.get_action()
                    traj["obs"].append(obs)
                    traj["states"].append(env.get_state())
                    obs, r, done, info = env.step(a)
                    traj["actions"].append(a)
                    traj["rewards"].append(r)
                    success = info.get("is_success", {}).get("task", False) or ctrl["success"]
                    traj["dones"].append(float(done or success))
                    if done or success or ctrl["done"]:
                        break
            finally:
                device.stop_control()
            if hasattr(env, "get_ep_meta"):
                traj["ep_meta"] = env.get_ep_meta()
            if ns.only_success and not success:
                continue
            trajs.append(traj)
            n_success += int(success)
        write_demos(ns.output, env, trajs)
        print(f"wrote {len(trajs)} demos ({n_success} successful) to {ns.output}")
        return ns.output

    rng = np.random.default_rng(ns.seed)
    # kitchen tasks use the privileged scripted experts; the synthetic env
    # keeps its go-to-goal controller
    from lipvq_tpu_torch.robocasa.sim.scripted import TASK_POLICIES, make_scripted_policy

    policy_factory = None
    if ns.env in TASK_POLICIES:
        def policy_factory(e):
            return make_scripted_policy(ns.env, e)

    trajs, n_success, attempts = [], 0, 0
    while len(trajs) < ns.n_demos and attempts < ns.n_demos * 8:
        attempts += 1
        traj, success = collect_demo(env, scripted_policy, ns.max_steps, rng,
                                     policy_factory=policy_factory)
        if hasattr(env, "get_ep_meta"):
            traj["ep_meta"] = env.get_ep_meta()
        if ns.only_success and not success:
            continue
        trajs.append(traj)
        n_success += int(success)
    write_demos(ns.output, env, trajs)
    print(f"wrote {len(trajs)} demos ({n_success} successful) to {ns.output}")
    return ns.output


if __name__ == "__main__":
    main()
