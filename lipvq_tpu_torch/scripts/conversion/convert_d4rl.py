"""Convert a D4RL-style flat transition buffer into an export (counterpart
of ``lipvq_tpu/scripts/conversion/convert_d4rl.py``, which writes an HDF5
file; reference scripts/conversion/convert_d4rl.py:60-143).

The flat ``observations / actions / rewards / terminals [/ timeouts]``
buffer (an ``.npz``, or D4RL's HDF5 layout where ``h5py`` is installed)
is split into ``demo_<i>`` episodes at each terminal or timeout, as the JAX
script splits it: episodes shorter than 2 steps are dropped, ``dones``
come from the terminals only (a timeout-ended episode has none), the
observation lands in ``obs/flat`` and ``next_obs/flat`` (the buffer's
``next_observations``, else the observations shifted by one step, the last
repeated), and ``env_args`` names a gym env (type 2).

    python -m lipvq_tpu_torch.scripts.conversion.convert_d4rl \\
        --buffer hopper-medium-v2.npz --env_name Hopper-v4 --output export_dir
"""

from __future__ import annotations

import argparse
import json

import numpy as np

from lipvq_tpu_torch.data.export import ExportWriter
from lipvq_tpu_torch.envs.env_base import EnvType


def _load_buffer(path: str) -> dict:
    if path.endswith(".npz"):
        with np.load(path) as z:
            return {k: np.asarray(z[k]) for k in z.files}
    import h5py  # D4RL's HDF5 layout; only where h5py is installed

    out = {}
    with h5py.File(path, "r") as f:
        for k in ("observations", "actions", "rewards", "terminals", "timeouts",
                  "next_observations"):
            if k in f:
                out[k] = np.asarray(f[k])
    return out


def convert_d4rl(buffer_path: str, env_name: str, output: str) -> int:
    """Split the flat buffer at terminal / timeout boundaries into the export
    ``output``. Returns the demo count."""
    buf = _load_buffer(buffer_path)
    obs = buf["observations"]
    acts = buf["actions"]
    rews = buf["rewards"].reshape(-1)
    terms = buf.get("terminals", np.zeros(len(acts))).reshape(-1)
    touts = buf.get("timeouts", np.zeros(len(acts))).reshape(-1)
    next_obs = buf.get("next_observations")

    ends = np.where((terms > 0) | (touts > 0))[0].tolist()
    if not ends or ends[-1] != len(acts) - 1:
        ends.append(len(acts) - 1)

    writer = ExportWriter(output)
    n_demos = 0
    total = 0
    start = 0
    for end in ends:
        sl = slice(start, end + 1)
        n = end + 1 - start
        if n < 2:
            start = end + 1
            continue
        if next_obs is not None:
            nxt = next_obs[sl]
        else:
            nxt = np.concatenate([obs[sl][1:], obs[sl][-1:]], axis=0)
        writer.add_demo(f"demo_{n_demos}", {"num_samples": n}, {
            "actions": acts[sl].astype(np.float32),
            "rewards": rews[sl].astype(np.float32),
            "dones": terms[sl].astype(np.float32),
            "obs/flat": obs[sl].astype(np.float32),
            "next_obs/flat": nxt.astype(np.float32)})
        total += n
        n_demos += 1
        start = end + 1
    env_args = {"env_name": env_name, "type": EnvType.GYM_TYPE, "env_kwargs": {}}
    writer.finish({"env_args": json.dumps(env_args), "total": total}, {})
    return n_demos


def main(args=None):
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--buffer", type=str, required=True, help="raw D4RL hdf5/npz buffer")
    parser.add_argument("--env_name", type=str, required=True)
    parser.add_argument("--output", type=str, required=True, help="the export directory to write")
    ns = parser.parse_args(args)
    n = convert_d4rl(ns.buffer, ns.env_name, ns.output)
    print(f"wrote {n} demos to {ns.output}")


if __name__ == "__main__":
    main()
