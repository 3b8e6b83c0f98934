"""Training entry point (counterpart of ``lipvq_tpu/scripts/train.py``).

config load/override -> obs-utils init -> dataset metadata -> algo factory
-> data loading -> epoch loop (train / validate / rollout / checkpoint /
log). Datasets are numpy exports of robomimic HDF5 files
(``python -m lipvq_tpu_torch.data.export in.hdf5 out_dir``). Closed-loop
rollouts run when the dataset's env_meta builds an env (the synthetic env;
the MuJoCo kitchen, a gym, robosuite or iG-MoMart env where its simulator
package is installed); when it cannot (no ``mujoco``, ``gymnasium``,
``robosuite`` or ``igibson``), the script prints "Rollout disabled" with the
error and trains on, as the JAX script does.

The run takes the CUDA device unless ``train.cuda`` is false or
``--device cpu`` is given, and raises where there is no GPU.

``train.num_devices`` trains data-parallel (``parallel/mesh.py``): -1 means
every card (``torch.cuda.device_count()``; one rank on the CPU), n > 1
spawns n ranks with one card each (NCCL; gloo on the CPU), n = 1 runs in
this process in a group of one through the same code. Every rank loads the
same global batches and trains on its rows; only rank 0 writes checkpoints,
logs and rollouts.

Usage:
    python -m lipvq_tpu_torch.scripts.train --config cfg.json [--dataset D]
        [--name N] [--output_dir O] [--device cpu] [--debug] [--eval_only]
"""

from __future__ import annotations

import argparse
import contextlib
import glob
import json
import os
import pickle
import sys
import time
import traceback

import numpy as np
import torch

from lipvq_tpu_torch.algo import algo_factory, resolve_device
from lipvq_tpu_torch.config import config_factory
from lipvq_tpu_torch.utils import file_utils as FileUtils
from lipvq_tpu_torch.utils import obs_utils as ObsUtils
from lipvq_tpu_torch.utils import train_utils as TrainUtils
from lipvq_tpu_torch.utils.lang_utils import LangEncoder
from lipvq_tpu_torch.utils.log_utils import DataLogger, PrintLogger


def _num_devices(config, device: torch.device) -> int | None:
    """``train.num_devices`` as a rank count (None: no mesh)."""
    n_dev = config.train.get("num_devices", None)
    if n_dev is None:
        return None
    cards = torch.cuda.device_count() if device.type == "cuda" else 1
    n = cards if int(n_dev) == -1 else int(n_dev)
    if device.type == "cuda" and n > cards:
        raise ValueError(f"train.num_devices={n} but {cards} CUDA device(s) are visible")
    if config.train.batch_size % n != 0:
        raise ValueError(f"train.batch_size={config.train.batch_size} not divisible "
                         f"by num_devices={n}")
    return n


def _rank_main(rank: int, world: int, config, eval_only: bool, device_type: str,
               tmp: str) -> None:
    """One spawned rank: join the group, train on card ``rank`` (or the
    CPU), and (rank 0) leave the checkpoint directory in ``tmp``."""
    import torch.distributed as dist

    from lipvq_tpu_torch.parallel.mesh import init_group

    device = torch.device("cuda", rank) if device_type == "cuda" else torch.device("cpu")
    init_group(rank, world, os.path.join(tmp, "store"), device)
    try:
        ckpt_dir = train(config, eval_only=eval_only, device=device)
        if rank == 0:
            with open(os.path.join(tmp, "ckpt_dir"), "w") as f:
                f.write(ckpt_dir)
    finally:
        dist.destroy_process_group()


def _spawn(config, eval_only: bool, device: torch.device, n: int) -> str:
    """Train in ``n`` spawned ranks; returns rank 0's checkpoint directory."""
    import tempfile

    import torch.multiprocessing as mp

    with tempfile.TemporaryDirectory(prefix="lipvq_train_") as tmp:
        mp.spawn(_rank_main, args=(n, config, eval_only, device.type, tmp), nprocs=n,
                 join=True)
        with open(os.path.join(tmp, "ckpt_dir")) as f:
            return f.read()


def _load_full_state(model, ckpt_path: str) -> None:
    """Resume from a full train state; a truncated or corrupt one falls back
    to the newest weights-only checkpoint beside it (the optimizer restarts
    fresh), as the JAX script does, so a supervisor does not crash-loop."""
    print(f"Resuming full train state from {ckpt_path}")
    try:
        model.deserialize_full(
            torch.load(ckpt_path, map_location="cpu", weights_only=True))
    except (RuntimeError, EOFError, KeyError, pickle.UnpicklingError) as e:
        sib = sorted(glob.glob(os.path.join(os.path.dirname(ckpt_path), "*.ckpt")),
                     key=os.path.getmtime)
        if not sib:
            raise
        print(f"WARNING: resume state unreadable ({e!r}); "
              f"falling back to weights-only {sib[-1]}")
        model.deserialize(FileUtils.load_checkpoint_dict(sib[-1])["model"])


def _save_full_state(model, ckpt_dir: str, epoch: int) -> None:
    """Write ``latest_full.state`` and its ``.epoch`` sidecar, each through a
    temporary file and ``os.replace``: a kill mid-save never truncates the
    only resume state. The sidecar records the epoch inside the state."""
    payload = model.serialize_full()
    state_path = os.path.join(ckpt_dir, "latest_full.state")
    torch.save(payload, state_path + ".tmp")
    os.replace(state_path + ".tmp", state_path)
    with open(state_path + ".epoch.tmp", "w") as f:
        f.write(str(epoch))
    os.replace(state_path + ".epoch.tmp", state_path + ".epoch")


def _make_rollout_envs(config, env_meta, model):
    """{env name: env or VectorEnv}, or None where the env cannot be built."""
    from lipvq_tpu_torch.envs.env_factory import create_env_from_metadata

    rollout_env_meta = dict(env_meta)
    if config.experiment.env:
        # explicit eval-env override (reference train.py:124-132)
        rollout_env_meta["env_name"] = config.experiment.env
    try:
        if config.experiment.rollout.batched:
            from lipvq_tpu_torch.envs.vector_env import VectorEnv

            fns = []
            for i in range(config.experiment.rollout.num_batch_envs):
                meta_i = json.loads(json.dumps(rollout_env_meta))
                kw = meta_i.setdefault("env_kwargs", {})
                if kw.get("seed") is not None:
                    # distinct episode streams per member
                    kw["seed"] = int(kw["seed"]) + 1000 + i
                fns.append(lambda m=meta_i: create_env_from_metadata(m))
            vec = VectorEnv(
                fns,
                frame_stack=config.train.frame_stack,
                obs_keys=[k for k in model.obs_shapes if k != ObsUtils.LANG_EMB_KEY],
            )
            return {rollout_env_meta["env_name"]: vec}
        env = create_env_from_metadata(rollout_env_meta)
        return {env.name: env}
    except Exception as e:  # as lipvq_tpu/scripts/train.py:193-194
        print(f"Rollout disabled (no env adapter): {type(e).__name__}: {e}")
        return None


def train(config, eval_only: bool = False, device=None):
    """Main train loop (reference train.py:47-485). ``device`` defaults to
    CUDA, or the CPU where ``train.cuda`` is false. Returns the checkpoint
    directory."""
    import torch.distributed as dist

    device = resolve_device(device if device is not None
                            else (None if config.train.cuda else "cpu"))
    n = _num_devices(config, device)
    if n is not None and n > 1 and not dist.is_initialized():
        return _spawn(config, eval_only, device, n)
    own_group = n is not None and not dist.is_initialized()
    np.random.seed(config.train.seed)
    lead = not dist.is_initialized() or dist.get_rank() == 0

    print("\n============= New Training Run with Config =============")
    print(config.dump())

    log_dir = ckpt_dir = video_dir = None
    if lead:  # only rank 0 writes
        log_dir, ckpt_dir, video_dir = TrainUtils.get_exp_dir(config)
    stdout, stderr = sys.stdout, sys.stderr
    if lead and config.experiment.logging.terminal_output_to_txt:
        logger = PrintLogger(os.path.join(log_dir, "log.txt"))
        sys.stdout = logger
        sys.stderr = logger
    try:
        with contextlib.ExitStack() as on_exit:
            _train(config, eval_only, device, n, log_dir, ckpt_dir, video_dir, on_exit)
    finally:
        sys.stdout, sys.stderr = stdout, stderr
        if own_group:
            dist.destroy_process_group()
    return ckpt_dir


class _NoLogger:
    """The data logger of a rank that writes nothing."""

    def record(self, *args, **kwargs):
        pass

    def close(self):
        pass


def _train(config, eval_only, device, n_devices, log_dir, ckpt_dir, video_dir, on_exit):
    ObsUtils.initialize_obs_utils_with_config(config)
    lead = ckpt_dir is not None

    data_spec = config.train.data
    if isinstance(data_spec, (list, tuple)):
        # multi-dataset (MetaDataset) training: env/shape metadata come
        # from the first dataset
        first = data_spec[0]
        dataset_path = os.path.expanduser(
            first["path"] if not isinstance(first, str) else first
        )
    else:
        dataset_path = os.path.expanduser(data_spec)
    env_meta = FileUtils.get_env_metadata_from_dataset(dataset_path)
    shape_meta = FileUtils.get_shape_metadata_from_dataset(
        dataset_path,
        all_obs_keys=config.all_obs_keys,
        action_keys=tuple(config.train.action_keys),
    )

    data_logger = DataLogger(
        log_dir, config,
        log_tb=config.experiment.logging.log_tb,
        log_wandb=config.experiment.logging.log_wandb,
    ) if lead else _NoLogger()

    model = algo_factory(
        config.algo_name, config,
        obs_key_shapes=shape_meta["all_shapes"],
        ac_dim=shape_meta["ac_dim"],
        device=device,
    )

    ckpt_path = config.experiment.ckpt_path
    follow_along_dir = None
    if ckpt_path is not None:
        if os.path.isdir(ckpt_path):
            # follow-along evaluation mode: load model_epoch_{e} each epoch
            # if present (reference train.py:259-267)
            follow_along_dir = ckpt_path
        elif ckpt_path.endswith(".state") and os.path.isfile(ckpt_path):
            _load_full_state(model, ckpt_path)
        elif os.path.isfile(ckpt_path):
            print(f"Loading model weights from {ckpt_path}")
            model.deserialize(FileUtils.load_checkpoint_dict(ckpt_path)["model"])

    # data-parallel mesh, attached after the checkpoint load so the loaded
    # state is what rank 0 broadcasts
    if n_devices is not None:
        from lipvq_tpu_torch.parallel.mesh import make_mesh

        mesh = make_mesh(n_devices, devices=[device])
        model.attach_mesh(mesh)
        print(f"Data-parallel training over {n_devices} devices (rank {mesh.rank}, "
              f"{mesh.backend})")

    lang_encoder = LangEncoder(device=device)
    train_ds, valid_ds = TrainUtils.load_data_for_training(
        config, obs_keys=shape_meta["all_obs_keys"], lang_encoder=lang_encoder
    )
    print("\n============= Training Dataset =============")
    n_demos = getattr(train_ds, "n_demos", None)
    if n_demos is None:  # MetaDataset: sum over members
        n_demos = sum(getattr(d, "n_demos", 0) for d in
                      getattr(train_ds, "datasets", []))
    print(f"{len(train_ds)} sequences / {n_demos} demos")

    obs_normalization_stats = None
    if config.train.hdf5_normalize_obs:
        obs_normalization_stats = train_ds.get_obs_normalization_stats()

    train_loader, valid_loader, context_loader = TrainUtils.make_loaders(
        config, train_ds, valid_ds, model=model
    )
    if hasattr(train_loader, "close"):  # its worker processes
        on_exit.callback(train_loader.close)

    envs = None
    if lead and config.experiment.rollout.enabled:
        envs = _make_rollout_envs(config, env_meta, model)

    best_valid_loss = None
    best_return = {}
    best_success_rate = {}
    last_ckpt_time = time.time()

    num_epochs = 0 if eval_only else config.train.num_epochs
    start_epoch = int(config.experiment.get("start_epoch", 1) or 1)
    for epoch in range(start_epoch, num_epochs + 1):
        if follow_along_dir is not None:
            candidate = os.path.join(follow_along_dir, f"model_epoch_{epoch}.ckpt")
            if os.path.isfile(candidate):
                print(f"follow-along: loading {candidate}")
                model.deserialize(FileUtils.load_checkpoint_dict(candidate)["model"])
                if model.mesh is not None:  # replicate the loaded state again
                    model.attach_mesh(model.mesh)
        step_log = TrainUtils.run_epoch(
            model, train_loader, epoch,
            num_steps=config.experiment.epoch_every_n_steps,
        )
        model.on_epoch_end(epoch)

        print(f"Train Epoch {epoch}")
        print(json.dumps(step_log, sort_keys=True, indent=4))
        for k, v in step_log.items():
            if k.startswith("Time_"):
                data_logger.record(f"Timing_Stats/Train_{k[5:]}", v, epoch)
            else:
                data_logger.record(f"Train/{k}", v, epoch)

        # save checkpoint policy (reference train.py:283-294)
        epoch_ckpt_name = f"model_epoch_{epoch}"
        should_save_ckpt = False
        if config.experiment.save.enabled:
            n_ep = config.experiment.save.every_n_epochs
            t_sec = config.experiment.save.every_n_seconds
            if n_ep is not None and epoch % n_ep == 0:
                should_save_ckpt = True
            if t_sec is not None and time.time() - last_ckpt_time > t_sec:
                should_save_ckpt = True
            if epoch in (config.experiment.save.epochs or []):
                should_save_ckpt = True

        # validation
        if config.experiment.validate and valid_loader is not None:
            valid_log = TrainUtils.run_epoch(
                model, valid_loader, epoch, validate=True,
                num_steps=config.experiment.validation_epoch_every_n_steps,
            )
            for k, v in valid_log.items():
                key = f"Timing_Stats/Valid_{k[5:]}" if k.startswith("Time_") else f"Valid/{k}"
                data_logger.record(key, v, epoch)
            print(f"Validation Epoch {epoch}")
            print(json.dumps(valid_log, sort_keys=True, indent=4))
            valid_loss = valid_log.get("Loss")
            if valid_loss is not None and (
                best_valid_loss is None or valid_loss <= best_valid_loss
            ):
                best_valid_loss = valid_loss
                if config.experiment.save.on_best_validation:
                    epoch_ckpt_name += f"_best_validation_{valid_loss}"
                    should_save_ckpt = True

        # prediction-MSE observability (reference train.py:439-459)
        mse_cfg = config.experiment.mse
        if lead and mse_cfg.enabled and (
            epoch % (mse_cfg.every_n_epochs or 50) == 0
            or (mse_cfg.on_save_ckpt and should_save_ckpt)
        ):
            from lipvq_tpu_torch.utils.vis_utils import compute_mse_visualize

            mse_log = compute_mse_visualize(
                model, train_ds, num_samples=mse_cfg.num_samples,
                savedir=os.path.join(video_dir, f"mse_epoch_{epoch}")
                if mse_cfg.visualize else None,
                context_loader=context_loader if config.algo_name.startswith("icl") else None,
            )
            for k, v in mse_log.items():
                data_logger.record(f"MSE/{k}", v, epoch)
            print(f"MSE Epoch {epoch}: {json.dumps(mse_log)}")

        # rollout evaluation (reference train.py:336-400)
        rollout_check = epoch % config.experiment.rollout.rate == 0
        if (
            envs is not None
            and rollout_check
            and epoch >= config.experiment.rollout.warmstart
        ):
            from lipvq_tpu_torch.algo.rollout_policy import ICLRolloutPolicy
            from lipvq_tpu_torch.envs.rollout import (
                icl_batched_rollout_with_stats,
                icl_rollout_with_stats,
            )

            context_batch = next(iter(context_loader))
            context_batch = model.process_batch_for_training(context_batch)
            policy = ICLRolloutPolicy(
                model,
                obs_normalization_stats=obs_normalization_stats,
                action_normalization_stats=train_ds.get_action_normalization_stats(),
                lang_encoder=lang_encoder,
            )
            if config.experiment.rollout.batched:
                all_rollout_logs, video_paths = icl_batched_rollout_with_stats(
                    policy=policy,
                    vec_envs=envs,
                    context_batch=context_batch,
                    horizon=config.experiment.rollout.horizon,
                    num_episodes=config.experiment.rollout.n,
                    terminate_on_success=config.experiment.rollout.terminate_on_success,
                )
            else:
                all_rollout_logs, video_paths = icl_rollout_with_stats(
                    policy=policy,
                    envs=envs,
                    context_batch=context_batch,
                    horizon=config.experiment.rollout.horizon,
                    num_episodes=config.experiment.rollout.n,
                    render=config.experiment.render,
                    video_dir=video_dir if config.experiment.render_video else None,
                    epoch=epoch,
                    video_skip=config.experiment.video_skip,
                    terminate_on_success=config.experiment.rollout.terminate_on_success,
                    frame_stack=config.train.frame_stack,
                )
            for env_name, rollout_logs in all_rollout_logs.items():
                print(f"Rollout Epoch {epoch} [{env_name}]: "
                      + json.dumps({k: v for k, v in rollout_logs.items()
                                    if not k.startswith("Time_")},
                                   sort_keys=True))
                for k, v in rollout_logs.items():
                    if k.startswith("Time_"):
                        data_logger.record(
                            f"Timing_Stats/Rollout_{env_name}_{k[5:]}", v, epoch
                        )
                    else:
                        data_logger.record(
                            f"Rollout/{k}/{env_name}", v, epoch, log_stats=True
                        )
            (
                should_save_by_rollout, epoch_ckpt_name,
                best_return, best_success_rate,
            ) = TrainUtils.should_save_from_rollout_logs(
                all_rollout_logs, best_return, best_success_rate,
                epoch_ckpt_name,
                config.experiment.save.on_best_rollout_return,
                config.experiment.save.on_best_rollout_success_rate,
            )
            should_save_ckpt = should_save_ckpt or should_save_by_rollout

        if lead and should_save_ckpt:
            path = os.path.join(ckpt_dir, epoch_ckpt_name + ".ckpt")
            FileUtils.save_checkpoint(
                path, model, config,
                env_meta=env_meta, shape_meta=shape_meta,
                obs_normalization_stats=obs_normalization_stats,
                action_normalization_stats=train_ds.get_action_normalization_stats(),
                lang_backend=lang_encoder.backend,
            )
            _save_full_state(model, ckpt_dir, epoch)
            print(f"save checkpoint to {path}")
            last_ckpt_time = time.time()

        # host memory observability (reference train.py:480-483)
        try:
            import psutil
        except ImportError:
            psutil = None
        if psutil is not None:
            mem = psutil.Process(os.getpid()).memory_info().rss / (1 << 20)
            data_logger.record("System/RAM Usage (MB)", mem, epoch)

    data_logger.close()


def main(args=None):
    """Parse ``args`` (the command line when None), train, and return the
    checkpoint directory."""
    parser = argparse.ArgumentParser()
    parser.add_argument("--config", type=str, required=True)
    parser.add_argument("--algo", type=str, default=None)
    parser.add_argument("--name", type=str, default=None)
    parser.add_argument("--dataset", type=str, default=None)
    parser.add_argument("--output_dir", type=str, default=None)
    parser.add_argument("--device", type=str, default=None,
                        help="torch device (default: CUDA, or the CPU where "
                             "train.cuda is false)")
    parser.add_argument("--debug", action="store_true")
    parser.add_argument("--eval_only", action="store_true")
    ns = parser.parse_args(args)

    with open(ns.config) as f:
        ext_cfg = json.load(f)
    algo_name = ns.algo or ext_cfg.get("algo_name")
    config = config_factory(algo_name, ext_cfg)

    with config.values_unlocked():
        if ns.dataset is not None:
            config.train.data = ns.dataset
        if ns.name is not None:
            config.experiment.name = ns.name
        if ns.output_dir is not None:
            config.train.output_dir = ns.output_dir
        if ns.debug:
            config.experiment.epoch_every_n_steps = 3
            config.experiment.validation_epoch_every_n_steps = 3
            config.train.num_epochs = 2
            config.experiment.rollout.n = 2
            config.experiment.rollout.horizon = 10
            config.experiment.rollout.rate = 1
            config.experiment.save.every_n_epochs = 1

    try:
        return train(config, eval_only=ns.eval_only, device=ns.device)
    except Exception:
        print(f"run failed with error:\n{traceback.format_exc()}")
        raise


if __name__ == "__main__":
    main()
