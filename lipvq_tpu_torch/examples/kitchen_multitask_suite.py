"""Multi-task closed-loop suite: collect -> MetaDataset train -> eval (the
port's twin of the JAX package's ``examples/kitchen_multitask_suite.py``,
with its functions, flags, defaults, printed lines and JSON files).

The reference's protocol trains/evals ICL per task over the robocasa
suite (config_gen_utils.py:150-164 eval protocol, train_utils.py:904
icl_rollout_with_stats). This script pins that protocol end-to-end on
the first-party kitchen: scripted experts collect corpora for N
fixture-centric task families (fixed layout/style per task), ONE
ICL+LipVQ model trains on the weighted MetaDataset mixture, and the
checkpoint is evaluated closed-loop per task with a same-task context
demo, producing the per-task success table.

    python -m lipvq_tpu_torch.examples.kitchen_multitask_suite \\
        [--n_demos 40] [--epochs 30] [--eval_episodes 10] [--out DIR]

Where it differs from the JAX script:

- a task's corpus is an export (``data/export.py``) at
  ``<corpus_dir>/<task>/``, not ``<task>.hdf5``; an existing export is never
  recollected without ``--recollect``, and then nothing imports the
  simulator, so ``--train_only`` runs where ``mujoco`` is not installed;
- training takes the CUDA device unless ``--train_device cpu``, and the
  closed-loop evaluation takes it unless ``--eval_device cpu``: the port's
  entry points run on the card unless the caller asks for the CPU. With
  ``--eval_device cpu`` the policy is loaded on the CPU, so the eval-only
  modes (``--skip_train``, ``--screen_only``, ``--eval_ckpt``) never
  initialize CUDA and can run beside a training process on the card;
- ``task_policy`` builds one task's policy and context batch (the part of
  ``evaluate`` before the env stepping), for callers that serve a task
  without the simulator.

Obs keys are proprio + lang_emb (no "object" vector): its dimension is
task-dependent (10 x num_objects), which a MetaDataset mixture cannot
batch; the chosen families are fixture-state tasks where language +
proprio identify the goal (same trade the reference's lang-conditioned
low-dim configs make).
"""

from __future__ import annotations

import argparse
import json
import os
import time

from lipvq_tpu_torch.robocasa.dataset_registry import ALL_TASK_DATASETS

TASKS = [
    # (task, collect_seed, layout_id, style_id)
    ("NavigateKitchen", 11, 0, 0),
    ("OpenDrawer", 3, 0, 0),
    ("CloseDrawer", 5, 0, 0),
    ("OpenSingleDoor", 7, 0, 0),
    ("CloseSingleDoor", 2, 0, 0),
    ("TurnOnSinkFaucet", 1, 0, 0),
    ("TurnOffSinkFaucet", 4, 0, 0),
    ("TurnSinkSpout", 9, 0, 0),
]

# --task_set wide: +5 fixture families (microwave/coffee buttons, stove
# knobs), every family whose goal is identified by proprio + fixture_state
# + lang
WIDE_TASKS = TASKS + [
    ("TurnOnMicrowave", 6, 0, 0),
    ("TurnOffMicrowave", 8, 0, 0),
    ("CoffeePressButton", 10, 0, 0),
    ("TurnOnStove", 12, 0, 0),
    ("TurnOffStove", 13, 0, 0),
]

# --task_set full: +4 PnP families, mug PnP onto the coffee machine, and
# ONE registry multi-stage activity (PrepareCoffee); the obj_state
# observation (sim/kitchen.py) identifies the payload/container the way the
# reference's per-task ``object`` sensor does (kitchen.py:1232-1302)
FULL_TASKS = WIDE_TASKS + [
    ("PnPCounterToCab", 14, 0, 0),
    ("PnPCabToCounter", 15, 0, 0),
    ("PnPMicrowaveToCounter", 16, 0, 0),
    ("PnPSinkToCounter", 17, 0, 0),
    ("CoffeeServeMug", 18, 0, 0),
    ("PrepareCoffee", 19, 0, 0),
]

TASK_SETS = {"core": TASKS, "wide": WIDE_TASKS, "full": FULL_TASKS}


def task_horizon(task, default=500):
    """The eval/collection horizon of the reference's per-task registry
    (robocasa/utils/dataset_registry.py)."""
    return int(ALL_TASK_DATASETS.get(task, {}).get("horizon", default))


OBS_KEYS = [
    "robot0_base_pos", "robot0_base_quat", "robot0_eef_pos",
    "robot0_eef_quat", "robot0_gripper_qpos", "robot0_base_to_eef_pos",
    # task-fixture articulation (handle world pos + handle-to-eef + joint
    # fractions, fixed 16-dim): the fixture-task analogue of the reference's
    # object sensor vector; without it the precision families (door handle
    # hook, faucet lever) are state-blind
    "fixture_state",
    # fixed-dim payload/container state (primary object + container pos/
    # quat/to-eef): what PnP + coffee families manipulate, the
    # MetaDataset-batchable analogue of the reference's ``object`` key
    "obj_state",
    "lang_emb",
]


def _check_corpus_obs_keys(path):
    """Fail fast if a pre-existing corpus predates an OBS_KEYS change.

    collect() skips existing exports, so re-running the suite over a corpus
    collected before a new obs key (e.g. obj_state) was added would
    otherwise crash with a bare KeyError deep inside training setup. Reads
    the export's ``meta.json`` only."""
    from lipvq_tpu_torch.data.export import Export

    export = Export(path)
    demos = sorted(export.demos)
    if not demos:
        return
    have = set(export.keys(demos[0], "obs"))
    missing = [k for k in OBS_KEYS if k != "lang_emb" and k not in have]
    if missing:
        raise SystemExit(
            f"corpus {path} lacks obs keys {missing} (collected before "
            f"they were added); re-run with --recollect or point "
            f"--corpus_dir elsewhere")


def collect(args):
    from lipvq_tpu_torch.scripts.collect_kitchen_suite import collect_task

    paths = {}
    tasks = TASK_SETS[getattr(args, "task_set", "core")]
    only = [t.strip() for t in getattr(args, "tasks", "").split(",")
            if t.strip()]
    if only:
        by_name = {t[0]: t for t in FULL_TASKS}
        tasks = [by_name[n] for n in only]
    corpus_dir = getattr(args, "corpus_dir", "") or args.out
    os.makedirs(corpus_dir, exist_ok=True)
    for task, seed, layout, style in tasks:
        path = os.path.join(corpus_dir, task)
        if os.path.exists(path) and not args.recollect:
            _check_corpus_obs_keys(path)
            paths[task] = path
            continue
        t0 = time.time()
        stats = collect_task(
            task, path, n_demos=args.n_demos,
            max_steps=max(900, task_horizon(task)), seed=seed,
            layout_ids=layout, style_ids=style,
            action_noise=args.action_noise,
            dwell_prob=getattr(args, 'dwell_prob', 0.0),
        )
        print(f"[collect] {task}: {stats['demos']}/{args.n_demos} demos "
              f"({stats['attempts']} attempts, {time.time() - t0:.0f}s)",
              flush=True)
        if stats["demos"] < max(2, args.n_demos // 2):
            raise RuntimeError(f"collection too unreliable for {task}")
        paths[task] = path
    return paths


def make_config(args, paths):
    from lipvq_tpu_torch.config import config_factory
    from lipvq_tpu_torch.utils.test_utils import icl_test_config_overrides

    d = icl_test_config_overrides()
    tw = {}
    for kv in getattr(args, "task_weights", "").split(","):
        if kv.strip():
            k, v = kv.split("=")
            tw[k.strip()] = float(v)
    d["train"].update({
        # per-task mixture weight (default 1.0): with --balance_tasks the
        # per-TASK sampling probability is proportional to the weight
        # (MetaDataset normalize_weights_by_ds_size divides by ds length
        # first), so "OpenSingleDoor=2" doubles OSD's share
        "data": [{"path": p, "weight": tw.get(t, 1.0)}
                 for t, p in paths.items()],
        # MetaDataset rejects hdf5_cache_mode="all" (reference quirk,
        # dataset.py:1080-1082); "device" keeps the corpus resident on the
        # training device, so batches are gathered there, not collated on
        # the host
        "hdf5_cache_mode": "device",
        # min_max-normalize actions to +-0.999999 (the reference's robocasa
        # abs-action treatment, config_gen_utils.py:50-86 /
        # dataset.py:1203-1238). Scripted experts saturate actions at
        # EXACTLY +-1, which the tanh-squashed GMM mean can only fit with
        # infinite pre-activations; atanh(0.999999) ~ 7.3 keeps the optimum
        # finite and the gradients sane
        "action_config": {"actions": {"normalization": "min_max"}},
        "num_epochs": args.epochs,
        "batch_size": int(getattr(args, "batch_size", 64)),
        # task-aligned context/query pairing is OFF by default: with
        # per-frame lang_emb identifying the goal, the cross-task "noise"
        # context regularizes the policy into lang-reliance, which is what
        # transfers to rollouts (BASELINE.md, the JAX package's runs)
        "group_task_batches": bool(getattr(args, "pair_task_batches",
                                           False)),
        # task-balanced sampling: per-task timestep counts vary ~10x with
        # the expert's episode length, so per-item uniform sampling starves
        # the short-demo precision tasks
        "normalize_weights_by_ds_size": bool(
            getattr(args, "balance_tasks", False)),
        # training seed (init + dropout + loader shuffling): headline tables
        # report mean+-range over >=3 seeds because multi-task capacity
        # allocation is retrain-sensitive
        "seed": int(getattr(args, "train_seed", 1)),
        "output_dir": os.path.join(args.out, "run"),
    })
    d["experiment"].update({
        "epoch_every_n_steps": args.steps_per_epoch,
        "rollout": {"enabled": False},
        # periodic checkpoints feed post-hoc best-checkpoint selection (the
        # restartable analogue of the reference's in-training
        # save-on-best-rollout protocol, train.py:417-430)
        "save": {
            "enabled": True,
            "every_n_epochs": args.save_every or args.epochs,
        },
        "validate": False,
    })
    d["algo"]["transformer"].update({
        "embed_dim": int(getattr(args, "embed_dim", 256)),
        "num_layers": int(getattr(args, "num_layers", 4)),
        "num_heads": 8,
    })
    # the paper's ablation axis (reference icl_config.py:154-157 + raw-MLP
    # default obs_nets.py:1244-1260): exactly one of the four switches, or
    # none for raw
    tok = getattr(args, "tokenizer", "vq")
    d["algo"]["transformer"].update({
        "vq_vae_enabled": tok == "vq",
        "bin_enabled": tok == "bin",
        "fast_enabled": tok == "fast",
        "ln_act_enabled": tok == "ln_act",
    })
    # min_std floor: scripted-expert labels sit exactly on bin edges (0 /
    # +-1 per dim), so the GMM's sigma collapses toward the residual floor
    # and (y-mu)/sigma^2 explodes; 0.03 bounds the sharpness (the reference
    # template's 0.005 is for human data, which never saturates)
    d["algo"]["gmm"]["min_std"] = 0.03
    d["algo"]["optim_params"] = {"policy": {"learning_rate": {
        "initial": 1e-3, "scheduler_type": "none"}}}
    d["algo"]["vq"] = {"num_codes": 512}
    d["observation"]["modalities"]["obs"]["low_dim"] = list(OBS_KEYS)
    if getattr(args, "backbone", "transformer") == "mamba":
        # the reference's second ICL algorithm (algo/icl_mamba.py, Appendix
        # B.7): same composite encoder + heads, Mamba backbone instead of
        # the GPT. Size knobs transfer (embed_dim/num_layers); the SSM dims
        # follow the reference (obs_nets.py:2748-2753)
        mb = d["algo"].pop("transformer")
        mb.update({"d_state": 8, "d_conv": 4, "expand": 2})
        d["algo"]["mamba"] = mb
        return config_factory("icl_mamba", d)
    return config_factory("icl", d)


def task_policy(args, model, ckpt, task, path, lang_encoder):
    """One task's rollout policy and context batch -> (policy, context_batch,
    cfg): the context demo comes from that task's own corpus at ``path``
    (reference train.py:217-224: a context loader over the train set), the
    context actions normalized and the policy's outputs unnormalized with
    the TRAINING mixture's stats, stored in ``ckpt`` (per-task stats differ
    on dims whose range varies across tasks, which would mis-scale both
    streams)."""
    from lipvq_tpu_torch.algo.rollout_policy import ICLRolloutPolicy
    from lipvq_tpu_torch.utils import train_utils as TrainUtils

    cfg = make_config(args, {task: path})
    with cfg.unlocked():
        cfg.train.data = path
        # one context batch per task: the device-resident corpus is
        # training machinery
        cfg.train.hdf5_cache_mode = "low_dim"
    train_ds, _ = TrainUtils.load_data_for_training(
        cfg, obs_keys=model.obs_shapes.keys(), lang_encoder=lang_encoder
    )
    stats = ckpt.get("action_normalization_stats_unpacked") or \
        train_ds.get_action_normalization_stats()
    train_ds.set_action_normalization_stats(stats)
    _, _, context_loader = TrainUtils.make_loaders(cfg, train_ds, None)
    context_batch = model.process_batch_for_training(
        next(iter(context_loader))
    )
    policy = ICLRolloutPolicy(
        model,
        action_normalization_stats=stats,
        lang_encoder=lang_encoder,
    )
    return policy, context_batch, cfg


def evaluate(args, paths, ckpt_path, episodes=None, cache_name=None):
    import copy

    from lipvq_tpu_torch.envs.env_factory import create_env_from_metadata
    from lipvq_tpu_torch.envs.vector_env import VectorEnv, batched_icl_rollout
    from lipvq_tpu_torch.utils import file_utils as FileUtils
    from lipvq_tpu_torch.utils.lang_utils import LangEncoder

    episodes = episodes or args.eval_episodes
    # the card unless the caller asks for the CPU (--eval_device cpu)
    device = "cpu" if getattr(args, "eval_device", "cuda") == "cpu" else None
    model, ckpt = FileUtils.policy_from_checkpoint(ckpt_path, device=device)
    lang_encoder = LangEncoder(device=device)
    # incremental, restartable: completed tasks persist and are skipped on
    # relaunch
    partial_path = os.path.join(args.out, cache_name or "success_table.json")
    table = {}
    if os.path.exists(partial_path):
        with open(partial_path) as f:
            table = json.load(f).get("per_task", {})
    for task, path in paths.items():
        if task in table:
            print(f"[eval] {task}: cached {table[task]:.2f}", flush=True)
            continue
        policy, context_batch, cfg = task_policy(args, model, ckpt, task, path,
                                                 lang_encoder)
        # batched eval: eval_episodes envs step in lock-step against one
        # policy request per step. Each env gets a distinct eval seed (the
        # dataset env_kwargs pin the COLLECTION seed; reusing it across N
        # identical envs would replay one episode N times).
        env_meta = FileUtils.get_env_metadata_from_dataset(path)
        fns = []
        for i in range(episodes):
            meta_i = copy.deepcopy(env_meta)
            meta_i.setdefault("env_kwargs", {})["seed"] = 1000 + i
            fns.append(lambda m=meta_i: create_env_from_metadata(m))
        vec = VectorEnv(
            fns, frame_stack=cfg.train.frame_stack,
            obs_keys=[k for k in model.obs_shapes if k != "lang_emb"],
        )
        t0 = time.time()
        horizon = args.horizon if args.horizon else task_horizon(task)
        logs = batched_icl_rollout(
            policy, vec, context_batch, horizon=horizon,
            terminate_on_success=True,
        )
        rate = float(logs["Success_Rate"])
        table[task] = rate
        print(f"[eval] {task}: success={rate:.2f} "
              f"({episodes} episodes, {time.time() - t0:.0f}s, "
              f"mean horizon {logs['Horizon']:.0f})", flush=True)
        for e in vec.envs:
            (e.unwrapped if hasattr(e, "unwrapped") else e).close()
        with open(partial_path, "w") as f:
            json.dump({"per_task": table}, f, indent=2)
    return table


def build_parser():
    ap = argparse.ArgumentParser()
    ap.add_argument("--n_demos", type=int, default=40)
    ap.add_argument("--epochs", type=int, default=30)
    ap.add_argument("--steps_per_epoch", type=int, default=300)
    ap.add_argument("--eval_episodes", type=int, default=10)
    ap.add_argument("--save_every", type=int, default=0,
                    help="checkpoint every N epochs (0 = final only); "
                         "feeds best-checkpoint screening")
    ap.add_argument("--screen_episodes", type=int, default=0,
                    help="episodes/task for the best-checkpoint screen "
                         "over all periodic saves (0 = eval final only)")
    ap.add_argument("--screen_last", type=int, default=3,
                    help="screen only the newest K periodic checkpoints "
                         "(env stepping is the cost)")
    ap.add_argument("--train_seed", type=int, default=1,
                    help="training seed (model init + dropout + data "
                         "shuffling); replicate headline runs over >=3 "
                         "seeds: retrain variance is the dominant noise "
                         "source")
    ap.add_argument("--screen_topk", type=int, default=0,
                    help="successive-halving screen: after the wide "
                         "--screen_episodes pass, re-screen the top K "
                         "checkpoints at --screen_topk_episodes and pick "
                         "the winner from the re-screen (few-episode "
                         "screens overestimate the final mean through "
                         "selection over noise). 0 = pick from the wide pass")
    ap.add_argument("--screen_topk_episodes", type=int, default=10,
                    help="episodes/task for the --screen_topk re-screen")
    ap.add_argument("--screen_epochs", type=str, default="",
                    help="comma-separated epoch numbers to screen (e.g. "
                         "'120,240'); overrides --screen_last. Long runs "
                         "overfit closed-loop well before the final save, "
                         "so the EARLY saves are the ones worth screening")
    ap.add_argument("--eval_device", choices=("cpu", "cuda"), default="cuda",
                    help="closed-loop eval inference placement (default "
                         "cuda; cpu loads the policy on the host and never "
                         "initializes CUDA in the eval-only modes)")
    ap.add_argument("--train_device", choices=("cpu", "cuda"), default="cuda",
                    help="training device (default cuda)")
    ap.add_argument("--task_set", choices=("core", "wide", "full"),
                    default="core",
                    help="core = the 8 round-3 families; wide adds 5 "
                         "button/knob fixture families (13); full adds 4 "
                         "PnP + CoffeeServeMug + the PrepareCoffee "
                         "multi-stage activity (19)")
    ap.add_argument("--tasks", type=str, default="",
                    help="comma-separated task names overriding "
                         "--task_set (e.g. a single-family probe)")
    ap.add_argument("--tokenizer",
                    choices=("vq", "bin", "fast", "ln_act", "raw"),
                    default="vq",
                    help="action tokenizer for the ICL context stream: "
                         "the paper's ablation axis (reference "
                         "icl_config.py:154-157)")
    ap.add_argument("--backbone", choices=("transformer", "mamba"),
                    default="transformer",
                    help="ICL sequence backbone: the reference's two ICL "
                         "algorithms (icl.py GPT / icl_mamba.py SSM); "
                         "mamba reuses --embed_dim/--num_layers")
    ap.add_argument("--batch_size", type=int, default=64)
    ap.add_argument("--embed_dim", type=int, default=256)
    ap.add_argument("--num_layers", type=int, default=4,
                    help="policy transformer size (multi-task capacity "
                         "dilutes per-task success)")
    ap.add_argument("--horizon", type=int, default=0,
                    help="override eval horizon for ALL tasks (0 = the "
                         "per-task registry horizon, dataset_registry.py)")
    ap.add_argument("--out", type=str, default="/tmp/kitchen_suite")
    ap.add_argument("--corpus_dir", type=str, default="",
                    help="read/collect corpora here instead of --out: "
                         "lets ablation runs (e.g. the 5-tokenizer sweep) "
                         "share one corpus set while keeping separate "
                         "run/eval dirs")
    ap.add_argument("--action_noise", type=float, default=0.0,
                    help="DART-style expert action noise during collection "
                         "(closed-loop manipulation needs ~0.05: noise-free "
                         "corpora leave the policy no recovery data)")
    ap.add_argument("--dwell_prob", type=float, default=0.0,
                    help="random hold-in-place injection during collection\n(clean progress labels at frozen states): decorrelates trajectory\ntime from state so the policy learns state-conditioned phase\nprogression (the OpenSingleDoor study)")
    ap.add_argument("--task_weights", type=str, default="",
                    help="comma-separated Task=weight mixture overrides "
                         "(e.g. 'OpenSingleDoor=2'); with --balance_tasks "
                         "the per-task sampling share is proportional to "
                         "the weight")
    ap.add_argument("--recollect", action="store_true")
    ap.add_argument("--balance_tasks", action="store_true",
                    help="equal per-TASK sampling probability in the "
                         "MetaDataset mixture (per-task timestep counts "
                         "vary 10x across families)")
    ap.add_argument("--pair_task_batches", action="store_true",
                    help="task-aligned ctx/qry batch halves (measured "
                         "worse closed-loop than plain shuffling; see "
                         "make_config)")
    ap.add_argument("--skip_train", action="store_true",
                    help="evaluate the newest checkpoint in --out/run")
    ap.add_argument("--eval_ckpt", type=str, default="",
                    help="evaluate exactly this checkpoint path (implies "
                         "no training and no screening)")
    ap.add_argument("--screen_timeout", type=int, default=7200,
                    help="--screen_only gives up after this many seconds "
                         "without a new checkpoint appearing")
    ap.add_argument("--screen_only", action="store_true",
                    help="poll --out/run for the --screen_epochs periodic "
                         "checkpoints and screen each as it appears, then "
                         "exit (no final eval). With --eval_device cpu it "
                         "runs CONCURRENTLY with the training process on the "
                         "card; the screen caches it writes are reused by "
                         "the main pipeline's screening phase")
    ap.add_argument("--collect_only", action="store_true",
                    help="stop after corpus collection")
    ap.add_argument("--train_only", action="store_true",
                    help="stop after training (screening/eval run in a "
                         "separate process)")
    ap.add_argument("--resume", action="store_true",
                    help="resume training from --out/run's newest "
                         "latest_full.state (params + optimizer + rng) at "
                         "saved_epoch + 1: a supervisor can kill a hung "
                         "process and relaunch with --resume, losing at most "
                         "save_every epochs")
    return ap


def main(argv=None):
    # SIGUSR1 -> all-thread stack dump on stderr: lets a supervisor capture
    # WHERE a run hung before killing and resuming it
    import faulthandler
    import signal

    faulthandler.register(signal.SIGUSR1)

    args = build_parser().parse_args(argv)
    os.makedirs(args.out, exist_ok=True)

    paths = collect(args)
    if args.collect_only:
        print("[collect] done (collect_only)", flush=True)
        return

    import glob

    if args.screen_only:
        # concurrent screening: the training process owns the card; this
        # process screens checkpoints as they land. evaluate() caches
        # per-task results to screen_<tag>.json, which the main pipeline's
        # screening phase reads and skips
        run_dir = os.path.join(args.out, "run")
        want = [e.strip() for e in args.screen_epochs.split(",")
                if e.strip()]
        if not want or args.screen_episodes <= 0:
            raise SystemExit("--screen_only needs --screen_epochs and "
                             "--screen_episodes")
        done = set()
        last_progress = time.time()
        while set(want) - done:
            # liveness bound: if the trainer dies or was reconfigured before
            # producing a requested epoch, exit instead of polling forever
            if time.time() - last_progress > args.screen_timeout:
                missing = sorted(set(want) - done)
                print(f"[screen_only] timeout ({args.screen_timeout}s) "
                      f"waiting for epochs {missing}; exiting", flush=True)
                return
            progressed = False
            for e in want:
                if e in done:
                    continue
                cks = glob.glob(
                    os.path.join(run_dir, "**", f"model_epoch_{e}.ckpt"),
                    recursive=True)
                if not cks:
                    continue
                # resumes can leave the same epoch in multiple timestamped
                # run dirs: screen the newest, and apply the still-writing
                # mtime guard to THAT file
                ck = max(cks, key=os.path.getmtime)
                if time.time() - os.path.getmtime(ck) < 5:
                    continue
                # cache keyed by (epoch, ckpt mtime): a resumed run can
                # re-produce the same epoch in a new run dir; an epoch-only
                # key would serve the OLD run's stale screen rates for the
                # new weights
                tag = f"model_epoch_{e}_{int(os.path.getmtime(ck))}"
                t0 = time.time()
                tbl = evaluate(args, paths, ck,
                               episodes=args.screen_episodes,
                               cache_name=f"screen_{tag}.json")
                print(f"[screen_only] {tag}: "
                      f"mean={sum(tbl.values()) / len(tbl):.3f} "
                      f"({time.time() - t0:.0f}s)", flush=True)
                done.add(e)
                progressed = True
            if progressed:
                last_progress = time.time()
            elif set(want) - done:
                time.sleep(20)
        return

    if getattr(args, "eval_ckpt", ""):
        # evaluate exactly this checkpoint (e.g. the winner of a
        # subset-proxy screen), no screening pass
        ckpts = [args.eval_ckpt]
    elif args.skip_train:
        ckpts = sorted(
            glob.glob(os.path.join(args.out, "run", "**", "*.ckpt"),
                      recursive=True),
            key=os.path.getmtime,
        )
    else:
        import re

        from lipvq_tpu_torch.scripts.train import train

        cfg = make_config(args, paths)
        if args.resume:
            states = glob.glob(
                os.path.join(args.out, "run", "**", "latest_full.state"),
                recursive=True)
            if states:
                state = max(states, key=os.path.getmtime)
                # the state's own epoch sidecar (written WITH the state) is
                # authoritative; ckpt filenames can be ahead of the restored
                # weights if a kill landed between the two writes, and
                # inferring from them would skip epochs with stale weights
                start_epoch = None
                try:
                    with open(state + ".epoch") as f:
                        start_epoch = int(f.read().strip()) + 1
                except (OSError, ValueError):
                    saved = [
                        int(m.group(1)) for c in glob.glob(
                            os.path.join(os.path.dirname(state), "*.ckpt"))
                        if (m := re.search(r"model_epoch_(\d+)", c))
                    ]
                    start_epoch = (max(saved) + 1) if saved else 1
                with cfg.unlocked():
                    cfg.experiment.ckpt_path = state
                    cfg.experiment.start_epoch = start_epoch
                print(f"[resume] {state} -> start_epoch "
                      f"{cfg.experiment.start_epoch}", flush=True)
        t0 = time.time()
        train(cfg, device=args.train_device)
        print(f"[train] done in {time.time() - t0:.0f}s", flush=True)
        if args.train_only:
            return
        ckpts = sorted(
            glob.glob(os.path.join(args.out, "run", "**", "*.ckpt"),
                      recursive=True),
            key=os.path.getmtime)
    ckpt_path = ckpts[-1]

    # rollout-based best-checkpoint selection (reference protocol: rollout
    # every N epochs, keep the best, train.py:417-430). Post hoc over the
    # periodic saves: screen each checkpoint with a small episode budget,
    # then run the full eval on the winner. The final epoch is NOT reliably
    # the best: multi-task capacity allocation drifts across epochs at
    # near-identical train LL.
    if args.screen_episodes > 0 and len(ckpts) > 1:
        if args.screen_epochs:
            want = {f"model_epoch_{e.strip()}" for e in
                    args.screen_epochs.split(",") if e.strip()}
            to_screen = [c for c in ckpts
                         if os.path.splitext(os.path.basename(c))[0] in want]
        else:
            to_screen = ckpts[-args.screen_last:]
        tables = {}
        for ck in to_screen:
            tag = (os.path.splitext(os.path.basename(ck))[0]
                   + f"_{int(os.path.getmtime(ck))}")
            t0 = time.time()
            tbl = evaluate(args, paths, ck, episodes=args.screen_episodes,
                           cache_name=f"screen_{tag}.json")
            tables[ck] = tbl
            print(f"[screen] {tag}: mean={sum(tbl.values()) / len(tbl):.3f} "
                  f"({time.time() - t0:.0f}s)", flush=True)
        # compare means over the COMMON task set: a screen cache written by
        # an interrupted or narrower run has fewer tasks, and a mean over a
        # lucky subset would win spuriously
        common = set.intersection(*(set(t) for t in tables.values()))
        if not common:
            raise RuntimeError("screen caches share no common tasks")
        screen = {ck: sum(t[k] for k in common) / len(common)
                  for ck, t in tables.items()}
        ckpt_path = max(screen, key=screen.get)
        screen_mean_winner = screen[ckpt_path]
        rescreen = {}
        if args.screen_topk > 0 and len(screen) > 1:
            # successive halving: wide low-episode screens OVERESTIMATE the
            # final mean through selection over noise and can pick the
            # wrong checkpoint; the top-K get a >=10-ep re-screen and the
            # winner comes from THAT, approaching the reference's
            # 50-rollout selection fidelity (config_gen_utils.py:150-164)
            # at a fraction of the episode budget
            top = sorted(screen, key=screen.get,
                         reverse=True)[:args.screen_topk]
            for ck in top:
                tag = (os.path.splitext(os.path.basename(ck))[0]
                       + f"_{int(os.path.getmtime(ck))}")
                t0 = time.time()
                tbl = evaluate(args, paths, ck,
                               episodes=args.screen_topk_episodes,
                               cache_name=f"rescreen_{tag}.json")
                ks = [k for k in common if k in tbl]
                if not ks:
                    continue
                rescreen[ck] = sum(tbl[k] for k in ks) / len(ks)
                print(f"[rescreen] {tag}: mean={rescreen[ck]:.3f} "
                      f"({args.screen_topk_episodes} eps, "
                      f"{time.time() - t0:.0f}s)", flush=True)
            if rescreen:
                ckpt_path = max(rescreen, key=rescreen.get)
                screen_mean_winner = rescreen[ckpt_path]
        print(f"[screen] best: {os.path.basename(ckpt_path)} "
              f"(mean {screen_mean_winner:.3f})", flush=True)
        with open(os.path.join(args.out, "screen_table.json"), "w") as f:
            json.dump({
                "screen": {os.path.basename(k): v
                           for k, v in screen.items()},
                "rescreen": {os.path.basename(k): v
                             for k, v in rescreen.items()},
                "screen_episodes": args.screen_episodes,
                "rescreen_episodes": (args.screen_topk_episodes
                                      if rescreen else None),
            }, f, indent=2)
    else:
        screen_mean_winner = None

    table = evaluate(args, paths, ckpt_path)
    mean = sum(table.values()) / len(table)
    out = {"per_task": table, "mean": round(mean, 3),
           "episodes_per_task": args.eval_episodes,
           "train_seed": args.train_seed,
           "ckpt": os.path.basename(ckpt_path)}
    if screen_mean_winner is not None:
        # screen-vs-final bias estimate: how much the selection screen
        # overestimated the winner's full-eval mean
        out["screen_mean_winner"] = round(screen_mean_winner, 3)
        out["screen_bias"] = round(screen_mean_winner - mean, 3)
        print(f"[bias] winner screen mean {screen_mean_winner:.3f} vs "
              f"final {mean:.3f} (bias {screen_mean_winner - mean:+.3f})",
              flush=True)
    print(json.dumps(out))
    with open(os.path.join(args.out, "success_table.json"), "w") as f:
        json.dump(out, f, indent=2)


if __name__ == "__main__":
    main()
