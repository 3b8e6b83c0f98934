"""The port stands alone: it imports no JAX and nothing of ``lipvq_tpu``,
and its entry points run on the card unless told otherwise."""

import ast
import pathlib
import re
import subprocess
import sys

import numpy as np
import pytest
import torch

from lipvq_tpu_torch.algo import algo_factory
from lipvq_tpu_torch.config import config_factory

REPO = pathlib.Path(__file__).resolve().parent.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "h5py", "msgpack", "lipvq_tpu")
# optional packages that modules import only inside the functions that need
# them (the HF-backed PRISE algorithms, the pretrained CLIP loader)
LAZY = ("tokenizers", "transformers")

# the teleop devices, the robocasa expert tools, the USD export and the
# kitchen suite's example twins
TOOL_MODULES = (
    "lipvq_tpu_torch.robocasa.sim.devices", "lipvq_tpu_torch.scripts.collect_demos",
    *(f"lipvq_tpu_torch.robocasa.{m}" for m in (
        "bench_expert_success", "bench_speed", "diagnose_expert", "repin_experts",
        "usd_export")),
    *(f"lipvq_tpu_torch.examples.{m}" for m in (
        "kitchen_multitask_suite", "pnp_probe", "aggregate_seed_tables")))

# the first-party MuJoCo kitchen and its collection tools
KITCHEN_MODULES = (
    "lipvq_tpu_torch.robocasa", "lipvq_tpu_torch.robocasa.sim",
    *(f"lipvq_tpu_torch.robocasa.sim.{m}" for m in (
        "textures", "fixtures", "objects", "placement", "layouts", "robot", "kitchen",
        "single_stage", "scripted")),
    "lipvq_tpu_torch.robocasa.dataset_registry", "lipvq_tpu_torch.robocasa.env_registry",
    "lipvq_tpu_torch.robocasa.env_utils", "lipvq_tpu_torch.envs.env_kitchen",
    "lipvq_tpu_torch.robocasa.sim.multi_stage",
    *(f"lipvq_tpu_torch.robocasa.sim.multi_stage.{m}" for m in (
        "baking", "boiling", "brewing", "chopping_food", "clearing_table", "defrosting_food",
        "restocking_supplies", "washing_dishes", "frying", "making_toast", "meat_preparation",
        "mixing_and_blending", "reheating_food", "sanitize_surface", "serving_food",
        "setting_the_table", "snack_preparation", "steaming_food",
        "tidying_cabinets_and_drawers", "washing_fruits_and_vegetables")),
    "lipvq_tpu_torch.scripts.collect_kitchen_suite", "lipvq_tpu_torch.scripts.conversion",
    "lipvq_tpu_torch.scripts.conversion.extract_action_dict",
    "lipvq_tpu_torch.scripts.dataset_states_to_obs", "lipvq_tpu_torch.scripts.playback_dataset",
    "lipvq_tpu_torch.examples.kitchen_convergence_demo", *TOOL_MODULES)

_IMPORT_ALL = f"""
import importlib, pkgutil, sys
KITCHEN_MODULES = {KITCHEN_MODULES!r}
import lipvq_tpu_torch
names = [m.name for m in pkgutil.walk_packages(lipvq_tpu_torch.__path__, "lipvq_tpu_torch.")]
for name in names:
    importlib.import_module(name)
for name in ("lipvq_tpu_torch.algo.icl", "lipvq_tpu_torch.ops.vq_lookup",
             "lipvq_tpu_torch.utils.train_utils", "lipvq_tpu_torch.data.loaders",
             "lipvq_tpu_torch.utils.tensor_utils", "lipvq_tpu_torch.data.export",
             "lipvq_tpu_torch.data.dataset", "lipvq_tpu_torch.utils.file_utils",
             "lipvq_tpu_torch.utils.lang_utils", "lipvq_tpu_torch.utils.log_utils",
             "lipvq_tpu_torch.utils.test_utils", "lipvq_tpu_torch.envs.env_base",
             "lipvq_tpu_torch.envs.wrappers", "lipvq_tpu_torch.envs.env_synthetic",
             "lipvq_tpu_torch.envs.env_factory", "lipvq_tpu_torch.envs.vector_env",
             "lipvq_tpu_torch.envs.rollout", "lipvq_tpu_torch.scripts.train",
             "lipvq_tpu_torch.scripts.eval_checkpoint", "lipvq_tpu_torch.models.mamba",
             "lipvq_tpu_torch.models.tokenizers.bin_action",
             "lipvq_tpu_torch.parallel.corpus", "lipvq_tpu_torch.scripts.tokenize_corpus",
             "lipvq_tpu_torch.native", "lipvq_tpu_torch.models.tokenizers.prise",
             "lipvq_tpu_torch.models.tokenizers.fast", "lipvq_tpu_torch.models.clip_text",
             "lipvq_tpu_torch.models.tokenizers.vqvae",
             "lipvq_tpu_torch.scripts.tokenizer_sweep", "lipvq_tpu_torch.models.obs_core",
             "lipvq_tpu_torch.utils.vis_utils", "lipvq_tpu_torch.algo.bc",
             "lipvq_tpu_torch.algo.act", "lipvq_tpu_torch.algo.diffusion_policy",
             "lipvq_tpu_torch.models.diffusion_nets", "lipvq_tpu_torch.models.vae_nets",
             "lipvq_tpu_torch.ops.diffusion_schedulers", "lipvq_tpu_torch.algo.rl_common",
             "lipvq_tpu_torch.algo.td3_bc", "lipvq_tpu_torch.algo.iql",
             "lipvq_tpu_torch.algo.cql", "lipvq_tpu_torch.algo.bcq",
             "lipvq_tpu_torch.algo.gl", "lipvq_tpu_torch.algo.hbc",
             "lipvq_tpu_torch.models.value_nets", "lipvq_tpu_torch.algo.mcr",
             "lipvq_tpu_torch.algo.mcr_data", "lipvq_tpu_torch.scripts.train_mcr_representation",
             "lipvq_tpu_torch.scripts.collect_demos",
             "lipvq_tpu_torch.examples.convergence_demo", *KITCHEN_MODULES):
    assert name in names, (name, names)
loaded = sorted(m for m in sys.modules if m.split(".")[0] in {FORBIDDEN!r} + {LAZY!r})
print(len(names), loaded)
assert not loaded, loaded
# nothing was built or loaded: a kernel or the BPE library loads only after
# its build, at first use
from lipvq_tpu_torch import native
from lipvq_tpu_torch.ops import _build
assert not native._LOADED and not _build._LOADED
"""


def test_importing_every_module_loads_no_jax():
    """A fresh interpreter: the test process itself has JAX loaded."""
    proc = subprocess.run([sys.executable, "-c", _IMPORT_ALL], cwd=REPO,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr


_WITHOUT_MUJOCO = f"""
import importlib, sys
sys.modules["mujoco"] = None  # import mujoco raises ModuleNotFoundError
for name in {KITCHEN_MODULES!r}:
    importlib.import_module(name)
from lipvq_tpu_torch.envs.env_factory import create_env
from lipvq_tpu_torch.robocasa.sim import REGISTERED_KITCHEN_ENVS
assert len(REGISTERED_KITCHEN_ENVS) == 121, len(REGISTERED_KITCHEN_ENVS)
for task in ("OpenDrawer", "PreSoakPan"):
    try:
        create_env(task, seed=0)
    except ModuleNotFoundError as e:
        assert e.name == "mujoco" and "'mujoco'" in str(e), e
        print("raised:", e)
    else:
        raise AssertionError("a kitchen was built without mujoco")
"""


_WITHOUT_OPTIONAL = f"""
import importlib, sys
for name in ("mujoco", "hid", "h5py"):
    sys.modules[name] = None  # import raises ModuleNotFoundError
assert not sys.stdin.isatty()
for name in {TOOL_MODULES!r}:
    importlib.import_module(name)
from lipvq_tpu_torch.robocasa.sim.devices import make_device
try:
    make_device("spacemouse")
except ImportError as e:
    print("raised:", e)
print("keyboard:", type(make_device("keyboard")).__name__)
"""


def test_tool_modules_import_without_mujoco_hid_h5py_or_a_terminal():
    """The teleop devices, the expert tools and the suite's twins import where
    ``mujoco``, ``hid`` and ``h5py`` are not installed, with no terminal on
    stdin; the SpaceMouse then raises naming ``hid``, and the keyboard
    builds."""
    proc = subprocess.run([sys.executable, "-c", _WITHOUT_OPTIONAL], cwd=REPO,
                          stdin=subprocess.DEVNULL, capture_output=True, text=True,
                          timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "raised: SpaceMouse teleop requires the `hid` package" in proc.stdout
    assert "keyboard: Keyboard" in proc.stdout


def test_kitchen_modules_import_without_mujoco():
    """Every kitchen module, the multi-stage package included, imports where
    ``mujoco`` is not installed (the card's machine) and registers every
    task; building a single- or multi-stage kitchen there raises
    ``ModuleNotFoundError`` naming it."""
    proc = subprocess.run([sys.executable, "-c", _WITHOUT_MUJOCO], cwd=REPO,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    for task in ("OpenDrawer", "PreSoakPan"):
        assert f"raised: {task}: the kitchen sim needs the 'mujoco' package" in proc.stdout


_IMPORT_LINE = re.compile(
    r"^\s*(?:import|from)\s+(" + "|".join(FORBIDDEN) + r")\b", re.MULTILINE)
# the exceptions: the functions that read or write an HDF5 file or a flax
# msgpack file import h5py or msgpack inside themselves, so they run only
# where that package is installed
ALLOWED = {"lipvq_tpu_torch/data/export.py": {"hdf5_to_export": "h5py"},
           "lipvq_tpu_torch/algo/mcr_data.py": {"_open_hdf5": "h5py",
                                                "_write_hdf5_clips": "h5py"},
           "lipvq_tpu_torch/utils/jax_weights.py": {"_flax_msgpack_ext": "msgpack",
                                                    "mcr_checkpoint_from_msgpack": "msgpack"}}


def _forbidden_imports_in(tree, function: str) -> list[str]:
    fn = next(n for n in ast.walk(tree)
              if isinstance(n, ast.FunctionDef) and n.name == function)
    found = []
    for node in ast.walk(fn):
        if isinstance(node, ast.Import):
            found += [a.name.split(".")[0] for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.module:
            found.append(node.module.split(".")[0])
    return [m for m in found if m in FORBIDDEN]


@pytest.mark.parametrize("path", sorted(
    str(p.relative_to(REPO)) for p in [*(REPO / "lipvq_tpu_torch").rglob("*.py"),
                                        REPO / "chip_smoke.py"]))
def test_source_imports_nothing_of_jax(path):
    text = (REPO / path).read_text()
    found = _IMPORT_LINE.findall(text)
    if path in ALLOWED:
        allowed = ALLOWED[path]
        assert sorted(found) == sorted(allowed.values()), f"{path} imports {found}"
        for function, module in allowed.items():
            assert _forbidden_imports_in(ast.parse(text), function) == [module]
    else:
        assert not found, f"{path} imports {found}"


def test_algo_factory_without_device_raises_without_gpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = config_factory("icl", {"algo": {"gmm": {"enabled": True},
                                          "transformer": {"enabled": True,
                                                          "vq_vae_enabled": True}}})
    shapes = {"robot0_eef_pos": [3], "robot0_eef_quat": [4],
              "robot0_gripper_qpos": [2], "object": [14]}
    with pytest.raises(RuntimeError, match="device='cpu'"):
        algo_factory("icl", cfg, shapes, ac_dim=12)


def _tiny_config(**train):
    cfg = config_factory("icl", {"train": train,
                                 "algo": {"gmm": {"enabled": True},
                                          "transformer": {"enabled": True, "embed_dim": 32,
                                                          "num_layers": 1, "num_heads": 2,
                                                          "vq_vae_enabled": True},
                                          "vq": {"num_codes": 8}}})
    with cfg.unlocked():
        cfg.observation.modalities.obs.low_dim = ["robot0_eef_pos", "object"]
    return cfg


def test_train_script_without_device_raises_without_gpu(monkeypatch, tmp_path):
    from lipvq_tpu_torch.scripts.train import train
    from lipvq_tpu_torch.utils.test_utils import make_synthetic_export

    export = make_synthetic_export(str(tmp_path / "export"), n_demos=3, demo_len=12)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = _tiny_config(data=export, output_dir=str(tmp_path / "out"), num_epochs=1)
    assert cfg.train.cuda
    with pytest.raises(RuntimeError, match="device='cpu'"):
        train(cfg)
    assert not (tmp_path / "out").exists()


def test_checkpoint_entry_points_without_device_raise_without_gpu(monkeypatch, tmp_path):
    from lipvq_tpu_torch.scripts.eval_checkpoint import evaluate_checkpoint
    from lipvq_tpu_torch.utils.file_utils import policy_from_checkpoint, save_checkpoint

    cfg = _tiny_config()
    shapes = {"robot0_eef_pos": [3], "object": [14]}
    algo = algo_factory("icl", cfg, shapes, ac_dim=12, device="cpu")
    path = str(tmp_path / "m.ckpt")
    save_checkpoint(path, algo, cfg, shape_meta={"ac_dim": 12, "all_shapes": shapes,
                                                 "all_obs_keys": list(shapes)})
    assert policy_from_checkpoint(path, device="cpu")[0].device.type == "cpu"
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        policy_from_checkpoint(path)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        evaluate_checkpoint(path, n=1, horizon=1)


def test_corpus_entry_points_without_device_raise_without_gpu(monkeypatch, tmp_path):
    import numpy as np

    from lipvq_tpu_torch.models.tokenizers.lipvq import LipVQVAE
    from lipvq_tpu_torch.parallel.corpus import tokenize_array
    from lipvq_tpu_torch.scripts import tokenize_corpus
    from lipvq_tpu_torch.utils.test_utils import make_synthetic_export

    export = make_synthetic_export(str(tmp_path / "export"), n_demos=2, demo_len=5)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tokenize_array(LipVQVAE(12, 8, num_codes=4), np.zeros((3, 12), np.float32))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tokenize_corpus.main(["--datasets", export, "--latent_dim", "8", "--num_codes", "4"])


@pytest.mark.parametrize("algo_name,section", [("icl", "transformer"), ("icl_mamba", "mamba")])
@pytest.mark.parametrize("arm", ["bin", "ln_act", "raw"])
def test_every_arm_builds_on_the_cpu_and_raises_without_gpu(monkeypatch, algo_name, section,
                                                            arm):
    switches = {"bin": {"bin_enabled": True}, "ln_act": {"ln_act_enabled": True},
                "raw": {"ln_act_enabled": False}}[arm]
    cfg = config_factory(algo_name, {"algo": {"gmm": {"enabled": True}, section: {
        "enabled": True, "embed_dim": 32, "num_layers": 1, "num_heads": 2, **switches}}})
    with cfg.unlocked():
        cfg.observation.modalities.obs.low_dim = ["robot0_eef_pos", "object"]
    shapes = {"robot0_eef_pos": [3], "object": [14]}
    algo = algo_factory(algo_name, cfg, shapes, ac_dim=12, device="cpu")
    assert type(algo.nets.net.encoder.action_network).__name__ == {
        "bin": "AdaptiveBinActionEmbedding", "ln_act": "LnActTokenizer",
        "raw": "RawActionTokenizer"}[arm]
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        algo_factory(algo_name, cfg, shapes, ac_dim=12)


def test_fast_and_sweep_entry_points_without_device_raise_without_gpu(monkeypatch, tmp_path):
    from lipvq_tpu_torch.scripts import tokenizer_sweep
    from lipvq_tpu_torch.utils.test_utils import make_synthetic_export

    export = make_synthetic_export(str(tmp_path / "export"), n_demos=2, demo_len=5)
    cfg = config_factory("icl", {"algo": {"gmm": {"enabled": True}, "transformer": {
        "enabled": True, "embed_dim": 32, "num_layers": 1, "num_heads": 2,
        "fast_enabled": True}}})
    with cfg.unlocked():
        cfg.observation.modalities.obs.low_dim = ["robot0_eef_pos", "object"]
    shapes = {"robot0_eef_pos": [3], "object": [14]}
    assert algo_factory("icl", cfg, shapes, ac_dim=12, device="cpu").fast_enabled
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        algo_factory("icl", cfg, shapes, ac_dim=12)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tokenizer_sweep.main(["--dataset", export, "--codebook_sizes", "4", "--steps", "1"])
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tokenizer_sweep.train_tokenizer(np.zeros((8, 12), np.float32), 4, False, 8, 1, 4)


PORTED = ["act", "bc", "bcq", "cql", "diffusion_policy", "gl", "hbc", "icl", "icl_mamba", "iql",
          "iris", "mcr", "td3_bc"]


def test_registry_lists_the_ported_algorithms_and_raises_for_the_others():
    """The port registers every algorithm of the JAX package, all 13, in its
    config and its algo factory; a name neither package knows raises
    KeyError from both factories."""
    from lipvq_tpu.algo.base import ALGO_REGISTRY as JAX_REGISTRY
    from lipvq_tpu_torch.algo.base import ALGO_REGISTRY
    from lipvq_tpu_torch.config import REGISTERED_CONFIGS

    import lipvq_tpu.algo  # noqa: F401  (registers the JAX algos)

    assert len(PORTED) == 13
    assert sorted(ALGO_REGISTRY) == PORTED
    assert sorted(REGISTERED_CONFIGS) == PORTED
    assert sorted(JAX_REGISTRY) == PORTED
    cfg = config_factory("bc")
    with pytest.raises(KeyError):
        config_factory("no_such_algo")
    with pytest.raises(KeyError):
        algo_factory("no_such_algo", cfg, {"object": [14]}, ac_dim=12, device="cpu")


@pytest.mark.parametrize("algo_name,over", [
    ("bc", {"algo": {"gmm": {"enabled": True}, "actor_layer_dims": [16]}}),
    ("act", {"algo": {"act": {"hidden_dim": 16, "ff_dim": 16, "enc_layers": 1,
                              "dec_layers": 1}}}),
    ("diffusion_policy", {"algo": {"unet": {"down_dims": [16, 32]}}}),
    ("td3_bc", {"algo": {"actor": {"layer_dims": [16]}, "critic": {"layer_dims": [16]}}}),
    ("iql", {"algo": {"actor": {"layer_dims": [16]}, "critic": {"layer_dims": [16]}}}),
    ("cql", {"algo": {"actor": {"layer_dims": [16]}, "critic": {"layer_dims": [16]}}}),
    ("bcq", {"algo": {"critic": {"layer_dims": [16]}}}),
    ("gl", {"algo": {"ae": {"planner_layer_dims": [16]}, "vae": {"enabled": True}}}),
    ("hbc", {"algo": {"planner": {"ae": {"planner_layer_dims": [16]}},
                      "actor": {"actor_layer_dims": [16]}}}),
    ("iris", {"algo": {"actor": {"actor_layer_dims": [16]}}}),
    ("mcr", {"algo": {"transformer": {"embed_dim": 16, "num_layers": 1, "num_heads": 2}}}),
])
def test_every_baseline_builds_on_the_cpu_and_raises_without_gpu(monkeypatch, algo_name, over):
    cfg = config_factory(algo_name, over)
    with cfg.unlocked():
        cfg.observation.modalities.obs.low_dim = ["robot0_eef_pos", "object"]
    shapes = {"robot0_eef_pos": [3], "object": [14]}
    algo = algo_factory(algo_name, cfg, shapes, ac_dim=12, device="cpu")
    assert all(p.device.type == "cpu" for p in algo.nets.parameters())
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        algo_factory(algo_name, cfg, shapes, ac_dim=12)


def test_mcr_and_closed_loop_entry_points_without_device_raise_without_gpu(monkeypatch,
                                                                          tmp_path):
    """The MCR pretrainer and workspace and the convergence twin take CUDA
    unless they are given a device."""
    from lipvq_tpu_torch.algo.mcr import MCRPretrainer
    from lipvq_tpu_torch.algo.mcr_data import build_synthetic_corpus
    from lipvq_tpu_torch.examples import convergence_demo
    from lipvq_tpu_torch.scripts.train_mcr_representation import RepresentationWorkspace

    corpus = build_synthetic_corpus(str(tmp_path), n_videos=2, length=6, hw=(32, 32))
    assert MCRPretrainer(embed_dim=8, device="cpu").device.type == "cpu"
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        MCRPretrainer(embed_dim=8)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        RepresentationWorkspace(corpus, embed_dim=8)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        convergence_demo.run(workdir=str(tmp_path), n_demos=1, log=lambda *_: None)


def test_export_profile_and_mesh_entry_points_without_device_raise_without_gpu(monkeypatch,
                                                                            tmp_path):
    """``export_policy``, ``profile_train_step`` and ``make_mesh`` take CUDA
    unless they are given a device; ``set_inference_device`` is an explicit
    request and moves to the CPU."""
    from lipvq_tpu_torch.parallel.mesh import make_mesh
    from lipvq_tpu_torch.scripts import export_policy, profile_train_step
    from lipvq_tpu_torch.utils.file_utils import save_checkpoint

    shapes = {"robot0_eef_pos": [3], "object": [14]}
    algo = algo_factory("icl", _tiny_config(), shapes, ac_dim=12, device="cpu")
    ckpt = str(tmp_path / "model.ckpt")
    save_checkpoint(ckpt, algo, algo.global_config,
                    env_meta={"env_name": "SyntheticKitchen", "type": 1, "env_kwargs": {}},
                    shape_meta={"ac_dim": 12, "all_shapes": shapes,
                                "all_obs_keys": list(shapes), "use_images": False},
                    obs_normalization_stats=None, action_normalization_stats=None,
                    lang_backend="hash")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    algo.set_inference_device("cpu")
    assert algo.device.type == "cpu"
    with pytest.raises(RuntimeError, match="device='cpu'"):
        profile_train_step.main(["--mode", "lowdim", "--batches", "2"])
    with pytest.raises(RuntimeError, match="device='cpu'"):
        make_mesh(1)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        export_policy.export_policy(ckpt, str(tmp_path / "p.pt2"))
