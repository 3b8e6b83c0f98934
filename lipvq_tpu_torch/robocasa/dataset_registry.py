"""RoboCasa dataset registry.

The port's copy of ``lipvq_tpu/robocasa/dataset_registry.py``.

Capability parity with the reference registry
(reference: robocasa/utils/dataset_registry.py:9-354): task name ->
rollout horizon + dataset file layout, used by the config-gen layer to
resolve dataset paths and eval horizons. Task list and horizons match the
reference (24 single-stage + 5 multi-stage activities used by the paper's
config-gen, SURVEY.md §6).

Dataset files live under ``$ROBOCASA_DATASET_BASE`` (or the path passed
explicitly); the reference's download URLs require robocasa's asset
server and are delegated to ``scripts/download_datasets.py``.
"""

from __future__ import annotations

import os
from collections import OrderedDict

SINGLE_STAGE_TASK_DATASETS = OrderedDict(
    PnPCounterToCab=dict(horizon=500),
    PnPCabToCounter=dict(horizon=500),
    PnPCounterToSink=dict(horizon=700),
    PnPSinkToCounter=dict(horizon=500),
    PnPCounterToMicrowave=dict(horizon=600),
    PnPMicrowaveToCounter=dict(horizon=500),
    PnPCounterToStove=dict(horizon=500),
    PnPStoveToCounter=dict(horizon=500),
    OpenSingleDoor=dict(horizon=500),
    CloseSingleDoor=dict(horizon=500),
    OpenDoubleDoor=dict(horizon=1000),
    CloseDoubleDoor=dict(horizon=700),
    OpenDrawer=dict(horizon=500),
    CloseDrawer=dict(horizon=500),
    TurnOnSinkFaucet=dict(horizon=500),
    TurnOffSinkFaucet=dict(horizon=500),
    TurnSinkSpout=dict(horizon=500),
    TurnOnStove=dict(horizon=500),
    TurnOffStove=dict(horizon=500),
    CoffeeSetupMug=dict(horizon=600),
    CoffeeServeMug=dict(horizon=600),
    CoffeePressButton=dict(horizon=300),
    TurnOnMicrowave=dict(horizon=500),
    TurnOffMicrowave=dict(horizon=500),
    NavigateKitchen=dict(horizon=500),
)

MULTI_STAGE_TASK_DATASETS = OrderedDict(
    ArrangeVegetables=dict(horizon=1200),
    MicrowaveThawing=dict(horizon=1000),
    RestockPantry=dict(horizon=1000),
    PreSoakPan=dict(horizon=1500),
    PrepareCoffee=dict(horizon=1000),
)

ALL_TASK_DATASETS = OrderedDict(
    **SINGLE_STAGE_TASK_DATASETS, **MULTI_STAGE_TASK_DATASETS
)

DATASET_BASE_ENV = "ROBOCASA_DATASET_BASE"


# public dataset release base (reference download_links; robocasa's
# v0.1 release server)
DOWNLOAD_BASE = (
    "https://utexas.box.com/shared/static"  # robocasa v0.1 hosting
)


def get_ds_url(task: str, ds_type: str = "human_im") -> str | None:
    """Download URL for a registry dataset (reference ds_info['url'],
    dataset_registry.py:352). The reference stores per-file box links;
    without network access we return the release base + expected layout
    for scripts/download_datasets.py to report."""
    return f"{DOWNLOAD_BASE}/{task}_{ds_type}.hdf5"


def get_ds_path(task: str, ds_type: str = "human_im",
                return_info: bool = False, base_path: str | None = None):
    """task + type -> hdf5 path (+ info dict). ds_type in
    {'human_raw', 'human_im', 'mg_im'} (reference get_ds_path:311-354)."""
    assert task in ALL_TASK_DATASETS, f"unknown task {task!r}"
    base = base_path or os.environ.get(DATASET_BASE_ENV, "datasets")
    fname = {
        "human_raw": "demo.hdf5",
        "human_im": "demo_gentex_im128_randcams.hdf5",
        "mg_im": "demo_gentex_im128_randcams.hdf5",
    }[ds_type]
    subdir = "mg" if ds_type == "mg_im" else "human"
    path = os.path.join(base, subdir, task, fname)
    if return_info:
        info = dict(ALL_TASK_DATASETS[task])
        info["path"] = path
        return path, info
    return path


def get_task_horizon(task: str) -> int:
    return int(ALL_TASK_DATASETS[task]["horizon"])
