"""Minimal train loop using the framework's building blocks directly (the
port's twin of the JAX package's ``examples/simple_train_loop.py``;
counterpart of reference examples/simple_train_loop.py).

Creates a synthetic robomimic-format dataset (a numpy export), builds the
flagship ICL + LipVQ-VAE model on the card (unless ``--device cpu``), and
runs a few epochs without the full train() entry point.

    python -m lipvq_tpu_torch.examples.simple_train_loop [--device cpu]
"""

import argparse
import os
import tempfile

from lipvq_tpu_torch.algo import algo_factory
from lipvq_tpu_torch.config import config_factory
from lipvq_tpu_torch.utils import obs_utils as ObsUtils
from lipvq_tpu_torch.utils import train_utils as TrainUtils
from lipvq_tpu_torch.utils.file_utils import get_shape_metadata_from_dataset
from lipvq_tpu_torch.utils.test_utils import (
    icl_test_config_overrides,
    make_synthetic_export,
)


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--device", type=str, default=None, help="cpu (default: CUDA)")
    device = parser.parse_args(argv).device

    with tempfile.TemporaryDirectory() as tmp:
        dataset_path = make_synthetic_export(
            os.path.join(tmp, "synthetic"), n_demos=8, demo_len=40
        )

        overrides = icl_test_config_overrides()
        overrides["train"]["data"] = dataset_path
        config = config_factory("icl", overrides)

        ObsUtils.initialize_obs_utils_with_config(config)
        shape_meta = get_shape_metadata_from_dataset(
            dataset_path, all_obs_keys=config.all_obs_keys
        )
        model = algo_factory(
            "icl", config,
            obs_key_shapes=shape_meta["all_shapes"],
            ac_dim=shape_meta["ac_dim"],
            device=device,
        )

        train_ds, _ = TrainUtils.load_data_for_training(
            config, obs_keys=shape_meta["all_obs_keys"]
        )
        loader, _, _ = TrainUtils.make_loaders(config, train_ds, None)

        for epoch in range(1, 4):
            log = TrainUtils.run_epoch(model, loader, epoch, num_steps=5)
            print(f"epoch {epoch}: loss={log['Loss']:.4f} "
                  f"vq={log.get('VQ_Loss', 0):.4f}")


if __name__ == "__main__":
    main()
