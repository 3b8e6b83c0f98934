"""Train a BC-RNN-GMM policy programmatically (the port's twin of the JAX
package's ``examples/train_bc_rnn.py``; counterpart of reference
examples/train_bc_rnn.py), on the card unless ``--device cpu``.

    python -m lipvq_tpu_torch.examples.train_bc_rnn [--device cpu]
"""

import argparse
import os
import tempfile

from lipvq_tpu_torch.algo import algo_factory
from lipvq_tpu_torch.config import config_factory
from lipvq_tpu_torch.utils import obs_utils as ObsUtils
from lipvq_tpu_torch.utils import train_utils as TrainUtils
from lipvq_tpu_torch.utils.file_utils import get_shape_metadata_from_dataset
from lipvq_tpu_torch.utils.test_utils import make_synthetic_export


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--device", type=str, default=None, help="cpu (default: CUDA)")
    device = parser.parse_args(argv).device

    with tempfile.TemporaryDirectory() as tmp:
        dataset_path = make_synthetic_export(
            os.path.join(tmp, "synthetic"), n_demos=8, demo_len=40
        )
        config = config_factory("bc", {
            "train": {
                "data": dataset_path, "batch_size": 16,
                "seq_length": 10, "hdf5_load_next_obs": False,
            },
            "algo": {
                "gmm": {"enabled": True},
                "rnn": {"enabled": True, "hidden_dim": 128, "num_layers": 2,
                        "horizon": 10},
            },
            "observation": {"modalities": {"obs": {"low_dim": [
                "robot0_eef_pos", "robot0_eef_quat", "robot0_gripper_qpos",
                "object",
            ]}}},
        })
        ObsUtils.initialize_obs_utils_with_config(config)
        shape_meta = get_shape_metadata_from_dataset(
            dataset_path, all_obs_keys=config.all_obs_keys
        )
        model = algo_factory(
            "bc", config, obs_key_shapes=shape_meta["all_shapes"],
            ac_dim=shape_meta["ac_dim"], device=device,
        )
        train_ds, _ = TrainUtils.load_data_for_training(
            config, obs_keys=shape_meta["all_obs_keys"]
        )
        loader, _, _ = TrainUtils.make_loaders(config, train_ds, None)
        for epoch in range(1, 4):
            log = TrainUtils.run_epoch(model, loader, epoch, num_steps=5)
            print(f"epoch {epoch}: loss={log['Loss']:.4f}")

        obs = {k: train_ds[0]["obs"][k][None] for k in shape_meta["all_obs_keys"]}
        action = model.get_action(obs)
        print("rollout action:", action.shape)


if __name__ == "__main__":
    main()
