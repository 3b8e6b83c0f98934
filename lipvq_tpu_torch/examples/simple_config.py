"""Config system walkthrough (the port's twin of the JAX package's
``examples/simple_config.py``; counterpart of reference
examples/simple_config.py): factory defaults, json overrides, locking.

    python -m lipvq_tpu_torch.examples.simple_config
"""

from lipvq_tpu_torch.config import Config, config_factory


def main():
    config = config_factory("icl")
    print("algo:", config.algo_name)
    print("context length:", config.algo.transformer.context_length)

    # scoped value mutation on a locked config
    with config.values_unlocked():
        config.train.batch_size = 64
    print("batch size:", config.train.batch_size)

    # unknown keys error when locked
    try:
        config.train.not_a_key = 1
    except Exception as e:
        print("locked key rejected:", type(e).__name__)

    # build from scratch
    c = Config()
    c.my.nested.value = 42
    print(c.dump())


if __name__ == "__main__":
    main()
