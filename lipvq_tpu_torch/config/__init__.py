from lipvq_tpu_torch.config.config import Config, ConfigLockError
from lipvq_tpu_torch.config.base import (
    BaseConfig,
    REGISTERED_CONFIGS,
    UNPORTED_ALGOS,
    config_factory,
    config_from_json,
)
from lipvq_tpu_torch.config.algo_configs import (
    ACTConfig,
    BCConfig,
    BCQConfig,
    CQLConfig,
    DiffusionPolicyConfig,
    GLConfig,
    HBCConfig,
    ICLConfig,
    ICLMambaConfig,
    IQLConfig,
    IRISConfig,
    TD3BCConfig,
)

__all__ = [
    "Config",
    "ConfigLockError",
    "BaseConfig",
    "REGISTERED_CONFIGS",
    "UNPORTED_ALGOS",
    "config_factory",
    "config_from_json",
    "ACTConfig",
    "BCConfig",
    "BCQConfig",
    "CQLConfig",
    "DiffusionPolicyConfig",
    "GLConfig",
    "HBCConfig",
    "ICLConfig",
    "ICLMambaConfig",
    "IQLConfig",
    "IRISConfig",
    "TD3BCConfig",
]
