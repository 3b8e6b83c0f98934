"""Algorithm registry — importing this package registers the ported algorithms."""

from lipvq_tpu_torch.algo.base import (
    Algo,
    PolicyAlgo,
    algo_factory,
    register_algo_factory_func,
    resolve_device,
)
import lipvq_tpu_torch.algo.icl  # noqa: F401  (registers icl)

__all__ = [
    "Algo",
    "PolicyAlgo",
    "algo_factory",
    "register_algo_factory_func",
    "resolve_device",
]
