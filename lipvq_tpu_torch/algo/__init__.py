"""Algorithm registry — importing this package registers the ported algorithms."""

from lipvq_tpu_torch.algo.base import (
    Algo,
    PolicyAlgo,
    algo_factory,
    register_algo_factory_func,
    resolve_device,
)
import lipvq_tpu_torch.algo.act  # noqa: F401  (registers act)
import lipvq_tpu_torch.algo.bc  # noqa: F401  (registers bc)
import lipvq_tpu_torch.algo.diffusion_policy  # noqa: F401  (registers diffusion_policy)
import lipvq_tpu_torch.algo.icl  # noqa: F401  (registers icl and icl_mamba)

__all__ = [
    "Algo",
    "PolicyAlgo",
    "algo_factory",
    "register_algo_factory_func",
    "resolve_device",
]
