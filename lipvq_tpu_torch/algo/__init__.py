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
import lipvq_tpu_torch.algo.bcq  # noqa: F401  (registers bcq)
import lipvq_tpu_torch.algo.cql  # noqa: F401  (registers cql)
import lipvq_tpu_torch.algo.diffusion_policy  # noqa: F401  (registers diffusion_policy)
import lipvq_tpu_torch.algo.gl  # noqa: F401  (registers gl)
import lipvq_tpu_torch.algo.hbc  # noqa: F401  (registers hbc and iris)
import lipvq_tpu_torch.algo.icl  # noqa: F401  (registers icl and icl_mamba)
import lipvq_tpu_torch.algo.iql  # noqa: F401  (registers iql)
import lipvq_tpu_torch.algo.mcr  # noqa: F401  (registers mcr)
import lipvq_tpu_torch.algo.td3_bc  # noqa: F401  (registers td3_bc)

__all__ = [
    "Algo",
    "PolicyAlgo",
    "algo_factory",
    "register_algo_factory_func",
    "resolve_device",
]
