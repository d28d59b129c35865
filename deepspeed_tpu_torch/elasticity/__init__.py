"""Elastic training (port of ``deepspeed_tpu/elasticity``): the elastic
batch computation and the restart agent, host code the port keeps its own
copy of."""

from .elastic_agent import MEMBERSHIP_CHANGE_EXIT, run_elastic
from .elasticity import (
    ElasticityConfigError,
    ElasticityError,
    ElasticityIncompatibleWorldSize,
    compute_elastic_config,
    ensure_immutable_elastic_config,
)

__all__ = ["ElasticityConfigError", "ElasticityError",
           "ElasticityIncompatibleWorldSize", "MEMBERSHIP_CHANGE_EXIT",
           "compute_elastic_config", "ensure_immutable_elastic_config",
           "run_elastic"]
