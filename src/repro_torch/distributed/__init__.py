"""The distributed runtime: the ambient mesh and the collectives the
layers run over its axes (tensor and expert parallelism), the sharding
rules, int8 gradient compression, the straggler watchdog and elastic
restart plans."""
from .fault_tolerance import (ElasticPlan, StepWatchdog,  # noqa: F401
                              plan_elastic_restart, simulate_failure)
