"""The distributed runtime: the ambient mesh, the sharding rules, int8
gradient compression, the straggler watchdog and elastic restart plans
(the data-parallel half of the reference's layer; tensor and expert
parallelism are ROADMAP Queue 1 item 6b)."""
from .fault_tolerance import (ElasticPlan, StepWatchdog,  # noqa: F401
                              plan_elastic_restart, simulate_failure)
