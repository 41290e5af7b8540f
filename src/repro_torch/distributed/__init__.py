"""The distributed runtime: so far only the straggler watchdog (the mesh,
sharding and elastic restart are ROADMAP Queue 1 item 6)."""
from .fault_tolerance import StepWatchdog  # noqa: F401
