"""device_idle_share: one minus the union of the device's intervals over
the traced range, in percent.  Layer: the device."""
from ..harness.trace import busy_seconds, window_seconds

NAME = "device_idle_share"
UNIT = "%"


def read(rec: dict):
    tr = rec.get("trace")
    if not tr:
        return None
    return 100.0 * (1.0 - busy_seconds(tr) / window_seconds(tr))
