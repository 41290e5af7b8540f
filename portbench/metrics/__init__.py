"""Per-layer metrics, one reader a file: ``NAME``, ``UNIT`` and
``read(record)``, which returns the metric's value from a traced run's
record, or None where the run has nothing for it to read."""
