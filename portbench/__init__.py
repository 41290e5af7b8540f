"""The benchmark of the PyTorch and CUDA port (``repro_torch``).

``python3 portbench/run.py --workload <cell> --seed <n> --seconds <s>
--trace <0|1>`` runs one cell on the card and prints one JSON line.
Everything here is found by name: a cell in ``workloads/<cell>.json``,
its traffic in ``traffic/<mix>.json``, its model in
``configs/<config>.json``, a per-layer metric's reader in
``metrics/<metric>.py``, a kernel's work and name table in
``work/<op>.py`` and a run's driver in ``drivers/<kind>.py``.  Nothing
here imports ``jax`` or the JAX package ``repro``; ``reference/`` imports
nothing of ``repro_torch`` either.
"""
