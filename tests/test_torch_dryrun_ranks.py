"""The dry run's collectives and shards against real ``gloo`` ranks, on
the CPU.

The dry run (``repro_torch.launch.dryrun.run_cell``, rank 0 of a fake
process group, in a subprocess under its own timeout) of the reduced
llama3.2-3b (tensor-parallel, with remat) and phi3.5-moe (expert-parallel,
its fused path) train cells of ``tests/test_torch_{tp,ep}.py``, at the
(data, model) meshes (1, 2) and (2, 2) they train on, B4 S32, AdamW, no
FSDP, against one real step of the same cell through ``Trainer(mesh=)``
on ``gloo`` ranks (``torch_cases.spawn_ranks``: a group of two ranks and
one of four, each under its own timeout) recorded by
``op_analysis.analyze``: the collective counts and wire bytes, by class
and by mesh axis, equal rank 0's exactly (the same step code, the same
shapes and dtypes), and the dry run's parameter and optimizer bytes
equal rank 0's ``to_local()`` bytes (the count included).
"""
import json
import os
import subprocess
import sys

import pytest

from torch_cases import ROOT, spawn_ranks

#: (mesh shape, arch) of the compared cells
CASES = [((1, 2), "llama3.2-3b"), ((1, 2), "phi3.5-moe-42b-a6.6b"),
         ((2, 2), "llama3.2-3b"), ((2, 2), "phi3.5-moe-42b-a6.6b")]
SEQ, BATCH = 32, 4

REAL = """
    import json
    from repro_torch.configs import get_arch
    from repro_torch.launch import op_analysis
    from repro_torch.launch.dryrun import _nbytes
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.launch.train import Trainer
    from torch_cases import mesh_cfg
    for shape, arch in {cases!r}:
        if shape[0] * shape[1] != WORLD:
            continue
        mesh = make_mesh(shape, ("data", "model"), device="cpu")
        tr = Trainer(mesh_cfg(arch), optimizer=get_arch(arch).optimizer,
                     seq_len={seq}, global_batch={batch}, seed=0, mesh=mesh,
                     torch_device="cpu")
        batch = tr.batch(0)
        with op_analysis.analyze(op_analysis.mesh_axes(mesh)) as st:
            tr.step_fn(tr.params, tr.opt_state, batch, 0)
        print("OUT" + json.dumps(dict(
            key=f"{{arch}} {{shape}}", counts=st.collective_counts,
            bytes=st.collective_bytes,
            counts_by_axis=st.collective_counts_by_axis,
            bytes_by_axis=st.collective_bytes_by_axis,
            param_bytes=_nbytes(tr.params),
            opt_state_bytes=_nbytes(tr.opt_state))))
"""

DRY = """
import dataclasses, json, sys
from repro_torch.launch import dryrun
from torch_cases import mesh_cfg
for shape, arch in json.loads(sys.argv[1]):
    cfg = mesh_cfg(arch)
    ov = {f.name: getattr(cfg, f.name) for f in dataclasses.fields(cfg)}
    c = dryrun.run_cell(arch, "train_4k", False, overrides=ov,
                        mesh_shape=tuple(shape), fsdp=False, verbose=False,
                        shape_overrides=dict(seq_len=%d, global_batch=%d))
    h, m = c["hlo"], c["memory"]
    print("OUT" + json.dumps(dict(
        key=f"{arch} {tuple(shape)}",
        counts=h["collective_counts"],
        bytes=h["collective_bytes_per_device"],
        counts_by_axis=h["collective_counts_by_axis"],
        bytes_by_axis=h["collective_bytes_by_axis"],
        param_bytes=m["param_bytes"],
        opt_state_bytes=m["opt_state_bytes"])))
""" % (SEQ, BATCH)


def _records(text):
    return {r["key"]: r for r in (json.loads(x[3:]) for x in
                                  text.splitlines() if x.startswith("OUT"))}


@pytest.fixture(scope="module")
def runs():
    """(dry run records, rank 0's real records), keyed "<arch> <mesh>"."""
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [str(ROOT / "src"), str(ROOT / "tests")]), OMP_NUM_THREADS="2")
    dry = subprocess.Popen([sys.executable, "-c", DRY, json.dumps(CASES)],
                           env=env, cwd=str(ROOT), stdout=subprocess.PIPE,
                           stderr=subprocess.PIPE, text=True)
    try:
        body = REAL.format(cases=CASES, seq=SEQ, batch=BATCH)
        real = {}
        for world in (2, 4):
            real.update(_records(spawn_ranks(body, world, timeout=150)[0]))
        out, err = dry.communicate(timeout=120)
        assert dry.returncode == 0, err[-3000:]
    finally:
        if dry.poll() is None:
            dry.kill()
            dry.wait()
    return _records(out), real


@pytest.mark.parametrize("case", CASES, ids=lambda c: f"{c[1]}-{c[0]}")
def test_collectives_equal_a_real_step(runs, case):
    dry, real = runs
    key = f"{case[1]} {tuple(case[0])}"
    d, r = dry[key], real[key]
    assert sum(r["counts"].values()) > 0
    for k in ("counts", "bytes", "counts_by_axis", "bytes_by_axis"):
        assert d[k] == r[k], (k, d[k], r[k])


@pytest.mark.parametrize("case", CASES, ids=lambda c: f"{c[1]}-{c[0]}")
def test_shard_bytes_equal_the_real_ranks(runs, case):
    dry, real = runs
    key = f"{case[1]} {tuple(case[0])}"
    for k in ("param_bytes", "opt_state_bytes"):
        assert dry[key][k] == real[key][k], k
