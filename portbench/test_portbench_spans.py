"""The spans' rule (``harness/spans.py``) on events made by hand, and the
program's spans under the CPU profiler in a reduced zamba2 step."""
import pytest

from portbench.harness import spans as S
from portbench.harness.spans import Event

MAIN, BWD = 1, 2      # the profiler's ids of the main and autograd threads


def op(name, a, b, thread=MAIN, corr=0, **kw):
    return Event(name, a, b, "cpu_op", thread, corr, **kw)


def launch(corr, op_corr, a, b):
    """A runtime call (on the system's thread id) and its kernel, later."""
    return [Event("cudaLaunchKernel", a, b, "runtime", 9999, corr, op_corr),
            Event(f"kernel_{corr}", 1000 + a, 1000 + b, "device", 0, corr,
                  op_corr)]


def forward_and_backward():
    """One step's spans on two threads: the forward of a Mamba2 block on
    the main thread, its backward on the autograd thread with the block's
    recompute inside a node, an engine sum outside any node."""
    return [
        op("train.forward", 0, 100, corr=1),
        op("block", 10, 90, corr=2),
        op("mamba2", 20, 80, corr=3),
        op("aten::mul", 30, 40, corr=4, seq=7),
        op("mamba2.out_proj", 50, 70, corr=5),
        op("aten::mm", 55, 65, corr=6, seq=8),
        op("train.backward", 200, 400, corr=10),
        # the out_proj's backward: its recompute opens the block again
        op("MmBackward0", 210, 300, BWD, 11, seq=8, fwd_thread=MAIN,
           scope=S.BACKWARD_FUNCTION),
        op("block", 215, 260, BWD, 12),
        op("mamba2", 220, 255, BWD, 13),
        op("mamba2.in_proj", 225, 235, BWD, 14),
        op("aten::mm", 226, 234, BWD, 15),
        op("aten::mul", 240, 245, BWD, 16),
        op("aten::mm", 270, 290, BWD, 17),
        # the gate's backward: no span opens inside it
        op("MulBackward0", 310, 330, BWD, 18, seq=7, fwd_thread=MAIN,
           scope=S.BACKWARD_FUNCTION),
        op("aten::mul", 312, 328, BWD, 19),
        # the engine's evaluation of a node: a sum of the node's gradient
        # outside the node's own op
        op(S.EVALUATE + "MulBackward0", 335, 360, BWD, 21, seq=7,
           fwd_thread=MAIN),
        op("MulBackward0", 336, 340, BWD, 22, seq=7, fwd_thread=MAIN,
           scope=S.BACKWARD_FUNCTION),
        op("aten::add", 345, 350, BWD, 23),
        # the engine's own work between nodes
        op("aten::add", 370, 380, BWD, 20),
    ]


def paths(events):
    at = S.Attribution(events)
    return {d.name: at.path(*at.anchor(d)) if at.anchor(d) else
            S.UNATTRIBUTED for d in events if d.kind == "device"}


def test_forward_launches_on_two_threads():
    ev = forward_and_backward() + [op("train.batch", 500, 600, 3, 30),
                                   op("aten::copy_", 510, 520, 3, 31)]
    ev += launch(101, 4, 32, 33) + launch(102, 6, 56, 57) \
        + launch(103, 31, 511, 512)
    p = paths(ev)
    assert p["kernel_101"] == "train.forward/block/mamba2"
    assert p["kernel_102"] == "train.forward/block/mamba2/mamba2.out_proj"
    assert p["kernel_103"] == "train.batch"


def test_backward_node_takes_its_forward_ops_path():
    ev = forward_and_backward() + launch(104, 19, 313, 314)
    assert paths(ev)["kernel_104"] == "train.backward/block/mamba2"
    # the node's own op when the kernel links to nothing inside it
    ev = forward_and_backward() + launch(105, 18, 320, 321)
    assert paths(ev)["kernel_105"] == "train.backward/block/mamba2"


def test_recompute_spans_opened_inside_a_node():
    ev = forward_and_backward() + launch(106, 15, 227, 228) \
        + launch(107, 16, 241, 242) + launch(108, 17, 271, 272)
    p = paths(ev)
    assert p["kernel_106"] == "train.backward/block/mamba2/mamba2.in_proj"
    assert p["kernel_107"] == "train.backward/block/mamba2"
    # after the recompute, the node's own product: out_proj's backward
    assert p["kernel_108"] == \
        "train.backward/block/mamba2/mamba2.out_proj"


def test_an_ops_backward_span_joins_its_forward_path():
    ev = [op("train.forward", 0, 100, corr=1),
          op("mamba2", 10, 90, corr=2),
          op("gla_chunk", 20, 80, corr=3),
          op("_GlaChunk", 25, 75, corr=4, seq=3),
          op("train.backward", 200, 300, corr=5),
          op("_GlaChunkBackward", 210, 290, BWD, 6, seq=3,
             fwd_thread=MAIN, scope=S.BACKWARD_FUNCTION),
          op("gla_chunk", 215, 285, BWD, 7)]
    ev += launch(109, 7, 220, 221)
    assert paths(ev)["kernel_109"] == "train.backward/mamba2/gla_chunk"


def test_engine_sums_take_their_nodes_path_or_the_backward_phase():
    ev = forward_and_backward() + launch(110, 20, 371, 372) \
        + launch(113, 23, 346, 347)
    p = paths(ev)
    assert p["kernel_110"] == "train.backward"
    assert p["kernel_113"] == "train.backward/block/mamba2"


def test_unlinked_kernel_is_unattributed():
    ev = forward_and_backward() + [
        Event("kernel_111", 1500, 1600, "device", 0, 111, 0)]
    assert paths(ev)["kernel_111"] == S.UNATTRIBUTED
    # a runtime call tied to no op, at a time no span holds
    ev = forward_and_backward() + [
        Event("cudaMemcpyAsync", 450, 460, "runtime", 9999, 112, 0),
        Event("kernel_112", 1500, 1600, "device", 0, 112, 0)]
    assert paths(ev)["kernel_112"] == S.UNATTRIBUTED


def test_record_sums_paths_and_the_input_gap():
    us = 1000
    ev = [op("train.batch", 0, 20 * us, corr=1),
          op("aten::copy_", 15 * us, 19 * us, corr=2),
          op("train.forward", 20 * us, 60 * us, corr=3),
          op("mlp", 25 * us, 50 * us, corr=4),
          op("aten::mm", 26 * us, 27 * us, corr=5),
          Event("cudaMemcpyAsync", 16 * us, 17 * us, "runtime", 9, 50, 2),
          Event("Memcpy HtoD", 18 * us, 22 * us, "device", 0, 50, 2),
          Event("cudaLaunchKernel", 26 * us, 27 * us, "runtime", 9, 51, 5),
          Event("gemm", 30 * us, 50 * us, "device", 0, 51, 5),
          Event("portbench.profiled", 0, 60 * us, "device", 0, 52, 0)]
    rec = S.record(ev, (0, 60 * us), exclude=("portbench.profiled",))
    assert rec["steps"] == 1
    assert rec["device_s"] == {"train.batch": pytest.approx(4e-6),
                               "train.forward/mlp": pytest.approx(20e-6)}
    # gaps: 0-18 us under train.batch, 22-30 and 50-60 us under forward
    assert rec["input_idle_s"] == pytest.approx(18e-6)
    assert rec["idle_s"] == {"train.batch": pytest.approx(18e-6),
                             "train.forward/mlp": pytest.approx(8e-6),
                             "train.forward": pytest.approx(10e-6)}
    assert S.per_step_ms(rec, "mlp_ms") == pytest.approx(20e-3)
    assert S.per_step_ms(rec, "input_idle_ms") == pytest.approx(18e-3)
    assert S.attributed_share(rec) == 1.0


def test_metrics_sum_their_paths():
    rec = {"steps": 2, "input_idle_s": 0.0, "device_s": {
        "train.forward/block/mamba2": 1.0,
        "train.backward/block/mamba2/gla_chunk": 2.0,
        "train.forward/block/mamba2/mamba2.in_proj": 4.0,
        "train.backward/block/attention/flash_attention": 8.0,
        "train.forward/block/mlp": 16.0,
        "train.backward/loss": 32.0,
        "train.clip": 64.0, "train.optimizer": 128.0,
        "train.backward": 256.0, S.UNATTRIBUTED: 512.0}}
    ms = {n: S.per_step_ms(rec, n) for n in S.SUMS}
    assert ms == {"mamba2_ms": 3500.0, "mamba2_pointwise_ms": 500.0,
                  "attention_ms": 4000.0, "mlp_ms": 8000.0,
                  "loss_ms": 16000.0, "optimizer_ms": 96000.0}
    assert S.attributed_share(rec) == pytest.approx(511 / 1023)


@pytest.mark.parametrize("name", sorted(S.SUMS) + ["input_idle_ms"])
def test_metrics_read_nothing_without_spans(name):
    assert S.per_step_ms(None, name) is None
    assert S.per_step_ms({}, name) is None
    assert S.per_step_ms({"steps": 0, "device_s": {}, "input_idle_s": 0},
                         name) is None


def test_program_spans_under_the_cpu_profiler():
    """A reduced zamba2 step, remat on: every span is a CPU op and never
    a user annotation; each Mamba2 layer's span opens twice (forward and
    recompute); every aten op of the step's phases has a path headed by
    its phase, and every aten op inside a backward node a layer too, but
    for the nodes of the forward's few ops outside every layer."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.configs import get_arch, reduced
    from repro_torch.launch.train import Trainer
    cfg = reduced(get_arch("zamba2-1.2b").model).replace(remat=True)
    tr = Trainer(cfg, seq_len=32, global_batch=2, torch_device="cpu")
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        tr.train(1, log_every=10 ** 9)
    kineto = list(prof.profiler.kineto_results.events())
    assert not [e.name() for e in kineto
                if e.name() in S.SPANS and e.is_user_annotation()]
    ev = S.events_of(kineto)
    seen = {e.name for e in ev if e.kind == "cpu_op"}
    assert set(S.SPANS) <= seen
    n_mamba = cfg.block_pattern().count("mamba2") \
        + cfg.block_pattern().count("mamba2_sharedattn")
    assert sum(e.name == "mamba2" for e in ev) == 2 * n_mamba

    at = S.Attribution(ev)
    phases = ("train.forward", "train.backward", "train.clip",
              "train.optimizer")
    main = {e.thread for e in ev if e.name == "train.forward"}
    nodes = [n for nest in at.nodes.values() for n in nest.evs]
    assert sum(n.scope == S.BACKWARD_FUNCTION for n in nodes) > 100
    spanless = {}
    for n in nodes:
        f = at.forward[(n.fwd_thread, n.seq)]
        if "/" not in at.path(f.thread, f.start, f.end):
            spanless[n] = f.name
    # the stacked leaves' unbind (forward_hidden) and the aux loss's sum
    assert {(n.name.replace(S.EVALUATE, ""), f)
            for n, f in spanless.items()} <= {
        ("UnbindBackward0", "aten::unbind"), ("AddBackward0", "aten::add")}
    checked = 0
    for e in ev:
        if not e.name.startswith("aten::") or e.thread not in main:
            continue
        inside = [s.name for s in at.spans[e.thread].chain(e.start, e.end)
                  if s.name in phases]
        if not inside:
            continue
        p = at.path(e.thread, e.start, e.end).split("/")
        assert p[0] == inside[0], (e, p)
        k = at.nodes[e.thread].innermost(e.start, e.end) \
            if e.thread in at.nodes else -1
        if k >= 0 and at.nodes[e.thread].evs[k] not in spanless:
            assert set(p) & set(S.LAYERS), (e, p)
        checked += 1
    assert checked > 1000
    assert torch.isfinite(torch.tensor(tr.train(1, 10 ** 9)["loss"]))


def test_train_spans_tool_rehearses_on_the_cpu():
    """``tools/train_spans.py --device cpu`` runs a reduced cell through
    its whole flow, in a process of its own: spans read, no device
    events, the collector's spans counted."""
    import json
    import subprocess
    import sys

    from portbench.harness.cell import ROOT
    p = subprocess.run(
        [sys.executable, str(ROOT.parent / "tools" / "train_spans.py"),
         "--workload", "zamba2-1.2b.train_4k.b4", "--seed", "2147483901",
         "--device", "cpu", "--timed", "1", "--steps", "1"],
        cwd=ROOT.parent, capture_output=True, text=True, timeout=300,
        env={"PATH": "/usr/bin:/bin", "OMP_NUM_THREADS": "1",
             "PYTHONPATH": f"{ROOT.parent / 'src'}:{ROOT.parent}"})
    assert p.returncode == 0, p.stderr[-3000:]
    out = json.loads(p.stdout.strip().splitlines()[-1])
    assert out["steps"] == 1 and out["device"] == "cpu"
    assert out["device_s"] == {} and out["checks"]["device_events"] == 0
    assert out["checks"]["span_kinds"] == ["cpu_op"]
    assert set(out["metrics"]) == set(S.SUMS) | {"input_idle_ms"}
