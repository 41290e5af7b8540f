"""The plain reference against the port's own training step on the CPU at
the reduced sizes, and its control (fp8 products in the program's place)
against the bfloat16 program."""
import pytest
import torch

from portbench.conftest import small_cell
from portbench.drivers import train as drv
from portbench.harness.cell import load_cell
from portbench.harness import compare
from portbench.harness.compare import gaps
from portbench.harness.inputs import TokenStream, make_weights
from portbench.reference.model import leaf_specs

CELLS = ["zamba2-1.2b.train_4k.b4", "phi3.5-moe-42b-a6.6b-l2.train_4k.b16"]
SEED = 2 ** 31 + 977


def readings(cell, seed, precision=None, rows=0):
    """The program's readings (precision None) or the reference's."""
    dev = torch.device("cpu")
    if precision is None:
        tr = drv.build(cell, seed, dev)
        return drv.checked_steps(tr, cell, seed, dev)
    return drv.reference_readings(cell, seed, dev, precision, rows)


@pytest.mark.parametrize("name", CELLS)
def test_leaf_specs_are_the_port_tree(name):
    """The reference's parameters are the port's, path for path, in shape
    and dtype, at the reduced size and (on meta) at the committed one."""
    from repro_torch.models.config import ModelConfig
    from repro_torch.models.transformer import init_params
    from repro_torch.tree import flatten
    for cell in (small_cell(name, "bfloat16"), load_cell(name)):
        m = cell.model
        port = flatten(init_params(ModelConfig(**m), 0, "meta").tree())
        specs = leaf_specs(m)
        assert list(specs) == list(port)
        for k, (shape, dt, _, _) in specs.items():
            assert tuple(port[k].shape) == shape, k
            assert str(port[k].dtype) == f"torch.{dt}", k


@pytest.fixture
def every_leaf(monkeypatch):
    """``grad`` over every leaf: none has BIG elements at these sizes."""
    monkeypatch.setattr(compare, "BIG", 1)


@pytest.mark.parametrize("name", CELLS)
def test_reference_follows_the_port_step(name, every_leaf):
    """float32 at the reduced size: the port's three steps and the
    reference's agree to float32 rounding in every number read.  A norm
    scale near 1 moves by about 1e-5 an element in three steps, so one
    float32 ulp (1.2e-7) on a few of its elements reads some 1e-5 in
    ``change``: its tolerance is ten times the others'."""
    cell = small_cell(name)
    found = gaps(readings(cell, SEED), readings(cell, SEED, "f32"))
    for k, (gap, at) in found.items():
        assert gap < (1e-4 if k == "change" else 1e-5), (k, gap, at)


def test_weights_and_tokens_repeat_from_the_seed():
    cell = small_cell(CELLS[1], "bfloat16")
    a = make_weights(cell.model, SEED, "cpu")
    b = make_weights(cell.model, SEED, "cpu")
    c = make_weights(cell.model, SEED + 1, "cpu")
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert not torch.equal(a["lm_head/w"], c["lm_head/w"])
    s = TokenStream(512, 64, 2, SEED)
    assert (s.batch(3)["tokens"] == TokenStream(512, 64, 2, SEED)
            .batch(3)["tokens"]).all()
    assert (s.batch(0)["tokens"] != s.batch(1)["tokens"]).any()


def test_token_stream_is_the_port_pipeline():
    """The copy of the port's synthetic mixture gives its batches."""
    from repro_torch.data import DataConfig, SyntheticLMDataset
    ours = TokenStream(32000, 128, 3, SEED)
    port = SyntheticLMDataset(DataConfig(vocab_size=32000, seq_len=128,
                                         global_batch=3, seed=SEED))
    for step in (0, 5):
        a, b = ours.batch(step), port.batch(step)
        assert all((a[k] == b[k]).all() for k in ("tokens", "targets"))


@pytest.mark.parametrize("name", CELLS)
def test_control_reads_above_the_program(name, every_leaf):
    """The control (the reference with fp8 products) in the bfloat16
    program's place reads at least 3x what the program reads, on some
    number, at every seed."""
    cell = small_cell(name, "bfloat16")
    for seed in (SEED, SEED + 1):
        ref = readings(cell, seed, "f32")
        prog = gaps(readings(cell, seed), ref)
        ctl = gaps(readings(cell, seed, "fp8"), ref)
        assert max(ctl[k][0] / max(prog[k][0], 1e-12) for k in ctl) >= 3, \
            (prog, ctl)


def test_compare_rules_by_hand():
    """grad: leaves of BIG elements or more; grad_small: the others;
    change: leaves whose reference gradient is at least a thousandth of
    the median leaf's; each gap over the larger of the leaf's and the
    median leaf's norm, the median over every leaf."""
    big = compare.BIG
    ref = {"loss": [10.0, 9.0], "size": {"a": big, "b": big, "c": 8},
           "grad": {"a": 1.0, "b": 2.0, "c": 1e-6},
           "change": {"a": 0.5, "b": 1.0, "c": 0.3}}
    prog = {"loss": [10.01, 9.0], "size": ref["size"],
            "grad": {"a": 1.1, "b": 2.0, "c": 0.5},
            "change": {"a": 0.5, "b": 0.9, "c": 0.0}}
    found = compare.gaps(prog, ref)
    assert found["loss"] == (pytest.approx(1e-3), "step 1")
    # the median of a, b, c is 1.0
    assert found["grad"] == (pytest.approx(0.1), "a")
    # c alone is small, its gap over the median leaf's norm
    assert found["grad_small"] == (pytest.approx(0.5 - 1e-6), "c")
    # c's gradient is under a thousandth of the median: left out
    assert found["change"] == (pytest.approx(0.1 / 1.0), "b")
    limits = {"grad": 0.2, "grad_small": 0.6, "change": 0.05}
    ok, checks = compare.judge(found, limits)
    assert not ok and set(checks) == set(limits)
    assert compare.judge(found, dict(limits, change=0.2))[0]
    assert not compare.judge(found, dict(limits, change=0.2,
                                         grad_small=0.4))[0]
    prog["grad"]["a"] = float("nan")
    assert compare.gaps(prog, ref)["grad"][0] == float("inf")


def test_decay_fault_and_bf16_witness():
    """The reference with the scan's log-decay gradient left out leaves
    A_log to its weight decay: ``change`` reads it there, far above what
    the reference in bfloat16 products reads."""
    cell = small_cell(CELLS[0])
    ref = readings(cell, SEED, "f32")
    dev = torch.device("cpu")
    fault = gaps(drv.reference_readings(cell, SEED, dev, decay_grad=0.0),
                 ref)
    bf16 = gaps(readings(cell, SEED, "bf16"), ref)
    assert fault["change"][1].endswith("A_log")
    assert fault["change"][0] > 10 * bf16["change"][0] > 0
