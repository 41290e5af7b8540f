"""A whole run of the training driver on the CPU at the reduced sizes
(everything but the look for a card and the trace), sound and with the
timed path broken underneath: ``correct`` is true for the sound program
and false for each fault a training cell on one card can have."""
import pytest

from portbench.conftest import small_cell
from portbench.drivers import train as drv

#: the cells of BENCHMARK.json
CELLS = ["zamba2-1.2b.train_4k.b4"]
SEED = 2 ** 31 + 4099


def run(cell):
    return drv.run(cell, SEED, 0.05, False, lambda: 1.0, device="cpu")


@pytest.mark.parametrize("name", CELLS)
def test_sound_run_is_correct(name):
    r = run(small_cell(name))
    assert r["correct"], r["checks"]
    assert r["attempted"] >= 1 and r["failed"] == 0
    assert set(r["metrics"]) == {"train_tokens_per_s", "peak_alloc_gb",
                                 "setup_s"}


@pytest.mark.parametrize("name", CELLS)
def test_state_left_unchanged_is_caught(name, monkeypatch):
    """A step that returns its parameters and moments as it found them."""
    import repro_torch.launch.train as lt
    real = lt.make_optimizer

    def frozen(opt):
        init, _ = real(opt)
        return init, lambda grads, state, params, **kw: (params, state)
    monkeypatch.setattr(lt, "make_optimizer", frozen)
    r = run(small_cell(name))
    assert not r["correct"]
    assert r["checks"]["change"]["value"] == pytest.approx(1.0)


@pytest.mark.parametrize("name", CELLS)
def test_half_batch_is_caught(name, monkeypatch):
    """A step that takes half of the batch's rows, the mean over them."""
    import repro_torch.models.transformer as T
    real = T.forward_train

    def half(params, cfg, batch):
        n = batch["tokens"].shape[0] // 2
        return real(params, cfg, {k: v[:n] for k, v in batch.items()})
    monkeypatch.setattr(T, "forward_train", half)
    r = run(small_cell(name, batch=4))
    assert not r["correct"], r["checks"]
