"""pytest settings of the benchmark's own tests: the ``cuda`` marker (as
``tests/conftest.py`` registers it), and the reduced cells the CPU tests
run."""
import copy

import pytest

from portbench.harness.cell import Cell, load_cell


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs an NVIDIA card; skips with a reason where "
        "there is none")


#: the fields the port's ``configs.reduced`` changes, per family
SMALL = {
    "hybrid": dict(n_layers=4, attn_every=2, ssm_state=16, ssm_head_dim=16,
                   n_kv_heads=4),
    "moe": dict(n_layers=2, moe_experts=4, moe_top_k=2, moe_d_ff=64,
                n_kv_heads=2),
}


def small_cell(name: str, dtype: str = "float32", batch: int = 2,
               seq_len: int = 64) -> Cell:
    """A cell of the benchmark at the port's reduced (CPU) sizes: its
    configuration's widths and depth cut as ``configs.reduced`` cuts them
    (q kept as many times d_model wide as the configuration has it),
    its traffic at `batch` rows of `seq_len`, its limits as committed."""
    c = load_cell(name)
    cfg = copy.deepcopy(c.config)
    # heads of 16 times the configuration's ratio of q's width to d_model
    wide = cfg["n_heads"] * cfg["head_dim"] // cfg["d_model"]
    cfg.update(d_model=64, n_heads=4, head_dim=16 * wide, d_ff=128,
               vocab_size=512,
               dtype=dtype, remat=False, chunked_loss_chunks=2,
               **SMALL[cfg["family"]])
    return Cell(name, c.workload, cfg,
                dict(c.traffic, batch=batch, seq_len=seq_len))


@pytest.fixture(autouse=True)
def one_thread():
    """Each test here on one intra-op thread: its tensors are small, and
    the suite runs several workers on the machine's cores at once."""
    import torch
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def cuda_card():
    """Skips the test where this machine has no CUDA card."""
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
