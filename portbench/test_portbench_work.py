"""The yardstick's arithmetic against values worked out by hand, and the
model FLOPs against the port's dry run, each difference explained."""
import pytest

from portbench.conftest import small_cell
from portbench.harness.cell import load_cell
from portbench.work import flash_attention as fa
from portbench.work import gla_chunk as gla
from portbench.work.model_flops import forward_flops_per_token, step_flops
from portbench.work.peaks import BF16_FLOPS, HBM_BYTES

ZAMBA = "zamba2-1.2b.train_4k.b4"
PHI = "phi3.5-moe-42b-a6.6b-l2.train_4k.b16"


def test_flash_work_by_hand():
    # llama's train shape: 4 B HQ S^2 D / 2 = 4*2*24*4096^2*128/2
    key = (2, 4096, 4096, 24, 8, 128, True, "bfloat16")
    flops, nbytes = fa.work(key, "fwd")
    assert flops == 206158430208
    # q, o: 2*4096*24*128*2 bytes each; k, v: 2*4096*8*128*2 each
    assert nbytes == 2 * 50331648 + 2 * 16777216
    assert fa.least_seconds(key, "fwd") == pytest.approx(flops / BF16_FLOPS)
    bflops, bbytes = fa.work(key, "bwd")
    assert bflops == 2.5 * flops
    # q, o, dO, dq; k, v, dk, dv; and L (2*24*4096 float32)
    assert bbytes == 4 * 50331648 + 4 * 16777216 + 786432
    # chip_smoke's 5b row: the backward's bound 0.5211 ms at this shape
    assert fa.least_seconds(key, "bwd") * 1e3 == pytest.approx(0.5211,
                                                               abs=1e-4)
    # a decode-like shape is bound by bytes
    small = (4, 1, 1500, 20, 20, 64, False, "bfloat16/float32")
    f, b = fa.work(small, "fwd")
    assert b == 2 * 4 * 1 * 20 * 64 * 2 + 2 * 4 * 1500 * 20 * 64 * 4
    assert fa.least_seconds(small, "fwd") == pytest.approx(b / HBM_BYTES)


def test_flash_expected_launches():
    fwd = {(4, 4096, 4096, 32, 32, 64, True, "bfloat16"): 12,
           (1, 16, 16, 8, 8, 160, True, "bfloat16"): 3}
    bwd = {(4, 4096, 4096, 32, 32, 64, True, "bfloat16"): 6,
           (1, 64, 64, 4, 4, 64, True, "float32"): 2}
    assert fa.expected_launches(fwd, bwd) == {
        "flash_wgmma_kernel": 12, "flash_bwd_delta_kernel": 8,
        "flash_bwd_dkdv_wgmma_kernel": 6, "flash_bwd_dq_wgmma_kernel": 6,
        "flash_bwd_dkdv_kernel": 2, "flash_bwd_dq_kernel": 2}


def test_gla_work_by_hand():
    # zamba2 B4 S4096 H64 N64 P64 at the caller's chunk 64, q/k broadcast
    key = (4, 4096, 64, 64, 64, 64, "bfloat16", True)
    flops, nbytes = gla.work(key, "fwd")
    chunks = 4 * 64
    per = 2 * 64 * 64 * 64 + 64 * (2 * 64 * 64 * 64 + 4 * 64 * 64 * 64)
    assert flops == chunks * per
    qk = 2 * 4 * 4096 * 64 * 2
    v = 4 * 4096 * 64 * 64 * 4
    assert nbytes == qk + v + 4 * 4096 * 64 * 4 + v + 4 * 64 * 64 * 64 * 4
    assert gla.least_seconds(key, "fwd") == pytest.approx(nbytes / HBM_BYTES)
    bflops, bbytes = gla.work(key, "bwd")
    assert bflops == chunks * (6 * 64 ** 3 + 64 * (4 * 64 ** 3
                                                   + 10 * 64 ** 3))
    assert bbytes == 2 * qk + 3 * v + 2 * 4 * 4096 * 64 * 4 \
        + 4 * 64 * 64 * 64 * 4
    # per head, not broadcast: the score product counts H times
    per_head = key[:7] + (False,)
    assert gla.work(per_head, "fwd")[0] == chunks * 64 * (
        2 * 64 ** 3 + 2 * 64 ** 3 + 4 * 64 ** 3)


def test_gla_expected_launches():
    fwd = {(4, 4096, 64, 64, 64, 64, "bfloat16", True): 76}
    bwd = {(4, 4096, 64, 64, 64, 64, "bfloat16", True): 38,
           (2, 2048, 4, 256, 1025, 512, "bfloat16", False): 5}
    assert gla.expected_launches(fwd, bwd) == {
        "gla_kernel": 76, "gla_bwd_state_kernel": 43,
        "gla_bwd_carry_kernel": 43, "gla_bwd_tile_kernel": 43,
        "gla_bwd_dla_kernel": 43, "gla_bwd_head_sum_kernel": 38}


def test_model_flops_by_hand():
    m = load_cell(ZAMBA).model
    d, di, N, H, P, V, S = 2048, 4096, 64, 64, 64, 32000, 4096
    mamba = 2 * d * (2 * di + 2 * N + H) + 2 * di * d + 4 * N * P * H
    attn = 2 * d * (3 * 4096) + 2 * 4096 * d + 2 * S * 128 * 32
    mlp = 6 * d * 8192
    want = 2 * d * V + 38 * mamba + 6 * (attn + mlp)
    assert forward_flops_per_token(m, S) == want
    assert step_flops(m, 4, S) == 3 * want * 4 * S
    p = load_cell(PHI).model
    d, V = 4096, 32064
    attn = 2 * d * (4096 + 2 * 1024) + 2 * 4096 * d + 2 * S * 128 * 32
    layer = attn + 2 * d * 16 + 2 * 3 * 2 * d * 6400
    assert forward_flops_per_token(p, S) == 2 * d * V + 2 * layer


@pytest.mark.parametrize("name", [ZAMBA, PHI])
def test_model_flops_against_the_dry_run(name):
    """The dry run's model_flops_total is 6 N_active T, from the port's
    parameter counts.  Ours differs by exactly: the attention's quadratic
    part (6 S D HQ a token and layer; 6N leaves it out); the embedding,
    a lookup here and a 2 d V product in 6N; the scan's 4 N P H a token
    (in ours only) and the causal conv's and A, D's parameters (in 6N
    only); and zamba2's shared block, counted once in 6N and at each of
    its applications here."""
    from repro_torch.configs import get_arch
    from repro_torch.launch.dryrun import run_cell
    cell = small_cell(name, dtype="bfloat16")
    m = cell.model
    B, S = cell.traffic["batch"], cell.traffic["seq_len"]
    over = {k: v for k, v in m.items() if k in (
        "n_layers", "d_model", "n_heads", "n_kv_heads", "head_dim", "d_ff",
        "vocab_size", "ssm_state", "ssm_head_dim", "attn_every",
        "moe_experts", "moe_top_k", "moe_d_ff", "chunked_loss_chunks",
        "remat")}
    dry = run_cell(get_arch(m["name"]).name, "train_4k", False,
                   overrides=over, verbose=False, mesh_shape=(),
                   shape_overrides={"seq_len": S, "global_batch": B})
    got = dry["roofline"]["model_flops_total"]
    d, hd, hq, V = m["d_model"], m["head_dim"], m["n_heads"], \
        m["vocab_size"]
    L = m["n_layers"]
    attn = d * hq * hd + 2 * d * m["n_kv_heads"] * hd + hq * hd * d
    explained = -6 * d * V
    if m["family"] == "moe":
        explained += 6 * L * S * hd * hq
    else:
        di, N = 2 * d, m["ssm_state"]
        Hs = di // m["ssm_head_dim"]
        P = m["ssm_head_dim"]
        apps = L // m["attn_every"]
        mlp = 3 * d * m["d_ff"]
        explained += L * (12 * N * P * Hs - 6 * 4 * (di + 2 * N)
                          - 12 * Hs)
        explained += 6 * (apps - 1) * (attn + mlp) + 6 * apps * S * hd * hq
    assert step_flops(m, B, S) - got == pytest.approx(explained * B * S,
                                                      rel=1e-12)
