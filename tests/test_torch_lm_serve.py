"""The port's LM serving engine against the reference's.

The reference's ``ServeEngine`` (``repro.launch.serve``) and the port's
serve the same requests with the same weights (the reference's
``init_params`` from a PRNG key, quantized or not, crossed as numpy) on
reduced configs, with float32 caches.  Greedy tokens must be identical:
float32 logits agree to about 1e-6 relative, far inside the gaps between
the top two logits here, and the int8 GEMM operands are byte-equal.  The
traffic is the reference CLI's (16-token prompts from
``np.random.default_rng(0)``), plus staggered admission: 2 slots, three
requests of 4, 12 and 8 new tokens, where the reference's uniform step
position (``max(slot_pos)``) makes the third request's tokens differ from
serving it alone; the port keeps that behaviour and so equals the
reference in both runs.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch as r_get_arch, reduced as r_reduced
from repro.launch import serve as R
from repro.models import transformer as RT
from repro.models.quantized import quantize_params as r_quantize_params
from repro_torch import convert
from repro_torch.configs import get_arch, reduced
from repro_torch.launch import serve as S
from repro_torch.models import transformer as TT


def _setup(arch, quant, use_pallas=False):
    rcfg = r_reduced(r_get_arch(arch).model).replace(use_pallas=use_pallas)
    tcfg = convert.model_config_from_fields(dataclasses.asdict(rcfg))
    rp = RT.init_params(jax.random.PRNGKey(0), rcfg)
    if quant:
        rp = r_quantize_params(rp)
    tp = convert.lm_params_from_numpy(jax.tree.map(np.asarray, rp), "cpu")
    return rcfg, tcfg, rp, tp


def _requests(module, cfg, max_new, seed=0):
    rng = np.random.default_rng(seed)
    return [module.Request(rid=i, prompt=rng.integers(
        0, cfg.vocab_size, size=16).astype(np.int32), max_new=m)
        for i, m in enumerate(max_new)]


def _serve(rcfg, tcfg, rp, tp, max_new, slots, only=None):
    """Tokens of every request from both engines; `only` serves one of the
    requests alone."""
    out = []
    for module, cfg, params, kw in (
            (R, rcfg, rp, dict(dtype=jnp.float32)),
            (S, tcfg, tp, dict(dtype=torch.float32, torch_device="cpu"))):
        reqs = _requests(module, cfg, max_new)
        if only is not None:
            reqs = [reqs[only]]
        eng = module.ServeEngine(cfg, params, batch_slots=slots, max_len=64,
                                 **kw)
        done = eng.run(reqs)
        out.append({r.rid: r.out_tokens for r in done})
    return out


@pytest.mark.parametrize("quant", [False, True], ids=["float", "int8"])
def test_cli_traffic_tokens_equal_the_reference(quant):
    rcfg, tcfg, rp, tp = _setup("llama3.2-3b", quant)
    want, got = _serve(rcfg, tcfg, rp, tp, [16] * 6, slots=4)
    assert got == want
    assert sorted(got) == list(range(6))
    assert all(len(t) == 16 for t in got.values())


def test_tokens_equal_with_the_pallas_kernels_and_gelu():
    """starcoder2's family (layernorm, gelu, G = 2 after the cut) on int8
    weights, the reference's engine on its Pallas kernels."""
    rcfg, tcfg, rp, tp = _setup("starcoder2-7b", True, use_pallas=True)
    want, got = _serve(rcfg, tcfg, rp, tp, [6, 9, 4], slots=2)
    assert got == want


@pytest.mark.parametrize("quant", [False, True], ids=["float", "int8"])
def test_staggered_admission_keeps_the_reference_step_position(quant):
    """The reference decodes every slot at max(slot_pos): request 2,
    admitted while request 1 is further on, attends over zero cache rows
    and gives other tokens than when served alone.  The port equals the
    reference both ways."""
    rcfg, tcfg, rp, tp = _setup("llama3.2-3b", quant)
    want, got = _serve(rcfg, tcfg, rp, tp, [4, 12, 8], slots=2)
    assert got == want
    want_alone, got_alone = _serve(rcfg, tcfg, rp, tp, [4, 12, 8], slots=2,
                                   only=2)
    assert got_alone == want_alone
    assert got[2] != got_alone[2]        # the reference's behaviour
    assert got[0] == _serve(rcfg, tcfg, rp, tp, [4, 12, 8], slots=2,
                            only=0)[1][0]


def test_cli_runs_on_the_cpu(capsys):
    S.main(["--arch", "olmo-1b", "--reduced", "--device", "cpu",
            "--requests", "3", "--max-new", "4", "--slots", "2",
            "--quantized"])
    out = capsys.readouterr().out
    assert "int8 PTQ" in out and "served 3 requests, 12 tokens" in out


def test_engine_refuses_weights_on_another_device():
    _, tcfg, _, tp = _setup("olmo-1b", False)
    with pytest.raises(ValueError, match="weights on"):
        S.ServeEngine(tcfg, tp, torch_device="meta")


def test_entry_points_ask_for_the_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device exists here")
    cfg = reduced(get_arch("llama3.2-3b").model)
    with pytest.raises(RuntimeError, match="torch_device='cpu'"):
        TT.init_params(cfg, 0)
    with pytest.raises(RuntimeError, match="torch_device='cpu'"):
        TT.init_caches(cfg, 1, 8)
    params = TT.init_params(cfg, 0, torch_device="cpu")
    with pytest.raises(RuntimeError, match="torch_device='cpu'"):
        S.ServeEngine(cfg, params)
    with pytest.raises(RuntimeError, match="torch_device='cpu'"):
        convert.lm_params_from_numpy({"w": np.zeros(2, np.float32)})
    with pytest.raises(RuntimeError, match="torch_device='cpu'"):
        S.main(["--arch", "llama3.2-3b", "--reduced"])
