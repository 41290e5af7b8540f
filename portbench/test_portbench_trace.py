"""The reduction of a trace, on events made by hand: busy time as a union,
idle gaps named by the innermost open host event, the breakdown, the
rooflines and the check of the events against the launch counters."""
import pytest

from portbench.harness import roofline, trace
from portbench.metrics import device_idle_share, flash_attention_roofline, \
    gla_chunk_roofline, step_mfu
from portbench.work import flash_attention as fa
from portbench.work import gla_chunk as gla

KEY = (4, 4096, 4096, 32, 32, 64, True, "bfloat16")
GKEY = (4, 4096, 64, 64, 64, 64, "bfloat16", True)


def record():
    us = 1000
    device = [
        ("void (anonymous namespace)::flash_wgmma_kernel<64>(CUtensorMap_st,"
         " float)", 10 * us,
         40 * us),
        ("flash_bwd_delta_kernel<__nv_bfloat16>", 30 * us, 50 * us),
        ("void flash_bwd_dkdv_wgmma_kernel<64>(...)", 60 * us, 80 * us),
        ("void flash_bwd_dq_wgmma_kernel<64>(...)", 80 * us, 90 * us),
        ("Memcpy HtoD (Pageable -> Device)", 5 * us, 8 * us),
        ("ampere_bf16_s16816gemm", 100 * us, 130 * us),
        ("void gla_kernel<__nv_bfloat16, true, false>(...)", 150 * us,
         160 * us),
    ]
    host = [("aten::mm", 0, 200 * us), ("aten::item", 52 * us, 58 * us),
            ("cudaStreamSynchronize", 132 * us, 149 * us)]
    return {"device": device, "host": host, "range": (0, 200 * us),
            "counters": {"flash_attention": {"fwd": {KEY: 1},
                                             "bwd": {KEY: 1}},
                         "gla_chunk": {"fwd": {GKEY: 1}, "bwd": {}}}}


def test_kernel_id():
    assert trace.kernel_id("void flash_wgmma_kernel<64>(CUtensorMap)") \
        == "flash_wgmma_kernel"
    assert trace.kernel_id("void ns::gla_kernel<float, true>(float*)") \
        == "gla_kernel"
    assert trace.kernel_id(
        "void (anonymous namespace)::flash_wgmma_kernel<64>(CUtensorMap_st,"
        " float)") == "flash_wgmma_kernel"
    assert trace.kernel_id("(anonymous namespace)::gla_bwd_carry_kernel("
                           "float*, int)") == "gla_bwd_carry_kernel"
    assert trace.kernel_id("Memcpy HtoD (Pageable -> Device)") \
        == "Memcpy HtoD (Pageable -> Device)"


def test_busy_and_idle():
    rec = record()
    # union: 5-8, 10-50, 60-90, 100-130, 150-160 = 3+40+30+30+10 = 113 us
    assert trace.busy_seconds(rec) == pytest.approx(113e-6)
    assert trace.window_seconds(rec) == pytest.approx(200e-6)
    gaps = dict(trace.breakdown(rec)["idle_gaps"])
    # 0-5 and 8-10 and 90-100 and 160-200 under aten::mm alone; 50-60
    # under aten::item; 130-150 under cudaStreamSynchronize
    assert gaps["aten::item"] == pytest.approx(10e-6)
    assert gaps["cudaStreamSynchronize"] == pytest.approx(20e-6)
    assert gaps["aten::mm"] == pytest.approx(57e-6)
    assert sum(gaps.values()) == pytest.approx(200e-6 - 113e-6)
    ops = trace.breakdown(rec)["device_ops"]
    assert ops[0] == ["flash_wgmma_kernel", pytest.approx(30e-6)]
    assert len(ops) <= 10


def test_readers():
    rec = record()
    assert device_idle_share.read({"trace": rec}) == pytest.approx(43.5)
    assert device_idle_share.read({}) is None
    assert step_mfu.read({"window": {"steps": 10, "seconds": 2.0},
                          "model_flops_per_step": 9.89e13}) \
        == pytest.approx(50.0)
    assert step_mfu.read({"window": {"steps": 0, "seconds": 2.0},
                          "model_flops_per_step": 1.0}) is None
    least = fa.least_seconds(KEY, "fwd") + fa.least_seconds(KEY, "bwd")
    spent = (30 + 20 + 20 + 10) * 1e-6
    assert flash_attention_roofline.read({"trace": rec}) \
        == pytest.approx(100 * least / spent)
    assert gla_chunk_roofline.read({"trace": rec}) == pytest.approx(
        100 * gla.least_seconds(GKEY, "fwd") / 10e-6)
    rec["counters"]["gla_chunk"] = {"fwd": {}, "bwd": {}}
    assert gla_chunk_roofline.read({"trace": rec}) is None


def test_shortfall():
    rec = record()
    assert roofline.shortfall(rec, fa) == []
    assert roofline.shortfall(rec, gla) == []
    rec["device"] = [e for e in rec["device"]
                     if "dq_wgmma" not in e[0]]
    assert roofline.shortfall(rec, fa) == [
        ("flash_bwd_dq_wgmma_kernel", 0, 1)]


def test_work_modules_are_found_by_name():
    from portbench.harness.roofline import work_modules
    assert [w.OP for w in work_modules()] == ["flash_attention",
                                              "gla_chunk"]
