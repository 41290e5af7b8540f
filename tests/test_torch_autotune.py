"""The port's design-space autotuner and tuning cache against the
reference's (paper §4).

Stage 1 of the search (the sampled candidates, each candidate's replayed
cycles and the ranking) is a host computation on the same TimingModel,
so it must equal the reference's exactly; so must ``spec_key``,
``enumerate_candidates`` and ``op_signature``.  One TuningCache file,
written by either package, must steer both packages' ``Program.compile``
to the same lowering decisions, the same encoded streams and the same
``tune_hits`` / ``tune_misses``.  Stage 2 validates candidates on both
engines (the reference's numpy simulator against Pallas in interpret
mode; the port's against the CUDA engine's plain versions on CPU
tensors): every candidate validated there must validate here.  No test
ranks by wall time.  The reference's own tests
(``tests/test_autotune.py``) are ported below it.
"""
import os
import subprocess
import sys
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest

from repro.core import autotune as RA
from repro.core import hwspec as rhw
from repro.core.conv import ConvShape as RConvShape
from repro.core.program import Program as RProgram
from repro.core.program import op_signature as r_op_signature
from repro.core.scheduler import Epilogue as REpilogue
from repro_torch.core import autotune, hwspec
from repro_torch.core.autotune import (Candidate, TuningRecord,
                                       ValidationError, enumerate_candidates,
                                       matmul_workload, oracle_stage,
                                       predict_program_cycles, rank_trials,
                                       search, spec_key, validate_candidate)
from repro_torch.core.compiler import AccelStep
from repro_torch.core.conv import (ConvShape, cheapest_conv_lowering,
                                   conv2d_reference, predict_conv_cycles,
                                   select_conv_lowering)
from repro_torch.core.isa import IsaLayout
from repro_torch.core.program import Program, op_signature
from repro_torch.core.scheduler import Epilogue, matmul_reference
from repro_torch.core.simulator import TimingModel, replay_timing

ROOT = Path(__file__).resolve().parents[1]
CPU = dict(torch_device="cpu", dram_size=1 << 22)


@pytest.fixture(autouse=True)
def _pristine_global_caches():
    """Snapshot + clear both packages' process-wide TuningCache around
    every test: records put here never leak into other test files (the
    golden-stream tests assert exact hit/miss counts)."""
    snaps = []
    for gc in (RA.global_cache(), autotune.global_cache()):
        snaps.append((gc, dict(gc.entries), gc.hits, gc.misses))
        gc.clear()
    yield
    for gc, entries, hits, misses in snaps:
        gc.entries, gc.hits, gc.misses = entries, hits, misses


def _spec_pairs():
    """(reference spec, port spec) with the same fields."""
    out = []
    for name in ("pynq", "pynq_batch2", "calibrated", "tpu_like"):
        out.append((getattr(rhw, name)(), getattr(hwspec, name)()))
    out.append((rhw.lowbit(4), hwspec.lowbit(4)))
    out.append((rhw.pynq().replace(block_in=8, block_out=32,
                                   acc_buff_bytes=64 * 1024),
                hwspec.pynq().replace(block_in=8, block_out=32,
                                      acc_buff_bytes=64 * 1024)))
    return out


# ----------------------------------------------------------------------
# the keys and the candidate grid equal the reference's
# ----------------------------------------------------------------------
@pytest.mark.parametrize("i", range(6))
def test_spec_key_equals_the_reference(i):
    r, t = _spec_pairs()[i]
    assert spec_key(t) == RA.spec_key(r)


GRIDS = {
    "default": {},
    "no_sram_splits": dict(sram_splits=False),
    "tile_shapes": dict(tile_shapes=[(1, 16, 32), (2, 8, 8), (1, 16, 16)]),
    "tiles_no_splits": dict(tile_shapes=[(1, 32, 32), (2, 16, 8)],
                            sram_splits=False),
    "vts_lowerings": dict(vts=(1, 2, 4), lowerings=(None, "direct",
                                                    "im2col")),
}


@pytest.mark.parametrize("base", ["pynq", "calibrated"])
@pytest.mark.parametrize("grid", sorted(GRIDS))
def test_enumerate_candidates_equals_the_reference(grid, base):
    """Label for label and in order, with and without sram_splits and
    tile_shapes; candidate 0 is the base configuration."""
    kw = GRIDS[grid]
    want = RA.enumerate_candidates(getattr(rhw, base)(), **kw)
    got = enumerate_candidates(getattr(hwspec, base)(), **kw)
    assert [c.label() for c in got] == [c.label() for c in want]
    assert [(c.virtual_threads, c.lowering) for c in got] \
        == [(c.virtual_threads, c.lowering) for c in want]
    assert [spec_key(c.spec) for c in got] \
        == [RA.spec_key(c.spec) for c in want]
    assert got[0] == Candidate(getattr(hwspec, base)(), 2, None)


def _bench_workloads(pkg, shape_cls, seed=0):
    """The two workloads of benchmarks/BENCH_autotune.json."""
    return [pkg.conv_workload(shape_cls(n=1, h=14, w=14, ic=32, oc=32,
                                        kh=3, kw=3, stride=1, pad=1),
                              seed=seed),
            pkg.matmul_workload(64, 128, 128, seed=seed)]


def _stage1(res):
    return [(t.candidate.label(), t.predicted_cycles, t.predicted_s, t.error)
            for t in res.trials]


def _ranking(res):
    ok = sorted((t for t in res.trials[1:] if t.error is None),
                key=lambda t: (t.predicted_cycles, t.candidate.label()))
    return [t.candidate.label() for t in ok]


@pytest.mark.parametrize("which", [0, 1], ids=["conv", "matmul"])
def test_seeded_search_stage1_equals_the_reference(which):
    """BENCH_autotune.json's workloads at seed 0 (12 of 352 candidates in
    the bench; 8 here, top 2): the sampled candidates, the predicted
    cycles (exact), the ranking and the stage-2 set equal the
    reference's; every stage-2 candidate validates in both."""
    rw = _bench_workloads(RA, RConvShape)[which]
    tw = _bench_workloads(autotune, ConvShape)[which]
    assert tw.name == rw.name
    kw = dict(seed=0, n_candidates=8, top_n=2, repeats=1)
    want = RA.search(rw, cache=RA.TuningCache(), **kw)
    got = search(tw, cache=autotune.TuningCache(), backend="cuda", **CPU,
                 **kw)
    assert got.candidates_total == want.candidates_total == 352
    assert _stage1(got) == _stage1(want)
    assert _ranking(got) == _ranking(want)
    stage2 = [t.candidate.label() for t in got.trials
              if t.validated is not None]
    assert stage2 == [t.candidate.label() for t in want.trials
                      if t.validated is not None]
    assert len(stage2) == 3
    assert all(t.validated for t in got.trials if t.validated is not None)
    assert all(t.validated for t in want.trials if t.validated is not None)
    assert got.winner is not None and got.winner.validated
    assert got.records_written == 1 and got.speedup_predicted is not None
    # stage 1 alone, as chip_smoke.py computes it on CPU tensors
    trials, arts, total = oracle_stage(tw, seed=0, n_candidates=8, **CPU)
    assert total == 352 and len(arts) == len(trials)
    assert _stage1(SimpleNamespace(trials=trials)) == _stage1(want)
    assert [t.candidate.label() for t in rank_trials(trials)] \
        == _ranking(want)


# ----------------------------------------------------------------------
# one cache file steers both packages' compiles alike
# ----------------------------------------------------------------------
CONV = dict(n=1, h=8, w=8, ic=16, oc=16, kh=3, kw=3, stride=1, pad=1)


def _graphs(kind):
    """The same graph built in both packages: (reference, port)."""
    out = []
    for prog_cls, spec, shape_cls, ep_cls in (
            (RProgram, rhw.pynq(), RConvShape, REpilogue),
            (Program, hwspec.pynq(), ConvShape, Epilogue)):
        p = prog_cls(spec)
        if kind == "conv":
            s = shape_cls(**CONV)
            p.conv2d(p.input("x", (s.n, s.ic, s.h, s.w)),
                     p.input("k", (s.oc, s.ic, s.kh, s.kw)), s,
                     epilogue=ep_cls(shift=5, relu=True), name="y")
        else:
            h = p.matmul(p.input("a", (32, 64)), p.input("w", (64, 64)),
                         epilogue=ep_cls(shift=7, relu=True))
            s = shape_cls(**CONV)
            p.conv2d(p.input("x", (s.n, s.ic, s.h, s.w)),
                     p.input("k", (s.oc, s.ic, s.kh, s.kw)), s,
                     epilogue=ep_cls(shift=5), name="y")
            p.output(h)
        out.append(p)
    return out


def _compiled_view(c):
    return dict(
        lowerings=[n.lowering for n in c.nodes if n.op == "conv2d"],
        tune=(c.tune_hits, c.tune_misses),
        streams=[np.asarray(s.stream).tobytes() for s in c.accel_steps],
        insns=c.insn_count)


def _record_for(pkg, lowering):
    return pkg.TuningRecord(lowering=lowering, virtual_threads=2,
                            gang_width=2, window_us=100.0,
                            predicted_cycles=1.0, measured_s=0.5,
                            validated=True)


@pytest.mark.parametrize("kind", ["conv", "matmul_conv"])
@pytest.mark.parametrize("writer", ["reference", "port"])
def test_one_cache_file_steers_both_compiles_alike(writer, kind, tmp_path):
    """A record forcing the other conv lowering (and one for the matmul
    node) is saved by one package and loaded into both global caches:
    both compiles make the same decisions, the same stream bytes and the
    same hit/miss counts, and differ from the compile without it."""
    rp, tp = _graphs("conv" if kind == "conv" else "matmul_conv")
    miss_r = rp.compile(use_cache=False)
    miss_t = tp.compile(use_cache=False, **CPU)
    assert _compiled_view(miss_t) == _compiled_view(miss_r)
    n_ops = sum(1 for n in rp.nodes if n.op in ("conv2d", "matmul"))
    assert (miss_t.tune_hits, miss_t.tune_misses) == (0, n_ops)

    picked = _compiled_view(miss_r)["lowerings"][0]
    other = "im2col" if picked == "direct" else "direct"
    pkg, prog, mod_sig = ((RA, rp, r_op_signature) if writer == "reference"
                          else (autotune, tp, op_signature))
    cache = pkg.TuningCache()
    for n in prog.nodes:
        if n.op in ("conv2d", "matmul"):
            cache.put(prog.spec, mod_sig(prog, n), _record_for(
                pkg, other if n.op == "conv2d" else None))
    path = tmp_path / "tune.json"
    cache.save(str(path))
    assert RA.global_cache().load(str(path)) == n_ops
    assert autotune.global_cache().load(str(path)) == n_ops
    assert autotune.global_cache().entries == {
        k: TuningRecord(**vars(v))
        for k, v in RA.global_cache().entries.items()}

    hit_r = rp.compile(use_cache=False)
    hit_t = tp.compile(use_cache=False, **CPU)
    assert _compiled_view(hit_t) == _compiled_view(hit_r)
    assert (hit_t.tune_hits, hit_t.tune_misses) == (n_ops, 0)
    assert _compiled_view(hit_t)["lowerings"] == [other]
    assert hit_t.insn_count != miss_t.insn_count
    assert f"tune {n_ops} hit/0 miss" in hit_t.describe()


def test_op_signatures_equal_the_reference():
    rp, tp = _graphs("matmul_conv")
    want = [r_op_signature(rp, n) for n in rp.nodes]
    assert [op_signature(tp, n) for n in tp.nodes] == want
    assert any(s.startswith("matmul:m32.k64.n64:ep") for s in want)


def test_the_environment_variable_loads_one_file_into_both(tmp_path):
    """REPRO_TUNE_CACHE=path fills both packages' global caches at
    import, so one file steers both."""
    cache = autotune.TuningCache()
    cache.put(hwspec.pynq(), "matmul:m8.k16.n16:ep0:vt2",
              TuningRecord(virtual_threads=1, validated=True))
    path = tmp_path / "tune.json"
    cache.save(str(path))
    code = ("from repro.core import autotune as a; "
            "from repro_torch.core import autotune as b; "
            "print(len(a.global_cache()), len(b.global_cache()), "
            "a.global_cache().entries == {k: a.TuningRecord(**vars(v)) "
            "for k, v in b.global_cache().entries.items()})")
    env = dict(os.environ, REPRO_TUNE_CACHE=str(path), JAX_PLATFORMS="cpu",
               PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.split() == ["1", "1", "True"]


# ----------------------------------------------------------------------
# the reference's tests (tests/test_autotune.py), ported
# ----------------------------------------------------------------------
def test_enumerate_candidates_feasible_and_deterministic():
    base = hwspec.pynq()
    grid = enumerate_candidates(base)
    assert grid[0] == Candidate(base, 2, None)       # baseline is always #0
    assert grid == enumerate_candidates(base)         # deterministic order
    budget = (base.inp_buff_bytes + base.wgt_buff_bytes
              + base.acc_buff_bytes)
    for c in grid:
        assert hwspec.spec_feasible(c.spec) is None, c.label()
        assert (c.spec.inp_buff_bytes + c.spec.wgt_buff_bytes
                + c.spec.acc_buff_bytes) <= budget, c.label()
    assert len({c.label() for c in grid}) == len(grid)


def _oracle_table(res):
    return [(t.candidate.label(), t.predicted_cycles, t.error)
            for t in res.trials]


def test_search_is_deterministic_for_a_fixed_seed():
    wl = matmul_workload(32, 64, 64, seed=3)
    kw = dict(seed=11, n_candidates=6, top_n=0, repeats=1, **CPU)
    r1 = search(wl, cache=autotune.TuningCache(), **kw)
    r2 = search(wl, cache=autotune.TuningCache(), **kw)
    assert _oracle_table(r1) == _oracle_table(r2)
    assert r1.candidates_total == r2.candidates_total > 6


def test_search_writes_the_winner_into_the_cache():
    """The winner is validated and its decisions land in the cache, one
    record per accelerator op, keyed by its spec; its serving knobs come
    out as a ready SchedConfig.  (Which candidate wins is a wall-time
    ranking: not asserted.)"""
    cache = autotune.TuningCache()
    res = search(matmul_workload(64, 128, 128, seed=0), seed=0,
                 n_candidates=8, top_n=3, repeats=1, cache=cache,
                 backend="cuda", **CPU)
    assert res.winner is not None and res.winner.validated
    assert res.records_written == 1 and len(cache) == 1
    ((sk, sig), rec), = cache.entries.items()
    assert sk == spec_key(res.winner.candidate.spec)
    assert sig.startswith("matmul:m64.k128.n128")
    assert rec.validated and rec.gang_width >= 1
    assert rec.predicted_cycles == res.winner.predicted_cycles
    cfg = res.sched_config()
    assert cfg.gang_width == res.winner.gang_width
    assert 50.0 <= cfg.window_us <= 5000.0
    assert res.to_json()["winner"]["candidate"] == res.winner.candidate \
        .label()


def test_search_drops_candidates_that_fail_validation(monkeypatch):
    """A corrupted/diverging candidate is disqualified — never the
    winner, never a tuning record — and the search still completes."""
    real = autotune.validate_candidate
    calls = []

    def sabotage(compiled, feeds, refs):
        calls.append(1)
        if len(calls) > 1:      # stage 2 validates the baseline first
            raise ValidationError("injected corruption")
        real(compiled, feeds, refs)

    monkeypatch.setattr(autotune, "validate_candidate", sabotage)
    cache = autotune.TuningCache()
    res = search(matmul_workload(32, 64, 64, seed=0), seed=0,
                 n_candidates=5, top_n=2, repeats=1, cache=cache, **CPU)
    dropped = [t for t in res.trials if t.validated is False]
    assert dropped, "sabotage never triggered — widen the sample"
    for t in dropped:
        assert t.error.startswith("ValidationError")
        assert t.measured_s is None
    assert res.winner is res.baseline
    for (sk, _), rec in cache.entries.items():
        assert sk == spec_key(hwspec.pynq())


def test_validate_candidate_rejects_corrupted_constants():
    """Tamper the staged constant image in device DRAM — both engines then
    agree with each other but diverge from the numpy reference, and
    validation must refuse the candidate."""
    spec = hwspec.pynq()
    rng = np.random.default_rng(4)
    x = rng.integers(-64, 64, size=(16, 64), dtype=np.int8)
    w = rng.integers(-16, 16, size=(64, 64), dtype=np.int8)
    ep = Epilogue(shift=6)
    p = Program(spec)
    p.matmul(p.input("x", x.shape), p.constant("w", w), epilogue=ep,
             name="y")
    compiled = p.compile(use_cache=False, **CPU)
    refs = {"y": matmul_reference(x, w, epilogue=ep, spec=spec)}
    validate_candidate(compiled, {"x": x}, refs)          # clean: passes
    compiled._write(compiled.input_ids["w"], w ^ np.int8(0x11))
    with pytest.raises(ValidationError, match="reference"):
        validate_candidate(compiled, {"x": x}, refs)


def _conv_program(spec, shape=None):
    shape = shape or ConvShape(**CONV)
    p = Program(spec)
    p.conv2d(p.input("x", (shape.n, shape.ic, shape.h, shape.w)),
             p.input("k", (shape.oc, shape.ic, shape.kh, shape.kw)),
             shape, epilogue=Epilogue(shift=5, relu=True), name="y")
    return p, shape


def test_compile_consults_cache_and_record_steers_lowering():
    spec = hwspec.pynq()
    p, shape = _conv_program(spec)
    node = next(n for n in p.nodes if n.op == "conv2d")
    sig = op_signature(p, node)

    miss = p.compile(use_cache=False, **CPU)
    assert (miss.tune_hits, miss.tune_misses) == (0, 1)
    assert "tune 0 hit/1 miss" in miss.describe()
    picked = next(n for n in miss.nodes if n.op == "conv2d").lowering
    assert picked == cheapest_conv_lowering(shape, spec)[0]

    # a stored record overrides the cycle pick: force the OTHER mode
    other = "im2col" if picked == "direct" else "direct"
    autotune.global_cache().put(spec, sig, TuningRecord(lowering=other,
                                                        validated=True))
    hit = p.compile(use_cache=False, **CPU)
    assert (hit.tune_hits, hit.tune_misses) == (1, 0)
    assert "tune 1 hit/0 miss" in hit.describe()
    assert next(n for n in hit.nodes if n.op == "conv2d").lowering == other
    assert hit.insn_count != miss.insn_count

    # RunStats carries the counters; both engines give the exact result
    rng = np.random.default_rng(0)
    x = rng.integers(-64, 64, size=(1, 16, 8, 8), dtype=np.int8)
    k = rng.integers(-16, 16, size=(16, 16, 3, 3), dtype=np.int8)
    want = conv2d_reference(x, k, shape,
                            epilogue=Epilogue(shift=5, relu=True))
    for backend in ("simulator", "cuda"):
        np.testing.assert_array_equal(hit(backend=backend, x=x, k=k), want)
        assert hit.last_stats[-1].tune_cache_hits == 1
        assert hit.last_stats[-1].tune_cache_misses == 0


def test_a_stale_record_falls_back_and_explicit_lowerings_stand():
    """A record whose mode the shape cannot take (via_matmul on a 3x3)
    falls back to the cycle pick but still counts as a hit; a node with
    an explicit lowering is never overridden."""
    spec = hwspec.pynq()
    p, shape = _conv_program(spec)
    node = next(n for n in p.nodes if n.op == "conv2d")
    autotune.global_cache().put(spec, op_signature(p, node),
                                TuningRecord(lowering="via_matmul"))
    c = p.compile(use_cache=False, **CPU)
    assert (c.tune_hits, c.tune_misses) == (1, 0)
    assert next(n for n in c.nodes if n.op == "conv2d").lowering \
        == cheapest_conv_lowering(shape, spec)[0]
    q = Program(spec)
    q.conv2d(q.input("x", (1, 16, 8, 8)), q.input("k", (16, 16, 3, 3)),
             shape, epilogue=Epilogue(shift=5, relu=True),
             lowering="im2col")
    autotune.global_cache().put(spec, op_signature(q, q.nodes[-1]),
                                TuningRecord(lowering="direct"))
    c = q.compile(use_cache=False, **CPU)
    assert c.tune_hits == 1
    assert next(n for n in c.nodes if n.op == "conv2d").lowering == "im2col"


def test_cache_records_invalidate_on_spec_change():
    spec_a = hwspec.pynq()
    p_a, _ = _conv_program(spec_a)
    node = next(n for n in p_a.nodes if n.op == "conv2d")
    autotune.global_cache().put(spec_a, op_signature(p_a, node),
                                TuningRecord(lowering="direct",
                                             validated=True))
    assert p_a.compile(use_cache=False, **CPU).tune_hits == 1
    spec_b = spec_a.replace(acc_buff_bytes=64 * 1024)
    p_b, _ = _conv_program(spec_b)
    c_b = p_b.compile(use_cache=False, **CPU)
    assert (c_b.tune_hits, c_b.tune_misses) == (0, 1)
    assert spec_key(spec_a) != spec_key(spec_b)


def test_cache_json_roundtrip(tmp_path):
    cache = autotune.TuningCache()
    cache.put(hwspec.pynq(), "matmul:m8.k16.n16:ep0:vt2",
              TuningRecord(lowering=None, virtual_threads=1, gang_width=2,
                           window_us=120.0, predicted_cycles=123.0,
                           measured_s=0.5, validated=True))
    path = tmp_path / "tune.json"
    cache.save(str(path))
    fresh = autotune.TuningCache(path=str(path))
    assert fresh.entries == cache.entries
    # the file is the reference's, byte for byte
    ref = RA.TuningCache()
    ref.put(rhw.pynq(), "matmul:m8.k16.n16:ep0:vt2",
            RA.TuningRecord(lowering=None, virtual_threads=1, gang_width=2,
                            window_us=120.0, predicted_cycles=123.0,
                            measured_s=0.5, validated=True))
    ref.save(str(tmp_path / "ref.json"))
    assert path.read_bytes() == (tmp_path / "ref.json").read_bytes()


def test_auto_conv_lowering_tracks_the_cycle_oracle():
    """The auto pick equals the argmin of the replayed per-mode cycles on
    every spec, and the two template instances disagree on the answer."""
    shape = ConvShape(n=1, h=56, w=56, ic=16, oc=16, kh=3, kw=3,
                      stride=1, pad=1)
    picks = {}
    for tag, spec in (("pynq", hwspec.pynq()),
                      ("calibrated", hwspec.calibrated())):
        costs = {m: predict_conv_cycles(shape, spec, m)
                 for m in ("direct", "im2col")}
        pick = select_conv_lowering(shape, spec, None)
        assert pick == min(costs, key=costs.get), (tag, costs)
        picks[tag] = pick
    assert picks == {"pynq": "direct", "calibrated": "im2col"}


def test_predict_program_cycles_matches_replay():
    """The search oracle prices programs with the same decode+replay the
    serving plane uses — one number, two consumers — and equals the
    reference's on the same graph."""
    p, _ = _conv_program(hwspec.pynq())
    compiled = p.compile(use_cache=False, **CPU)
    (step,) = compiled.accel_steps
    assert isinstance(step, AccelStep)
    insns = IsaLayout(compiled.spec).decode_stream(
        np.ascontiguousarray(step.stream))
    want = replay_timing(compiled.spec, insns,
                         TimingModel(compiled.spec)).total_cycles
    assert predict_program_cycles(compiled) == pytest.approx(want)
    rp, _ = _graphs("conv")
    assert predict_program_cycles(compiled) == RA.predict_program_cycles(
        rp.compile(use_cache=False))
