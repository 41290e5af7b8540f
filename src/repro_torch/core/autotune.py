"""Design-space autotuner over the parametrizable VTA template (§4).

The port of the reference's ``core/autotune.py``.  The paper's Section-4
flow: the accelerator is a *template*, so finding a good deployment
means searching jointly over hardware geometry and schedule knobs — not
hand-picking either.  This module is that search, built on the
calibrated cycle oracle:

  (a) **hwspec geometry** — scratchpad splits (``inp/wgt/acc_buff_bytes``
      re-partitioned inside the base spec's fixed SRAM budget) and GEMM
      tile shape (``batch``/``block_in``/``block_out``), gated by
      :func:`hwspec.spec_feasible` (power-of-two depths, derived ISA
      field widths, the 32-bit uop-address budget);
  (b) **lowering choice** — conv nodes force ``direct``/``im2col`` or
      leave the per-node replayed-cycle auto pick
      (:func:`conv.select_conv_lowering`);
  (c) **per-op knobs** — ``virtual_threads``;
  (d) **serving knobs** — ``SchedConfig.gang_width`` (via the shared
      :func:`sched.stream_costs` evaluation) and ``window_us``.

Two-stage evaluation keeps it cheap: every candidate is priced by
TimingModel replay (the oracle, a host computation whose numbers equal
the reference's); only the top-N by predicted cycles are measured for
wall time, and every measured candidate is byte-validated —
``CrossBackendChecker(("simulator", "cuda"))`` per accelerator segment
plus exact equality against the numpy reference — before it can win.
An unvalidated candidate NEVER becomes a winner or a tuning record.

Candidate programs compile onto ``torch_device`` (default the card).  On
the card the ``"cuda"`` engine launches ``vta_gemm`` and
``tensor_alu_scatter`` under every candidate's geometry; on CPU tensors
it runs their plain versions (the port's dispatch rule).

Winners land in a persistent per-(spec-key, op-signature)
:class:`TuningCache` that ``Program.compile`` consults transparently
(``CompiledProgram.tune_hits``/``tune_misses``, also on ``RunStats`` and
``describe()``).  The cache file's JSON is the reference's, field for
field, and ``REPRO_TUNE_CACHE=path`` loads it into the global cache at
import in both packages, so one file steers both.
``tools/autotune_torch.py`` is the CLI.
"""
from __future__ import annotations

import itertools
import json
import os
import time
from dataclasses import asdict, dataclass
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np

from .backend import CrossBackendChecker
from .compiler import AccelStep, CpuStep
from .conv import ConvShape, conv2d_reference
from .driver import TorchDeviceLike
from .hwspec import HardwareSpec, pynq, spec_feasible
from .program import CompiledProgram, Program, op_signature
from .sched import SchedConfig, auto_gang_width, stream_costs
from .scheduler import Epilogue, matmul_reference
from .simulator import TimingModel


class ValidationError(RuntimeError):
    """A candidate's execution diverged — engines disagreed byte-wise or
    the output mismatched the numpy reference.  The candidate is dropped
    from the search; it can never become a winner or a tuning record."""
    pass


# ----------------------------------------------------------------------
# tuning cache: per-(spec-key, op-signature) records
# ----------------------------------------------------------------------
def spec_key(spec: HardwareSpec) -> str:
    """Stable string identity of everything that shapes a spec's streams
    and timing.  Two specs differing in ANY of these fields are different
    cache keys — which is exactly how records invalidate on spec change."""
    return (f"g{spec.batch}x{spec.block_in}x{spec.block_out}"
            f".i{spec.inp_buff_bytes}.w{spec.wgt_buff_bytes}"
            f".a{spec.acc_buff_bytes}.o{spec.out_buff_bytes}"
            f".u{spec.uop_buff_bytes}.wb{spec.wgt_bits}"
            f".f{spec.freq_mhz:g}.rd{spec.dram_rd_bytes_per_cycle:g}"
            f".wr{spec.dram_wr_bytes_per_cycle:g}"
            f".lat{spec.dram_latency_cycles}")


@dataclass
class TuningRecord:
    """One tuned decision set for one (spec, op-signature) pair."""
    lowering: Optional[str] = None        # conv nodes: the winning mode
    virtual_threads: Optional[int] = None
    gang_width: Optional[int] = None      # serving knobs of the winning
    window_us: Optional[float] = None     # program (program-level ops)
    predicted_cycles: Optional[float] = None
    measured_s: Optional[float] = None
    validated: bool = False
    source: str = "search"                # search | manual


class TuningCache:
    """Persistent per-(spec-key, op-signature) store of tuned decisions.

    ``Program.compile`` consults the global instance through
    :meth:`lookup` (counted — hit/miss totals feed the per-compile
    ``tune_hits``/``tune_misses``); the autotuner fills it through
    :meth:`put` after validation.  JSON round-trips with :meth:`save` /
    :meth:`load`, so a tuned deployment survives process restarts
    (``REPRO_TUNE_CACHE=path`` auto-loads into the global cache)."""

    def __init__(self, path: Optional[str] = None):
        self.entries: Dict[Tuple[str, str], TuningRecord] = {}
        self.hits = 0
        self.misses = 0
        if path and os.path.exists(path):
            self.load(path)

    def __len__(self) -> int:
        return len(self.entries)

    def lookup(self, spec: HardwareSpec,
               op_sig: str) -> Optional[TuningRecord]:
        rec = self.entries.get((spec_key(spec), op_sig))
        if rec is None:
            self.misses += 1
        else:
            self.hits += 1
        return rec

    def put(self, spec: HardwareSpec, op_sig: str,
            record: TuningRecord) -> None:
        self.entries[(spec_key(spec), op_sig)] = record

    def clear(self) -> None:
        self.entries.clear()
        self.hits = self.misses = 0

    def to_json(self) -> dict:
        return {"version": 1,
                "entries": [{"spec": sk, "op": op, **asdict(rec)}
                            for (sk, op), rec in sorted(self.entries.items())]}

    def save(self, path: str) -> None:
        with open(path, "w") as f:
            json.dump(self.to_json(), f, indent=2, sort_keys=True)
            f.write("\n")

    def load(self, path: str) -> int:
        """Merge records from a saved cache file; returns how many."""
        with open(path) as f:
            data = json.load(f)
        n = 0
        for row in data.get("entries", []):
            row = dict(row)
            sk, op = row.pop("spec"), row.pop("op")
            self.entries[(sk, op)] = TuningRecord(**row)
            n += 1
        return n


_GLOBAL_CACHE = TuningCache(path=os.environ.get("REPRO_TUNE_CACHE"))


def global_cache() -> TuningCache:
    """The process-wide TuningCache every ``Program.compile`` consults."""
    return _GLOBAL_CACHE


# ----------------------------------------------------------------------
# workloads: spec -> (Program, feeds, references)
# ----------------------------------------------------------------------
@dataclass(frozen=True)
class Workload:
    """A tunable workload: ``build(spec, virtual_threads, lowering)``
    returns a fresh ``(Program, feeds, refs)`` triple for one candidate
    configuration.  Layouts are spec-dependent, so the graph must be
    rebuilt per candidate — only the *data* (seeded) stays fixed."""
    name: str
    kind: str          # "conv" | "matmul"
    build: Callable[[HardwareSpec, int, Optional[str]],
                    Tuple[Program, Dict[str, np.ndarray],
                          Dict[str, np.ndarray]]]


def conv_workload(shape: ConvShape, seed: int = 0,
                  epilogue: Optional[Epilogue] = None,
                  name: Optional[str] = None) -> Workload:
    ep = epilogue if epilogue is not None else Epilogue(shift=5, relu=True)
    rng = np.random.default_rng(seed)
    x = rng.integers(-64, 64, size=(shape.n, shape.ic, shape.h, shape.w),
                     dtype=np.int8)
    k = rng.integers(-16, 16, size=(shape.oc, shape.ic, shape.kh, shape.kw),
                     dtype=np.int8)
    ref = conv2d_reference(x, k, shape, epilogue=ep)

    def build(spec, virtual_threads, lowering):
        p = Program(spec, virtual_threads=virtual_threads)
        p.conv2d(p.input("x", x.shape), p.input("k", k.shape), shape,
                 epilogue=ep, lowering=lowering, name="y")
        return p, {"x": x, "k": k}, {"y": ref}

    return Workload(name or f"conv{shape.kh}x{shape.kw}_"
                            f"{shape.h}x{shape.w}x{shape.ic}-{shape.oc}",
                    "conv", build)


def matmul_workload(m: int = 64, k: int = 256, n: int = 256, seed: int = 0,
                    epilogue: Optional[Epilogue] = None,
                    name: Optional[str] = None) -> Workload:
    ep = epilogue if epilogue is not None else Epilogue(shift=7, relu=True)
    rng = np.random.default_rng(seed)
    a = rng.integers(-64, 64, size=(m, k), dtype=np.int8)
    w = rng.integers(-16, 16, size=(n, k), dtype=np.int8)

    def build(spec, virtual_threads, lowering):
        p = Program(spec, virtual_threads=virtual_threads)
        p.matmul(p.input("a", a.shape), p.input("w", w.shape),
                 epilogue=ep, name="y")
        ref = matmul_reference(a, w, epilogue=ep, spec=spec)
        return p, {"a": a, "w": w}, {"y": ref}

    return Workload(name or f"matmul{m}x{k}x{n}", "matmul", build)


# ----------------------------------------------------------------------
# candidate space
# ----------------------------------------------------------------------
@dataclass(frozen=True)
class Candidate:
    """One point of the design space: a template instance + schedule
    knobs.  ``lowering=None`` leaves conv nodes on the per-node
    replayed-cycle auto pick; "direct"/"im2col" force one mode."""
    spec: HardwareSpec
    virtual_threads: int = 2
    lowering: Optional[str] = None

    def label(self) -> str:
        s = self.spec
        lw = self.lowering or "auto"
        return (f"{s.batch}x{s.block_in}x{s.block_out}"
                f"/i{s.inp_buff_bytes >> 10}k.w{s.wgt_buff_bytes >> 10}k"
                f".a{s.acc_buff_bytes >> 10}k/vt{self.virtual_threads}"
                f"/{lw}")


def enumerate_candidates(base: HardwareSpec,
                         vts: Sequence[int] = (1, 2),
                         lowerings: Sequence[Optional[str]] = (None,),
                         tile_shapes: Optional[Sequence[Tuple[int, int, int]]]
                         = None,
                         sram_splits: bool = True) -> List[Candidate]:
    """The full (deterministic-order) candidate grid around `base`.

    Geometry: GEMM tile shapes from a power-of-two neighbourhood of the
    base intrinsic, crossed with scratchpad re-partitions (each buffer
    halved/kept/doubled) whose total stays inside the base SRAM budget.
    Every spec passes :func:`hwspec.spec_feasible` — infeasible geometry
    (uop-budget overflow, non-power-of-two depths) never reaches a
    compile.  Candidate 0 is always the unmodified base configuration,
    the search's baseline."""
    tiles: List[Tuple[int, int, int]] = \
        [(base.batch, base.block_in, base.block_out)]
    if tile_shapes is not None:
        for t in tile_shapes:
            if t not in tiles:
                tiles.append(t)
    else:
        for b, bi, bo in itertools.product((1, 2), (8, 16, 32),
                                           (8, 16, 32)):
            if (b, bi, bo) not in tiles:
                tiles.append((b, bi, bo))

    budget = base.inp_buff_bytes + base.wgt_buff_bytes + base.acc_buff_bytes
    splits = [(base.inp_buff_bytes, base.wgt_buff_bytes,
               base.acc_buff_bytes)]
    if sram_splits:
        for fi, fw, fa in itertools.product((1, 2, 4), repeat=3):
            cand = (base.inp_buff_bytes * fi // 2,
                    base.wgt_buff_bytes * fw // 2,
                    base.acc_buff_bytes * fa // 2)
            if sum(cand) <= budget and cand not in splits:
                splits.append(cand)

    cands: List[Candidate] = []
    for (b, bi, bo), (ib, wb, ab) in itertools.product(tiles, splits):
        sp = base.replace(batch=b, block_in=bi, block_out=bo,
                          inp_buff_bytes=ib, wgt_buff_bytes=wb,
                          acc_buff_bytes=ab)
        if spec_feasible(sp) is not None:
            continue
        for vt, lw in itertools.product(vts, lowerings):
            cands.append(Candidate(sp, vt, lw))
    # candidate 0: the exact base configuration (vt/lowering defaults)
    base_cand = Candidate(base, 2, None)
    if base_cand in cands:
        cands.remove(base_cand)
    return [base_cand] + cands


# ----------------------------------------------------------------------
# two-stage evaluation
# ----------------------------------------------------------------------
@dataclass
class Trial:
    """One evaluated candidate: oracle prediction for everyone, measured
    wall + validation verdict only for the top-N."""
    candidate: Candidate
    predicted_cycles: Optional[float] = None
    predicted_s: Optional[float] = None
    measured_s: Optional[float] = None
    validated: Optional[bool] = None      # None = never measured
    gang_width: Optional[int] = None
    window_us: Optional[float] = None
    error: Optional[str] = None

    def to_json(self) -> dict:
        return {"candidate": self.candidate.label(),
                "virtual_threads": self.candidate.virtual_threads,
                "lowering": self.candidate.lowering,
                "predicted_cycles": self.predicted_cycles,
                "predicted_s": self.predicted_s,
                "measured_s": self.measured_s,
                "validated": self.validated,
                "gang_width": self.gang_width,
                "window_us": self.window_us,
                "error": self.error}


def predict_program_cycles(compiled: CompiledProgram,
                           timing: Optional[TimingModel] = None) -> float:
    """Oracle stage: total replayed cycles over every accelerator
    segment, through the SAME memoized :func:`sched.stream_costs` the
    gang-width tuner uses — one decode + replay per compiled program."""
    return float(sum(f + l for f, l, _ in stream_costs(compiled, timing)))


def measure_wall_s(compiled: CompiledProgram,
                   feeds: Dict[str, np.ndarray],
                   backend: str = "simulator", repeats: int = 3) -> float:
    """Measure stage: best-of-`repeats` wall seconds of one call (after
    one warm-up call, so kernel builds and layout setup are excluded).
    Each call returns its outputs as host (numpy) arrays, read from the
    DRAM image after the engine's last operation: on the card that read
    waits for the device, so the clock covers the device's work too."""
    compiled(backend=backend, **feeds)
    best = float("inf")
    for _ in range(max(1, repeats)):
        t0 = time.perf_counter()
        compiled(backend=backend, **feeds)
        best = min(best, time.perf_counter() - t0)
    return best


def validate_candidate(compiled: CompiledProgram,
                       feeds: Dict[str, np.ndarray],
                       refs: Dict[str, np.ndarray]) -> None:
    """Differential validation of one candidate, the fuzzer's flow: every
    accelerator segment runs on BOTH engines against cloned devices and
    the DRAM images must match byte-for-byte; host steps execute in
    between; final outputs must equal the numpy reference exactly.
    Raises :class:`ValidationError` on any divergence.  On CPU tensors
    the ``"cuda"`` engine runs its kernels' plain versions."""
    for name, arr in feeds.items():
        compiled._write(compiled.input_ids[name], arr)
    checker = CrossBackendChecker(("simulator", "cuda"))
    for step in compiled.steps:
        if isinstance(step, CpuStep):
            node = compiled.nodes[step.node_id]
            args = [compiled._read(i) for i in node.inputs]
            compiled._write(step.node_id, node.fn(*args))
            continue
        assert isinstance(step, AccelStep)
        report = checker.run(compiled.spec, compiled.device, step.stream)
        if not report.matches:
            raise ValidationError(
                f"{report.mismatched_bytes} DRAM bytes differ between "
                f"engines on segment {step}")
        compiled.device.copy_from(report.device_for("simulator"))
    outs = {compiled.nodes[i].name: compiled._read(i)
            for i in compiled.output_ids}
    for name, ref in refs.items():
        if not np.array_equal(outs[name], ref):
            raise ValidationError(
                f"output {name!r} mismatches the numpy reference "
                f"({int(np.count_nonzero(outs[name] != ref))} elements)")


# ----------------------------------------------------------------------
# the search
# ----------------------------------------------------------------------
@dataclass
class SearchResult:
    workload: str
    seed: int
    trials: List[Trial]
    baseline: Trial
    winner: Optional[Trial]
    candidates_total: int = 0      # full grid size before seeded sampling
    records_written: int = 0

    @property
    def speedup_predicted(self) -> Optional[float]:
        if (self.winner is None or not self.winner.predicted_cycles
                or not self.baseline.predicted_cycles):
            return None
        return self.baseline.predicted_cycles / self.winner.predicted_cycles

    @property
    def speedup_measured(self) -> Optional[float]:
        if (self.winner is None or not self.winner.measured_s
                or not self.baseline.measured_s):
            return None
        return self.baseline.measured_s / self.winner.measured_s

    def sched_config(self, **kw) -> SchedConfig:
        """Serving knobs of the winner as a ready SchedConfig."""
        w = self.winner or self.baseline
        cfg = dict(gang_width=w.gang_width, window_us=w.window_us or 500.0)
        cfg.update(kw)
        return SchedConfig(**cfg)

    def to_json(self) -> dict:
        return {"workload": self.workload, "seed": self.seed,
                "candidates_total": self.candidates_total,
                "candidates_evaluated": len(self.trials),
                "baseline": self.baseline.to_json(),
                "winner": self.winner.to_json() if self.winner else None,
                "speedup_predicted": self.speedup_predicted,
                "speedup_measured": self.speedup_measured,
                "records_written": self.records_written,
                "trials": [t.to_json() for t in self.trials]}


_Artifacts = Dict[int, Tuple[Program, CompiledProgram, Dict[str, np.ndarray],
                             Dict[str, np.ndarray]]]


def oracle_stage(workload: Workload, *,
                 base_spec: Optional[HardwareSpec] = None, seed: int = 0,
                 n_candidates: int = 24, vts: Sequence[int] = (1, 2),
                 lowerings: Sequence[Optional[str]] = (None,),
                 tile_shapes: Optional[Sequence[Tuple[int, int, int]]]
                 = None,
                 sram_splits: bool = True,
                 log: Optional[Callable[[str], None]] = None,
                 torch_device: TorchDeviceLike = "cuda",
                 dram_size: int = 1 << 28
                 ) -> Tuple[List[Trial], _Artifacts, int]:
    """Stage 1 of :func:`search`: the seeded sample of the candidate grid
    (candidate 0 always the base), each candidate compiled onto
    `torch_device` and priced by :func:`predict_program_cycles`.  Returns
    the trials (a candidate that fails to compile keeps its error), the
    compiled artifacts keyed by ``id(trial)`` and the grid's full size.
    A host computation: its result does not depend on `torch_device`."""
    base_spec = base_spec or pynq()
    say = log or (lambda s: None)
    rng = np.random.default_rng(seed)
    grid = enumerate_candidates(base_spec, vts=vts, lowerings=lowerings,
                                tile_shapes=tile_shapes,
                                sram_splits=sram_splits)
    total = len(grid)
    if total > n_candidates:
        rest = grid[1:]
        pick = rng.choice(len(rest), size=max(0, n_candidates - 1),
                          replace=False)
        grid = [grid[0]] + [rest[i] for i in sorted(pick)]
    say(f"{workload.name}: {len(grid)} candidates "
        f"(of {total} feasible grid points), oracle stage...")

    trials: List[Trial] = []
    arts: _Artifacts = {}
    for cand in grid:
        t = Trial(candidate=cand)
        trials.append(t)
        try:
            prog, feeds, refs = workload.build(cand.spec,
                                               cand.virtual_threads,
                                               cand.lowering)
            compiled = prog.compile(use_cache=False,
                                    torch_device=torch_device,
                                    dram_size=dram_size)
            t.predicted_cycles = predict_program_cycles(compiled)
            t.predicted_s = t.predicted_cycles / (cand.spec.freq_mhz * 1e6)
            arts[id(t)] = (prog, compiled, feeds, refs)
        except (ValueError, MemoryError) as e:
            t.error = f"{type(e).__name__}: {e}"
    return trials, arts, total


def rank_trials(trials: Sequence[Trial]) -> List[Trial]:
    """Every priced candidate after the baseline, by predicted cycles
    (ties by label): the order stage 2 takes its top-N from."""
    return sorted((t for t in trials[1:] if t.error is None),
                  key=lambda t: (t.predicted_cycles, t.candidate.label()))


def search(workload: Workload, *, base_spec: Optional[HardwareSpec] = None,
           seed: int = 0, n_candidates: int = 24, top_n: int = 4,
           repeats: int = 3, backend: str = "simulator",
           vts: Sequence[int] = (1, 2),
           lowerings: Sequence[Optional[str]] = (None,),
           tile_shapes: Optional[Sequence[Tuple[int, int, int]]] = None,
           sram_splits: bool = True, max_gang_width: int = 4,
           cache: Optional[TuningCache] = None,
           log: Optional[Callable[[str], None]] = None,
           torch_device: TorchDeviceLike = "cuda",
           dram_size: int = 1 << 28) -> SearchResult:
    """Seeded two-stage design-space search for one workload.

    Stage 1 (:func:`oracle_stage`) prices every sampled candidate on the
    TimingModel replay (compile + :func:`predict_program_cycles`); stage
    2 takes the baseline plus the top-`top_n` by predicted cycles
    (:func:`rank_trials`), byte-validates each (both engines + numpy
    reference — a candidate failing validation is disqualified, never
    silently kept), and measures wall time on `backend`.  The
    measured-fastest validated candidate wins; its schedule decisions
    (lowering, virtual_threads) and serving knobs (gang_width from the
    shared cost evaluation, window_us from predicted service time) are
    written into `cache` (default: the global TuningCache that
    ``Program.compile`` consults) for every accelerator op of the
    winning program.  Deterministic for a fixed seed (stage 1 entirely:
    the sampled candidates, their predicted cycles and the ranking).
    Candidate programs compile onto `torch_device` (default the card)
    with `dram_size`-byte images."""
    say = log or (lambda s: None)
    trials, arts, total = oracle_stage(
        workload, base_spec=base_spec, seed=seed, n_candidates=n_candidates,
        vts=vts, lowerings=lowerings, tile_shapes=tile_shapes,
        sram_splits=sram_splits, log=log, torch_device=torch_device,
        dram_size=dram_size)
    baseline = trials[0]
    if baseline.error is not None:
        raise RuntimeError(f"baseline configuration failed to compile: "
                           f"{baseline.error}")

    stage2 = [baseline] + rank_trials(trials)[:top_n]
    say(f"measuring + validating {len(stage2)} of {len(trials)} "
        f"(baseline + top-{top_n} predicted)...")
    for t in stage2:
        prog, compiled, feeds, refs = arts[id(t)]
        try:
            validate_candidate(compiled, feeds, refs)
            t.validated = True
        except ValidationError as e:
            t.validated = False
            t.error = f"ValidationError: {e}"
            say(f"  DROP {t.candidate.label()}: {t.error}")
            continue
        t.measured_s = measure_wall_s(compiled, feeds, backend=backend,
                                      repeats=repeats)
        t.gang_width = auto_gang_width(compiled, max_gang_width)
        # admission window: half a gang's predicted service time, inside
        # sane serving bounds
        t.window_us = float(min(5000.0, max(
            50.0, t.predicted_s * 1e6 * t.gang_width / 2)))
        say(f"  {t.candidate.label()}: predicted {t.predicted_cycles:.0f} "
            f"cyc, measured {t.measured_s * 1e3:.2f} ms, "
            f"gang {t.gang_width}")

    measured = [t for t in stage2 if t.validated and t.measured_s]
    winner = min(measured, key=lambda t: t.measured_s) if measured else None

    result = SearchResult(workload=workload.name, seed=seed, trials=trials,
                          baseline=baseline, winner=winner,
                          candidates_total=total)
    if winner is not None:
        cache = cache if cache is not None else global_cache()
        prog, compiled, _, _ = arts[id(winner)]
        for n in prog.nodes:
            if n.op not in ("conv2d", "matmul"):
                continue
            cache.put(winner.candidate.spec, op_signature(prog, n),
                      TuningRecord(
                          lowering=compiled.nodes[n.idx].lowering,
                          virtual_threads=winner.candidate.virtual_threads,
                          gang_width=winner.gang_width,
                          window_us=winner.window_us,
                          predicted_cycles=winner.predicted_cycles,
                          measured_s=winner.measured_s,
                          validated=True))
            result.records_written += 1
        say(f"winner {winner.candidate.label()}: "
            f"{result.speedup_measured:.2f}x measured over baseline, "
            f"{result.records_written} tuning record(s) written")
    return result
