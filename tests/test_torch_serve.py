"""The serving plane in the port against the reference package, on the
quantized int4 decoder (``lowbit(4)``, numpy attention, s_max 16).

  * pooled decode equals serial decode at pool sizes 1 and 2, sessions
    stay isolated, a 16-step pooled greedy decode reproduces the
    reference ``DecoderReference``'s tokens, and no slot allocates DRAM
    after warm-up;
  * a seeded ``FaultPlan`` equals the reference's for the same seed and
    fires the same log on the same workload; respawn with checkpoint
    restore leaves survivors byte-equal to a fault-free serial run, and an
    injected constant bit-flip is restaged;
  * ``stream_costs``, ``predict_gang_cycles`` and ``auto_gang_width``
    equal the reference's on the decoder program, and ``Scheduler``
    matches serial;
  * on a stateless matmul -> host -> matmul program: a scripted kill or a
    delay past the segment watchdog's deadline fails the request typed
    and a stateless retry brings it back, with the fault log, the
    attempts and the slot counters equal to the reference pool's;
    session-bound requests never retry; the watchdog's per-segment budget
    equals the reference's and never fires on a healthy decode;
    ``serve_batch`` and ``BatchServer`` equal serial runs and the
    reference.

Tolerance: 0 (integer paths).  Every wait has a timeout.
"""
import dataclasses

import numpy as np
import pytest

import repro.core.chaos as r_chaos
import repro.core.compiler as r_compiler
import repro.core.hwspec as r_hw
import repro.core.program as r_prog
import repro.core.sched as r_sched
import repro.core.scheduler as r_scheduler
import repro.core.serve as r_serve
import repro_torch.core.chaos as t_chaos
import repro_torch.core.compiler as t_compiler
import repro_torch.core.hwspec as t_hw
import repro_torch.core.program as t_prog
import repro_torch.core.sched as t_sched
import repro_torch.core.scheduler as t_scheduler
import repro_torch.core.serve as t_serve
from repro.models.vta_decoder import (DecoderConfig as RConfig,
                                      QuantDecoder as RDecoder)
from repro_torch.models.vta_decoder import (DecoderConfig as TConfig,
                                            QuantDecoder as TDecoder)

WAIT = 120
CFG = dict(s_max=16)


@pytest.fixture(scope="module")
def dec():
    d = TDecoder(TConfig(**CFG), spec=t_hw.lowbit(4), torch_device="cpu",
                 dram_size=1 << 22)
    return d, d.compile(use_cache=False)


def _greedy(step, prompt, steps, token):
    tok, out = prompt, []
    for _ in range(steps):
        tok = int(np.argmax(step(token(tok))))
        out.append(tok)
    return out


def _pooled(pool, d, prompts, steps):
    sess = [pool.session() for _ in prompts]
    toks, out = list(prompts), [[] for _ in prompts]
    for _ in range(steps):
        futs = [s.submit(x=d.token(t)) for s, t in zip(sess, toks)]
        for i, f in enumerate(futs):
            toks[i] = int(np.argmax(f.wait(timeout=WAIT)))
            out[i].append(toks[i])
    return out, sess


# ----------------------------------------------------------------------
# DevicePool
# ----------------------------------------------------------------------
@pytest.mark.parametrize("size", [1, 2])
def test_pool_matches_serial_and_reference_tokens(dec, size):
    d, c = dec
    prompts = [3, 10, 17]
    rd = RDecoder(RConfig(**CFG), spec=r_hw.lowbit(4))
    want = [_greedy(rd.reference().step, p, 6, rd.token) for p in prompts]
    serial = [_greedy(d.reference().step, p, 6, d.token) for p in prompts]
    assert serial == want
    with t_serve.DevicePool(c, size=size) as pool:
        assert pool.engine.name == "cuda"
        got, _ = _pooled(pool, d, prompts, 6)
    assert got == want


def test_sixteen_step_decode_zero_dram_growth_and_isolation(dec):
    d, c = dec
    rd = RDecoder(RConfig(**CFG), spec=r_hw.lowbit(4))
    prompts = [5, 12]
    want = [_greedy(rd.reference().step, p, 16, rd.token) for p in prompts]
    with t_serve.DevicePool(c, size=1) as pool:
        # warm-up, then no slot may allocate: trimmed clones raise on it
        pool.session().submit(x=d.token(0)).wait(timeout=WAIT)
        marks = [s.device.dram._next for s in pool.slots]
        got, sess = _pooled(pool, d, prompts, 16)
        assert [s.device.dram._next for s in pool.slots] == marks
        # two sessions on one slot: each kept its own KV bytes
        assert sess[0].state("pos0")[0] == 16 == sess[1].state("pos0")[0]
        assert not np.array_equal(sess[0].state("k0"), sess[1].state("k0"))
    assert got == want
    assert sum(s.ganged_steps for s in pool.slot_stats()) == 0


# ----------------------------------------------------------------------
# chaos
# ----------------------------------------------------------------------
def test_fault_plan_equals_reference_for_the_same_seed():
    kw = dict(seed=7, n_gangs=200, slots=4, rate=0.2)
    a = t_chaos.FaultPlan.random(**kw)
    b = r_chaos.FaultPlan.random(**kw)
    assert len(a) > 0
    assert [dataclasses.asdict(f) for f in a.faults] \
        == [dataclasses.asdict(f) for f in b.faults]
    assert a.describe() == b.describe()


def _scripted_plan(chaos_m):
    """A constant flip at gang 3 and a kill of slot 0 at gang 31: 7
    accelerator segments per step, so step 4's fourth segment, after the
    step-4 checkpoint."""
    return chaos_m.FaultPlan(faults=[
        chaos_m.Fault(kind="flip", gang=3, slot=1, byte=12345),
        chaos_m.Fault(kind="kill", gang=31, slot=0)])


def _seeded_flips(chaos_m):
    return chaos_m.FaultPlan.random(seed=23, n_gangs=56, slots=2,
                                    rate=0.15, kinds=("flip",))


def _run_chaos(serve_m, chaos_m, d, c, backend, make_plan=_scripted_plan):
    """Two sessions, one per slot, 8 lockstep steps under the plan.  A
    step a kill interrupts fails typed and is submitted again."""
    plan = make_plan(chaos_m)
    pool = serve_m.DevicePool(c, size=2, backend=backend, max_respawns=1,
                              checkpoint_every=4, integrity=True,
                              fault_plan=plan)
    outs, errors = [[], []], []
    try:
        s = [pool.session(slot=i) for i in range(2)]
        for t in range(8):
            feeds = [d.token(t + 11 * i) for i in range(2)]
            futs = [x.submit(x=f) for x, f in zip(s, feeds)]
            for i, f in enumerate(futs):
                try:
                    outs[i].append(f.wait(timeout=WAIT))
                except serve_m.SlotDied as e:
                    errors.append((i, t, type(e).__name__))
                    outs[i].append(s[i].submit(x=feeds[i]).wait(
                        timeout=WAIT))
        stats = [(x.stats.restores, x.stats.restored_from_step) for x in s]
        restages = sum(sl.stats.integrity_restages for sl in pool.slots)
    finally:
        pool.close()
    log = [{k: e[k] for k in ("kind", "gang", "slot", "addr") if k in e}
           for e in plan.fired]
    return outs, errors, stats, restages, log


def test_chaos_log_and_survivors_equal_reference(dec):
    d, c = dec
    rd = RDecoder(RConfig(**CFG), spec=r_hw.lowbit(4))
    rc = rd.compile()
    t_out, t_err, t_stats, t_rst, t_log = _run_chaos(
        t_serve, t_chaos, d, c, "cuda")
    r_out, r_err, r_stats, r_rst, r_log = _run_chaos(
        r_serve, r_chaos, rd, rc, "simulator")
    assert t_log == r_log and len(t_log) == 2
    assert t_stats == r_stats and t_err == r_err == [(0, 4, "SlotDied")]
    assert t_rst == r_rst >= 1
    assert t_stats[0] == (1, 4)     # session 0 restored from step 4
    # both dialogues byte-equal to the reference and to fault-free serial
    # runs, the interrupted step included
    for i in range(2):
        dev = c.device.clone(trim=True)
        serial = [c.run_on(dev, inputs={"x": d.token(t + 11 * i)}).outputs
                  for t in range(8)]
        for a, b, want in zip(t_out[i], r_out[i], serial):
            np.testing.assert_array_equal(a, b)
            np.testing.assert_array_equal(a, want)


def test_seeded_flip_plan_fires_the_reference_log_and_restages(dec):
    """A seeded random plan of constant bit-flips: the same faults fire at
    the same gangs, slots and addresses as in the reference pool, every
    flip is restaged before a gang reads it, and both dialogues stay
    byte-equal to the reference."""
    d, c = dec
    rd = RDecoder(RConfig(**CFG), spec=r_hw.lowbit(4))
    t_out, t_err, _, t_rst, t_log = _run_chaos(
        t_serve, t_chaos, d, c, "cuda", make_plan=_seeded_flips)
    r_out, r_err, _, r_rst, r_log = _run_chaos(
        r_serve, r_chaos, rd, rd.compile(), "simulator",
        make_plan=_seeded_flips)
    assert len(t_log) >= 3 and t_log == r_log
    assert t_err == r_err == []
    assert t_rst == r_rst == len(t_log)
    for i in range(2):
        for a, b in zip(t_out[i], r_out[i]):
            np.testing.assert_array_equal(a, b)


# ----------------------------------------------------------------------
# Scheduler
# ----------------------------------------------------------------------
def test_sched_cost_model_equals_reference(dec):
    d, c = dec
    rc = RDecoder(RConfig(**CFG), spec=r_hw.lowbit(4)).compile()
    assert t_sched.stream_costs(c) == r_sched.stream_costs(rc)
    for w in (1, 2, 4):
        assert t_sched.predict_gang_cycles(c, w) \
            == r_sched.predict_gang_cycles(rc, w)
    for mw in (1, 2, 4, 8):
        assert t_sched.auto_gang_width(c, mw) \
            == r_sched.auto_gang_width(rc, mw)


def test_scheduler_matches_serial(dec):
    d, c = dec
    prompts = [2, 9, 23, 30]
    serial = [_greedy(d.reference().step, p, 4, d.token) for p in prompts]
    with t_serve.DevicePool(c, size=2) as pool:
        sched = t_sched.Scheduler(pool, t_sched.SchedConfig(window_us=500.0))
        try:
            sess = [sched.session() for _ in prompts]
            toks, got = list(prompts), [[] for _ in prompts]
            for _ in range(4):
                futs = [s.submit(x=d.token(t)) for s, t in zip(sess, toks)]
                for i, f in enumerate(futs):
                    toks[i] = int(np.argmax(f.wait(timeout=WAIT)))
                    got[i].append(toks[i])
        finally:
            sched.close()
    assert got == serial


# ----------------------------------------------------------------------
# retry, watchdog and batch serving on a stateless program
# ----------------------------------------------------------------------
def _reverse_rows(a):
    return np.ascontiguousarray(a[::-1])


def _hostful(pkg):
    """matmul -> host (row reversal) -> matmul, 16 x 32, in package
    `pkg` ("ref" or "port"), from the same seeded weights: two
    accelerator segments, so gang 1 is the request's second segment."""
    rng = np.random.default_rng(23)
    w1 = rng.integers(-64, 64, size=(32, 32), dtype=np.int8)
    w2 = rng.integers(-64, 64, size=(32, 32), dtype=np.int8)
    prog, hw, sch = ((r_prog, r_hw, r_scheduler) if pkg == "ref"
                     else (t_prog, t_hw, t_scheduler))
    ep = sch.Epilogue(shift=6, relu=True)
    p = prog.Program(hw.pynq())
    t = p.matmul(p.input("x", (16, 32)), p.constant("w1", w1), epilogue=ep)
    t = p.host(_reverse_rows, t, shape=(16, 32), kind="mat")
    p.output(p.matmul(t, p.constant("w2", w2), epilogue=ep))
    if pkg == "ref":
        return p.compile(use_cache=False)
    return p.compile(use_cache=False, torch_device="cpu", dram_size=1 << 22)


def _feeds(n, seed=5):
    rng = np.random.default_rng(seed)
    return [{"x": rng.integers(-64, 64, size=(16, 32), dtype=np.int8)}
            for _ in range(n)]


def _faulted_request(serve_m, chaos_m, c, backend, fault, feed, after):
    """One request on a 2-slot pool that retries stateless work once and
    respawns once, under a one-fault plan; then `after` more requests.
    Returns (output, attempts, fault log, slot counters, later outputs)."""
    kw = dict(max_respawns=1, retries=1, retry_backoff_s=0.01,
              fault_plan=chaos_m.FaultPlan(faults=[fault(chaos_m)]))
    if fault(chaos_m).kind == "delay":
        kw["watchdog"] = serve_m.WatchdogConfig(mult=2.0, floor_s=0.5,
                                                poll_s=0.05)
    pool = serve_m.DevicePool(c, size=2, backend=backend, **kw)
    try:
        f = pool.submit(**feed)
        out = f.wait(timeout=WAIT)
        later = [g.wait(timeout=WAIT) for g in
                 [pool.submit(**x) for x in after]]
        counters = [(s.stats.deaths, s.stats.respawns,
                     s.stats.watchdog_kills, s.stats.calls)
                    for s in pool.slots]
    finally:
        pool.close(timeout=10)
    log = [{k: v for k, v in e.items() if k != "failed_or_retried"}
           for e in kw["fault_plan"].fired]
    return out, f.attempts, log, counters, later


@pytest.mark.parametrize("fault", [
    lambda m: m.Fault(kind="kill", gang=1, slot=0),
    lambda m: m.Fault(kind="delay", gang=1, slot=0, delay_s=1.5)],
    ids=["kill", "watchdog_delay"])
def test_stateless_retry_after_kill_or_watchdog_equals_reference(fault):
    """A kill at the request's second segment, or a delay there past the
    watchdog's 0.5 s floor, fails the attempt (SlotDied or
    WatchdogTimeout) and the stateless retry succeeds on the respawned
    pool: output, attempts, fault log and slot counters equal the
    reference pool's, and later requests equal serial runs."""
    tc, rc = _hostful("port"), _hostful("ref")
    feed, *after = _feeds(4)
    t_out, t_att, t_log, t_cnt, t_later = _faulted_request(
        t_serve, t_chaos, tc, "cuda", fault, feed, after)
    r_out, r_att, r_log, r_cnt, r_later = _faulted_request(
        r_serve, r_chaos, rc, "simulator", fault, feed, after)
    assert t_att == r_att == 2
    assert t_log == r_log and len(t_log) == 1
    assert t_cnt == r_cnt
    assert sum(c[0] for c in t_cnt) == sum(c[1] for c in t_cnt) == 1
    assert sum(c[2] for c in t_cnt) == \
        (1 if t_log[0]["kind"] == "delay" else 0)
    np.testing.assert_array_equal(t_out, r_out)
    np.testing.assert_array_equal(t_out, tc(backend="cuda", **feed))
    for got, want, x in zip(t_later, r_later, after):
        np.testing.assert_array_equal(got, want)
        np.testing.assert_array_equal(got, tc(backend="cuda", **x))


def test_session_requests_never_retry(dec):
    """A session's call mutates its KV caches, so a replay would advance
    them twice: with retries on, a killed session call fails typed after
    one attempt, in the port as in the reference."""
    d, c = dec
    rd = RDecoder(RConfig(**CFG), spec=r_hw.lowbit(4))
    got = []
    for serve_m, chaos_m, dd, cc, backend in (
            (t_serve, t_chaos, d, c, "cuda"),
            (r_serve, r_chaos, rd, rd.compile(), "simulator")):
        plan = chaos_m.FaultPlan(faults=[chaos_m.Fault(kind="kill", gang=2,
                                                       slot=0)])
        pool = serve_m.DevicePool(cc, size=1, backend=backend, retries=3,
                                  retry_backoff_s=0.01, fault_plan=plan)
        try:
            f = pool.session().submit(x=dd.token(4))
            with pytest.raises(serve_m.SlotDied):
                f.wait(timeout=WAIT)
            got.append((f.attempts, pool.slots[0].stats.deaths))
        finally:
            pool.close(timeout=10)
    assert got[0] == got[1] == (1, 1)


def test_watchdog_budget_equals_reference_and_spares_healthy_decode(dec):
    """The watchdog prices each accelerator segment of the decoder as the
    reference does (TimingModel cycles over the spec's clock), and with
    the default budget a pooled 4-step decode runs with no kill and the
    reference's tokens."""
    d, c = dec
    rd = RDecoder(RConfig(**CFG), spec=r_hw.lowbit(4))
    rc = rd.compile()
    t_idx = [i for i, s in enumerate(c.steps)
             if isinstance(s, t_compiler.AccelStep)]
    assert t_idx == [i for i, s in enumerate(rc.steps)
                     if isinstance(s, r_compiler.AccelStep)]
    prompts = [6, 13]
    want = [_greedy(rd.reference().step, p, 4, rd.token) for p in prompts]
    with r_serve.DevicePool(rc, size=1, backend="simulator") as rpool:
        r_budget = [rpool._accel_step_seconds(rc, 0, i) for i in t_idx]
    with t_serve.DevicePool(c, size=2,
                            watchdog=t_serve.WatchdogConfig()) as pool:
        t_budget = [pool._accel_step_seconds(c, 0, i) for i in t_idx]
        got, _ = _pooled(pool, d, prompts, 4)
        kills = sum(s.stats.watchdog_kills for s in pool.slots)
    assert t_budget == r_budget and all(b > 0 for b in t_budget)
    assert got == want and kills == 0


def test_serve_batch_and_batch_server_equal_serial_and_reference():
    tc, rc = _hostful("port"), _hostful("ref")
    feeds = _feeds(9, seed=37)
    serial = [tc(backend="cuda", **f) for f in feeds]
    got = t_serve.serve_batch(tc, feeds, size=3)
    want = r_serve.serve_batch(rc, feeds, size=3, backend="simulator")
    assert len(got) == len(want) == len(feeds)
    for a, b, s in zip(got, want, serial):
        np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(a, s)
    with t_serve.BatchServer.build(tc, size=2,
                                   policy="least_loaded") as server:
        outs = server(feeds[:4], timeout=WAIT)
        futs = server.submit_all(feeds[4:])
        outs += [f.wait(timeout=WAIT) for f in futs]
        calls = sorted(s.calls for s in server.pool.slot_stats())
    for a, s in zip(outs, serial):
        np.testing.assert_array_equal(a, s)
    assert sum(calls) == 9 and calls[0] >= 1
