"""The program's spans in a traced run: each device event placed under the
spans of the training step (``repro_torch/trace.py``) that launched it,
and the device's idle gaps under the host's spans.

The profiler's own events carry what that needs: a host op's thread, the
correlation ids that tie a kernel to its launch, and an autograd node's
sequence number and forward thread.  Each device event stands for its
launch by an *anchor* on the host: the runtime call with its correlation
id, on the thread of the CPU op that call (or the kernel) is linked to
(the runtime's own thread id is the system's, not the profiler's).  A
host op is its own anchor, which is how the CPU tests read the rule.  An
anchor's span path, outermost first:

1. the program spans open around it on its thread;
2. inside a backward node (the engine's ``evaluate_function`` op around
   a node, with the checks and sums of the node's gradients, or the node's
   own op, of scope ``BACKWARD_FUNCTION``), the path of the forward op the
   node differentiates (the op of the node's forward thread and sequence
   number), with the spans opened inside the node (a recompute, or an
   op's own backward span) put in from the last place their outermost
   name holds in that path, or after it;
3. on a thread with no span open and outside a node, the spans open at
   that time on any thread, the innermost one's thread (the engine's own
   work between nodes reads ``train.backward``);
4. else ``unattributed``.

The step's phase (a ``train.*`` span) heads each path: the phase open
around the anchor, or at its time on any thread, so that a backward
kernel reads ``train.backward/block/mamba2``.
"""
from __future__ import annotations

from bisect import bisect_right
from dataclasses import dataclass
from typing import Callable, Dict, Iterable, List, Optional, Sequence, \
    Tuple

from .trace import busy_intervals

#: the step's phases, in order (``repro_torch/trace.py``)
PHASES = ("train.batch", "train.forward", "train.backward", "train.clip",
          "train.optimizer", "train.loss_read")
#: the layers' and the kernel ops' spans
LAYERS = ("embed", "block", "mamba2", "mamba2.in_proj", "mamba2.out_proj",
          "attention", "mlp", "loss", "gla_chunk", "flash_attention")
SPANS = PHASES + LAYERS
UNATTRIBUTED = "unattributed"
#: ``at::RecordScope::BACKWARD_FUNCTION``: an autograd node's own op
BACKWARD_FUNCTION = 1
#: the autograd engine's op around a node's evaluation
EVALUATE = "autograd::engine::evaluate_function: "


@dataclass(frozen=True)
class Event:
    """One profiler event.  `kind`: "cpu_op", "runtime" (a CUDA runtime or
    driver call) or "device"; `corr` its correlation id, `linked` the id
    of the CPU op it is linked to."""
    name: str
    start: int
    end: int
    kind: str = "cpu_op"
    thread: int = 0
    corr: int = 0
    linked: int = 0
    seq: int = -1
    fwd_thread: int = 0
    scope: int = 0


def events_of(kineto: Iterable) -> List[Event]:
    """The profiler's kineto events (``prof.profiler.kineto_results
    .events()``) as :class:`Event`.  A host event linked to a CPU op is a
    runtime or driver call (the profiler links those and the device's
    events alone); every other host event counts as a CPU op."""
    from torch.autograd import DeviceType
    out = []
    for e in kineto:
        if e.device_type() == DeviceType.CUDA:
            kind = "device"
        elif e.linked_correlation_id() > 0:
            kind = "runtime"
        else:
            kind = "cpu_op"
        out.append(Event(e.name(), e.start_ns(), e.end_ns(), kind,
                         e.start_thread_id(), e.correlation_id(),
                         e.linked_correlation_id(), e.sequence_nr(),
                         e.fwd_thread_id(), e.scope()))
    return out


class _Nest:
    """The nested intervals of one thread: the innermost that holds an
    interval, and the chain of those around it."""

    def __init__(self, evs: Sequence[Event]):
        self.evs = sorted(evs, key=lambda e: (e.start, -e.end))
        self.starts = [e.start for e in self.evs]
        self.parent: List[int] = []
        stack: List[int] = []
        for i, e in enumerate(self.evs):
            while stack and self.evs[stack[-1]].end < e.end:
                stack.pop()
            self.parent.append(stack[-1] if stack else -1)
            stack.append(i)

    def innermost(self, a: int, b: int) -> int:
        """The index of the innermost interval holding [a, b], or -1."""
        i = bisect_right(self.starts, a) - 1
        while i >= 0 and self.evs[i].end < b:
            i = self.parent[i]
        return i

    def chain(self, a: int, b: int) -> List[Event]:
        """Every interval holding [a, b], outermost first."""
        out, i = [], self.innermost(a, b)
        while i >= 0:
            out.append(self.evs[i])
            i = self.parent[i]
        return out[::-1]


def _by_thread(evs: Iterable[Event]) -> Dict[int, _Nest]:
    groups: Dict[int, List[Event]] = {}
    for e in evs:
        groups.setdefault(e.thread, []).append(e)
    return {t: _Nest(g) for t, g in groups.items()}


def _splice(outer: List[str], inner: List[str]) -> List[str]:
    """`inner` put into `outer` from the last place its head holds there,
    or after `outer`."""
    if inner and inner[0] in outer:
        i = len(outer) - 1 - outer[::-1].index(inner[0])
        return outer[:i] + inner
    return outer + inner


class Attribution:
    """The rule of the module docstring over one trace's host events."""

    def __init__(self, events: Sequence[Event], names: Sequence[str] = SPANS):
        names = set(names)
        ops = [e for e in events if e.kind == "cpu_op"]
        self.spans = _by_thread(e for e in ops if e.name in names)
        self.nodes = _by_thread(e for e in ops if e.seq >= 0 and (
            e.scope == BACKWARD_FUNCTION or e.name.startswith(EVALUATE)))
        # other host events (the profiler's own) may share an op's id
        self.ops: Dict[int, List[Event]] = {}
        for e in ops:
            self.ops.setdefault(e.corr, []).append(e)
        self.runtime = {e.corr: e for e in events if e.kind == "runtime"}
        # ops before the one that makes a node share its number (the
        # dispatcher records the next number, not the node's): the node's
        # op, or one inside it, is the last of them
        self.forward: Dict[Tuple[int, int], Event] = {}
        for e in sorted(ops, key=lambda e: e.start):
            if e.seq >= 0 and e.fwd_thread == 0 \
                    and e.scope != BACKWARD_FUNCTION \
                    and not e.name.startswith(EVALUATE):
                self.forward[(e.thread, e.seq)] = e

    def open_at(self, t: int) -> List[Event]:
        """The spans open at time t on the thread whose innermost open
        span began last, outermost first."""
        best: List[Event] = []
        for nest in self.spans.values():
            c = nest.chain(t, t)
            if c and (not best or c[-1].start > best[-1].start):
                best = c
        return best

    def anchor(self, d: Event) -> Optional[Tuple[Optional[int], int, int]]:
        """(thread or None, start, end) of a device event's launch, or
        None where nothing on the host is tied to it."""
        rt = self.runtime.get(d.corr)
        ops = self.ops.get(d.linked or (rt.linked if rt else 0), [])
        if rt is not None:
            op = next((o for o in ops
                       if o.start <= rt.start and rt.end <= o.end), None)
            return (op.thread if op is not None else None, rt.start, rt.end)
        if len(ops) == 1:
            return ops[0].thread, ops[0].start, ops[0].end
        return None

    def _layers(self, thread: Optional[int], a: int, b: int,
                depth: int = 0) -> Tuple[List[Event], List[str]]:
        """(the spans open around [a, b] on `thread`, the path's layer
        part: its spans but the phases)."""
        nest = self.spans.get(thread)
        around = nest.chain(a, b) if nest is not None else []
        nodes = self.nodes.get(thread)
        k = nodes.innermost(a, b) if nodes is not None else -1
        if k >= 0 and depth < 2:
            node = nodes.evs[k]
            inner = [s.name for s in around if s.start >= node.start
                     and s.name not in PHASES]
            fwd = self.forward.get((node.fwd_thread, node.seq))
            if fwd is None:
                return around, inner
            _, outer = self._layers(fwd.thread, fwd.start, fwd.end,
                                    depth + 1)
            return around, _splice(outer, inner)
        if not around:
            around = self.open_at(a)
        return around, [s.name for s in around if s.name not in PHASES]

    def path(self, thread: Optional[int], a: int, b: int) -> str:
        """The span path of an anchor, joined by "/" ("unattributed" where
        no span holds it)."""
        around, layers = self._layers(thread, a, b)
        phase = [s.name for s in around if s.name in PHASES] or \
            [s.name for s in self.all_open(a) if s.name in PHASES]
        return "/".join(phase[:1] + layers) or UNATTRIBUTED

    def all_open(self, t: int) -> List[Event]:
        """The spans open at time t on every thread."""
        return [s for nest in self.spans.values() for s in nest.chain(t, t)]


def record(events: Sequence[Event], rng: Tuple[int, int],
           exclude: Sequence[str] = (), names: Sequence[str] = SPANS
           ) -> dict:
    """The spans' record of a traced range: {"device_s": {path: seconds of
    device events inside `rng`, each clipped to it}, "steps": the
    ``train.forward`` spans in it, "input_idle_s": the idle time of the
    gaps whose middle falls inside a ``train.batch`` span, "idle_s":
    {the span path open at a gap's middle (rule 3): seconds}}.  Device events
    named in `exclude` (the harness's own span) are left out; `names` are
    the spans read."""
    lo, hi = rng
    at = Attribution(events, names)
    device = [e for e in events if e.kind == "device"
              and e.name not in exclude]
    out: Dict[str, float] = {}
    for d in device:
        if d.end <= lo or d.start >= hi:
            continue
        anc = at.anchor(d)
        p = at.path(*anc) if anc is not None else UNATTRIBUTED
        out[p] = out.get(p, 0.0) + (min(d.end, hi) - max(d.start, lo)) / 1e9
    idle: Dict[str, float] = {}
    batch = 0.0
    prev = lo
    gaps = []
    for a, b in busy_intervals([(e.name, e.start, e.end) for e in device],
                               rng):
        if a > prev:
            gaps.append((prev, a))
        prev = max(prev, b)
    if hi > prev:
        gaps.append((prev, hi))
    for a, b in gaps:
        mid = (a + b) // 2
        key = at.path(None, mid, mid)
        key = "no span" if key == UNATTRIBUTED else key
        idle[key] = idle.get(key, 0.0) + (b - a) / 1e9
        if any(s.name == "train.batch" for s in at.all_open(mid)):
            batch += (b - a) / 1e9
    steps = sum(1 for nest in at.spans.values() for s in nest.evs
                if s.name == "train.forward" and lo <= s.start < hi)
    return {"device_s": out, "steps": steps, "input_idle_s": batch,
            "idle_s": idle}


def _under(name: str, but: Sequence[str] = ()) -> Callable[[List[str]],
                                                           bool]:
    return lambda p: name in p and not set(but) & set(p)


#: each per-layer metric of the spans: the paths whose device time it sums
SUMS: Dict[str, Callable[[List[str]], bool]] = {
    "mamba2_ms": _under("mamba2"),
    "mamba2_pointwise_ms": _under("mamba2", ("mamba2.in_proj",
                                             "mamba2.out_proj",
                                             "gla_chunk")),
    "attention_ms": _under("attention"),
    "mlp_ms": _under("mlp"),
    "loss_ms": _under("loss"),
    "optimizer_ms": lambda p: bool({"train.clip", "train.optimizer"}
                                   & set(p)),
}


def per_step_ms(spans: Optional[dict], name: str) -> Optional[float]:
    """Metric `name` (a key of :data:`SUMS`, or ``input_idle_ms``) in
    device milliseconds a step, or None without spans to read."""
    if not spans or not spans.get("steps"):
        return None
    if name == "input_idle_ms":
        total = spans["input_idle_s"]
    else:
        keep = SUMS[name]
        total = sum(s for p, s in spans["device_s"].items()
                    if keep(p.split("/")))
    return 1e3 * total / spans["steps"]


def attributed_share(spans: dict) -> float:
    """The share of the device time in the range that some span holds."""
    total = sum(spans["device_s"].values())
    return 1.0 - spans["device_s"].get(UNATTRIBUTED, 0.0) / total \
        if total else 0.0
