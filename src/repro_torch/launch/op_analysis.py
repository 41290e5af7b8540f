"""Per-device analysis of one eager step: FLOPs, bytes, collectives and
the peak of live memory, counted from what the step dispatches.

The port's counterpart of the reference's ``launch/hlo_analysis.py``.
The reference reads the three roofline inputs out of compiled, post-SPMD
HLO text, and has to recover while-loop trip counts because a scanned
layer stack appears once in the text.  PyTorch has no HLO: the port's
step runs eagerly, every layer and every loop iteration is dispatched
op by op, so nothing is parsed and there are no trip counts to recover
(no ``while_trip_counts`` field).  :func:`analyze` runs the step inside
a ``TorchDispatchMode`` (on ``meta`` tensors in the dry run, so nothing
is computed or allocated) and counts, per device:

  * ``dot_flops`` -- the FLOPs of aten's matrix products, from
    ``torch.utils.flop_counter``'s registry (2 M N K a product, as the
    reference counts a ``dot``), plus what each kernel op reports through
    :func:`record_kernel`: a kernel is one opaque call, invisible to aten
    on ``meta``, so its meta route reports the FLOPs of the reference's
    oracle for the same call -- attention the full S x Sk score and
    output products (4 S Sk D a head, masked or not), the GLA scan its
    four chunk products, a quantized linear 2 M N K -- so that the
    port's numbers line up with the reference's HLO dot FLOPs;
  * ``memory_bytes`` -- operand + result bytes of every op, as the
    reference sums them over the top-level HLO ops; views and metadata
    ops are skipped, as the reference's ``_SKIP_MEM`` skips ``bitcast``,
    ``tuple``, ``parameter`` and the like, and so are bare allocations
    (``empty``); a kernel op counts its operands and results once;
  * collective wire bytes per class (``all-reduce``, ``all-gather``,
    ``reduce-scatter``, ``all-to-all``, ``collective-permute``) from each
    ``c10d`` op's result bytes and its process group's size n, with the
    reference's ring factors: all-gather result (n-1)/n, reduce-scatter
    result (n-1), all-reduce 2 result (n-1)/n, all-to-all result (n-1)/n,
    collective-permute result; also tallied by mesh axis (``axes`` maps a
    process group's name to its axis), so that a roofline can give each
    axis its own link;
  * ``peak_bytes`` -- the most bytes of live storages at any op (a
    storage is tracked from the op that made it, or from
    :meth:`OpStats.track` for the step's arguments, until a weakref
    finalizer sees it freed), with the largest live tensors at that peak
    (shape, dtype, the op and the source line that made them); and the
    top ops by FLOPs and by bytes (the port's counterpart of the
    reference's ``tools/top_ops.py``, which reads HLO).

Nothing here imports JAX or the reference package.
"""
from __future__ import annotations

import contextlib
import sys
import weakref
from dataclasses import dataclass, field
from typing import Any, Dict, Iterator, List, Optional, Tuple

import torch
from torch.utils._python_dispatch import TorchDispatchMode

COLLECTIVES = ("all-reduce", "all-gather", "reduce-scatter", "all-to-all",
               "collective-permute")

#: c10d op name -> the reference's collective class
_C10D = {
    "allreduce_": "all-reduce",
    "allreduce_coalesced_": "all-reduce",
    "allgather_": "all-gather",
    "_allgather_base_": "all-gather",
    "allgather_coalesced_": "all-gather",
    "allgather_into_tensor_coalesced_": "all-gather",
    "reduce_scatter_": "reduce-scatter",
    "_reduce_scatter_base_": "reduce-scatter",
    "reduce_scatter_tensor_coalesced_": "reduce-scatter",
    "alltoall_": "all-to-all",
    "alltoall_base_": "all-to-all",
    "send": "collective-permute",
    "recv_": "collective-permute",
}
#: c10d ops whose first tensor argument is the result (the rest: inputs)
_C10D_OUT_FIRST = {"allgather_", "_allgather_base_", "allgather_coalesced_",
                   "allgather_into_tensor_coalesced_", "reduce_scatter_",
                   "_reduce_scatter_base_",
                   "reduce_scatter_tensor_coalesced_", "alltoall_",
                   "alltoall_base_"}

#: aten ops that move no bytes (allocations and metadata)
_SKIP_MEM = {"empty", "empty_like", "empty_strided", "new_empty",
             "new_empty_strided", "detach", "lift_fresh", "alias",
             "_local_scalar_dense", "resize_", "set_", "sym_size",
             "sym_stride", "sym_numel", "is_same_size", "record_stream"}

#: how many live tensors at the peak, and top ops, an analysis keeps
TOP = 20


def ring_wire_bytes(kind: str, result_bytes: float, n: int) -> float:
    """Per-device link bytes of one collective (the reference's ring
    factors, ``hlo_analysis.py``)."""
    if kind == "all-gather":
        return result_bytes * (n - 1) / max(1, n)
    if kind == "reduce-scatter":
        return result_bytes * (n - 1)
    if kind == "all-reduce":
        return 2.0 * result_bytes * (n - 1) / max(1, n)
    if kind == "all-to-all":
        return result_bytes * (n - 1) / max(1, n)
    return float(result_bytes)


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _site() -> str:
    """file:line of the innermost frame in the port's own code outside
    the kernel ops and this module (the model line that called them), or
    of the innermost frame outside torch."""
    f = sys._getframe(2)
    fallback = None
    while f is not None:
        fn = f.f_code.co_filename
        if "repro_torch" in fn and "kernels" not in fn \
                and not fn.endswith("op_analysis.py"):
            i = fn.find("repro_torch")
            return f"{fn[i:]}:{f.f_lineno}"
        if fallback is None and "/torch/" not in fn \
                and not fn.endswith("op_analysis.py"):
            fallback = f"{fn}:{f.f_lineno}"
        f = f.f_back
    return fallback or "?"


@dataclass
class OpStats:
    """What :func:`analyze` counted, per device (see the module
    docstring)."""
    dot_flops: float = 0.0
    memory_bytes: float = 0.0
    collective_bytes: Dict[str, float] = field(
        default_factory=lambda: {c: 0.0 for c in COLLECTIVES})
    collective_counts: Dict[str, int] = field(
        default_factory=lambda: {c: 0 for c in COLLECTIVES})
    #: {axis: {class: wire bytes}} and {axis: {class: count}}
    collective_bytes_by_axis: Dict[str, Dict[str, float]] = field(
        default_factory=dict)
    collective_counts_by_axis: Dict[str, Dict[str, int]] = field(
        default_factory=dict)
    #: the most bytes of live storages at any op, and the bytes live when
    #: the analysis began (the arguments :meth:`track` registered)
    peak_bytes: int = 0
    argument_bytes: int = 0
    #: the TOP largest live tensors at the peak: dicts of shape, dtype,
    #: bytes, op and site (the source line that made them)
    peak_tensors: List[Dict[str, Any]] = field(default_factory=list)
    #: the live bytes at the peak summed by where they were made (the
    #: TOP largest sums): dicts of site, op, bytes and tensors
    peak_by_site: List[Dict[str, Any]] = field(default_factory=list)
    #: {(op, site): [count, flops, bytes]}
    ops: Dict[Tuple[str, str], List[float]] = field(default_factory=dict)
    #: kernel op name -> [calls, flops, bytes]
    kernels: Dict[str, List[float]] = field(default_factory=dict)
    n_ops: int = 0

    def __post_init__(self):
        self._live: Dict[int, Tuple[int, Dict[str, Any]]] = {}
        self._cur = 0
        self._dirty = False
        self._open = True
        self._peak_live: List[Tuple[int, Dict[str, Any]]] = []

    @property
    def total_collective_bytes(self) -> float:
        return sum(self.collective_bytes.values())

    # ------------------------------------------------------------------
    # live storages
    # ------------------------------------------------------------------
    def _add(self, t: torch.Tensor, op: str, site: str) -> None:
        st = t.untyped_storage()
        key = st._cdata
        if key in self._live:
            return
        n = st.nbytes()
        self._live[key] = (n, dict(shape=list(t.shape),
                                   dtype=str(t.dtype).split(".")[-1],
                                   bytes=n, op=op, site=site))
        self._cur += n
        weakref.finalize(st, self._free, key)
        if self._cur > self.peak_bytes:
            self.peak_bytes = self._cur
            self._dirty = True

    def _free(self, key: int) -> None:
        if not self._open or key not in self._live:
            return
        if self._dirty:
            self._snapshot()
        self._cur -= self._live.pop(key)[0]

    def _snapshot(self) -> None:
        """Keep the live set at the peak (read by :meth:`close`)."""
        self._dirty = False
        self._peak_live = list(self._live.values())

    def _report_peak(self) -> None:
        live = sorted((info for _, info in self._peak_live),
                      key=lambda d: -d["bytes"])
        self.peak_tensors = [dict(d) for d in live[:TOP]]
        sites: Dict[Tuple[str, str], List[int]] = {}
        for d in live:
            row = sites.setdefault((d["site"], d["op"]), [0, 0])
            row[0] += d["bytes"]
            row[1] += 1
        self.peak_by_site = [
            dict(site=site, op=op, bytes=b, tensors=n)
            for (site, op), (b, n) in sorted(sites.items(),
                                             key=lambda kv: -kv[1][0])[:TOP]]

    def track(self, tree: Any, label: str) -> None:
        """Register the device (``meta``) tensors of `tree` (nested dicts,
        lists, DTensors: their local shards) as live from the start, made
        by `label`."""
        for t in _tensors(tree):
            if t.device.type != "meta":
                continue           # host scalars (the optimizer's count)
            before = self._cur
            self._add(t, f"argument:{label}", label)
            self.argument_bytes += self._cur - before

    def close(self) -> None:
        if self._dirty:
            self._snapshot()
        self._report_peak()
        self._open = False
        self._live.clear()
        self._peak_live = []

    # ------------------------------------------------------------------
    # reports
    # ------------------------------------------------------------------
    def _count(self, op: str, site: str, flops: float, nbytes: float) -> None:
        row = self.ops.setdefault((op, site), [0, 0.0, 0.0])
        row[0] += 1
        row[1] += flops
        row[2] += nbytes

    def top_ops(self, by: str = "flops", n: int = TOP) -> List[Dict]:
        """The n (op, site) rows with the most FLOPs ("flops") or bytes
        ("bytes")."""
        i = 1 if by == "flops" else 2
        rows = sorted(self.ops.items(), key=lambda kv: -kv[1][i])[:n]
        return [dict(op=op, site=site, count=int(c), flops=f, bytes=b)
                for (op, site), (c, f, b) in rows if (f if i == 1 else b)]


def _tensors(tree: Any) -> Iterator[torch.Tensor]:
    if isinstance(tree, torch.Tensor):
        if hasattr(tree, "to_local"):
            yield tree.to_local()
        else:
            yield tree
    elif isinstance(tree, dict):
        for v in tree.values():
            yield from _tensors(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _tensors(v)


_ACTIVE: List[OpStats] = []


def active() -> Optional[OpStats]:
    """The analysis in progress, or None."""
    return _ACTIVE[-1] if _ACTIVE else None


def record_kernel(name: str, flops: float, nbytes: float) -> None:
    """A kernel op's meta route reports one call: its FLOPs (as the
    reference's oracle computes them) and its operand + result bytes.
    Does nothing when no analysis is active."""
    stats = active()
    if stats is None:
        return
    stats.dot_flops += flops
    stats.memory_bytes += nbytes
    row = stats.kernels.setdefault(name, [0, 0.0, 0.0])
    row[0] += 1
    row[1] += flops
    row[2] += nbytes
    stats._count(f"kernel:{name}", _site(), flops, nbytes)


def _flop_registry():
    from torch.utils.flop_counter import flop_registry
    return flop_registry


def _leaves(x: Any, out: List[Any]) -> List[Any]:
    """The leaves of nested lists, tuples and dicts, in order (a faster
    ``tree_flatten`` for op arguments)."""
    t = type(x)
    if t is list or t is tuple:
        for v in x:
            _leaves(v, out)
    elif t is dict:
        for v in x.values():
            _leaves(v, out)
    else:
        out.append(x)
    return out


def _key(a: Any) -> Any:
    """A hashable stand-in for one flattened argument of an op."""
    if isinstance(a, torch.Tensor):
        return (tuple(a.shape), a.stride(), a.dtype, a.storage_offset())
    try:
        hash(a)
        return a
    except TypeError:
        return repr(a)


class _Mode(TorchDispatchMode):
    """The analysis' dispatch mode.  Many of aten's meta kernels run in
    Python, which makes an eager step of a recurrent model (a loop a time
    step) slow to trace; so a functional aten op on meta tensors is run
    once per distinct signature (its inputs' shapes, strides, dtypes and
    its other arguments), and later calls get fresh meta tensors of the
    outputs' recorded shapes, strides and dtypes.  Views, in-place ops
    and ops whose outputs share an input's storage always run."""

    def __init__(self, stats: OpStats, axes: Dict[str, str]):
        super().__init__()
        self.stats = stats
        self.axes = axes
        self.flops = _flop_registry()
        self._info: Dict[Any, Tuple[bool, bool, str, Any]] = {}
        self._outs: Dict[Tuple, List[Tuple]] = {}
        #: ops seen to return an input's storage: never cached
        self._aliasing = set()

    def _func_info(self, func) -> Tuple[bool, bool, str, Any]:
        """(a view, cacheable, name, its FLOP formula) of an op."""
        info = self._info.get(func)
        if info is None:
            sch = func._schema
            rets = sch.returns
            view = any(r.alias_info is not None and not r.alias_info.is_write
                       for r in rets)
            name = func._opname
            cache = (func.namespace == "aten" and bool(rets)
                     and not view and not sch.is_mutable
                     and all(r.alias_info is None and str(r.type) == "Tensor"
                             for r in rets)
                     and "view" not in name and "alias" not in name
                     and name not in _SKIP_MEM)
            info = self._info[func] = (view, cache, name,
                                       self.flops.get(func.overloadpacket))
        return info

    def _run(self, func, cache, flat, args, kwargs):
        ins = [a for a in flat if isinstance(a, torch.Tensor)]
        key = None
        if cache and ins and func not in self._aliasing \
                and all(t.is_meta for t in ins):
            key = (func, len(flat)) + tuple(_key(a) for a in flat)
            metas = self._outs.get(key)
            if metas is not None:
                outs = [torch.empty_strided(sh, st, dtype=dt, device="meta")
                        for sh, st, dt in metas]
                return (outs[0] if len(outs) == 1 else tuple(outs)), ins
        out = func(*args, **kwargs)
        if key is not None:
            outs = _leaves(out, [])
            given = {t.untyped_storage()._cdata for t in ins}
            if all(isinstance(o, torch.Tensor) and o.is_meta
                   and o.untyped_storage()._cdata not in given
                   for o in outs):
                self._outs[key] = [(tuple(o.shape), o.stride(), o.dtype)
                                   for o in outs]
            else:
                self._aliasing.add(func)
        return out, ins

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if any(t is not torch.Tensor and getattr(
                t, "__torch_dispatch__", None) is not None
               and t.__torch_dispatch__ is not torch.Tensor.__torch_dispatch__
               for t in types):
            return NotImplemented      # a subclass (DTensor) unwraps first
        view, cache, name, flop_fn = self._func_info(func)
        flat = _leaves(kwargs, _leaves(args, []))
        out, ins = self._run(func, cache, flat, args, kwargs)
        s = self.stats
        s.n_ops += 1
        outs = [o for o in _leaves(out, []) if isinstance(o, torch.Tensor)]
        if func.namespace == "c10d":
            self._collective(func, args, ins, outs)
            return out
        if not any(t.device.type == "meta" for t in ins + outs):
            return out                 # host work (schedules, scalars)
        site = None
        if outs and not view:
            site = _site()
            for o in outs:
                s._add(o, name, site)
        flops = 0.0
        if flop_fn is not None:
            flops = float(flop_fn(*args, **kwargs, out_val=out))
        nbytes = 0.0
        if not view and name not in _SKIP_MEM:
            nbytes = float(sum(_nbytes(t) for t in ins)
                           + sum(_nbytes(t) for t in outs))
        if flops or nbytes:
            s.dot_flops += flops
            s.memory_bytes += nbytes
            s._count(f"aten.{name}", site or _site(), flops, nbytes)
        return out

    def _collective(self, func, args, ins, outs) -> None:
        import torch.distributed as dist
        name = func._opname
        kind = _C10D.get(name)
        if kind is None:
            return
        pg = None
        for a in args:
            if isinstance(a, torch.ScriptObject):
                try:
                    pg = dist.ProcessGroup.unbox(a)
                    break
                except RuntimeError:
                    continue
        n = pg.size() if pg is not None else 1
        axis = self.axes.get(pg.group_name, "world") if pg is not None \
            else "world"
        flat = [a for a in _leaves(args, []) if isinstance(a, torch.Tensor)]
        if name in _C10D_OUT_FIRST:
            result = flat[:1] if name.startswith("_") else \
                _leaves(args[0], [])
        else:
            result = flat
        rb = float(sum(_nbytes(t) for t in result))
        wire = ring_wire_bytes(kind, rb, n)
        s = self.stats
        s.collective_bytes[kind] += wire
        s.collective_counts[kind] += 1
        by = s.collective_bytes_by_axis.setdefault(
            axis, {c: 0.0 for c in COLLECTIVES})
        cnt = s.collective_counts_by_axis.setdefault(
            axis, {c: 0 for c in COLLECTIVES})
        by[kind] += wire
        cnt[kind] += 1
        nbytes = float(sum(_nbytes(t) for t in flat))
        s.memory_bytes += nbytes
        s._count(f"c10d.{name}", _site(), 0.0, nbytes)


@contextlib.contextmanager
def analyze(axes: Optional[Dict[str, str]] = None,
            arguments: Optional[Dict[str, Any]] = None
            ) -> Iterator[OpStats]:
    """Count what the block dispatches (module docstring).  `axes` maps a
    process group's name to its mesh axis (:func:`mesh_axes`); each entry
    of `arguments` ({label: tree}) is registered live from the start.
    Yields the OpStats, complete when the block ends."""
    stats = OpStats()
    for label, tree in (arguments or {}).items():
        stats.track(tree, label)
    _ACTIVE.append(stats)
    try:
        with _Mode(stats, axes or {}):
            yield stats
    finally:
        _ACTIVE.pop()
        stats.close()


def mesh_axes(mesh) -> Dict[str, str]:
    """{process group name: mesh axis name} of a DeviceMesh (empty for
    None)."""
    if mesh is None:
        return {}
    return {mesh.get_group(i).group_name: name
            for i, name in enumerate(mesh.mesh_dim_names)}
