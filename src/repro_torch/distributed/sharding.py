"""Parameter/optimizer/cache/batch sharding rules (TP + FSDP + EP).

The port of the reference's ``distributed/sharding.py``.  Maps every
parameter leaf to a spec by name-based rules with divisibility
fallbacks:
  * TP ("model" axis): attention heads, FFN hidden, MoE experts, vocab;
  * FSDP (ZeRO-3, over the data axes): the complementary large dim;
  * small/odd leaves (norms, scalars, conv taps) replicate.

A spec is the reference's ``PartitionSpec`` as a tuple with one entry
per dimension: ``None`` (replicated), an axis name, or a tuple of axis
names.  The rules read only the mesh's axis sizes, so every function
takes a ``DeviceMesh`` or a plain ``{axis: size}`` mapping.
:func:`named_shardings` turns specs into DTensor placements on a
``DeviceMesh``: ``Shard(d)`` on each axis named at dimension d,
``Replicate()`` on the rest.  The same spec tree shards optimizer
states (they mirror params) and is what restore-time resharding
(elastic restart) targets.

The specs say where a leaf is stored.  :func:`model_split_leaves` says
where the port's layers compute it split over "model" (tensor and
expert parallelism): attention where the split falls on heads
(``HQ % tp == 0`` and ``KH % tp == 0``), an MLP where its hidden width
divides, the vocab (embedding rows, ``lm_head`` columns) where it
divides, the moe layer's experts where ``E % tp == 0``.  Every other
leaf the specs shard on "model" (a head split that falls inside a head,
the generic fallback) is gathered whole over "model" before use, and
its compute is replicated over the model ranks, with the same values.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import TYPE_CHECKING, Any, Dict, Optional, Tuple

from repro_torch.tree import flatten, is_node, map_tree, unflatten

from .meshctx import MeshLike, axis_sizes, placements_of

if TYPE_CHECKING:     # the model code imports this module
    from repro_torch.models.config import ModelConfig

# ----------------------------------------------------------------------
# where the layers compute split over the "model" axis
# ----------------------------------------------------------------------
def heads_split(cfg: ModelConfig, tp: int) -> bool:
    """Attention runs on HQ/tp query and KH/tp KV heads a rank."""
    return tp > 1 and cfg.n_heads % tp == 0 and cfg.n_kv_heads % tp == 0


def hidden_split(f: int, tp: int) -> bool:
    """An MLP of hidden width f runs column-parallel in, row-parallel
    out."""
    return tp > 1 and f % tp == 0


def vocab_split(cfg: ModelConfig, tp: int) -> bool:
    """The embedding lookup, the logits and the loss run on V/tp rows of
    the vocab a rank."""
    return tp > 1 and cfg.vocab_size % tp == 0


def experts_split(cfg: ModelConfig, tp: int) -> bool:
    """The moe layer runs E/tp experts a rank (expert parallelism)."""
    return tp > 1 and cfg.moe_experts > 0 and cfg.moe_experts % tp == 0


def shared_expert_width(cfg: ModelConfig) -> int:
    return cfg.n_shared_experts * (cfg.moe_d_ff or cfg.d_ff)


def _leaf_split(path: str, cfg: ModelConfig, tp: int) -> bool:
    if path.startswith("embed/tokens") or path.startswith("lm_head"):
        return vocab_split(cfg, tp)
    parts = path.split("/")
    if parts[-1] in ("w", "w_q"):  # a dense weight, or its int8 PTQ form
        parts = parts[:-1]
    if len(parts) < 2:
        return False
    owner, last = parts[-2], parts[-1]
    if "shared" in parts and "moe" in parts:
        return last in ("wi", "wg", "wo") and hidden_split(
            shared_expert_width(cfg), tp)
    if owner == "moe" and last in ("wi", "wg", "wo"):
        return experts_split(cfg, tp)
    if owner in ("attn", "cross") and last in ("wq", "wk", "wv", "wo"):
        return heads_split(cfg, tp)
    if owner == "mlp" and last in ("wi", "wg", "wo"):
        return hidden_split(cfg.d_ff, tp)
    return False


def model_split_leaves(spec_tree: Any, cfg: ModelConfig,
                       mesh: MeshLike) -> Dict[str, bool]:
    """{leaf path: whether the layers compute it split over the "model"
    axis} for a tree of specs (``param_specs``).  No leaf is split where
    the mesh's "model" axis has size 1 or is one of the config's data
    axes (the recurrent archs' ``dp_over_model``).  Raises ValueError
    where a layer would compute a leaf split that its spec does not shard
    on "model"."""
    sizes = axis_sizes(mesh)
    sc = cfg.sharding
    model = sc.model_axis
    tp = sizes.get(model, 1) if model not in sc.data_axes else 1
    out = {}
    for path, spec in flatten(spec_tree).items():
        split = _leaf_split(path, cfg, tp)
        if split and not any(e == model or (isinstance(e, tuple)
                                            and model in e) for e in spec):
            raise ValueError(f"{path}: the layers compute it split over "
                             f"{model!r} ({tp}), but its spec {spec} does "
                             f"not shard it there")
        out[path] = split
    return out


Spec = Tuple[Any, ...]


def _fits(shape, dim: int, sizes: Dict[str, int], entry) -> bool:
    if entry is None or dim >= len(shape):
        return False
    names = entry if isinstance(entry, tuple) else (entry,)
    n = 1
    for a in names:
        if a not in sizes:
            return False
        n *= sizes[a]
    return shape[dim] % n == 0 and shape[dim] >= n


def _spec(shape, sizes: Dict[str, int], assignments) -> Spec:
    """assignments: list of (dim, axis_entry) — applied when divisible,
    falling back to the largest dividing prefix of a multi-axis entry."""
    out = [None] * len(shape)
    used = set()
    for dim, entry in assignments:
        if entry is None:
            continue
        names = tuple(entry) if isinstance(entry, tuple) else (entry,)
        names = tuple(a for a in names if a not in used)
        while names:
            cand = names if len(names) > 1 else names[0]
            if _fits(shape, dim, sizes, cand):
                out[dim] = cand
                used.update(names)
                break
            names = names[:-1]
    return tuple(out)


def param_specs(params: Any, cfg: ModelConfig, mesh: MeshLike,
                fsdp: bool = False) -> Any:
    """Spec tree matching `params` (a tree of tensors; shapes are read)."""
    sizes = axis_sizes(mesh)
    sc = cfg.sharding
    model = sc.model_axis if sc.model_axis in sizes else None
    fsdp_axes: Optional[Tuple[str, ...]] = None
    if fsdp:
        axes = tuple(a for a in (sc.fsdp_axes or sc.data_axes)
                     if a in sizes)
        fsdp_axes = axes if axes else None

    def leaf_spec(path: str, x) -> Spec:
        shape = tuple(x.shape)
        nd = len(shape)
        if nd == 0:
            return ()
        L = 1 if "layers/" in path else 0  # stacked leading layer dim

        def d(i):   # dim index offset by the stacked layer dim
            return L + i

        last = path.split("/")[-1]
        if last in ("w", "w_q"):
            lname = path.split("/")[-2]
        else:
            lname = last
        if last == "w_scale":       # per-channel PTQ scales: tiny, replicate
            return ()
        if "norm" in path or lname in ("scale", "bias", "A_log", "D",
                                       "dt_bias", "conv_w", "conv_b", "r"):
            return ()
        if path.startswith("embed/tokens"):
            return _spec(shape, sizes, [(0, model), (1, fsdp_axes)])
        if path.startswith("embed/pos"):
            return _spec(shape, sizes, [(1, fsdp_axes)])
        if path.startswith("lm_head"):
            return _spec(shape, sizes, [(1, model), (0, fsdp_axes)])
        # --- MoE experts: EP over model on the expert dim ---
        if "/moe/" in path or "/shared/" in path:
            if lname in ("wi", "wg") and nd == d(3):
                return _spec(shape, sizes, [(d(0), model), (d(1), fsdp_axes)])
            if lname == "wo" and nd == d(3):
                return _spec(shape, sizes, [(d(0), model), (d(2), fsdp_axes)])
            if lname == "router" or "/router/" in path:
                return _spec(shape, sizes, [(d(0), fsdp_axes)])
            if lname in ("wi", "wg"):   # shared-expert dense mlp (L, d, f)
                return _spec(shape, sizes, [(d(1), model), (d(0), fsdp_axes)])
            if lname == "wo":
                return _spec(shape, sizes, [(d(0), model), (d(1), fsdp_axes)])
        # --- attention projections ---
        if lname in ("wq", "wk", "wv"):
            return _spec(shape, sizes, [(d(1), model), (d(0), fsdp_axes)])
        if lname == "wo":
            return _spec(shape, sizes, [(d(0), model), (d(1), fsdp_axes)])
        # --- dense MLP ---
        if lname in ("wi", "wg"):
            return _spec(shape, sizes, [(d(1), model), (d(0), fsdp_axes)])
        # --- mamba / xlstm projections: TP-free (small), FSDP on d ---
        if lname in ("in_proj", "up_x", "up_z", "w_in"):
            return _spec(shape, sizes, [(d(0), fsdp_axes)])
        if lname in ("out_proj", "down"):
            return _spec(shape, sizes, [(d(1), fsdp_axes)])
        if lname == "w_if":
            return _spec(shape, sizes, [(d(0), fsdp_axes)])
        # generic fallback: try model on the last dim, fsdp on the first
        return _spec(shape, sizes,
                     [(nd - 1, model), (max(0, nd - 2), fsdp_axes)])

    return unflatten(params, {path: leaf_spec(path, x)
                              for path, x in flatten(params).items()})


@dataclass(frozen=True)
class NamedSharding:
    """A spec on a DeviceMesh, as DTensor placements (one per mesh axis)."""
    mesh: Any
    placements: Tuple[Any, ...]


def named_shardings(spec_tree: Any, mesh) -> Any:
    return map_tree(lambda s: NamedSharding(mesh, placements_of(s, mesh)),
                    spec_tree)


def _first_leaf(tree: Any, is_leaf) -> Any:
    """The first leaf of `tree` in flatten order, a node for which
    is_leaf holds counting as a leaf (None for an empty tree)."""
    if is_leaf(tree) or not is_node(tree):
        return tree
    for k in sorted(tree):
        leaf = _first_leaf(tree[k], is_leaf)
        if leaf is not None:
            return leaf
    return None


def opt_state_specs(opt_state: Any, param_spec_tree: Any,
                    params_shapes: Any) -> Any:
    """Optimizer-state specs.

    AdamW m/v mirror the params exactly.  Adafactor's factored moments
    drop one trailing dim: vr = spec[:-1], vc = spec[:-2] + spec[-1:];
    factoring only happens for >=2-D params (see optimizers._factored).
    Scalars (count) replicate."""
    def moments(x):
        return is_node(x) and set(x) <= {"vr", "vc", "v"}

    out = {}
    for k, v in opt_state.items():
        if k == "count":
            out[k] = ()
        elif k == "m":
            out[k] = param_spec_tree        # mirrors params exactly
        elif k == "v":
            first = _first_leaf(v, moments)
            if is_node(first):                              # Adafactor
                def per_param(sp, shape_leaf):
                    shape = tuple(shape_leaf.shape)
                    entries = list(sp) + [None] * (len(shape) - len(sp))
                    if len(shape) >= 2 and shape[-1] > 1 and shape[-2] > 1:
                        return {"vr": tuple(entries[:-1]),
                                "vc": tuple(entries[:-2] + entries[-1:])}
                    return {"v": tuple(entries)}
                out[k] = map_tree(per_param, param_spec_tree, params_shapes)
            else:                                           # AdamW
                out[k] = param_spec_tree
        else:
            out[k] = map_tree(lambda _: (), v) if is_node(v) else ()
    return out


def cache_specs(caches: Any, cfg: ModelConfig, mesh: MeshLike) -> Any:
    """KV caches: shard batch over data axes, kv-heads over model when
    divisible; SSM states: batch over data."""
    sizes = axis_sizes(mesh)
    sc = cfg.sharding
    data = tuple(a for a in sc.data_axes if a in sizes) or None
    model = sc.model_axis if sc.model_axis in sizes else None

    def leaf(x) -> Spec:
        shape = tuple(x.shape)
        if len(shape) == 5:
            # (L, B, S, KH, D) kv cache: batch over data; kv-heads over
            # model when divisible, else the SEQ dim over model
            assignments = [(1, data)]
            if model is not None and shape[3] % sizes[model] == 0:
                assignments.append((3, model))
            else:
                assignments.append((2, model))
            return _spec(shape, sizes, assignments)
        if len(shape) >= 2:
            return _spec(shape, sizes, [(1, data)])
        return ()

    return map_tree(leaf, caches)


def batch_specs(batch_shapes: Dict[str, Any], cfg: ModelConfig,
                mesh: MeshLike) -> Dict[str, Spec]:
    """Batch dim over the data axes: the largest prefix of them whose
    size divides it (none: replicated)."""
    sizes = axis_sizes(mesh)
    sc = cfg.sharding
    data = tuple(a for a in sc.data_axes if a in sizes) or None
    out = {}
    for k, v in batch_shapes.items():
        shape = tuple(v.shape) if hasattr(v, "shape") else tuple(v)
        spec = [None] * len(shape)
        if len(shape) >= 1 and data is not None:
            names = data
            while names:
                n = 1
                for a in names:
                    n *= sizes[a]
                if shape[0] % n == 0:
                    spec[0] = names if len(names) > 1 else names[0]
                    break
                names = names[:-1]
        out[k] = tuple(spec)
    return out
