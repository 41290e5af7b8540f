"""The port's sharding rules against the reference's, leaf by leaf.

For every config of ``configs/`` at the reference's production meshes
(16, 16) over ("data", "model") and (2, 16, 16) over ("pod", "data",
"model"), and at (2, 4): ``param_specs`` (FSDP off and on),
``opt_state_specs``, ``cache_specs`` and ``batch_specs`` of the port
equal the reference's at every path.  Shapes come from meta tensors on
the port's side (``init_params`` / ``init_caches`` / the optimizer's
init on ``torch_device="meta"``) and from ``jax.eval_shape`` on the
reference's, over a ``jax.sharding.AbstractMesh`` (no devices): the
rules read only the axis sizes, and the port takes them as a mapping.
The comparison is exact (tuples of axis entries).  Also the placements
``named_shardings`` derives from a spec, on a fake mesh object that has
only axis names.
"""
import jax
import numpy as np
import pytest
from jax.sharding import AbstractMesh
from torch.distributed.tensor import Replicate, Shard

from repro.configs import get_arch as r_get_arch
from repro.distributed import sharding as R
from repro.models import transformer as RT
from repro.optim import make_optimizer as r_make_optimizer
from repro_torch import tree
from repro_torch.configs import get_arch, list_archs
from repro_torch.distributed import sharding as S
from repro_torch.models import transformer as T
from repro_torch.optim import make_optimizer

MESHES = {"16x16": ((16, 16), ("data", "model")),
          "2x16x16": ((2, 16, 16), ("pod", "data", "model")),
          "2x4": ((2, 4), ("data", "model"))}
CACHE_BATCH, CACHE_LEN = 32, 256
BATCHES = (1, 2, 8, 16, 32, 256, 512)


def _ref_flat(specs):
    """path -> tuple(spec) of a reference spec tree."""
    flat = jax.tree_util.tree_flatten_with_path(
        specs, is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))[0]
    return {"/".join(str(getattr(k, "key", getattr(k, "idx", k)))
                     for k in kp): tuple(v) for kp, v in flat}


def _port_flat(specs):
    return dict(tree.flatten(specs))


def _same(ref_specs, port_specs, what):
    r, p = _ref_flat(ref_specs), _port_flat(port_specs)
    assert sorted(r) == sorted(p), what
    bad = {k: (r[k], p[k]) for k in r if r[k] != p[k]}
    assert not bad, f"{what}: {len(bad)} leaves differ, e.g. " \
                    f"{list(bad.items())[:3]}"
    return len(r)


@pytest.fixture(scope="module")
def shapes():
    """arch -> (reference shapes, port meta trees), built once."""
    out = {}

    def get(arch):
        if arch not in out:
            spec, rspec = get_arch(arch), r_get_arch(arch)
            cfg, rcfg = spec.model, rspec.model
            r_params = jax.eval_shape(
                lambda: RT.init_params(jax.random.PRNGKey(0), rcfg))
            r_opt = jax.eval_shape(r_make_optimizer(rspec.optimizer)[0],
                                   r_params)
            r_caches = jax.eval_shape(
                lambda: RT.init_caches(rcfg, CACHE_BATCH, CACHE_LEN))
            params = T.init_params(cfg, 0, "meta").tree()
            opt = make_optimizer(spec.optimizer)[0](params)
            caches = T.init_caches(cfg, CACHE_BATCH, CACHE_LEN,
                                   torch_device="meta")
            out[arch] = (cfg, rcfg, r_params, r_opt, r_caches, params, opt,
                         caches)
        return out[arch]
    return get


@pytest.mark.parametrize("mesh", sorted(MESHES))
@pytest.mark.parametrize("arch", list_archs())
def test_specs_equal_the_reference(shapes, arch, mesh):
    (cfg, rcfg, r_params, r_opt, r_caches, params, opt,
     caches) = shapes(arch)
    shape, axes = MESHES[mesh]
    amesh = AbstractMesh(shape, axes)
    sizes = dict(zip(axes, shape))
    n = 0
    for fsdp in (False, True):
        r_ps = R.param_specs(r_params, rcfg, amesh, fsdp=fsdp)
        ps = S.param_specs(params, cfg, sizes, fsdp=fsdp)
        n += _same(r_ps, ps, f"param_specs fsdp={fsdp}")
        r_os = R.opt_state_specs(r_opt, r_ps, r_params)
        os_ = S.opt_state_specs(opt, ps, params)
        n += _same(r_os, os_, f"opt_state_specs fsdp={fsdp}")
    n += _same(R.cache_specs(r_caches, rcfg, amesh),
               S.cache_specs(caches, cfg, sizes), "cache_specs")
    for b in BATCHES:
        bs = {"tokens": (b, 128), "targets": (b, 128)}
        r_bs = R.batch_specs({k: np.zeros(v, np.int8) for k, v in bs.items()},
                             rcfg, amesh)
        assert {k: tuple(v) for k, v in r_bs.items()} == \
            S.batch_specs(bs, cfg, sizes), f"batch_specs B{b}"
    assert n > 0


def test_fsdp_shards_the_large_leaves():
    """On (2, 4), FSDP puts the data axis on a dim of llama's stacked
    projections, and the model axis stays where TP puts it."""
    cfg = get_arch("llama3.2-3b").model
    params = T.init_params(cfg, 0, "meta").tree()
    specs = S.param_specs(params, cfg, {"data": 2, "model": 4}, fsdp=True)
    assert specs["layers"]["attn"]["attn"]["wq"]["w"] == (None, "data",
                                                          "model")
    assert specs["embed"]["tokens"] == ("model", "data")
    assert specs["layers"]["attn"]["ln1"]["scale"] == ()


class _Mesh:
    """Axis names alone: what placements are derived from."""
    mesh_dim_names = ("pod", "data", "model")


@pytest.mark.parametrize("spec,want", [
    ((), (Replicate(), Replicate(), Replicate())),
    ((None, "model"), (Replicate(), Replicate(), Shard(1))),
    ((("pod", "data"), None), (Shard(0), Shard(0), Replicate())),
    (("data", "model", None), (Replicate(), Shard(0), Shard(1))),
])
def test_named_shardings_placements(spec, want):
    sh = S.named_shardings({"a": {"b": spec}}, _Mesh())["a"]["b"]
    assert sh.placements == want and isinstance(sh.mesh, _Mesh)
