"""The LM mesh path's placements (``repro_torch.launch.sharding``,
``launch/steps.py::_zero1_spec``) against the JAX package's specs.

For every leaf of every architecture, at meshes (16, 16), (2, 16, 16)
and (2, 2), the port's per-mesh-dimension placements equal the
reference's ``PartitionSpec``s read as placements (a tensor dim over an
axis → ``Shard(dim)`` on that mesh dimension).  The reference's specs
come from a ``jax.sharding.AbstractMesh``, which needs no devices; the
port's from a dict of axis sizes, which needs no process group.
"""
import jax
import pytest
from jax.sharding import AbstractMesh, PartitionSpec as P
from torch.distributed.tensor import Replicate, Shard

from repro.configs import get_config as ref_config
from repro.configs.base import SHAPES as REF_SHAPES
from repro.launch import sharding as rsh
from repro.launch import steps as rsteps
from repro.models import lm as rlm

from repro_torch.configs import ARCH_IDS, get_config
from repro_torch.configs.base import SHAPES
from repro_torch.launch import sharding as tsh
from repro_torch.launch import steps as tsteps
from repro_torch.models import lm as tlm

MESHES = {"16x16": {"data": 16, "model": 16},
          "2x16x16": {"pod": 2, "data": 16, "model": 16},
          "2x2": {"data": 2, "model": 2}}


def _abstract(sizes):
    return AbstractMesh(tuple(sizes.values()), tuple(sizes))


def _as_placements(spec, sizes):
    """A reference ``PartitionSpec`` as one placement per mesh axis."""
    out = []
    for name in sizes:
        dims = [d for d, e in enumerate(spec)
                if e == name or (isinstance(e, tuple) and name in e)]
        out.append(Shard(dims[0]) if dims else Replicate())
    return out


def _leaves(tree, path=()):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], path + (k,))
    else:
        yield path, tree


def _get(tree, path):
    for k in path:
        tree = tree[k]
    return tree


@pytest.mark.parametrize("mesh", sorted(MESHES))
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_param_placements_equal_reference(arch, mesh):
    sizes = MESHES[mesh]
    ref = rsh.param_pspecs(ref_config(arch), _abstract(sizes))
    got = tsh.param_placements(get_config(arch), sizes)
    paths = [p for p, _ in _leaves(got)]
    assert len(paths) == len(jax.tree.leaves(
        ref, is_leaf=lambda x: isinstance(x, P)))
    for path in paths:
        assert _get(got, path) == _as_placements(_get(ref, path), sizes), path


@pytest.mark.parametrize("mesh", sorted(MESHES))
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_zero1_placements_equal_reference(arch, mesh):
    """``_zero1_spec`` on every leaf: the data axis on the first
    still-unsharded, divisible dim."""
    sizes = MESHES[mesh]
    amesh = _abstract(sizes)
    cfg = get_config(arch)
    got = tsteps.opt_state_placements(cfg, sizes, zero1=True)["m"]
    for path, (shape, role) in _leaves(tlm.model_defs(cfg)):
        want = rsteps._zero1_spec(rsh.role_pspec(role, shape, amesh),
                                  shape, amesh)
        assert _get(got, path) == _as_placements(want, sizes), path
        assert tsteps._zero1_spec(tsh.role_spec(role, shape, sizes), shape,
                                  sizes) == tuple(want) + (None,) * (
            len(shape) - len(want)), path


def _ref_shape_specs(specs):
    return {k: jax.ShapeDtypeStruct(v.shape, v.dtype)
            for k, v in specs.items()}


@pytest.mark.parametrize("mesh", sorted(MESHES))
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_batch_and_cache_placements_equal_reference(arch, mesh):
    sizes = MESHES[mesh]
    amesh = _abstract(sizes)
    rcfg, cfg = ref_config(arch), get_config(arch)
    for shape in ("train_4k", "prefill_32k", "decode_32k", "long_500k"):
        rcell, cell = REF_SHAPES[shape], SHAPES[shape]
        if cell.kind != "decode":
            want = rsh.batch_shardings(
                rcfg, _ref_shape_specs(rlm.input_specs(rcfg, rcell)), amesh)
            got = tsh.batch_placements(tlm.input_specs(cfg, cell), sizes)
            assert sorted(got) == sorted(want)
            for k in got:
                assert got[k] == _as_placements(want[k].spec, sizes), k
            continue
        tok = {"token": jax.ShapeDtypeStruct((rcell.global_batch, 1),
                                             jax.numpy.int32)}
        want = rsh.batch_shardings(rcfg, tok, amesh)["token"]
        got = tsh.batch_placements(tlm.input_specs(cfg, cell), sizes)
        assert got["token"] == _as_placements(want.spec, sizes)
        for seq in (False, True):
            want = rsh.cache_shardings(
                rcfg, _ref_shape_specs(rlm.cache_specs(rcfg, rcell)), amesh,
                shard_seq=seq)
            got = tsh.cache_placements(tlm.cache_specs(cfg, cell), sizes,
                                       shard_seq=seq)
            assert sorted(got) == sorted(want)
            for k in got:
                assert got[k] == _as_placements(want[k].spec, sizes), (k, seq)


class _FakeMesh:
    """The reference test's stand-in mesh (model 16, data 16)."""
    def __init__(self, model=16):
        self.shape = {"model": model, "data": 16}
        self.axis_names = ("data", "model")


@pytest.mark.parametrize("role,shape", [
    ("col", (80, 8192, 4096)), ("col", (4, 64, 25)), ("col", (4, 7, 25)),
    ("expert", (24, 32, 64, 512)), ("expert", (32, 40, 1536, 512)),
    ("embed", (152064, 8192)), ("row", (4, 25, 64)), ("row", (4, 7, 25)),
    ("col_b", (4, 24)), ("expert_in", (32, 40, 1536, 512)),
    ("expert_down", (32, 40, 512, 1536)), ("rep", (4, 64)),
])
def test_role_pspec_divisibility_fallbacks(role, shape):
    """``tests/test_launch_units.py``'s cases (col → contracting dim →
    replicate; expert → ff; vocab-parallel embed) and the other roles,
    against the reference's ``role_pspec``."""
    sizes = {"data": 16, "model": 16}
    want = rsh.role_pspec(role, shape, _FakeMesh())
    assert tsh.role_spec(role, shape, sizes) == tuple(want)
    assert tsh.role_pspec(role, shape, sizes) == _as_placements(want, sizes)


def test_role_pspec_fallback_values():
    """The reference test's expected specs, as placements."""
    m = {"data": 16, "model": 16}
    R = Replicate()
    assert tsh.role_pspec("col", (80, 8192, 4096), m) == [R, Shard(2)]
    assert tsh.role_pspec("col", (4, 64, 25), m) == [R, Shard(1)]
    assert tsh.role_pspec("col", (4, 7, 25), m) == [R, R]
    assert tsh.role_pspec("expert", (24, 32, 64, 512), m) == [R, Shard(1)]
    assert tsh.role_pspec("expert", (32, 40, 1536, 512), m) == [R, Shard(3)]
    assert tsh.role_pspec("embed", (152064, 8192), m) == [R, Shard(0)]
    assert tsh.batch_pspec({"pod": 2, "data": 16, "model": 16}) == [
        Shard(0), Shard(0), R]
