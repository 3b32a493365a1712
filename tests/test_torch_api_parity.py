"""The port does all that the JAX package does: every public name and
parameter of ``src/repro`` has a counterpart under the same module path in
``src/repro_torch``, or stands on ``DEVIATIONS`` below with its reason.

Both packages' sources are read with ``ast``; neither is imported by the
surface checks.  A module's public surface is its functions, classes and
assignments whose names do not start with ``_``; a class's is its public
methods and properties, its ``__init__`` and its annotated fields; a
function's is its parameters.  A package ``__init__`` of the reference
adds the names it re-exports.  A name the port imports into a module
counts as that module's, with the signature of its definition.

* One case per module of the reference: each name or parameter without
  a counterpart must be on the list.
* The list holds only what is missing (an item the port gains leaves
  it) and only what the reference has.
* One case each for the items the port gained to close the gap, held
  against the reference's value on the same inputs.
"""
import ast
import pathlib

import numpy as np
import pytest

SRC = pathlib.Path(__file__).resolve().parents[1] / "src"

_DEVICE_PICKS = ("the device picks the implementation: the CUDA kernel on a "
                 "CUDA tensor, its plain version on a CPU one; there is no "
                 "Pallas backend or interpret mode")
_MULTI_CONTROLLER = ("multi-controller partitioned training: one process per "
                     "shard over torch.distributed (dist/comm.py), where the "
                     "reference stacks every shard for one shard_map "
                     "program")
_TPU_CONSTANTS = ("the reference's TPU data-sheet constant; the port prices "
                  "through a Hardware record (core/cost_model.py::H100)")
_HW_BYTES = "`hw: Hardware` carries `dtype_bytes`"
_HLO = ("parses XLA's compiled HLO; the port's dry run counts FLOPs, bytes "
        "and collectives on a fake process group "
        "(launch/roofline.py::cost_counter, memory_tracker)")
_KEY = ("`key` (a JAX PRNG key) ↔ `generator=` (a torch.Generator); weights "
        "cross between the packages through convert.py")
_PLACEMENTS = ("`*_shardings` (NamedSharding) ↔ `*_placements` (DTensor "
               "placements, launch/sharding.py); `role_spec` gives a leaf's "
               "per-dim spec")
_EAGER_STEPS = ("jitted step functions ↔ eager steps on DTensors "
                "(launch/steps.py::sharded_train_step, sharded_prefill_step, "
                "sharded_decode_step)")
_PYTHON_LAYERS = ("layers run in a Python loop, not lax.scan: gemma2's "
                  "local/global alternation is a Python bool per layer "
                  "(`dense_layer(local=)`, `chunked_attention(window=)`), "
                  "not a traced flag")
_HEAD_TILED = ("the TPU kernels' head-tiled steering; the CUDA kernels take "
               "heads as a grid axis over the single-head steering "
               "(kernels/paramspmm/ops.py::device_steering)")

DEVIATIONS = {
    # the Pallas kernels themselves
    "kernels.paramspmm.kernel": "the Pallas kernel; csrc/paramspmm.cu does "
                                "its work",
    "kernels.sddmm.kernel": "the Pallas kernels; csrc/sddmm_softmax.cu and "
                            "csrc/sddmm.cu do their work",
    "kernels.selective_scan.kernel": "the Pallas kernel; "
                                     "csrc/selective_scan.cu does its work",
    # backends and interpret mode
    "core.engine:make_gat_message_fn(backend)": _DEVICE_PICKS,
    "core.engine:make_gat_message_fn(interpret)": _DEVICE_PICKS,
    "core.engine:make_spmm_fn(backend)": _DEVICE_PICKS,
    "core.engine:make_spmm_fn(interpret)": _DEVICE_PICKS,
    "core.engine:make_fused_spmm_fn(backend)": _DEVICE_PICKS,
    "core.engine:make_fused_spmm_fn(interpret)": _DEVICE_PICKS,
    "core.engine:ParamSpMMOperator.__init__(backend)": _DEVICE_PICKS,
    "core.engine:ParamSpMMOperator.__init__(interpret)": _DEVICE_PICKS,
    "pipeline:ParamSpMM.__init__(backend)": _DEVICE_PICKS,
    "pipeline:ParamSpMM.__init__(interpret)": _DEVICE_PICKS,
    "serve.forward:bucket_forward(backend)": _DEVICE_PICKS,
    "serve.forward:bucket_forward(interpret)": _DEVICE_PICKS,
    "serve.forward:reference_forward(backend)": _DEVICE_PICKS,
    "serve.forward:reference_forward(interpret)": _DEVICE_PICKS,
    "serve.service:GNNService.__init__(backend)": _DEVICE_PICKS,
    "serve.service:GNNService.__init__(interpret)": _DEVICE_PICKS,
    "kernels.paramspmm.ops:paramspmm(interpret)": _DEVICE_PICKS,
    "kernels.paramspmm.ops:paramspmm_with_vals(interpret)": _DEVICE_PICKS,
    "kernels.sddmm.ops:sddmm(interpret)": _DEVICE_PICKS,
    "kernels.sddmm.ops:sddmm_softmax_stats(interpret)": _DEVICE_PICKS,
    "kernels.sddmm.ops:sddmm_softmax(interpret)": _DEVICE_PICKS,
    "kernels.selective_scan.ops:selective_scan(interpret)": _DEVICE_PICKS,
    "kernels.selective_scan.ops:selective_scan(chunk)":
        "the Pallas kernel's time tile; the CUDA kernel's grid is fixed by "
        "its design (64-step chunks in training)",
    "kernels.selective_scan.ops:selective_scan(tile)":
        "the Pallas kernel's channel tile; the CUDA kernel's grid is fixed "
        "by its design",
    "obs.metrics:intercept_pallas":
        "counts pallas_call sites at trace time; each CUDA wrapper counts "
        "its own launches (launch_count)",
    "obs:intercept_pallas":
        "counts pallas_call sites at trace time; each CUDA wrapper counts "
        "its own launches (launch_count)",
    # TPU layouts
    "core.pcsr:PCSR.to_jax": "JAX device arrays; the port's are "
                             "kernels/paramspmm/ops.py::device_steering",
    "core.pcsr:PCSR.steering(H)": _HEAD_TILED,
    "core.pcsr:PCSR.head_tiled": _HEAD_TILED,
    "kernels.sddmm.ops:stats_rows": "TPU layout of the stats, lane-dense "
                                    "tiles; the CUDA kernels keep "
                                    "(H, n_blocks·R)",
    "kernels.sddmm.ops:pack_stats": "TPU layout of the stats; the CUDA "
                                    "kernels keep (H, n_blocks·R)",
    "kernels.sddmm.ops:unpack_stats": "TPU layout of the stats; the CUDA "
                                      "kernels keep (H, n_blocks·R)",
    # pricing
    "core.cost_model:HBM_BW": _TPU_CONSTANTS,
    "core.cost_model:VPU_FLOPS": _TPU_CONSTANTS,
    "core.cost_model:STEP_OVERHEAD": _TPU_CONSTANTS,
    "core.cost_model:CHUNK_SETUP": _TPU_CONSTANTS,
    "core.cost_model:DTYPE_BYTES": _TPU_CONSTANTS,
    "core.cost_model:ICI_BW": _TPU_CONSTANTS,
    "core.cost_model:PACK_SETUP": "a TPU-host fit; the port's is "
                                  "PACK_SETUP_H100, fitted on the card",
    "core.cost_model:PACK_SETUP_PER_NNZ": "a TPU-host fit; the port's is "
                                          "PACK_SETUP_H100",
    "core.cost_model:kernel_cost(dtype_bytes)": _HW_BYTES,
    "core.cost_model:degraded_kernel_cost(dtype_bytes)": _HW_BYTES,
    "core.cost_model:sddmm_cost(dtype_bytes)": _HW_BYTES,
    "core.cost_model:unfused_penalty(dtype_bytes)": _HW_BYTES,
    # partitioned training
    "dist.gat:T_SENTINEL": _MULTI_CONTROLLER,
    "dist.gat:GatShardPack": _MULTI_CONTROLLER,
    "dist.gat:build_gat_pack": _MULTI_CONTROLLER,
    "dist.gat:ensure_gat_bwd_pack": _MULTI_CONTROLLER,
    "dist.gat:build_dist_gat": _MULTI_CONTROLLER,
    "dist.packing:AXIS": _MULTI_CONTROLLER,
    "dist.packing:shard_map_2d": _MULTI_CONTROLLER,
    "dist.packing:PackedShards": _MULTI_CONTROLLER,
    "dist.packing:pack_shards": _MULTI_CONTROLLER,
    "dist:PackedShards": _MULTI_CONTROLLER,
    "dist:pack_shards": _MULTI_CONTROLLER,
    "dist.halo:halo_exchange(b_loc)": "a rank passes its own block: "
                                      "`halo_exchange(x, plan)`",
    "dist.halo:halo_exchange(send_idx_loc)": _MULTI_CONTROLLER,
    "dist.halo:halo_exchange(halo_src_loc)": _MULTI_CONTROLLER,
    "dist.halo:halo_exchange(axis_name)": _MULTI_CONTROLLER,
    "dist.halo:halo_scatter_back(send_idx_loc)": _MULTI_CONTROLLER,
    "dist.halo:halo_scatter_back(halo_src_loc)": _MULTI_CONTROLLER,
    "dist.halo:halo_scatter_back(n_parts)": _MULTI_CONTROLLER,
    "dist.halo:halo_scatter_back(max_send)": _MULTI_CONTROLLER,
    "dist.halo:halo_scatter_back(rows_pad)": _MULTI_CONTROLLER,
    "dist.halo:halo_scatter_back(axis_name)": _MULTI_CONTROLLER,
    "dist.spmm:DistGraph.mesh": _MULTI_CONTROLLER,
    "dist.spmm:DistGraph.gat_pack": _HEAD_TILED,
    "dist.spmm:DistGraph.unpad_heads(H)": "a rank's (H, rows_pad, d) stack "
                                          "carries H itself",
    "launch.mesh:make_partition_mesh": _MULTI_CONTROLLER,
    # the LM mesh path and the dry run
    "checkpoint.manager:CheckpointManager.restore(shardings)":
        "`shardings` ↔ `placements=` with `mesh=`: a DTensor's placements "
        "name no mesh, so the mesh comes beside them",
    "launch.sharding:param_pspecs": _PLACEMENTS,
    "launch.sharding:param_shardings": _PLACEMENTS,
    "launch.sharding:batch_shardings": _PLACEMENTS,
    "launch.sharding:cache_shardings": _PLACEMENTS,
    "launch.steps:opt_state_shardings": _PLACEMENTS,
    "launch.steps:make_train_fn": _EAGER_STEPS,
    "launch.steps:jit_train_step": _EAGER_STEPS,
    "launch.steps:make_prefill_fn": _EAGER_STEPS,
    "launch.steps:jit_prefill_step": _EAGER_STEPS,
    "launch.steps:make_decode_fn": _EAGER_STEPS,
    "launch.steps:jit_decode_step": _EAGER_STEPS,
    "launch.dryrun:compile_cell": _HLO,
    "launch.dryrun:scan_aware_cost": _HLO,
    "launch.dryrun:run_cell(full_compile)": _HLO,
    "launch.roofline:hbm_bytes_fused": _HLO,
    "launch.roofline:collective_bytes": _HLO,
    "launch.roofline:Roofline": _HLO,
    "launch.roofline:analyze": _HLO,
    "launch.report:TARGET": "no default target: the port writes only the "
                            "file --target names, never the reference's "
                            "EXPERIMENTS.md",
    # the models
    "models.common:scan_layers": _PYTHON_LAYERS,
    "models.transformer:Pytree": "a JAX typing alias",
    "models.transformer:chunked_attention(local_flag)": _PYTHON_LAYERS,
    "models.transformer:dense_layer(layer_idx)": _PYTHON_LAYERS,
    "models.transformer:moe_ffn(dispatch)": "the moe_dispatch perf option "
                                            "selects the dispatch",
    "models.common:gqa_attention": "no caller in the reference's models",
    "models.hybrid:decode_attn(valid_upto)":
        "`valid_upto` ↔ `pos` of transformer.decode_attn (the same mask: "
        "slots ≤ pos live), a device scalar so decode can be captured",
    "models.gnn:init_gcn(key)": _KEY,
    "models.gnn:init_gin(key)": _KEY,
    "models.gnn:init_gat(key)": _KEY,
    "models.lm:init_params(key)": _KEY,
}


# ------------------------------------------------------------ the surface
def _params(fn: ast.FunctionDef) -> list:
    a = fn.args
    return [x.arg for x in a.posonlyargs + a.args + a.kwonlyargs
            if x.arg not in ("self", "cls")]


def _module_name(path: pathlib.Path, root: pathlib.Path) -> str:
    parts = list(path.relative_to(root).with_suffix("").parts)
    if parts[-1] == "__init__":
        parts = parts[:-1]
    return ".".join(parts)


def _resolve(pkg: str, mod: str, node: ast.ImportFrom,
             is_pkg: bool) -> str | None:
    """The module path (inside ``pkg``) an import names, or None."""
    if node.level == 0:
        name = node.module or ""
        return name[len(pkg) + 1:] if name.startswith(pkg + ".") else None
    base = mod.split(".") if mod else []
    if not is_pkg:
        base = base[:-1]
    base = base[:len(base) - (node.level - 1)] if node.level > 1 else base
    return ".".join(base + ([node.module] if node.module else []))


def surface(pkg: str, *, reexports: bool) -> dict:
    """module → {name: signature}: a function's parameter list, a class
    (``"class"``) and its members (``Class.member``), an assignment
    (``"value"``) or an import (``("import", module, name)``)."""
    root = SRC / pkg
    out = {}
    for f in sorted(root.rglob("*.py")):
        mod = _module_name(f, root)
        tree = ast.parse(f.read_text())
        is_pkg = f.name == "__init__.py"
        names = {}
        for node in tree.body:
            if isinstance(node, ast.FunctionDef):
                if not node.name.startswith("_"):
                    names[node.name] = _params(node)
            elif isinstance(node, ast.ClassDef):
                if node.name.startswith("_"):
                    continue
                names[node.name] = "class"
                for sub in node.body:
                    if isinstance(sub, ast.FunctionDef) and (
                            not sub.name.startswith("_")
                            or sub.name == "__init__"):
                        names[f"{node.name}.{sub.name}"] = _params(sub)
                    elif isinstance(sub, ast.AnnAssign) and isinstance(
                            sub.target, ast.Name) and \
                            not sub.target.id.startswith("_"):
                        names[f"{node.name}.{sub.target.id}"] = "value"
            elif isinstance(node, (ast.Assign, ast.AnnAssign)):
                targets = node.targets if isinstance(node, ast.Assign) \
                    else [node.target]
                for t in targets:
                    if isinstance(t, ast.Name) and not t.id.startswith("_"):
                        names[t.id] = "value"
            elif isinstance(node, ast.ImportFrom) and (reexports or is_pkg):
                src = _resolve(pkg, mod, node, is_pkg)
                for alias in node.names:
                    name = alias.asname or alias.name
                    if not name.startswith("_"):
                        names.setdefault(name, ("import", src, alias.name))
        out[mod] = names
    return out


def _lookup(surf, mod, name, depth=0):
    """A port name's signature, through its imports."""
    sig = surf.get(mod, {}).get(name)
    if isinstance(sig, tuple) and depth < 8:
        _, src, orig = sig
        if src is None or src not in surf:
            return "value"            # from outside the package
        found = _lookup(surf, src, orig, depth + 1)
        return "value" if found is None else found
    return sig


def missing(ref, port) -> dict:
    """module → the keys (``module``, ``module:Name``,
    ``module:name(param)``) of the reference's surface the port lacks."""
    out = {}
    for mod, names in ref.items():
        if mod not in port:
            out[mod] = {mod}
            continue
        miss = set()
        for name, sig in names.items():
            cls = name.split(".")[0]
            if "." in name and f"{mod}:{cls}" in miss:
                continue                       # the class itself is missing
            got = _lookup(port, mod, name)
            if got is None:
                miss.add(f"{mod}:{name}")
            elif isinstance(sig, list) and isinstance(got, list):
                miss |= {f"{mod}:{name}({p})" for p in sig if p not in got}
        out[mod] = miss
    return out


REF = surface("repro", reexports=False)
PORT = surface("repro_torch", reexports=True)
MISSING = missing(REF, PORT)


def _key_module(key):
    return key.split(":")[0]


@pytest.mark.parametrize("module", sorted(REF))
def test_every_public_name_has_a_counterpart(module):
    extra = sorted(MISSING[module] - set(DEVIATIONS))
    assert not extra, (f"src/repro/{module.replace('.', '/')}: no "
                       f"counterpart in src/repro_torch for {extra}")


def test_deviations_hold_only_what_is_missing():
    """An item the port has (it was ported) leaves the list; an item the
    reference does not have is no deviation."""
    every = set().union(*MISSING.values())
    stale = sorted(set(DEVIATIONS) - every)
    assert not stale, f"on the list but not missing: {stale}"
    assert all(_key_module(k) in REF for k in DEVIATIONS)
    assert all(len(r) > 10 for r in DEVIATIONS.values())


def test_the_surface_reader_sees_both_packages():
    """The reader finds what it should: a known function with its
    parameters in each package, a class's members, a re-export."""
    assert REF["core.pcsr"]["transpose_pcsr"] == ["p", "config"]
    assert PORT["core.pcsr"]["transpose_pcsr"] == ["p", "config"]
    assert REF["core.pcsr"]["PCSR.padding_ratio"] == []
    assert "CSRMatrix" in REF["core"]
    assert _lookup(PORT, "kernels.sddmm.ops", "normalize_from_stats") == \
        PORT["core.engine"]["normalize_from_stats"]
    assert "kernels.paramspmm.kernel" not in PORT


# ------------------------------------- the items ported to close the gap
def _csr_pair(seed=0, n=60):
    from repro.core.sparse import CSRMatrix as RCSR
    from repro_torch.core.sparse import CSRMatrix as TCSR
    from conftest import random_csr
    rcsr, _ = random_csr(np.random.default_rng(seed), n, density=0.08,
                         skew=True)
    return rcsr, TCSR(rcsr.indptr, rcsr.indices, rcsr.data, rcsr.n_rows,
                      rcsr.n_cols)


def _pcsr_pair(cfg_t, seed=0):
    from repro.core import pcsr as rp
    from repro_torch.core import pcsr as tp
    rcsr, _ = _csr_pair(seed)
    args = (rcsr.indptr, rcsr.indices, rcsr.data, rcsr.n_rows, rcsr.n_cols)
    cfg_r = rp.SpMMConfig(V=cfg_t.V, S=cfg_t.S, F=cfg_t.F, W=cfg_t.W,
                          B=cfg_t.B)
    return rp.build_pcsr(*args, cfg_r), tp.build_pcsr(*args, cfg_t)


CONFIGS = ["V1S0W8", "V2S1W4", "V2S1W8B"]


def _cfg(name):
    from repro_torch.core.pcsr import SpMMConfig
    return SpMMConfig(V=int(name[1]), S=name[3] == "1",
                      W=int(name[5:].rstrip("B")), B=name.endswith("B"))


@pytest.mark.parametrize("cfg", CONFIGS)
def test_pcsr_ratios_equal_reference(cfg):
    r, t = _pcsr_pair(_cfg(cfg))
    for name in ("num_slots", "padding_ratio", "split_ratio", "slot_fill"):
        assert getattr(t, name) == getattr(r, name), name
    assert t.nbytes() == r.nbytes()


def test_transpose_pcsr_under_another_config_equals_reference():
    from repro.core import pcsr as rp
    from repro_torch.core import pcsr as tp
    r, t = _pcsr_pair(_cfg("V1S0W8"))
    cfg_t = tp.SpMMConfig(V=2, S=True, W=4)
    rt = rp.transpose_pcsr(r, rp.SpMMConfig(V=2, S=True, W=4))
    tt = tp.transpose_pcsr(t, cfg_t)
    assert tt.config == cfg_t and tt.n_rows == rt.n_rows
    for name in ("colidx", "lrow", "trow", "init", "vals"):
        np.testing.assert_array_equal(getattr(tt, name), getattr(rt, name))
    same = tp.transpose_pcsr(t)
    assert same.config == t.config


def test_row_normalize_equals_reference():
    rcsr, tcsr = _csr_pair(3)
    want, got = rcsr.row_normalize(), tcsr.row_normalize()
    for name in ("indptr", "indices", "data"):
        np.testing.assert_array_equal(getattr(got, name), getattr(want, name))
    assert got.data.dtype == np.float32


@pytest.mark.parametrize("op,H", [("gat", 1), ("gat", 4), ("spmm", 1)])
def test_fusion_savings_equals_reference(op, H):
    """Under the reference's constants the port's price is the
    reference's, for every config of the space."""
    import repro.core.cost_model as rcm
    from repro.core import pcsr as rp
    from repro_torch.core import cost_model as tcm
    from repro_torch.core import pcsr as tp
    rcsr, tcsr = _csr_pair(5, 90)
    hw = tcm.Hardware(hbm_bw=rcm.HBM_BW, flops=rcm.VPU_FLOPS,
                      step_overhead=rcm.STEP_OVERHEAD,
                      chunk_setup=rcm.CHUNK_SETUP,
                      dtype_bytes=rcm.DTYPE_BYTES)
    rm, tm = rcm.CostModel(rcsr), tcm.CostModel(tcsr, hw)
    for rc, tc in zip(rp.config_space(64), tp.config_space(64)):
        assert tm.fusion_savings(64, tc, op, H=H) == \
            rm.fusion_savings(64, rc, op, H=H)


@pytest.mark.parametrize("heads", [1, 3])
def test_sddmm_softmax_with_logits_equals_reference(heads):
    import jax.numpy as jnp
    import torch
    from repro.kernels.sddmm import ops as rops
    from repro_torch.kernels.sddmm import ops as tops
    r, t = _pcsr_pair(_cfg("V2S1W4"), seed=7)
    rng = np.random.default_rng(heads)
    lead = (heads,) if heads > 1 else ()
    Q, K = (rng.standard_normal(lead + (r.n_rows, 8)).astype(np.float32)
            for _ in range(2))
    want_a, want_l = rops.sddmm_softmax(r, jnp.asarray(Q), jnp.asarray(K),
                                        with_logits=True)
    got_a, got_l = tops.sddmm_softmax(t, torch.from_numpy(Q),
                                      torch.from_numpy(K), with_logits=True)
    C = r.num_chunks
    np.testing.assert_allclose(got_a.numpy()[..., :C, :, :],
                               np.asarray(want_a)[..., :C, :, :], rtol=0,
                               atol=1e-5)
    np.testing.assert_array_equal(np.isinf(got_l.numpy()[..., :C, :, :]),
                                  np.isinf(np.asarray(want_l)[..., :C, :, :]))
    alone = tops.sddmm_softmax(t, torch.from_numpy(Q), torch.from_numpy(K))
    assert torch.equal(alone, got_a)


def test_dense_references_equal_reference():
    import jax.numpy as jnp
    import torch
    from repro.kernels.paramspmm.ref import spmm_dense_ref as r_spmm
    from repro.kernels.sddmm.ref import sddmm_dense_ref as r_sddmm
    from repro_torch.kernels.paramspmm.ref import spmm_dense_ref
    from repro_torch.kernels.sddmm.ref import sddmm_dense_ref
    rng = np.random.default_rng(2)
    A = np.where(rng.random((12, 10)) < 0.3, rng.integers(1, 4, (12, 10)),
                 0).astype(np.float32)
    B = rng.integers(-3, 4, (10, 5)).astype(np.float32)
    np.testing.assert_array_equal(
        spmm_dense_ref(A, torch.from_numpy(B)).numpy(),
        np.asarray(r_spmm(A, jnp.asarray(B))))
    Q = rng.integers(-3, 4, (12, 4)).astype(np.float32)
    K = rng.integers(-3, 4, (10, 4)).astype(np.float32)
    np.testing.assert_array_equal(
        sddmm_dense_ref(A, torch.from_numpy(Q), torch.from_numpy(K)).numpy(),
        r_sddmm(A, Q, K))


def test_selective_scan_ref_equals_reference():
    import jax.numpy as jnp
    import torch
    from repro.kernels.selective_scan.ref import selective_scan_ref as ref
    from repro_torch.kernels.selective_scan.ref import selective_scan_ref
    rng = np.random.default_rng(4)
    dA = rng.uniform(0.5, 1.0, (2, 9, 3, 5)).astype(np.float32)
    dBx = rng.standard_normal((2, 9, 3, 5)).astype(np.float32)
    C = rng.standard_normal((2, 9, 3)).astype(np.float32)
    got = selective_scan_ref(*(torch.from_numpy(x) for x in (dA, dBx, C)))
    want = ref(*(jnp.asarray(x) for x in (dA, dBx, C)))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)


def test_pack_geom_num_slots_and_global_norm_tree():
    import torch
    from repro.serve import PackGeom as RGeom, ShapeBucket as RBucket
    from repro_torch.core.pcsr import SpMMConfig
    from repro_torch.optim.adamw import global_norm
    from repro_torch.serve import PackGeom, ShapeBucket
    from repro.core.pcsr import SpMMConfig as RConfig
    geo = PackGeom.from_bucket(ShapeBucket(256, 1024), SpMMConfig(V=2, W=4))
    rgeo = RGeom.from_bucket(RBucket(256, 1024), RConfig(V=2, W=4))
    assert geo.num_slots == rgeo.num_slots == geo.num_chunks * geo.K
    tree = {"a": torch.ones(3), "b": [torch.full((2,), 2.0)]}
    assert float(global_norm(tree=tree)) == pytest.approx(np.sqrt(11.0))
