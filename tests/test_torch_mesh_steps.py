"""The LM mesh path's sharded steps (``repro_torch.launch.steps``) on a
(data=2, model=2) mesh of 4 CPU ranks, against the port's unsharded step
and the JAX package's ``steps.jit_*`` on ``make_host_mesh(2)``.

* One group of 4 ranks for the module (``dist/comm.py::spawn``, file
  store; the ``staged`` backend, which on CPU tensors is gloo itself).
  Each rank runs, for reduced hymba, chatglm3, granite-moe (dispatch
  ``global`` and ``batched``), rwkv6 and whisper, one train step, a
  prefill and 2 decode steps, sharded and unsharded, on the same weights
  and batch (made from a seed with numpy); and hymba's train step and
  prefill again under ``ssm_scan_dtype="bfloat16"``, sharded against
  unsharded.
* The reference runs the same steps on the same numpy weights in two
  subprocesses (half the cases each) over 4 forced host devices, beside
  the ranks; the port's ``batched`` dispatch is held against the
  reference's ``shard_map`` (on a mesh the port's batched dispatch is
  that design: each rank its own block, one sum over model).
* Tolerances are those of each family's unsharded tests: the loss within
  ``rtol=1e-3``, each first moment within 5e-2 relative L2, logits
  within ``atol=rtol=5e-2``.  Against the unsharded port the step runs
  unclipped, so each first moment is 0.1 × the gradient itself and the
  gradients' global norm is held within ``rtol=1e-3`` (a fault that
  scales every leaf alike would pass a clipped comparison); against the
  reference it runs at ``jit_train_step``'s clip of 1.0.
* ``zero1=True`` gives the same bits as ``zero1=False``.
"""
import os
import pathlib
import pickle
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

ROOT = pathlib.Path(__file__).resolve().parents[1]
P = 4
B, S, DS = 4, 8, 16              # batch, train/prefill length, cache length
CASES = (("hymba-1.5b", "global"), ("chatglm3-6b", "global"),
         ("granite-moe-3b-a800m", "global"),
         ("granite-moe-3b-a800m", "batched"),
         ("rwkv6-1.6b", "global"), ("whisper-tiny", "global"))
REF_DISPATCH = {"batched": "shard_map"}   # the reference's run to hold
LOSS_RTOL = 1e-3
NORM_RTOL = 1e-3
CLIP_REL_L2 = 1e-2               # a clipped leaf against the unclipped one
GRAD_REL_L2 = 5e-2
MODEL_TOL = dict(atol=5e-2, rtol=5e-2)


def _name(arch, dispatch):
    return f"{arch}/{dispatch}"


def _numpy_case(arch):
    """Weights (float32 numpy of the bf16 values; ``a_log`` float32) and
    batch of a reduced config, from seeds."""
    from repro_torch.configs import get_reduced
    from repro_torch.configs.base import ShapeCell
    from repro_torch.models import lm
    cfg = get_reduced(arch)
    params = lm.init_params(cfg, generator=torch.Generator().manual_seed(0),
                            device="cpu")
    flat = {}

    def put(path, d):
        t = params
        for k in path:
            t = t[k]
        flat["/".join(path)] = t.float().numpy()

    lm.map_defs(put, lm.model_defs(cfg))
    rng = np.random.default_rng(1)
    batch = {}
    for k, (shape, dt) in lm.input_specs(
            cfg, ShapeCell("t", S, B, "train")).items():
        batch[k] = (rng.integers(0, cfg.vocab, shape).astype(np.int32)
                    if not dt.is_floating_point else
                    rng.standard_normal(shape).astype(np.float32))
    return flat, batch


def _inputs():
    return {arch: _numpy_case(arch) for arch in {a for a, _ in CASES}}


# ------------------------------------------------------- the ranks' side
def _tree(flat, cfg):
    from repro_torch.models import lm
    dt = lambda name: torch.float32 if name.endswith("a_log") else \
        torch.bfloat16
    return lm.map_defs(lambda path, d: torch.from_numpy(
        flat["/".join(path)]).to(dt("/".join(path))), lm.model_defs(cfg))


def _batch(cfg, np_batch):
    return {k: torch.from_numpy(v) if v.dtype == np.int32
            else torch.from_numpy(v).to(torch.bfloat16)
            for k, v in np_batch.items()}


def _np_tree(tree):
    if isinstance(tree, dict):
        return {k: _np_tree(v) for k, v in tree.items()}
    return tree.float().numpy()


def _run_case(arch, dispatch, flat, np_batch):
    from repro_torch.configs import get_reduced
    from repro_torch.configs.base import ShapeCell
    from repro_torch.launch import mesh as M, sharding as sh, steps
    from repro_torch.launch.train import build_step
    from repro_torch.models import common, lm
    from repro_torch.optim import AdamWConfig, adamw_init
    from repro_torch.optim.adamw import tree_map
    common.reset_perf_options()
    common.set_perf_options(moe_dispatch=dispatch)
    cfg = get_reduced(arch)
    mesh = M.make_host_mesh(2, device_type="cpu")
    cell = ShapeCell("t", S, B, "train")
    batch = _batch(cfg, np_batch)
    out = {}
    # unsharded: the launcher's donating step, unclipped, against the
    # mesh step unclipped
    unclipped = AdamWConfig(lr=1e-4, grad_clip=0.0)
    params = _tree(flat, cfg)
    p1 = tree_map(lambda t: t.clone(), params)
    st = adamw_init(p1)
    p1, st, _, loss = build_step(cfg, unclipped, donate=True)(
        p1, st, None, batch)
    out["plain"] = {"loss": float(loss), "m": _np_tree(st["m"])}
    bspec = lm.input_specs(cfg, cell)
    dp = sh.distribute_params(params, cfg, mesh)
    ost = steps.init_opt_state(cfg, mesh)
    db = sh.distribute(batch, sh.batch_placements(bspec, mesh), mesh)
    dp, ost, dl = steps.sharded_train_step(cfg, mesh, unclipped)(dp, ost, db)
    out["unclipped"] = {"loss": float(dl.full_tensor()),
                        "m": _np_tree(sh.full_tree(ost["m"]))}
    for zero1 in (False, True):
        dp = sh.distribute_params(params, cfg, mesh)
        ost = steps.init_opt_state(cfg, mesh, zero1=zero1)
        db = sh.distribute(batch, sh.batch_placements(bspec, mesh), mesh)
        dp, ost, dl = steps.sharded_train_step(cfg, mesh)(dp, ost, db)
        out[f"zero1={zero1}"] = {
            "loss": float(dl.full_tensor()),
            "m": _np_tree(sh.full_tree(ost["m"])),
            "v": _np_tree(sh.full_tree(ost["v"])),
            "params": _np_tree(sh.full_tree(dp))}
    # prefill
    dp = sh.distribute_params(params, cfg, mesh)
    db = sh.distribute(batch, sh.batch_placements(bspec, mesh), mesh)
    with torch.no_grad():
        want = lm.prefill(params, cfg, batch)
    got = steps.sharded_prefill_step(cfg, mesh)(dp, db).full_tensor()
    out["prefill"] = {"plain": want.float().numpy(), "mesh": got.numpy()}
    if arch == "chatglm3-6b":           # Megatron SP on the residual stream
        common.set_perf_options(seq_parallel=True)
        out["prefill"]["seq_parallel"] = steps.sharded_prefill_step(
            cfg, mesh)(dp, db).full_tensor().numpy()
        common.set_perf_options(seq_parallel=False)
    # two decode steps from the zero cache
    dcell = ShapeCell("d", DS, B, "decode")
    cache = lm.init_cache(cfg, dcell, device="cpu")
    cspec = lm.cache_specs(cfg, dcell)
    dcache = sh.distribute(lm.init_cache(cfg, dcell, device="cpu"),
                           sh.cache_placements(cspec, mesh), mesh)
    step = steps.sharded_decode_step(cfg, mesh)
    tok_place = sh.batch_placements({"token": ((B, 1), torch.int32)}, mesh)
    dec = {"plain": [], "mesh": []}
    for pos in range(2):
        tok = batch["tokens"][:, pos:pos + 1].contiguous()
        with torch.no_grad():
            want, cache = lm.decode_step(params, cfg, tok, cache, pos)
        dtok = sh.distribute({"token": tok}, tok_place, mesh)["token"]
        got, dcache = step(dp, dtok, dcache, torch.tensor(pos))
        dec["plain"].append(want.float().numpy())
        dec["mesh"].append(got.full_tensor().numpy())
    out["decode"] = dec
    common.reset_perf_options()
    return out


def _seq_sharded_decode(flat, np_batch):
    """Hymba's decode on a (data=1, model=4) mesh with ``shard_cache_seq``:
    its 2 KV heads do not divide 4, so the caches are cut along their
    slots and each rank holds a quarter of them."""
    from repro_torch.configs import get_reduced
    from repro_torch.configs.base import ShapeCell
    from repro_torch.launch import mesh as M, sharding as sh, steps
    from repro_torch.models import lm
    cfg = get_reduced("hymba-1.5b")
    mesh = M.make_host_mesh(4, device_type="cpu")
    params = _tree(flat, cfg)
    dp = sh.distribute_params(params, cfg, mesh)
    dcell = ShapeCell("d", DS, B, "decode")
    cspec = lm.cache_specs(cfg, dcell)
    place = sh.cache_placements(cspec, mesh, shard_seq=True)
    cache = lm.init_cache(cfg, dcell, device="cpu")
    dcache = sh.distribute(lm.init_cache(cfg, dcell, device="cpu"), place,
                           mesh)
    step = steps.sharded_decode_step(cfg, mesh)
    toks = torch.from_numpy(np_batch["tokens"])
    out = {"place": {k: [(type(p).__name__, getattr(p, "dim", None))
                         for p in v] for k, v in place.items()},
           "plain": [], "mesh": [], "cache": None}
    for pos in range(10):                 # past the ring's 8 slots
        tok = toks[:, pos % S:pos % S + 1].contiguous()
        with torch.no_grad():
            want, cache = lm.decode_step(params, cfg, tok, cache, pos)
        got, dcache = step(dp, tok, dcache, torch.tensor(pos))
        out["plain"].append(want.float().numpy())
        out["mesh"].append(got.full_tensor().numpy())
    out["cache"] = {k: (sh.full_tree(dcache)[k].float() - cache[k].float())
                    .abs().max().item() for k in cache}
    return out


def _scan_dtype_case(flat, np_batch):
    """Hymba under ``ssm_scan_dtype="bfloat16"``: one unclipped train step
    and a prefill on the (data=2, model=2) mesh and unsharded, and the
    scan's (B, S, N, Di) blocks and dtypes as each rank's custom op got
    them."""
    from repro_torch.configs import get_reduced
    from repro_torch.configs.base import ShapeCell
    from repro_torch.kernels.selective_scan import ops
    from repro_torch.launch import mesh as M, sharding as sh, steps
    from repro_torch.launch.train import build_step
    from repro_torch.models import common, lm
    from repro_torch.optim import AdamWConfig, adamw_init
    from repro_torch.optim.adamw import tree_map
    cfg = get_reduced("hymba-1.5b")
    mesh = M.make_host_mesh(2, device_type="cpu")
    bspec = lm.input_specs(cfg, ShapeCell("t", S, B, "train"))
    batch = _batch(cfg, np_batch)
    params = _tree(flat, cfg)
    unclipped = AdamWConfig(lr=1e-4, grad_clip=0.0)
    out, blocks = {}, set()
    forward = ops._forward

    def seen(dA, dBx, C, keep_states):
        blocks.add((tuple(dA.shape), str(dA.dtype), str(dBx.dtype)))
        return forward(dA, dBx, C, keep_states)

    common.reset_perf_options()
    common.set_perf_options(ssm_scan_dtype="bfloat16")
    try:
        p1 = tree_map(lambda t: t.clone(), params)
        st = adamw_init(p1)
        _, st, _, loss = build_step(cfg, unclipped, donate=True)(
            p1, st, None, batch)
        with torch.no_grad():
            want = lm.prefill(params, cfg, batch)
        out["plain"] = {"loss": float(loss), "m": _np_tree(st["m"]),
                        "prefill": want.float().numpy()}
        ops._forward = seen
        dp = sh.distribute_params(params, cfg, mesh)
        db = sh.distribute(batch, sh.batch_placements(bspec, mesh), mesh)
        ost = steps.init_opt_state(cfg, mesh)
        _, ost, dl = steps.sharded_train_step(cfg, mesh, unclipped)(dp, ost,
                                                                    db)
        dp = sh.distribute_params(params, cfg, mesh)
        got = steps.sharded_prefill_step(cfg, mesh)(dp, db).full_tensor()
        out["mesh"] = {"loss": float(dl.full_tensor()),
                       "m": _np_tree(sh.full_tree(ost["m"])),
                       "prefill": got.numpy()}
    finally:
        ops._forward = forward
        common.reset_perf_options()
    out["blocks"] = sorted(blocks)
    return out


def _rank_main(inputs_path):
    from repro_torch.dist import staged
    with open(inputs_path, "rb") as f:
        inputs = pickle.load(f)
    out = {_name(a, d): _run_case(a, d, *inputs[a]) for a, d in CASES}
    out["seq_decode"] = _seq_sharded_decode(*inputs["hymba-1.5b"])
    out["scan_dtype"] = _scan_dtype_case(*inputs["hymba-1.5b"])
    out["transport"] = staged.stats()
    return out


# ----------------------------------------------- the reference's side
JAX_SCRIPT = textwrap.dedent('''
    import pickle, sys
    import jax, jax.numpy as jnp, numpy as np
    from repro.configs import get_reduced
    from repro.configs.base import ShapeCell
    from repro.launch import steps
    from repro.launch.mesh import make_host_mesh
    from repro.models import lm, sharding_ctx
    from repro.models.common import reset_perf_options, set_perf_options
    from repro.optim import adamw_init
    with open(sys.argv[1], "rb") as f:
        inputs, cases, B, S, DS = pickle.load(f)
    mesh = make_host_mesh(model_parallel=2)
    out = {}
    for arch, dispatch, ref_dispatch in cases:
        reset_perf_options()
        set_perf_options(moe_dispatch=ref_dispatch)
        cfg = get_reduced(arch)
        flat, np_batch = inputs[arch]
        params = lm.map_defs(lambda d: None, lm.model_defs(cfg))
        def build(tree, path=()):
            if isinstance(tree, dict):
                return {k: build(v, path + (k,)) for k, v in tree.items()}
            name = "/".join(path)
            a = jnp.asarray(flat[name])
            return a if name.endswith("a_log") else a.astype(jnp.bfloat16)
        params = build(lm.model_defs(cfg))
        batch = {k: jnp.asarray(v) if v.dtype == np.int32
                 else jnp.asarray(v).astype(jnp.bfloat16)
                 for k, v in np_batch.items()}
        res = {}
        with mesh:
            fn = steps.jit_train_step(cfg, ShapeCell("t", S, B, "train"),
                                      mesh)
            donated = jax.tree.map(jnp.copy, params)
            _, opt, loss = fn(donated, adamw_init(donated), batch)
            res["loss"] = float(loss)
            res["m"] = jax.tree.map(lambda a: np.asarray(a, np.float32),
                                    opt["m"])
            fn = steps.jit_prefill_step(cfg, ShapeCell("p", S, B, "prefill"),
                                        mesh)
            res["prefill"] = np.asarray(fn(params, batch), np.float32)
            dcell = ShapeCell("d", DS, B, "decode")
            fn = steps.jit_decode_step(cfg, dcell, mesh)
            cache = lm.init_cache(cfg, dcell)
            res["decode"] = []
            for pos in range(2):
                tok = batch["tokens"][:, pos:pos + 1]
                logits, cache = fn(params, tok, cache, jnp.int32(pos))
                res["decode"].append(np.asarray(logits, np.float32))
        sharding_ctx.set_mesh(None)
        out[arch + "/" + dispatch] = res
    with open(sys.argv[2], "wb") as f:
        pickle.dump(out, f)
''')


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The reference's host-mesh steps (a subprocess) and the port's 4
    ranks, run side by side."""
    from repro_torch.dist import comm
    tmp = tmp_path_factory.mktemp("mesh")
    inputs = _inputs()
    with open(tmp / "inputs.pkl", "wb") as f:
        pickle.dump(inputs, f)
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu",
               OMP_NUM_THREADS="1",
               XLA_FLAGS="--xla_force_host_platform_device_count=4 "
                         "--xla_cpu_multi_thread_eigen=false "
                         "intra_op_parallelism_threads=1")
    refs = []
    for half in (0, 1):                  # two processes, half the cases each
        with open(tmp / f"ref_inputs{half}.pkl", "wb") as f:
            pickle.dump((inputs, [(a, d, REF_DISPATCH.get(d, d))
                                  for a, d in CASES[half::2]], B, S, DS), f)
        refs.append(subprocess.Popen(
            [sys.executable, "-c", JAX_SCRIPT,
             str(tmp / f"ref_inputs{half}.pkl"),
             str(tmp / f"reference{half}.pkl")], env=env,
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    reference = {}
    try:
        ranks = comm.spawn(_rank_main, P, (str(tmp / "inputs.pkl"),),
                           backend="staged", device="cpu", threads=1)
        for half, ref in enumerate(refs):
            log, _ = ref.communicate(timeout=600)
            assert ref.returncode == 0, log[-4000:]
            with open(tmp / f"reference{half}.pkl", "rb") as f:
                reference.update(pickle.load(f))
    finally:
        for ref in refs:
            ref.kill()
    return inputs, ranks, reference


def _leaves(tree, path=()):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], path + (k,))
    else:
        yield "/".join(path), tree


def _rel_l2(got, want):
    return float(np.linalg.norm(got - want) /
                 max(np.linalg.norm(want), 1e-30))


ALL = [pytest.param(a, d, id=f"{a}-{d}") for a, d in CASES]


def _global_norm(tree):
    return float(np.sqrt(sum(np.sum(np.square(a.astype(np.float64)))
                             for _, a in _leaves(tree))))


@pytest.mark.parametrize("arch,dispatch", ALL)
def test_sharded_train_step_matches_unsharded(runs, arch, dispatch):
    """Unclipped on both sides: each gradient leaf (10 × its first
    moment) and the global norm, which a common scale fault would move."""
    _, ranks, _ = runs
    r = ranks[0][_name(arch, dispatch)]
    got, want = r["unclipped"], r["plain"]
    np.testing.assert_allclose(got["loss"], want["loss"], rtol=LOSS_RTOL)
    np.testing.assert_allclose(_global_norm(got["m"]),
                               _global_norm(want["m"]), rtol=NORM_RTOL)
    w = dict(_leaves(want["m"]))
    for name, g in _leaves(got["m"]):
        assert _rel_l2(g, w[name]) < GRAD_REL_L2, name


@pytest.mark.parametrize("arch,dispatch", ALL)
def test_sharded_clip_takes_one_global_norm(runs, arch, dispatch):
    """The clipped sharded step scales every leaf by one factor, from one
    norm over all shards: its first moments are the unclipped step's
    times min(1, 1 / (‖g‖ + 1e-9)), with ‖g‖ from the unclipped moments
    (0.1 × the gradient) of the same sharded gradients.  The scaled
    gradients are bf16 and their partial sums are taken after the
    scaling, so the moments agree to bf16 rounding: their global norm
    within ``NORM_RTOL``, each leaf within ``CLIP_REL_L2``."""
    from repro_torch.optim import AdamWConfig
    _, ranks, _ = runs
    r = ranks[0][_name(arch, dispatch)]
    b1 = AdamWConfig(lr=1e-4).b1
    gn = _global_norm(r["unclipped"]["m"]) / (1 - b1)
    clip = min(1.0, 1.0 / (gn + 1e-9))
    got_m = r["zero1=False"]["m"]
    np.testing.assert_allclose(_global_norm(got_m),
                               clip * _global_norm(r["unclipped"]["m"]),
                               rtol=NORM_RTOL)
    want = dict(_leaves(r["unclipped"]["m"]))
    for name, got in _leaves(got_m):
        assert _rel_l2(got, want[name] * clip) < CLIP_REL_L2, name


@pytest.mark.parametrize("arch,dispatch", ALL)
def test_sharded_train_step_matches_reference(runs, arch, dispatch):
    _, ranks, reference = runs
    r, ref = ranks[0][_name(arch, dispatch)], reference[_name(arch, dispatch)]
    np.testing.assert_allclose(r["zero1=False"]["loss"], ref["loss"],
                               rtol=LOSS_RTOL)
    want = dict(_leaves(ref["m"]))
    got = dict(_leaves(r["zero1=False"]["m"]))
    assert sorted(got) == sorted(want)
    for name in got:
        assert _rel_l2(got[name], want[name]) < GRAD_REL_L2, name


@pytest.mark.parametrize("arch,dispatch", ALL)
def test_zero1_gives_the_same_bits(runs, arch, dispatch):
    _, ranks, _ = runs
    r = ranks[0][_name(arch, dispatch)]
    a, b = r["zero1=False"], r["zero1=True"]
    assert a["loss"] == b["loss"]
    for what in ("m", "v", "params"):
        for (n, x), (_, y) in zip(_leaves(a[what]), _leaves(b[what])):
            np.testing.assert_array_equal(x, y, err_msg=f"{what} {n}")


@pytest.mark.parametrize("arch,dispatch", ALL)
def test_ranks_agree(runs, arch, dispatch):
    """Every rank gathers the same loss and prefill logits."""
    _, ranks, _ = runs
    first = ranks[0][_name(arch, dispatch)]
    for other in ranks[1:]:
        o = other[_name(arch, dispatch)]
        assert o["zero1=False"]["loss"] == first["zero1=False"]["loss"]
        np.testing.assert_array_equal(o["prefill"]["mesh"],
                                      first["prefill"]["mesh"])


@pytest.mark.parametrize("arch,dispatch", ALL)
def test_sharded_prefill_matches(runs, arch, dispatch):
    _, ranks, reference = runs
    r = ranks[0][_name(arch, dispatch)]["prefill"]
    np.testing.assert_allclose(r["mesh"], r["plain"], **MODEL_TOL)
    np.testing.assert_allclose(
        r["mesh"], reference[_name(arch, dispatch)]["prefill"], **MODEL_TOL)


@pytest.mark.parametrize("arch,dispatch", ALL)
def test_sharded_decode_matches(runs, arch, dispatch):
    _, ranks, reference = runs
    r = ranks[0][_name(arch, dispatch)]["decode"]
    ref = reference[_name(arch, dispatch)]["decode"]
    for got, want, rw in zip(r["mesh"], r["plain"], ref):
        np.testing.assert_allclose(got, want, **MODEL_TOL)
        np.testing.assert_allclose(got, rw, **MODEL_TOL)


def test_seq_sharded_decode_writes_and_merges(runs):
    """``shard_cache_seq``: the caches' slots cut over model (the
    reference's placements), each position written by the rank that owns
    it, the softmax merged across ranks: the logits of 10 steps (past
    the ring) and the caches themselves match the unsharded step's."""
    _, ranks, _ = runs
    r = ranks[0]["seq_decode"]
    for k in ("k", "gk"):         # (L, B, S, KV, hd): batch, then slots
        assert r["place"][k] == [("Shard", 1), ("Shard", 2)], k
    for got, want in zip(r["mesh"], r["plain"]):
        np.testing.assert_allclose(got, want, **MODEL_TOL)
    assert max(r["cache"].values()) < 5e-2, r["cache"]


def test_scan_dtype_bf16_mesh_matches_unsharded(runs):
    """``ssm_scan_dtype="bfloat16"`` on the mesh: the train step's loss,
    gradient norm and every leaf, and the prefill logits, against the
    unsharded port under the same option at this file's tolerances; each
    rank's scan ran on its own (B/2, S, N, Di/2) block of float32
    operands (the cast comes before the custom op)."""
    from repro_torch.configs import get_reduced
    _, ranks, _ = runs
    r = ranks[0]["scan_dtype"]
    got, want = r["mesh"], r["plain"]
    np.testing.assert_allclose(got["loss"], want["loss"], rtol=LOSS_RTOL)
    np.testing.assert_allclose(_global_norm(got["m"]),
                               _global_norm(want["m"]), rtol=NORM_RTOL)
    w = dict(_leaves(want["m"]))
    for name, g in _leaves(got["m"]):
        assert _rel_l2(g, w[name]) < GRAD_REL_L2, name
    np.testing.assert_allclose(got["prefill"], want["prefill"], **MODEL_TOL)
    cfg = get_reduced("hymba-1.5b")
    block = (B // 2, S, cfg.ssm_state, cfg.ssm_expand * cfg.d_model // 2)
    for rank in ranks:
        assert rank["scan_dtype"]["blocks"] == [
            (block, "torch.float32", "torch.float32")]


def test_transport_carried_the_collectives(runs):
    """The staged transport ran the mesh's collectives on every rank."""
    _, ranks, _ = runs
    for r in ranks:
        t = r["transport"]
        assert t["all_reduce"]["calls"] > 0 and t["all_gather"]["calls"] > 0


# ------------------------------------------------------- in one process
def _bf16(rng, shape, scale=1.0):
    return (rng.standard_normal(shape) * scale).astype(np.float32)


def _batched_mixture(x, router, wg, wu, wd, k, cap):
    """The batched dispatch by its definition, in float32: each
    sequence's (token, slot) entries in queue order, kept while their
    expert has had fewer than ``cap`` entries in that sequence."""
    import jax.numpy as jnp
    B, S, D = x.shape
    out = np.zeros_like(x)
    logits = np.asarray(jnp.asarray(x, jnp.bfloat16) @ jnp.asarray(
        router, jnp.bfloat16), np.float32)
    for b in range(B):
        seen = np.zeros(router.shape[1], int)
        for s in range(S):
            top = np.argsort(-logits[b, s], kind="stable")[:k]
            g = np.exp(logits[b, s, top] - logits[b, s, top].max())
            g /= g.sum()
            for e, w in zip(top, g):
                if seen[e] < cap:
                    h = x[b, s] @ wg[e]
                    h = h / (1 + np.exp(-h)) * (x[b, s] @ wu[e])
                    out[b, s] += w * (h @ wd[e])
                seen[e] += 1
    return out


@pytest.mark.parametrize("dispatch", ["batched"])
@pytest.mark.parametrize("cf", [0.25, 0.5])
def test_moe_ffn_drops_by_queue_order(dispatch, cf):
    """The batched dispatch against its definition at a capacity that
    drops: every kept entry's expert output, the last slot of an
    overflowing expert included (where the reference's scatter-set token
    map hands it a dropped token's row), and nothing for the dropped."""
    from repro_torch.models import transformer as ttf
    rng = np.random.default_rng(3)
    Bq, Sq, D, E, F, k = 2, 64, 16, 4, 16, 1
    bf = lambda a: torch.from_numpy(a).to(torch.bfloat16)
    x = bf(_bf16(rng, (Bq, Sq, D)))
    router = _bf16(rng, (D, E))
    router[:, 0] += 1.0
    wg, wu = (bf(_bf16(rng, (E, D, F), 0.3)) for _ in range(2))
    wd = bf(_bf16(rng, (E, F, D), 0.3))
    router = bf(router)
    from repro_torch.models import common
    common.set_perf_options(moe_dispatch=dispatch)
    try:
        got = ttf.moe_ffn(x, router, wg, wu, wd, top_k=k, act="silu",
                          capacity_factor=cf)
    finally:
        common.reset_perf_options()
    cap = ttf.batched_capacity(Sq, E, k, cf)
    f = lambda t: t.float().numpy()
    want = _batched_mixture(f(x), f(router), f(wg), f(wu), f(wd), k, cap)
    dropped = np.abs(want).sum(-1) == 0
    assert dropped.sum() > 8
    np.testing.assert_allclose(f(got)[~dropped], want[~dropped],
                               atol=2e-2, rtol=2e-2)
    assert not f(got)[dropped].any()


def test_batched_capacity_is_the_reference_s():
    from repro.models import transformer as rtf  # noqa: F401
    from repro_torch.models import transformer as ttf
    for S, E, k, cf in ((64, 4, 1, 0.25), (4096, 40, 8, 1.25), (16, 4, 2,
                                                                1.25)):
        want = max(8, -(-int(cf * k * S / E) // 16) * 16)
        assert ttf.batched_capacity(S, E, k, cf) == want


def test_unported_perf_options_raise():
    from repro_torch.models import common
    common.set_perf_options(ssm_scan_dtype="bfloat16")   # the reference's
    assert common.perf_option("ssm_scan_dtype") == "bfloat16"
    common.reset_perf_options()
    with pytest.raises(NotImplementedError):
        common.set_perf_options(moe_dispatch="ragged")
    with pytest.raises(NotImplementedError, match="device picks"):
        common.set_perf_options(ssm_backend="pallas")
    with pytest.raises(KeyError):
        common.set_perf_options(no_such_option=True)
    assert common.perf_option("ssm_scan_dtype") == "float32"
    assert common.perf_option("ssm_backend") == "xla"
    assert common.PERF_DEFAULTS == {
        "moe_dispatch": "global", "ssm_scan_dtype": "float32",
        "remat_policy": "full", "seq_parallel": False,
        "bf16_norm_grad": False, "ssm_backend": "xla"}


def test_seq_parallel_prefill_matches(runs):
    """``seq_parallel``: residual activations also cut along the sequence
    over model, the same logits."""
    _, ranks, _ = runs
    r = ranks[0][_name("chatglm3-6b", "global")]["prefill"]
    np.testing.assert_allclose(r["seq_parallel"], r["plain"], **MODEL_TOL)


def test_remat_dots_policy_is_bit_equal():
    """``remat_policy="dots"`` / ``"dots_nb"`` keep matmul outputs instead
    of recomputing them: the same loss and gradients, bit for bit."""
    from repro_torch.configs import get_reduced
    from repro_torch.models import common, lm
    cfg = get_reduced("chatglm3-6b")
    flat, np_batch = _numpy_case("chatglm3-6b")
    batch = _batch(cfg, np_batch)
    out = {}
    try:
        for policy in ("full", "dots", "dots_nb"):
            common.set_perf_options(remat_policy=policy)
            p = {k: v for k, v in _tree(flat, cfg).items()}
            leaves = []

            def req(t):
                t.requires_grad_()
                leaves.append(t)
                return t
            from repro_torch.optim.adamw import tree_map
            p = tree_map(req, p)
            loss = lm.train_loss(p, cfg, batch)
            loss.backward()
            out[policy] = [float(loss.detach())] + [t.grad.float()
                                                    for t in leaves]
    finally:
        common.reset_perf_options()
    for policy in ("dots", "dots_nb"):
        assert out[policy][0] == out["full"][0]
        for a, b in zip(out[policy][1:], out["full"][1:]):
            assert torch.equal(a, b)


def test_bf16_norm_grad_matches_reference():
    """``bf16_norm_grad``: RMSNorm's hand-written vjp, against the
    reference's ``_rms_norm_bf16grad`` through ``jax.vjp``."""
    import jax
    import jax.numpy as jnp
    from repro.models import common as rcommon
    from repro_torch.models import common
    rng = np.random.default_rng(5)
    x = rng.standard_normal((2, 8, 32)).astype(np.float32)
    w = (1 + 0.1 * rng.standard_normal(32)).astype(np.float32)
    g = rng.standard_normal((2, 8, 32)).astype(np.float32)
    for plus_one in (False, True):
        jx, jw = (jnp.asarray(a, jnp.bfloat16) for a in (x, w))
        y, vjp = jax.vjp(lambda a, b: rcommon._rms_norm_bf16grad(
            a, b, 1e-6, plus_one), jx, jw)
        dx, dw = vjp(jnp.asarray(g, jnp.bfloat16))
        tx, tw = (torch.from_numpy(a).to(torch.bfloat16).requires_grad_()
                  for a in (x, w))
        try:
            common.set_perf_options(bf16_norm_grad=True)
            ty = common.rms_norm(tx, tw, plus_one=plus_one)
        finally:
            common.reset_perf_options()
        ty.backward(torch.from_numpy(g).to(torch.bfloat16))
        assert tx.grad.dtype == torch.bfloat16
        f = lambda a: np.asarray(a, np.float32)
        np.testing.assert_allclose(ty.detach().float().numpy(), f(y),
                                   atol=1e-2, rtol=1e-2)
        np.testing.assert_allclose(tx.grad.float().numpy(), f(dx),
                                   atol=2e-2, rtol=2e-2)
        np.testing.assert_allclose(tw.grad.float().numpy(), f(dw),
                                   atol=2e-2, rtol=2e-2)
