"""Elastic checkpoint restore of the LM mesh path: a ZeRO-1 training state
saved from a (data=2, model=2) mesh resumes on (4, 1), on (1, 4) and on one
device (``CheckpointManager.save`` of DTensor trees, ``restore(placements=,
mesh=)`` with ``launch.steps.train_state_placements`` of the new mesh).

* One group of 4 CPU ranks for the module (``dist/comm.py::spawn``, the
  ``staged`` backend, as ``test_torch_mesh_steps.py`` runs it).  For
  reduced hymba and chatglm3, each rank takes 2 sharded steps on the
  (2, 2) mesh with ZeRO-1 from the same weights and batches (made from
  seeds with numpy), saves, and takes the third step in memory: the
  uninterrupted run.  Then it restores onto each target and takes the
  third step there.
* Every restored leaf's full tensor is bit-equal to the saved one; the
  restored placements are the target mesh's; no two local blocks share
  memory (the in-place AdamW of ``sharded_train_step`` needs that).
* The step-3 losses lie within ``rtol=1e-3`` of the uninterrupted run,
  and of the reference's ``jit_train_step`` (ZeRO-1, 3 steps on 4 forced
  host devices, the same weights and batches) in a subprocess beside the
  ranks.
* A checkpoint of the one-device launcher (``launch.train --ckpt-dir
  --compress``) restores onto the (2, 2) mesh with the placements
  ``(params, opt, None)``, the ``None`` keeping the compression's error
  memory (a dict) whole, and the sharded step there gives the
  launcher's own third loss within ``rtol=1e-3``.
* Only rank 0 writes, and ``latest_step()`` agrees on every rank after
  ``wait()``.
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

from test_torch_mesh_steps import _numpy_case, _tree

ROOT = pathlib.Path(__file__).resolve().parents[1]
P = 4
B, S = 4, 8
ARCHS = ("hymba-1.5b", "chatglm3-6b")
TARGETS = ("4x1", "1x4", "one_device")
MODEL_PARALLEL = {"2x2": 2, "4x1": 1, "1x4": 4}
LOSS_RTOL = 1e-3
SAVED_AT = 1                      # the step index of the checkpoint


def _batches(cfg):
    """Three training batches (tokens, labels), one a step."""
    from repro_torch.configs.base import ShapeCell
    from repro_torch.models import lm
    out = []
    for seed in (1, 2, 3):
        rng = np.random.default_rng(seed)
        out.append({k: rng.integers(0, cfg.vocab, shape).astype(np.int32)
                    for k, (shape, _) in lm.input_specs(
                        cfg, ShapeCell("t", S, B, "train")).items()})
    return out


def _inputs():
    from repro_torch.configs import get_reduced
    return {arch: (_numpy_case(arch)[0], _batches(get_reduced(arch)))
            for arch in ARCHS}


# ------------------------------------------------------- the ranks' side
def _bits(t):
    t = t.detach().cpu()
    return t.view(torch.int16) if t.dtype == torch.bfloat16 else \
        t.view(torch.int32) if t.dtype == torch.float32 else t


def _flat(tree, path=()):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _flat(tree[k], path + (k,))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _flat(v, path + (str(i),))
    else:
        yield "/".join(path), tree


def _check_restored(tree, saved, want_place):
    """(names not bit-equal to ``saved``, names whose placements are not
    ``want_place``'s, the count of local blocks sharing memory, leaves
    compared) for a restored tree."""
    from torch.distributed.tensor import DTensor
    from repro_torch.launch import sharding as sh
    full = dict(_flat(sh.full_tree(tree)))
    unequal = [n for n, t in full.items()
               if not (torch.is_tensor(t) and torch.equal(
                   _bits(t), _bits(saved[n])))
               and not (not torch.is_tensor(t) and t == saved[n])]
    misplaced, ptrs = [], []
    for name, t in _flat(tree):
        if isinstance(t, DTensor):
            local = t.to_local()
            ptrs.append(local.untyped_storage().data_ptr())
            got = [str(p) for p in t.placements]
            if got != [str(p) for p in _place_of(want_place, name)]:
                misplaced.append(name)
        elif torch.is_tensor(t):
            ptrs.append(t.untyped_storage().data_ptr())
    return unequal, misplaced, len(ptrs) - len(set(ptrs)), len(full)


def _place_of(place, name):
    for k in name.split("/"):
        place = place[int(k)] if isinstance(place, (list, tuple)) and \
            k.isdigit() else place[k]
    return place


def _mesh_batch(np_batch, cfg, mesh):
    from repro_torch.configs.base import ShapeCell
    from repro_torch.launch import sharding as sh
    from repro_torch.models import lm
    batch = {k: torch.from_numpy(v) for k, v in np_batch.items()}
    return sh.distribute(batch, sh.batch_placements(
        lm.input_specs(cfg, ShapeCell("t", S, B, "train")), mesh), mesh)


def _elastic_case(arch, flat, batches, root):
    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.configs import get_reduced
    from repro_torch.launch import mesh as M, sharding as sh, steps
    from repro_torch.launch.train import build_step
    from repro_torch.optim import AdamWConfig
    cfg = get_reduced(arch)
    mesh = M.make_host_mesh(2, device_type="cpu")
    pp, op = steps.train_state_placements(cfg, mesh, zero1=True)
    dp = sh.distribute(_tree(flat, cfg), pp, mesh)
    ost = steps.init_opt_state(cfg, mesh, zero1=True)
    step = steps.sharded_train_step(cfg, mesh)
    losses = []
    for i in range(SAVED_AT + 1):
        dp, ost, loss = step(dp, ost, _mesh_batch(batches[i], cfg, mesh))
        losses.append(float(loss.full_tensor()))
    mgr = CheckpointManager(os.path.join(root, arch))
    mgr.save(SAVED_AT, (dp, ost))          # async: the writer on rank 0
    saved = {n: t.clone() if torch.is_tensor(t) else t
             for n, t in _flat(sh.full_tree((dp, ost)))}
    mgr.wait()
    out = {"latest": mgr.latest_step(), "files": sorted(os.listdir(
        os.path.join(root, arch)))}
    dp, ost, loss = step(dp, ost, _mesh_batch(batches[2], cfg, mesh))
    losses.append(float(loss.full_tensor()))
    out["uninterrupted"] = losses
    del dp, ost
    for target in TARGETS:
        if target == "one_device":
            place, tmesh = None, None
            got, tree = mgr.restore()
        else:
            tmesh = M.make_host_mesh(MODEL_PARALLEL[target],
                                     device_type="cpu")
            place = steps.train_state_placements(cfg, tmesh, zero1=True)
            got, tree = mgr.restore(placements=place, mesh=tmesh)
        unequal, misplaced, shared, n = _check_restored(tree, saved, place)
        rp, ro = tree
        if tmesh is None:
            step3 = build_step(cfg, AdamWConfig(lr=1e-4, grad_clip=1.0),
                               donate=True)
            batch = {k: torch.from_numpy(v) for k, v in batches[2].items()}
            _, _, _, loss = step3(rp, ro, None, batch)
            loss = float(loss)
        else:
            _, _, loss = steps.sharded_train_step(cfg, tmesh)(
                rp, ro, _mesh_batch(batches[2], cfg, tmesh))
            loss = float(loss.full_tensor())
        out[target] = {"step": got, "unequal": unequal,
                       "misplaced": misplaced, "shared": shared,
                       "leaves": n, "opt_step": ro["step"], "loss": loss}
    return out


def _launcher_case(root):
    """Rank 0 runs the one-device launcher with top-k compression for 2
    steps with checkpoints and for 3 without; every rank restores the
    first onto the (2, 2) mesh, its error memory (a dict shaped like the
    parameters) kept whole by a ``None`` placement, and takes the third
    step there."""
    import torch.distributed as dist
    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.configs import get_reduced
    from repro_torch.launch import mesh as M, steps
    from repro_torch.launch.train import batch_for_step, train
    arch, ckpt = "hymba-1.5b", os.path.join(root, "launcher")
    argv = ["--arch", arch, "--reduced", "--device", "cpu", "--batch",
            str(B), "--seq", str(S), "--log-every", "100", "--compress",
            "0.5"]
    out = {}
    if dist.get_rank() == 0:
        train(argv + ["--steps", "2", "--ckpt-dir", ckpt])
        out["launcher"] = train(argv + ["--steps", "3"])
    dist.barrier()
    cfg = get_reduced(arch)
    mesh = M.make_host_mesh(2, device_type="cpu")
    pp, op = steps.train_state_placements(cfg, mesh, zero1=True)
    mgr = CheckpointManager(ckpt)
    got, (params, opt, err) = mgr.restore(placements=(pp, op, None),
                                          mesh=mesh)
    _, (_, _, err_one) = mgr.restore()
    flat_err, flat_one = dict(_flat(err)), dict(_flat(err_one))
    np_batch = batch_for_step(cfg, B, S, 2, 0)
    _, _, loss = steps.sharded_train_step(cfg, mesh)(
        params, opt, _mesh_batch(np_batch, cfg, mesh))
    out.update(step=got, mesh_loss=float(loss.full_tensor()),
               err_names=sorted(flat_err) == sorted(flat_one),
               err_plain=all(type(t) is torch.Tensor
                             for t in flat_err.values()),
               err_unequal=[n for n, t in flat_err.items()
                            if not torch.equal(_bits(t),
                                               _bits(flat_one[n]))],
               err_leaves=len(flat_err),
               err_nonzero=sum(int(t.count_nonzero())
                               for t in flat_err.values()))
    return out


def _rank_main(inputs_path, root):
    with open(inputs_path, "rb") as f:
        inputs = pickle.load(f)
    out = {arch: _elastic_case(arch, *inputs[arch], root) for arch in ARCHS}
    out["launcher"] = _launcher_case(root)
    return out


# ----------------------------------------------- the reference's side
JAX_SCRIPT = textwrap.dedent('''
    import pickle, sys
    import jax, jax.numpy as jnp, numpy as np
    from repro.configs import get_reduced
    from repro.configs.base import ShapeCell
    from repro.launch import sharding as sh, steps
    from repro.launch.mesh import make_host_mesh
    from repro.models import lm, sharding_ctx
    from repro.optim import adamw_init
    with open(sys.argv[1], "rb") as f:
        inputs, B, S = pickle.load(f)
    mesh = make_host_mesh(model_parallel=2)
    out = {}
    for arch, (flat, batches) in inputs.items():
        cfg = get_reduced(arch)
        def build(tree, path=()):
            if isinstance(tree, dict):
                return {k: build(v, path + (k,)) for k, v in tree.items()}
            name = "/".join(path)
            a = jnp.asarray(flat[name])
            return a if name.endswith("a_log") else a.astype(jnp.bfloat16)
        params = build(lm.model_defs(cfg))
        losses = []
        with mesh:
            fn = steps.jit_train_step(cfg, ShapeCell("t", S, B, "train"),
                                      mesh, zero1=True)
            # on the step's own shardings, so that the first call's
            # inputs are placed as its outputs and it compiles once
            params, opt = jax.device_put(
                (params, adamw_init(params)),
                (sh.param_shardings(cfg, mesh),
                 steps.opt_state_shardings(cfg, mesh, zero1=True)))
            for np_batch in batches:
                batch = {k: jnp.asarray(v) for k, v in np_batch.items()}
                params, opt, loss = fn(params, opt, batch)
                losses.append(float(loss))
        sharding_ctx.set_mesh(None)
        out[arch] = losses
    with open(sys.argv[2], "wb") as f:
        pickle.dump(out, f)
''')


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    from repro_torch.dist import comm
    tmp = tmp_path_factory.mktemp("elastic")
    inputs = _inputs()
    with open(tmp / "inputs.pkl", "wb") as f:
        pickle.dump(inputs, f)
    with open(tmp / "ref_inputs.pkl", "wb") as f:
        pickle.dump((inputs, B, S), f)
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu",
               OMP_NUM_THREADS="1",
               XLA_FLAGS="--xla_force_host_platform_device_count=4 "
                         "--xla_cpu_multi_thread_eigen=false "
                         "intra_op_parallelism_threads=1")
    ref = subprocess.Popen(
        [sys.executable, "-c", JAX_SCRIPT, str(tmp / "ref_inputs.pkl"),
         str(tmp / "reference.pkl")], env=env, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True)
    try:
        ranks = comm.spawn(_rank_main, P, (str(tmp / "inputs.pkl"),
                                           str(tmp / "ckpt")),
                           backend="staged", device="cpu", threads=1)
        log, _ = ref.communicate(timeout=600)
        assert ref.returncode == 0, log[-4000:]
        with open(tmp / "reference.pkl", "rb") as f:
            reference = pickle.load(f)
    finally:
        ref.kill()
    return ranks, reference


CASES = [pytest.param(a, t, id=f"{a}-{t}") for a in ARCHS for t in TARGETS]


@pytest.mark.parametrize("arch,target", CASES)
def test_restored_leaves_are_bit_equal(runs, arch, target):
    ranks, _ = runs
    for r in ranks:
        c = r[arch][target]
        assert c["step"] == SAVED_AT
        assert c["unequal"] == [], c["unequal"]
        assert c["leaves"] > 0 and c["opt_step"] == SAVED_AT + 1


@pytest.mark.parametrize("arch,target", CASES)
def test_restored_state_takes_the_target_placements(runs, arch, target):
    """Each leaf on the target mesh's placements (ZeRO-1's moments with
    the data axis added where it divides, the parameters' fallbacks
    where the model axis does not), and no two blocks sharing memory."""
    ranks, _ = runs
    for r in ranks:
        c = r[arch][target]
        assert c["misplaced"] == [], c["misplaced"]
        assert c["shared"] == 0


@pytest.mark.parametrize("arch,target", CASES)
def test_step_after_restore_matches_uninterrupted(runs, arch, target):
    ranks, _ = runs
    want = ranks[0][arch]["uninterrupted"][2]
    for r in ranks:
        np.testing.assert_allclose(r[arch][target]["loss"], want,
                                   rtol=LOSS_RTOL)


@pytest.mark.parametrize("arch", ARCHS)
def test_mesh_losses_match_reference(runs, arch):
    """The uninterrupted (2, 2) run and every restored third step against
    the reference's ``jit_train_step`` with ZeRO-1."""
    ranks, reference = runs
    r = ranks[0][arch]
    np.testing.assert_allclose(r["uninterrupted"], reference[arch],
                               rtol=LOSS_RTOL)
    for target in TARGETS:
        np.testing.assert_allclose(r[target]["loss"], reference[arch][2],
                                   rtol=LOSS_RTOL)


@pytest.mark.parametrize("arch", ARCHS)
def test_rank_zero_writes_and_every_rank_sees_it(runs, arch):
    ranks, _ = runs
    for r in ranks:
        assert r[arch]["latest"] == SAVED_AT
        assert r[arch]["files"] == ["LATEST", f"step_{SAVED_AT}"]


def test_launcher_checkpoint_restores_onto_the_mesh(runs):
    ranks, _ = runs
    want = ranks[0]["launcher"]["launcher"]
    for r in ranks:
        c = r["launcher"]
        assert c["step"] == 1
        # the compression's error memory: a dict of plain tensors, as
        # the one-device restore gives it, and not all zero
        assert c["err_names"] and c["err_plain"] and c["err_leaves"] > 1
        assert c["err_unequal"] == [] and c["err_nonzero"] > 0
        np.testing.assert_allclose(c["mesh_loss"], want[2], rtol=LOSS_RTOL)


SUBTREES = {
    "dict": lambda: {"a": torch.ones(2, 3), "b": {"c": torch.zeros(4)}},
    "list": lambda: [torch.ones(2, 3), torch.zeros(4)],
    "tuple": lambda: (torch.ones(2, 3), 5),
    "tensor": lambda: torch.full((3,), 2.0),
}


@pytest.mark.parametrize("kind", sorted(SUBTREES))
def test_distribute_keeps_a_subtree_placed_none_whole(kind):
    """A ``None`` placement over a subtree (a launcher checkpoint's error
    memory under ``--compress`` is a dict) keeps each tensor below it
    plain, moved to ``device``, the containers and non-tensor leaves as
    they were; no mesh is asked for."""
    from repro_torch.launch import sharding as sh
    tree = {"err": SUBTREES[kind](), "step": 3}
    got = sh.distribute(tree, {"err": None, "step": None}, None,
                        device="cpu")
    want, have = dict(_flat(tree)), dict(_flat(got))
    assert have.keys() == want.keys() and type(got["err"]) is \
        type(tree["err"])
    for name, t in want.items():
        if torch.is_tensor(t):
            assert type(have[name]) is torch.Tensor
            assert torch.equal(have[name], t), name
        else:
            assert have[name] == t, name
    whole = sh.distribute(tree, None, None)
    assert all(whole_t is t for (_, whole_t), (_, t) in
               zip(_flat(whole), _flat(tree)))


def test_one_device_save_restores_with_placements_none(tmp_path):
    """Without DTensors the manager behaves as before: the tree comes
    back whole on the device asked for, and ``placements`` needs a
    mesh."""
    from repro_torch.checkpoint import CheckpointManager
    tree = ({"w": torch.arange(6, dtype=torch.bfloat16).reshape(2, 3)},
            {"m": [torch.ones(3)], "step": 4})
    mgr = CheckpointManager(str(tmp_path), async_save=False)
    mgr.save(0, tree)
    step, got = mgr.restore(device="cpu")
    assert step == 0 and got[1]["step"] == 4
    assert torch.equal(got[0]["w"], tree[0]["w"])
    assert got[0]["w"].dtype == torch.bfloat16
    assert isinstance(got[1]["m"], list)
    with pytest.raises(ValueError, match="needs the mesh"):
        mgr.restore(placements=({"w": None}, {"m": [None], "step": None}))
