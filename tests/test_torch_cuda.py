"""The port's CUDA kernels on the card (marker ``cuda``; skips without one).

These tests import neither JAX nor the JAX package, so they run on a
machine that has only PyTorch and the CUDA toolkit:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py

Each kernel is held against its plain PyTorch version on the same CUDA
tensors.  ParamSpMM: bit-exact with integer-valued operands, ``atol=1e-4,
rtol=1e-5`` with float operands (the sums run in another order).  Fused
SDDMM → softmax stats: logits bit-exact with integer-valued Q/K, stats
and α within ``rtol=1e-5, atol=1e-6``.  ParamSpMM with the softmax
prologue: ``rtol=1e-5, atol=1e-4``.  GAT serving on the card matches the
CPU within ``rtol=1e-4, atol=1e-4``.  Raw SDDMM: bit-exact with
integer-valued Q/K, ``rtol=1e-5, atol=1e-5`` with float ones, and every
slot without a stored nonzero exactly 0, at every load width and a d wider
than its Q tile, with split work units and on a hub graph; a CUDA call
launches the kernel and never reaches the plain version.  The training operators'
gradients on the card match the port on the CPU (bit-exact with integer
operands for the SpMMs, ``rtol=1e-5, atol=1e-4`` otherwise), the GAT
backward's slot pass gives its plain version's bits for every subset of
its outputs (Aᵀ slots without an edge +0), and a short
``train_gnn`` on the card follows the CPU's losses within ``rtol=1e-4``.
The ParamSpMM and SDDMM → softmax kernels are also held with work units
cut to a few real slots (every real group split, partials merged in unit
order), give the same bits on two launches, and index each head's stats by
the block count.  Selective scan: the kernel within ``atol = rtol = 1e-5``
of its plain version (an FMA and another Σ_n order), an impulse at t = 0
reaching the last of 1024 steps, and a CUDA tensor never reaching the
plain version;
the reduced Hymba's prefill (one launch per layer) and decode on the card
within ``atol = rtol = 5e-2`` of the port on the CPU (bf16).  The scan's
backward kernel within ``1e-4 × max |g|`` of its plain version per operand
(same bits on two launches), over S around its 64-step chunk on the
training forward's chunk states (held against the plain ones; that
forward's y the inference forward's bits; autograd saves the states and
no full h), and a backward through ``mamba_branch`` and
through the reduced Hymba's ``train_loss`` on the card against the CPU's
gradients; ``launch/train.py`` on the card.  CUDA graphs:
a captured bucket forward replayed on a second batch gives the eager
forward's bits and launch counts (GCN, GIN, GAT), a batch past its
bucket's schedule bounds raises, and the captured Hymba decode step gives
the eager step's bits.  Dynamic graphs: the three GNN kernels over
mutated views (delta chunks, tombstones, a born and a dead block, a fat
row) against their plain versions, at the wrapper's cap and at 4 real
slots a unit, and ``DynamicGraph`` on the card bit-exact against a fresh
pack over a churn stream, forward and gradient.
"""
import numpy as np
import pytest
import torch

from repro_torch.apps.gnn import train_gnn
from repro_torch.core import engine
from repro_torch.core.pcsr import SpMMConfig, build_pcsr, transpose_pcsr
from repro_torch.core.sparse import CSRMatrix
from repro_torch.data.tasks import community_task
from repro_torch.data.graphs import rmat
from repro_torch.dynamic import DynamicGraph, DynamicPCSR
from repro_torch.kernels.paramspmm import ops
from repro_torch.kernels.sddmm import ops as sddmm_ops
from repro_torch.models.gnn import init_gat, init_gcn
from repro_torch.serve import GNNService, replay, synthetic_stream

CONFIGS = [SpMMConfig(V=v, S=s, B=b, F=f, W=r // v)
           for v in (1, 2) for (s, b) in ((False, False), (True, False),
                                          (True, True))
           for f, r in ((1, 32), (2, 8))]


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and nvcc")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _pack(cfg, integer, seed=0, explicit_zeros=False):
    """A skewed graph with empty row blocks, integer or float edges;
    ``explicit_zeros`` stores every 5th edge with value 0 (masked)."""
    rng = np.random.default_rng(seed)
    A = (rng.random((90, 90)) < 0.05).astype(np.float32)
    A[rng.integers(0, 90, 4)] = (rng.random((4, 90)) < 0.5)
    A[20:52] = 0.0
    A = A * (rng.integers(-2, 3, A.shape) if integer
             else rng.standard_normal(A.shape))
    rows, cols = np.nonzero(A)
    vals = A[rows, cols].astype(np.float32)
    if explicit_zeros:
        vals[::5] = 0.0
    c = CSRMatrix.from_coo(rows, cols, vals, 90, 90, sum_duplicates=False)
    return build_pcsr(c.indptr, c.indices, c.data, 90, 90, cfg)


@pytest.mark.cuda
@pytest.mark.parametrize("cfg", CONFIGS, ids=lambda c: str(c.astuple()))
@pytest.mark.parametrize("activation", ["none", "relu", "leaky_relu"])
def test_kernel_matches_plain(cuda_device, cfg, activation):
    for integer in (False, True):
        p = _pack(cfg, integer)
        rng = np.random.default_rng(3)
        draw = ((lambda *s: rng.integers(-3, 4, s)) if integer
                else (lambda *s: rng.standard_normal(s)))
        t = lambda *s: torch.tensor(draw(*s), dtype=torch.float32,
                                    device=cuda_device)
        B = t(90, 200)
        epi = {"scale": t(90), "bias": t(200), "residual": t(90, 200),
               "activation": activation}
        before = ops.launch_count()
        got = ops.paramspmm(p, B, **epi)
        torch.cuda.synchronize()
        assert ops.launch_count() == before + 1
        want = ops.paramspmm_plain(
            ops.device_steering(p, cuda_device), B, V=cfg.V, R=cfg.R, K=p.K,
            n_blocks=p.n_blocks, n_rows=p.n_rows, **epi)
        if integer:
            assert torch.equal(got, want)
        else:
            torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-4)


@pytest.mark.cuda
def test_wrapper_refuses_other_dtypes(cuda_device):
    p = _pack(SpMMConfig(V=1, S=True, W=8), integer=False)
    B = torch.ones((90, 16), device=cuda_device)
    for dtype in (torch.float64, torch.bfloat16, torch.float16):
        with pytest.raises(TypeError, match="float32"):
            ops.paramspmm(p, B.to(dtype))
    with pytest.raises(TypeError, match="float32"):
        ops.paramspmm(p, B, bias=torch.ones(16, dtype=torch.float64,
                                            device=cuda_device))
    with pytest.raises(ValueError, match="contiguous"):
        ops.paramspmm(p, torch.ones((16, 90), device=cuda_device).t())


@pytest.mark.cuda
def test_service_on_card_matches_cpu(cuda_device):
    g = rmat(10, 6, seed=1)
    feats = np.random.default_rng(0).integers(0, 3, (g.n_rows, 8)).astype(
        np.float32)
    params = [{k: torch.round(v * 2) for k, v in l.items()}
              for l in init_gcn([8, 16, 16, 4],
                                generator=torch.Generator().manual_seed(0))]
    stream = synthetic_stream(12, g.n_rows, seed=3)
    out = {}
    for dev in ("cpu", cuda_device):
        svc = GNNService(g, feats, params, device=dev)
        before = ops.launch_count()
        out[str(dev)] = replay(svc, stream, tick_every=4)
        launches = ops.launch_count() - before
        assert launches == (0 if dev == "cpu" else 3 * len(svc.batch_log))
    for a, b in zip(out["cpu"], out[str(cuda_device)]):
        assert a.rid == b.rid and np.array_equal(a.outputs, b.outputs)


def _bucket_batches(geom, n_feat, seeds=(1, 2)):
    """Bucket-padded packs of two sampled batches of one rmat graph, with
    GCN-normalised (float) edges, and float features for each."""
    from repro_torch.data.graphs import extract_subgraph, sample_khop
    from repro_torch.serve import pack_subgraph
    g = rmat(10, 6, seed=7).gcn_normalize()
    rng = np.random.default_rng(0)
    out = []
    for seed in seeds:
        nodes = sample_khop(g, rng.integers(0, g.n_rows, 6), (10, 10),
                            seed=seed)
        sub = extract_subgraph(g, nodes)
        out.append((pack_subgraph(sub, geom), rng.standard_normal(
            (sub.n_rows, n_feat)).astype(np.float32)))
    return out


@pytest.mark.cuda
@pytest.mark.parametrize("model", ["gcn", "gin", "gat"])
def test_replayed_bucket_forward_equals_eager(cuda_device, model):
    """One bucket geometry, two batches: the captured program (warm-up on
    the first batch, a replay on the second) gives the eager program's
    bits on float operands, with the eager program's kernel launches."""
    from repro_torch.kernels import capture
    from repro_torch.models.gnn import init_gin
    from repro_torch.serve import PackGeom, ShapeBucket
    from repro_torch.serve.forward import BucketProgram
    geom = PackGeom.from_bucket(ShapeBucket(512, 4096),
                                SpMMConfig(V=2, S=True, B=True, W=8))
    init = {"gcn": init_gcn, "gin": init_gin, "gat": init_gat}[model]
    params = init([8, 16, 16, 4], generator=torch.Generator().manual_seed(1),
                  device=cuda_device)
    batches = _bucket_batches(geom, 8)
    progs = {g: BucketProgram(geom, batches[0][0], params, 8, cuda_device,
                              model=model, graphs=g) for g in (True, False)}
    for i, (p, X) in enumerate(batches):
        before = capture.launch_counts()
        got = progs[True](p, X).clone()
        mid = capture.launch_counts()
        want = progs[False](p, X)
        after = capture.launch_counts()
        torch.cuda.synchronize()
        assert torch.equal(got, want), f"batch {i}"
        assert ({k: mid[k] - before[k] for k in mid}
                == {k: after[k] - mid[k] for k in mid}), f"batch {i}"
        assert progs[True].captured is not None
    assert sum(progs[True].captured.launches.values()) == (
        6 if model == "gat" else 3)


@pytest.mark.cuda
def test_batch_past_its_bucket_bounds_raises(cuda_device, monkeypatch):
    """A batch whose unit table exceeds the bucket's bounds raises on the
    card: nothing is re-captured, nothing runs eagerly."""
    import dataclasses
    from repro_torch.serve import PackGeom
    bounds = PackGeom.bounds
    monkeypatch.setattr(PackGeom, "bounds", lambda self, cap=None: (
        dataclasses.replace(bounds(self, cap), n_units=self.n_blocks - 1)))
    g = rmat(10, 6, seed=1)
    params = init_gcn([8, 16, 4], generator=torch.Generator().manual_seed(0))
    svc = GNNService(g, np.ones((g.n_rows, 8), np.float32), params,
                     device=cuda_device)
    assert svc.graphs
    launches = ops.launch_count()
    with pytest.raises(ValueError, match="exceeds its bucket's bounds"):
        replay(svc, synthetic_stream(4, g.n_rows, seed=3), tick_every=4)
    assert ops.launch_count() == launches and svc.compiled_buckets == 0


@pytest.mark.cuda
def test_captured_decode_step_equals_eager(cuda_device):
    """Reduced Hymba: the decode step captured once (warm-up at position 0)
    and replayed gives the eager step's logits and caches bit for bit over
    12 positions, past the window of 8; ``generate`` gives the same tokens
    with and without graphs."""
    from repro_torch.configs import get_reduced
    from repro_torch.configs.base import ShapeCell
    from repro_torch.kernels.capture import capture
    from repro_torch.launch.serve import generate
    from repro_torch.models import lm
    cfg = get_reduced("hymba-1.5b")
    g = torch.Generator().manual_seed(2)
    params = _to(lm.init_params(cfg, generator=g, device="cpu"),
                 cuda_device)
    tokens = torch.randint(0, cfg.vocab, (2, 12), generator=g).to(
        cuda_device)
    caches = [lm.init_cache(cfg, ShapeCell("d", 12, 2, "decode"),
                            device=cuda_device) for _ in "ab"]
    static_tok = tokens[:, :1].clone()
    static_pos = torch.zeros((), dtype=torch.int64, device=cuda_device)
    step = lambda: lm.decode_step(params, cfg, static_tok, caches[1],
                                  static_pos)[0]
    captured = None
    with torch.no_grad():
        for t in range(12):
            want, _ = lm.decode_step(params, cfg, tokens[:, t:t + 1],
                                     caches[0], t)
            static_tok.copy_(tokens[:, t:t + 1])
            static_pos.fill_(t)
            if captured is None:
                got, captured = capture(step, cuda_device)
            else:
                got = captured.replay()
            assert torch.equal(got, want), f"step {t}"
    torch.cuda.synchronize()
    for name in caches[0]:
        assert torch.equal(caches[0][name], caches[1][name]), name
    prompt = tokens[:, :4].cpu().numpy()
    seqs = [generate(cfg, params, prompt, 12, 8, device=cuda_device,
                     graphs=graphs) for graphs in (True, False)]
    assert torch.equal(seqs[0], seqs[1])


def _sddmm_case(p, dev, d, H, integer, seed=5):
    rng = np.random.default_rng(seed)
    draw = ((lambda *s: rng.integers(-3, 4, s)) if integer
            else (lambda *s: rng.standard_normal(s)))
    t = lambda *s: torch.tensor(draw(*s), dtype=torch.float32, device=dev)
    return t(H, p.n_rows, d), t(H, p.n_cols, d), t(H, p.n_cols, 24)


@pytest.mark.cuda
@pytest.mark.parametrize("cfg", CONFIGS, ids=lambda c: str(c.astuple()))
@pytest.mark.parametrize("H", [1, 4])
def test_sddmm_softmax_and_prologue_match_plain(cuda_device, cfg, H):
    for integer in (True, False):
        p = _pack(cfg, integer)
        Q, K, B = _sddmm_case(p, cuda_device, 16, H, integer)
        steer = ops.device_steering(p, cuda_device)
        geo = dict(V=cfg.V, R=cfg.R, K=p.K, n_blocks=p.n_blocks,
                   n_rows=p.n_rows)
        before = sddmm_ops.launch_count()
        got = sddmm_ops.sddmm_softmax_stats(p, Q, K)
        torch.cuda.synchronize()
        assert sddmm_ops.launch_count() == before + 1
        want = sddmm_ops.sddmm_softmax_plain(steer, Q, K, scale=0.25,
                                             slope=0.2, **geo)
        if integer:
            assert torch.equal(got[0], want[0])
        else:
            torch.testing.assert_close(got[0], want[0], rtol=1e-5,
                                       atol=1e-5)
        for a, b in zip(got[1:], want[1:]):
            torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-6)
        before = ops.launch_count()
        out = ops.paramspmm_with_vals(p, got[0], B, stats=got[1:])
        torch.cuda.synchronize()
        assert ops.launch_count() == before + 1
        ref = ops.paramspmm_plain(steer, B, vals=got[0], rowmax=got[1],
                                  rowsum=got[2], **geo)
        torch.testing.assert_close(out, ref, rtol=1e-5, atol=1e-4)


@pytest.mark.cuda
def test_gat_service_on_card_matches_cpu(cuda_device):
    g = rmat(10, 6, seed=1)
    feats = np.random.default_rng(0).standard_normal(
        (g.n_rows, 16)).astype(np.float32)
    params = init_gat([16, 64, 64, 16],
                      generator=torch.Generator().manual_seed(0))
    stream = synthetic_stream(12, g.n_rows, seed=3)
    out = {}
    for dev in ("cpu", cuda_device):
        svc = GNNService(g, feats, params, model="gat", device=dev)
        before = (ops.launch_count(), sddmm_ops.launch_count())
        out[str(dev)] = replay(svc, stream, tick_every=4)
        launches = (ops.launch_count() - before[0],
                    sddmm_ops.launch_count() - before[1])
        per_kernel = 0 if dev == "cpu" else 3 * len(svc.batch_log)
        assert launches == (per_kernel, per_kernel)
    for a, b in zip(out["cpu"], out[str(cuda_device)]):
        assert a.rid == b.rid
        np.testing.assert_allclose(b.outputs, a.outputs, rtol=1e-4,
                                   atol=1e-4)


SMALL_CAP = 3        # real slots per work unit: every real group splits


def _geo(p):
    cfg = p.config
    return dict(V=cfg.V, R=cfg.R, K=p.K, n_blocks=p.n_blocks,
                n_rows=p.n_rows)


# epilogue operands and activation of each non-prologue mode
SPLIT_EPILOGUES = {"plain": ((), "none"),
                   "scale+bias+relu": (("scale", "bias"), "relu"),
                   "residual+leaky_relu": (("residual",), "leaky_relu")}


@pytest.mark.cuda
@pytest.mark.parametrize("cfg", CONFIGS, ids=lambda c: str(c.astuple()))
@pytest.mark.parametrize("mode", list(SPLIT_EPILOGUES)
                         + ["prologue", "prologue H=4"])
def test_split_units_match_plain(cuda_device, cfg, mode):
    """Both redesigned kernels with work units of at most SMALL_CAP real
    slots (split groups, partials merged in unit order) against their
    plain versions: bit-exact on integer operands, the tolerances above on
    float ones; one launch counted per call."""
    for integer in (True, False):
        p = _pack(cfg, integer)
        steer = ops.Steering.from_pcsr(p, cuda_device, cap=SMALL_CAP)
        assert steer.n_partials > 0 and steer.n_units > steer.n_groups
        rng = np.random.default_rng(4)
        draw = ((lambda *s: rng.integers(-3, 4, s)) if integer
                else (lambda *s: rng.standard_normal(s)))
        t = lambda *s: torch.tensor(draw(*s), dtype=torch.float32,
                                    device=cuda_device)
        if mode in SPLIT_EPILOGUES:
            names, activation = SPLIT_EPILOGUES[mode]
            shapes = {"scale": (90,), "bias": (72,), "residual": (90, 72)}
            epi = {k: t(*shapes[k]) for k in names}
            B = t(90, 72)
            before = ops.launch_count()
            got = ops._call(steer, B, dblk=cfg.dblk, activation=activation,
                            **_geo(p), **epi)
            torch.cuda.synchronize()
            assert ops.launch_count() == before + 1
            want = ops.paramspmm_plain(steer, B, activation=activation,
                                       **_geo(p), **epi)
            if integer:
                assert torch.equal(got, want)
            else:
                torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-4)
            continue
        H = 4 if mode.endswith("H=4") else 1
        Q, K, B = _sddmm_case(p, cuda_device, 16, H, integer)
        before = sddmm_ops.launch_count()
        got = sddmm_ops._stats_call(steer, Q, K, scale=0.25, slope=0.2,
                                    **_geo(p))
        torch.cuda.synchronize()
        assert sddmm_ops.launch_count() == before + 1
        want = sddmm_ops.sddmm_softmax_plain(steer, Q, K, scale=0.25,
                                             slope=0.2, **_geo(p))
        if integer:
            assert torch.equal(got[0], want[0])
        else:
            torch.testing.assert_close(got[0], want[0], rtol=1e-5,
                                       atol=1e-5)
        for a, b in zip(got[1:], want[1:]):
            torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-6)
        out = ops._call(steer, B, vals=got[0], rowmax=got[1], rowsum=got[2],
                        dblk=cfg.dblk, **_geo(p))
        ref = ops.paramspmm_plain(steer, B, vals=got[0], rowmax=got[1],
                                  rowsum=got[2], **_geo(p))
        torch.testing.assert_close(out, ref, rtol=1e-5, atol=1e-4)


@pytest.mark.cuda
@pytest.mark.parametrize("cap", [None, SMALL_CAP], ids=["cap", "small"])
def test_two_launches_give_the_same_bits(cuda_device, cap):
    """No atomics and every merge in a fixed order: two launches of each
    work-unit kernel (ParamSpMM, SDDMM → softmax, raw SDDMM) on the same
    float operands are bit-identical."""
    cfg = SpMMConfig(V=2, S=True, B=True, W=8)
    p = _pack(cfg, integer=False)
    steer = ops.Steering.from_pcsr(p, cuda_device, cap=cap)
    Q, K, B = _sddmm_case(p, cuda_device, 64, 4, integer=False)
    runs = []
    for _ in range(2):
        lg, rm, rs = sddmm_ops._stats_call(steer, Q, K, scale=0.125,
                                           slope=0.2, **_geo(p))
        runs.append((lg, rm, rs,
                     ops._call(steer, B, vals=lg, rowmax=rm, rowsum=rs,
                               dblk=cfg.dblk, **_geo(p)),
                     ops._call(steer, K[0], dblk=cfg.dblk, **_geo(p),
                               bias=K[0, 0], activation="relu"),
                     sddmm_ops._call(steer, Q, K, **_geo(p))))
    torch.cuda.synchronize()
    for a, b in zip(*runs):
        assert torch.equal(a, b)


@pytest.mark.cuda
def test_multi_head_stats_offsets_with_split_units(cuda_device):
    """Stats are indexed by the block count, not the grid: with more units
    than groups, each of 4 heads' stats equal that head run alone."""
    cfg = SpMMConfig(V=1, S=True, W=16)
    p = _pack(cfg, integer=True)
    steer = ops.Steering.from_pcsr(p, cuda_device, cap=SMALL_CAP)
    assert steer.n_units != steer.n_groups
    Q, K, _ = _sddmm_case(p, cuda_device, 16, 4, integer=True)
    kw = dict(scale=0.25, slope=0.2, **_geo(p))
    together = sddmm_ops._stats_call(steer, Q, K, **kw)
    want = sddmm_ops.sddmm_softmax_plain(steer, Q, K, **kw)
    for h in range(4):
        alone = sddmm_ops._stats_call(steer, Q[h:h + 1], K[h:h + 1], **kw)
        for a, b in zip(together, alone):
            assert torch.equal(a[h], b[0])
        assert torch.equal(together[0][h], want[0][h])
        for a, w in zip(together[1:], want[1:]):
            torch.testing.assert_close(a[h], w[h], rtol=1e-5, atol=1e-6)


# raw SDDMM feature widths: every load width (15 → 1 float, 18 → 2, 16 and
# 64 → 4) and, at R = 32, a d wider than the kernel's Q tile (200)
RAW_DIMS = (15, 16, 18, 64, 200)


def _raw_check(p, Q, K, integer, steer=None):
    """The raw SDDMM kernel against its plain version: through the public
    ``sddmm`` (the wrapper's steering; one head as the single-head entry
    point, as GAT calls it), or on ``steer`` through ``_call``.  One
    launch counted, every slot without a stored nonzero exactly 0,
    bit-exact on integer operands."""
    cfg = p.config
    before = sddmm_ops.launch_count("sddmm")
    if steer is not None:
        got = sddmm_ops._call(steer, Q, K, **_geo(p))
    elif Q.shape[0] == 1:
        got = sddmm_ops.sddmm(p, Q[0], K[0])[None]
    else:
        got = sddmm_ops.sddmm(p, Q, K)
    torch.cuda.synchronize()
    assert sddmm_ops.launch_count("sddmm") == before + 1
    if steer is None:
        steer = ops.device_steering(p, Q.device)
    want = sddmm_ops.sddmm_plain(steer, Q, K, V=cfg.V, R=cfg.R, K=p.K,
                                 n_rows=p.n_rows)
    assert (got[:, steer.vals == 0] == 0).all()
    if integer:
        assert torch.equal(got, want)
    else:
        torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)


@pytest.mark.cuda
@pytest.mark.parametrize("cfg", CONFIGS, ids=lambda c: str(c.astuple()))
@pytest.mark.parametrize("H", [1, 4])
def test_raw_sddmm_matches_plain(cuda_device, cfg, H):
    """At the wrapper's cap and with units of at most SMALL_CAP real
    slots, over RAW_DIMS."""
    for integer in (True, False):
        p = _pack(cfg, integer, explicit_zeros=True)
        split = ops.Steering.from_pcsr(p, cuda_device, cap=SMALL_CAP)
        assert split.n_units > split.n_groups
        for d in RAW_DIMS:
            Q, K, _ = _sddmm_case(p, cuda_device, d, H, integer)
            _raw_check(p, Q, K, integer)
            _raw_check(p, Q, K, integer, split)


def _hub_pack(cfg, integer, n=1200):
    """A star over ``n`` nodes (row and column 0 hold every node) plus 3
    random edges a row, every 7th stored value 0: the hub's group spans
    several units at the wrapper's own cap."""
    rng = np.random.default_rng(2)
    rows = np.concatenate([rng.integers(0, n, 3 * n), np.zeros(n, np.int64),
                           np.arange(n)])
    cols = np.concatenate([rng.integers(0, n, 3 * n), np.arange(n),
                           np.zeros(n, np.int64)])
    key = np.unique(rows * n + cols)
    rows, cols = key // n, key % n
    vals = (rng.choice([-2.0, -1.0, 1.0, 2.0], rows.size) if integer
            else rng.standard_normal(rows.size)).astype(np.float32)
    vals[::7] = 0.0
    c = CSRMatrix.from_coo(rows, cols, vals, n, n, sum_duplicates=False)
    return build_pcsr(c.indptr, c.indices, c.data, n, n, cfg)


@pytest.mark.cuda
@pytest.mark.parametrize("cfg", [SpMMConfig(V=1, S=True, W=32),
                                 SpMMConfig(V=2, S=False, W=4)],
                         ids=lambda c: str(c.astuple()))
def test_raw_sddmm_hub_matches_plain(cuda_device, cfg):
    """The hub's group split over several units at the wrapper's cap, at 1
    and 4 heads, over RAW_DIMS and a d wider than the Q tile at R = 8."""
    for integer in (True, False):
        p = _hub_pack(cfg, integer)
        steer = ops.device_steering(p, cuda_device)
        assert int(torch.bincount(steer.units[:, 2].long()).max()) >= 2
        for H in (1, 4):
            for d in RAW_DIMS + (520,):
                Q, K, _ = _sddmm_case(p, cuda_device, d, H, integer)
                _raw_check(p, Q, K, integer)


@pytest.mark.cuda
def test_raw_sddmm_on_cuda_never_takes_the_plain_version(cuda_device,
                                                          monkeypatch):
    """A CUDA call launches the kernel (one count) and never reaches
    ``sddmm_plain``, also for a Q that starts 4 bytes past a 16-byte
    boundary (the one-float load width)."""
    cfg = SpMMConfig(V=2, S=True, B=True, W=8)
    p = _pack(cfg, integer=True, explicit_zeros=True)
    steer = ops.device_steering(p, cuda_device)
    Q, K, _ = _sddmm_case(p, cuda_device, 64, 1, integer=True)
    shifted = torch.empty(Q.numel() + 1, device=cuda_device)[1:]
    shifted.copy_(Q.reshape(-1))
    Qs = shifted.view(p.n_rows, 64)
    assert Qs.is_contiguous() and Qs.data_ptr() % 16 == 4
    want = sddmm_ops.sddmm_plain(steer, Q, K, V=cfg.V, R=cfg.R, K=p.K,
                                 n_rows=p.n_rows)[0]

    def refuse(*a, **k):
        raise AssertionError("a CUDA tensor reached the plain version")

    monkeypatch.setattr(sddmm_ops, "sddmm_plain", refuse)
    for q in (Q[0], Qs):
        before = sddmm_ops.launch_count("sddmm")
        got = sddmm_ops.sddmm(p, q, K[0])
        torch.cuda.synchronize()
        assert sddmm_ops.launch_count("sddmm") == before + 1
        assert torch.equal(got, want)


def _grads(fn, args, dOut):
    """(output, grads) of ``fn(*args)`` against the cotangent ``dOut``."""
    args = [a.clone().requires_grad_() for a in args]
    out = fn(*args)
    return [out.detach()] + list(torch.autograd.grad(out, args, dOut))


def _assert_close(got, want, integer):
    for a, b in zip(got, want):
        assert a.device.type == "cuda" and bool(torch.isfinite(a).all())
        if integer:
            assert torch.equal(a.cpu(), b)
        else:
            torch.testing.assert_close(a.cpu(), b, rtol=1e-5, atol=1e-4)


@pytest.mark.cuda
@pytest.mark.parametrize("cfg", CONFIGS[::3], ids=lambda c: str(c.astuple()))
@pytest.mark.parametrize("activation", ["none", "relu", "leaky_relu"])
def test_spmm_operator_grads_on_card_match_cpu(cuda_device, cfg,
                                               activation):
    for integer in (True, False):
        p = _pack(cfg, integer)
        p_t = transpose_pcsr(p)
        rng = np.random.default_rng(7)
        draw = ((lambda *s: rng.integers(-3, 4, s) * 5.0) if integer
                else (lambda *s: rng.standard_normal(s)))
        cpu = [torch.tensor(draw(*s), dtype=torch.float32)
               for s in ((90, 32), (90,), (32,), (90, 32), (90, 32))]
        B, scale, bias, resid, dOut = cpu
        spmm = engine.make_spmm_fn(p, p_t)
        fused = engine.make_fused_spmm_fn(p, p_t)
        f = lambda B_, b_, r_, s_=None: fused(B_, scale=s_, bias=b_,
                                              residual=r_,
                                              activation=activation)
        for fn, args in ((spmm, [B]), (f, [B, bias, resid])):
            want = _grads(fn, args, dOut)
            before = ops.launch_count()
            got = _grads(fn, [a.to(cuda_device) for a in args],
                         dOut.to(cuda_device))
            torch.cuda.synchronize()
            assert ops.launch_count() == before + 2    # forward + dB
            _assert_close(got, want, integer)
        # scale: graph data, a constant of the backward
        g = lambda B_, b_, r_: f(B_, b_, r_, scale.to(B_.device))
        want = _grads(g, [B, bias, resid], dOut)
        got = _grads(g, [a.to(cuda_device) for a in (B, bias, resid)],
                     dOut.to(cuda_device))
        _assert_close(got, want, integer)


@pytest.mark.cuda
@pytest.mark.parametrize("cfg", CONFIGS[::3], ids=lambda c: str(c.astuple()))
@pytest.mark.parametrize("H", [1, 4])
def test_gat_message_grads_on_card_match_cpu(cuda_device, cfg, H):
    p = _pack(cfg, False, explicit_zeros=True)
    p_t = transpose_pcsr(p)
    rng = np.random.default_rng(8)
    lead = (H,) if H > 1 else ()
    cpu = [torch.tensor(rng.standard_normal(lead + (90, 16)),
                        dtype=torch.float32) for _ in range(4)]
    cpu[0][..., 60, :] = 0.0                     # a row of zero logits
    f = engine.make_gat_message_fn(p, p_t)
    want = _grads(f, cpu[:3], cpu[3])
    counts = lambda: (ops.launch_count(),
                      *(sddmm_ops.launch_count(k) for k in sddmm_ops.KERNELS))
    before = counts()
    got = _grads(f, [a.to(cuda_device) for a in cpu[:3]],
                 cpu[3].to(cuda_device))
    torch.cuda.synchronize()
    after = counts()
    # paramspmm, sddmm_softmax, sddmm, gat_backward (the slot pass)
    assert tuple(a - b for a, b in zip(after, before)) == (4, 1, 1, 1)
    _assert_close(got, want, False)


@pytest.mark.cuda
@pytest.mark.parametrize("cfg", CONFIGS[::3], ids=lambda c: str(c.astuple()))
@pytest.mark.parametrize("H", [None, 1, 8])
def test_gat_backward_slot_pass_matches_plain_bit_for_bit(cuda_device, cfg,
                                                          H):
    """The slot-pass kernel gives its plain version's bits on the same
    CUDA tensors for every subset of its outputs; Aᵀ slots without an edge
    read +0, and a CUDA call never reaches the plain version."""
    p = _pack(cfg, False, explicit_zeros=True)
    p_t = transpose_pcsr(p)
    steer = ops.device_steering(p, cuda_device)
    t = engine.TransposeSide.build(p, p_t, cuda_device)
    g = torch.Generator(device=cuda_device).manual_seed(3)
    lead = () if H is None else (H,)
    Q, K, Vf, dOut = (torch.randn(lead + (90, 16), generator=g,
                                  device=cuda_device) for _ in range(4))
    geo = dict(n_blocks=p.n_blocks, R=cfg.R, V=cfg.V, K=p.K, n_rows=90)
    logits, rm, rs = sddmm_ops._stats_call(steer, Q, K, scale=0.25, **geo)
    out = ops._call(steer, Vf, vals=logits, rowmax=rm, rowsum=rs,
                    dblk=cfg.dblk, **geo)
    dalpha = sddmm_ops._call(steer, dOut, Vf, **geo)
    rowdot = engine._row_dot(dOut, out, p.n_blocks * cfg.R)
    kw = dict(R=cfg.R, V=cfg.V, K=p.K, t_shape=t.shape, scale=0.25,
              slope=0.2)
    for nq, nk, nv in [(q, k, v) for q in (0, 1) for k in (0, 1)
                       for v in (0, 1) if q or k or v]:
        nd = bool(nq or nk)
        args = dict(kw, need_q=bool(nq), need_k=bool(nk), need_v=bool(nv),
                    dalpha=dalpha if nd else None,
                    rowdot=rowdot if nd else None)
        want = sddmm_ops.gat_backward_plain(steer, t.src, logits, rm, rs,
                                            **args)
        before = sddmm_ops.launch_count("gat_backward")
        # the kernel may hand dα's storage back as an Aᵀ output
        got = sddmm_ops.gat_backward(steer, t.src, logits, rm, rs,
                                     **dict(args, dalpha=dalpha.clone()
                                            if nd else None))
        torch.cuda.synchronize()
        assert sddmm_ops.launch_count("gat_backward") == before + 1
        for a, b in zip(got, want):
            assert (a is None) == (b is None)
            if a is not None:
                assert torch.equal(a.view(torch.int32), b.view(torch.int32))
        for x in got[1:]:
            if x is not None:
                empty = x.reshape(x.shape[:-3] + (-1,))[..., t.src < 0]
                assert not bool(empty.view(torch.int32).any())


@pytest.mark.cuda
@pytest.mark.parametrize("model", ["gcn", "gin", "gat"])
def test_train_gnn_on_card_matches_cpu(cuda_device, model):
    task = community_task(n_blocks=4, block_size=64)
    kw = dict(model=model, hidden=32, n_layers=3, steps=3, seed=1)
    cpu = train_gnn(task, device="cpu", **kw)
    before = ops.launch_count()
    card = train_gnn(task, device=cuda_device, **kw)
    assert ops.launch_count() > before
    assert card.config == cpu.config
    np.testing.assert_allclose(card.losses, cpu.losses, rtol=1e-4, atol=0)
    assert card.losses[-1] < card.losses[0]


# ------------------------------------------------------ selective scan (LM)
SCAN_GRID = [(1, 1, 2, 64), (1, 33, 4, 130), (2, 100, 16, 200),
             (4, 1024, 2, 64), (2, 33, 16, 3200), (1, 1024, 16, 130),
             (4, 100, 4, 3200), (2, 1, 16, 130), (1, 100, 2, 3200),
             (4, 33, 16, 64), (2, 1024, 4, 200), (1, 37, 32, 48)]
SCAN_TOL = dict(atol=1e-5, rtol=1e-5)   # FMA and the Σ_n order differ


def _scan_operands(shape, device, seed=0):
    g = torch.Generator(device=device).manual_seed(seed)
    B, S, N, Di = shape
    dA = torch.rand((B, S, N, Di), generator=g, device=device) * 0.79 + 0.2
    dBx = torch.randn((B, S, N, Di), generator=g, device=device) * 0.1
    C = torch.randn((B, S, N), generator=g, device=device)
    return dA, dBx, C


@pytest.mark.cuda
@pytest.mark.parametrize("shape", SCAN_GRID, ids=str)
def test_selective_scan_kernel_matches_plain(cuda_device, shape):
    from repro_torch.kernels import selective_scan as scan
    dA, dBx, C = _scan_operands(shape, cuda_device)
    before = scan.launch_count()
    got = scan.selective_scan(dA, dBx, C)
    torch.cuda.synchronize()
    assert scan.launch_count() == before + 1
    torch.testing.assert_close(got, scan.selective_scan_plain(dA, dBx, C),
                               **SCAN_TOL)


@pytest.mark.cuda
def test_selective_scan_impulse_reaches_last_step(cuda_device):
    from repro_torch.kernels import selective_scan as scan
    B, S, N, Di = 1, 1024, 2, 130
    dA = torch.full((B, S, N, Di), 0.999, device=cuda_device)
    dBx = torch.zeros((B, S, N, Di), device=cuda_device)
    dBx[:, 0] = 1.0
    y = scan.selective_scan(dA, dBx, torch.ones((B, S, N),
                                                device=cuda_device))
    torch.cuda.synchronize()
    want = torch.full((Di,), 2 * 0.999 ** (S - 1), dtype=torch.float64)
    torch.testing.assert_close(y[0, -1].double().cpu(), want, rtol=1e-4,
                               atol=0)


@pytest.mark.cuda
def test_selective_scan_on_cuda_never_takes_the_plain_version(cuda_device,
                                                               monkeypatch):
    from repro_torch.kernels.selective_scan import ops as scan_ops
    want = scan_ops.selective_scan_plain(*_scan_operands((2, 40, 4, 96),
                                                         cuda_device))

    def refuse(*a):
        raise AssertionError("a CUDA tensor reached the plain version")

    monkeypatch.setattr(scan_ops, "selective_scan_plain", refuse)
    before = scan_ops.launch_count()
    got = scan_ops.selective_scan(*_scan_operands((2, 40, 4, 96),
                                                  cuda_device))
    torch.cuda.synchronize()
    assert scan_ops.launch_count() == before + 1
    torch.testing.assert_close(got, want, **SCAN_TOL)
    with pytest.raises(ValueError, match="N ≤ 32"):
        scan_ops.selective_scan(*_scan_operands((1, 4, 33, 8), cuda_device))


SCAN_BWD_RTOL = 1e-4                    # × max |g| of each operand


def _scan_grads_plain(dA, dBx, C, gy):
    from repro_torch.kernels import selective_scan as scan
    h = scan.selective_scan_states_plain(dA, dBx)
    return scan.selective_scan_backward_plain(dA, C, h, gy)


def _assert_grads_close(got, want, what=""):
    for name, g, w in zip(("dA", "dBx", "C"), got, want):
        assert g.shape == w.shape, (what, name)
        top = float(w.abs().max())
        err = float((g - w).abs().max())
        assert err <= SCAN_BWD_RTOL * top, (what, name, err, top)


@pytest.mark.cuda
@pytest.mark.parametrize("shape", SCAN_GRID, ids=str)
def test_selective_scan_backward_kernel_matches_plain(cuda_device, shape):
    """Through the autograd path: one forward and one backward launch;
    the gradients against the plain backward and against autograd through
    the plain loop on the same CUDA tensors."""
    from repro_torch.kernels import selective_scan as scan
    dA, dBx, C = _scan_operands(shape, cuda_device, seed=1)
    gy = torch.randn(shape[:2] + shape[3:], device=cuda_device,
                     generator=torch.Generator(device=cuda_device)
                     .manual_seed(2))
    ts = [t.clone().requires_grad_() for t in (dA, dBx, C)]
    fwd, bwd = scan.launch_count("forward"), scan.launch_count("backward")
    got = torch.autograd.grad(scan.selective_scan(*ts), ts, gy)
    torch.cuda.synchronize()
    assert scan.launch_count("forward") == fwd + 1
    assert scan.launch_count("backward") == bwd + 1
    _assert_grads_close(got, _scan_grads_plain(dA, dBx, C, gy), "plain")
    ts = [t.clone().requires_grad_() for t in (dA, dBx, C)]
    auto = torch.autograd.grad(scan.selective_scan_plain(*ts), ts, gy)
    _assert_grads_close(got, auto, "autograd")


@pytest.mark.cuda
def test_selective_scan_backward_is_deterministic(cuda_device):
    from repro_torch.kernels import selective_scan as scan
    from repro_torch.kernels.selective_scan import ops as scan_ops
    shape = (2, 300, 16, 200)
    dA, dBx, C = _scan_operands(shape, cuda_device, seed=3)
    _, states = scan_ops._launch(dA, dBx, C, states=True)
    gy = torch.randn((2, 300, 200), device=cuda_device)
    one = scan.selective_scan_backward(dA, dBx, C, states, gy)
    two = scan.selective_scan_backward(dA, dBx, C, states, gy)
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in zip(one, two))


@pytest.mark.cuda
def test_selective_scan_backward_impulse_reaches_step_zero(cuda_device):
    from repro_torch.kernels import selective_scan as scan
    B, S, N, Di = 1, 1024, 2, 130
    dA = torch.full((B, S, N, Di), 0.999, device=cuda_device)
    dBx = torch.ones_like(dA)
    C = torch.ones((B, S, N), device=cuda_device)
    gy = torch.zeros((B, S, Di), device=cuda_device)
    gy[:, -1] = 1.0
    states = scan.selective_scan_chunk_states_plain(dA, dBx, scan.CHUNK)
    _, g_dBx, _ = scan.selective_scan_backward(dA, dBx, C, states, gy)
    torch.cuda.synchronize()
    want = torch.full((N, Di), 0.999 ** (S - 1), dtype=torch.float64)
    torch.testing.assert_close(g_dBx[0, 0].double().cpu(), want, rtol=1e-4,
                               atol=0)


# S around the chunk length (64) and past several chunks, B = 1 and 2,
# ragged Di against the backward's 32-column slices, N not a multiple of 4
SCAN_CHUNK_GRID = [(1, 1, 16, 3200), (2, 63, 4, 130), (1, 64, 16, 200),
                   (2, 65, 2, 64), (1, 197, 3, 40), (2, 128, 16, 96),
                   (1, 129, 32, 33), (1, 1000, 16, 3200)]


@pytest.mark.cuda
@pytest.mark.parametrize("shape", SCAN_CHUNK_GRID, ids=str)
def test_selective_scan_chunk_states_and_backward_match_plain(cuda_device,
                                                              shape):
    """The training forward's chunk states against the plain ones, its y
    the inference forward's bits, and the backward kernel on them against
    the plain backward from the same states."""
    from repro_torch.kernels import selective_scan as scan
    from repro_torch.kernels.selective_scan import ops as scan_ops
    dA, dBx, C = _scan_operands(shape, cuda_device, seed=4)
    gy = torch.randn(shape[:2] + shape[3:], device=cuda_device,
                     generator=torch.Generator(device=cuda_device)
                     .manual_seed(5))
    y, states = scan_ops._launch(dA, dBx, C, states=True)
    y0, none = scan_ops._launch(dA, dBx, C)
    torch.cuda.synchronize()
    assert none is None and torch.equal(y, y0)
    B, S, N, Di = shape
    assert tuple(states.shape) == (B, -(-S // scan.CHUNK), N, Di)
    want = scan.selective_scan_chunk_states_plain(dA, dBx, scan.CHUNK)
    torch.testing.assert_close(states, want, **SCAN_TOL)
    bwd = scan.launch_count("backward")
    got = scan.selective_scan_backward(dA, dBx, C, states, gy)
    torch.cuda.synchronize()
    assert scan.launch_count("backward") == bwd + 1
    _assert_grads_close(got, scan.selective_scan_backward_from_states_plain(
        dA, dBx, C, states, gy, scan.CHUNK), "from states")
    _assert_grads_close(got, _scan_grads_plain(dA, dBx, C, gy), "plain")


@pytest.mark.cuda
def test_selective_scan_autograd_saves_chunk_states_not_h(cuda_device):
    from repro_torch.kernels import selective_scan as scan
    B, S, N, Di = 2, 200, 16, 96
    dA, dBx, C = (t.requires_grad_() for t in _scan_operands(
        (B, S, N, Di), cuda_device, seed=6))
    y = scan.selective_scan(dA, dBx, C)
    saved = y.grad_fn.saved_tensors
    assert [tuple(t.shape) for t in saved] == [
        (B, S, N, Di), (B, S, N, Di), (B, S, N), (B, -(-S // scan.CHUNK), N,
                                                  Di)]
    # dA and dBx are the inputs themselves: nothing of (B, S, N, Di) new
    assert saved[0].data_ptr() == dA.data_ptr()
    assert saved[1].data_ptr() == dBx.data_ptr()


@pytest.mark.cuda
def test_selective_scan_without_grad_keeps_no_states(cuda_device,
                                                     monkeypatch):
    """No input requiring grad, or grad disabled: the forward kernel alone,
    as in serving."""
    from repro_torch.kernels.selective_scan import ops as scan_ops
    dA, dBx, C = _scan_operands((1, 40, 4, 96), cuda_device)

    def refuse(*a):
        raise AssertionError("a call without a gradient kept the states")

    monkeypatch.setattr(scan_ops._Scan, "apply", refuse)
    fwd = scan_ops.launch_count("forward")
    scan_ops.selective_scan(dA, dBx, C)
    with torch.no_grad():
        scan_ops.selective_scan(dA.requires_grad_(), dBx, C)
    torch.cuda.synchronize()
    assert scan_ops.launch_count("forward") == fwd + 2


def _live_mamba_params(cfg, g):
    D, N = cfg.d_model, cfg.ssm_state
    Di = cfg.ssm_expand * D
    scales = {"in_proj": ((D, 2 * Di), D ** -0.5), "conv_w": ((4, Di), 0.5),
              "dt_a": ((Di, 64), Di ** -0.5), "dt_proj": ((64, Di), 0.125),
              "dt_b": ((Di,), 0.5), "bc_w": ((Di, 2 * N), Di ** -0.5),
              "d_skip": ((Di,), 1.0), "out_proj": ((Di, D), Di ** -0.5)}
    lp = {k: (torch.randn(s, generator=g) * sc).to(torch.bfloat16)
          for k, (s, sc) in scales.items()}
    lp["a_log"] = torch.log(torch.arange(1, N + 1, dtype=torch.float32)
                            ).expand(Di, N).contiguous()
    return lp


def _rel_l2(got, want):
    got, want = got.float().cpu(), want.float()
    return float((got - want).norm() / want.norm().clamp_min(1e-30))


@pytest.mark.cuda
def test_mamba_branch_backward_on_card_matches_cpu(cuda_device):
    """A backward through ``mamba_branch`` on the card reaches the scan's
    backward kernel, and every parameter's and the input's gradient
    matches the CPU's (bf16 model: 5e-2 relative L2, the LM training
    tolerance)."""
    from repro_torch.configs import get_reduced
    from repro_torch.kernels import selective_scan as scan
    from repro_torch.models import ssm
    cfg = get_reduced("hymba-1.5b")
    g = torch.Generator().manual_seed(0)
    lp = _live_mamba_params(cfg, g)
    x = torch.randn((2, 40, cfg.d_model), generator=g).to(torch.bfloat16)
    gy = torch.randn((2, 40, cfg.d_model), generator=g).to(torch.bfloat16)
    grads = {}
    for dev in ("cpu", cuda_device):
        p = {k: v.to(dev, copy=True).requires_grad_() for k, v in lp.items()}
        xi = x.to(dev, copy=True).requires_grad_()
        bwd = scan.launch_count("backward")
        y = ssm.mamba_branch(xi, p, cfg)
        y.backward(gy.to(dev))
        if dev != "cpu":
            torch.cuda.synchronize()
            assert scan.launch_count("backward") == bwd + 1
        grads[str(dev)] = {"x": xi.grad, **{k: v.grad for k, v in p.items()}}
    cpu, card = grads["cpu"], grads[str(cuda_device)]
    for k in cpu:
        assert card[k] is not None and bool(card[k].abs().sum() > 0), k
        assert _rel_l2(card[k], cpu[k]) <= 5e-2, (k, _rel_l2(card[k], cpu[k]))


@pytest.mark.cuda
def test_train_loss_and_entry_point_on_card(cuda_device, tmp_path):
    """The reduced Hymba's ``train_loss`` gradients on the card against the
    CPU's (loss rtol 1e-3, each leaf 5e-2 relative L2), launches per
    backward (2 forward per layer under remat, 1 backward), and
    ``launch/train.py`` on the card with a kill and resume."""
    from repro_torch.configs import get_reduced
    from repro_torch.data.tokens import batch_for_step
    from repro_torch.kernels import selective_scan as scan
    from repro_torch.launch import train
    from repro_torch.models import lm
    from repro_torch.optim.adamw import tree_leaves, tree_map
    cfg = get_reduced("hymba-1.5b")
    cpu = lm.init_params(cfg, generator=torch.Generator().manual_seed(1),
                         device="cpu")
    batch = {k: torch.as_tensor(v) for k, v in
             batch_for_step(cfg, 2, 32, 0, seed=0).items()}
    out = {}
    for dev in ("cpu", cuda_device):
        p = tree_map(lambda t: t.to(dev).detach().requires_grad_(), cpu)
        scan.reset_launch_count()
        loss = lm.train_loss(p, cfg, {k: v.to(dev) for k, v in
                                      batch.items()}, chunk=16)
        loss.backward()
        out[str(dev)] = (float(loss), [t.grad for t in tree_leaves(p)],
                         scan.launch_count("forward"),
                         scan.launch_count("backward"))
    (l0, g0, _, _), (l1, g1, f1, b1) = out["cpu"], out[str(cuda_device)]
    assert (f1, b1) == (2 * cfg.n_layers, cfg.n_layers)
    np.testing.assert_allclose(l1, l0, rtol=1e-3)
    for a, b in zip(g1, g0):
        assert _rel_l2(a, b) <= 5e-2
    argv = ["--reduced", "--batch", "2", "--seq", "16", "--log-every", "100"]
    full = train.main(argv + ["--steps", "6"])
    ck = str(tmp_path / "ck")
    train.main(argv + ["--steps", "4", "--ckpt-dir", ck])
    resumed = train.main(argv + ["--steps", "6", "--ckpt-dir", ck,
                                 "--resume"])
    assert all(np.isfinite(full)) and len(resumed) == 2
    np.testing.assert_allclose(resumed, full[4:], rtol=1e-3)


def _to(tree, device):
    return {k: _to(v, device) if isinstance(v, dict) else v.to(device)
            for k, v in tree.items()}


@pytest.mark.cuda
def test_hymba_prefill_and_decode_on_card_match_cpu(cuda_device):
    """Reduced Hymba: prefill (through the kernel, one launch per layer)
    and 12 decode steps (none) on the card vs the port on the CPU, bf16
    within the reference's backend-agreement tolerance 5e-2."""
    from repro_torch.configs import get_reduced
    from repro_torch.configs.base import ShapeCell
    from repro_torch.kernels import selective_scan as scan
    from repro_torch.launch.serve import generate
    from repro_torch.models import lm
    cfg = get_reduced("hymba-1.5b")
    g = torch.Generator().manual_seed(0)
    cpu = lm.init_params(cfg, generator=g, device="cpu")
    for stack in ("layers", "glayers"):
        for name in ("bc_w", "d_skip"):
            cpu[stack][name] = (torch.randn(cpu[stack][name].shape,
                                            generator=g) * 0.02).to(
                                                torch.bfloat16)
    card = _to(cpu, cuda_device)
    tokens = torch.randint(0, cfg.vocab, (2, 40), generator=g)
    before = scan.launch_count()
    got = lm.prefill(card, cfg, {"tokens": tokens.to(cuda_device)}, chunk=8)
    torch.cuda.synchronize()
    assert scan.launch_count() == before + cfg.n_layers
    want = lm.prefill(cpu, cfg, {"tokens": tokens}, chunk=8)
    m = want > -1e30
    torch.testing.assert_close(got.cpu()[m], want[m], atol=5e-2, rtol=5e-2)

    cache = {d: lm.init_cache(cfg, ShapeCell("d", 12, 2, "decode"),
                              device=d) for d in ("cpu", cuda_device)}
    before = scan.launch_count()
    for t in range(12):
        tok = tokens[:, t:t + 1]
        lc, cache["cpu"] = lm.decode_step(cpu, cfg, tok, cache["cpu"], t)
        lg, cache[cuda_device] = lm.decode_step(card, cfg,
                                                tok.to(cuda_device),
                                                cache[cuda_device], t)
        torch.testing.assert_close(lg.cpu()[m], lc[m], atol=5e-2,
                                   rtol=5e-2)
    assert scan.launch_count() == before
    seq = generate(cfg, card, tokens[:, :6].numpy(), 14, 8,
                   device=cuda_device)
    assert seq.shape == (2, 14) and seq.device.type == "cuda"
    assert int(seq.max()) < cfg.vocab


# ------------------------------------- measured oracle, baselines, decider
@pytest.mark.cuda
@pytest.mark.parametrize("op,H", [("spmm", 1), ("spmm", 4), ("sddmm", 1),
                                  ("gat", 1), ("gat", 4)])
def test_measured_oracle_times_the_kernels(cuda_device, op, H):
    """Each config launches each timed kernel warmup + reps times, and
    nothing else; every time is finite and positive, the best the
    argmin."""
    from repro_torch.core.autotune import oracle_search
    from repro_torch.core.pcsr import config_space
    g = rmat(10, 8, seed=1)
    space = config_space(64)
    ops.reset_launch_count()
    sddmm_ops.reset_launch_count()
    res = oracle_search(g, 64, mode="measured", reps=3, warmup=2, op=op,
                        H=H, device=cuda_device)
    per = 5 * len(space)
    assert (ops.launch_count(), sddmm_ops.launch_count("sddmm_softmax"),
            sddmm_ops.launch_count("sddmm")) == (
        per if op in ("spmm", "gat") else 0, per if op == "gat" else 0,
        per if op == "sddmm" else 0)
    t = np.array(list(res.times.values()))
    assert np.isfinite(t).all() and (t > 0).all()
    assert res.best_config == min(res.times, key=res.times.get)


@pytest.mark.cuda
@pytest.mark.parametrize("cfg", CONFIGS, ids=lambda c: str(c.astuple()))
def test_cusparse_analogue_equals_paramspmm(cuda_device, cfg):
    """torch.sparse.mm on CSR (cuSPARSE) and the ParamSpMM kernel give the
    same bits on integer-valued operands; so does the GE-SpMM analogue,
    and both differentiate in B like the kernel's operator."""
    from repro_torch.core.baselines import (make_cusparse_analog,
                                            make_gespmm_analog)
    rng = np.random.default_rng(3)
    A = (rng.random((90, 90)) < 0.08) * rng.integers(-2, 3, (90, 90))
    c = CSRMatrix.from_dense(A.astype(np.float32))
    p = build_pcsr(c.indptr, c.indices, c.data, 90, 90, cfg)
    B = torch.from_numpy(rng.integers(-4, 5, (90, 24)).astype(np.float32)
                         ).to(cuda_device)
    launches = ops.launch_count()
    want = ops.paramspmm(p, B)
    assert ops.launch_count() == launches + 1
    for make in (make_cusparse_analog, make_gespmm_analog):
        fn = make(c, cuda_device)
        assert torch.equal(fn(B), want)
        Bg = B.clone().requires_grad_()
        dC = torch.ones_like(want)
        (dB,) = torch.autograd.grad(fn(Bg), Bg, dC)
        assert torch.equal(dB.cpu(), torch.from_numpy(
            (A.T @ np.ones((90, 24))).astype(np.float32)))
    assert ops.launch_count() == launches + 1


@pytest.mark.cuda
def test_serving_with_a_decider_on_card(cuda_device):
    """A decider's pick drives GCN serving on the card; the result equals
    the same service on the CPU bit for bit (integer operands)."""
    from repro_torch.core.decider import RandomForest, SpMMDecider
    from repro_torch.core.features import extract_features
    g = rmat(10, 6, seed=4)
    pick = SpMMConfig(V=2, S=True, F=1, W=4, B=True)
    dec = SpMMDecider(forest=RandomForest(n_estimators=3, seed=0))
    dec.fit([(extract_features(g), 64, pick)] * 4)
    rng = np.random.default_rng(0)
    feats = rng.integers(0, 3, (g.n_rows, 16)).astype(np.float32)
    params = [{k: torch.round(v * 4) for k, v in layer.items()}
              for layer in init_gcn([16, 64, 16],
                                    generator=torch.Generator()
                                    .manual_seed(0))]
    out = {}
    for dev in (cuda_device, "cpu"):
        svc = GNNService(g, feats, params, model="gcn", device=dev,
                         decider=dec)
        res = replay(svc, synthetic_stream(6, g.n_rows, seed=1),
                     tick_every=3)
        assert {r.config for r in res} == {pick}
        out[str(dev)] = [r.outputs for r in res]
    for a, b in zip(out["cuda"], out["cpu"]):
        np.testing.assert_array_equal(a, b)


# --------------------------------------------- dynamic graphs (mutated views)
def _dyn_ints(rng, n, d):
    return rng.integers(-3, 4, (n, d)).astype(np.float32)


def _dyn_edges(csr):
    rows = np.repeat(np.arange(csr.n_rows, dtype=np.int64), csr.degrees)
    return rows, csr.indices


DYN_CONFIGS = [SpMMConfig(V=v, S=s, B=b, W=8 // v)
               for v in (1, 2) for s, b in ((False, False), (True, False),
                                            (True, True))]


def _degraded(cfg, seed=3, n=96):
    """A numpy-only degraded layout: churn, block birth (rows 80..95 had
    no edge), a fully deleted block (rows 0..7) and a fat row."""
    rng = np.random.default_rng(seed)
    A = ((rng.random((n, n)) < 0.08)
         * rng.integers(1, 8, (n, n))).astype(np.float32)
    A[80:] = 0.0
    d = DynamicPCSR.from_csr(CSRMatrix.from_dense(A), cfg)
    d.insert_edges(np.full(60, 81), rng.permutation(n)[:60],
                   rng.integers(1, 5, 60).astype(np.float32))
    rows, cols = _dyn_edges(d.to_csr())
    sel = (rows < 8) | (rng.random(rows.size) < 0.2)
    d.delete_edges(rows[sel], cols[sel])
    d.insert_edges(rng.integers(8, n, 40), rng.integers(0, n, 40),
                   rng.integers(1, 5, 40).astype(np.float32))
    return d


@pytest.mark.cuda
@pytest.mark.parametrize("cfg", DYN_CONFIGS, ids=lambda c: str(c.astuple()))
@pytest.mark.parametrize("cap", [None, 4])
def test_kernels_on_degraded_views_match_plain(cuda_device, cfg, cap):
    """ParamSpMM, the SDDMM → softmax pair and the raw SDDMM over a
    degraded view on the card, against their plain versions on the same
    tensors: SpMM and raw SDDMM bit-exact on integer operands, the GAT
    message forward and gradients within ``rtol=1e-5, atol=1e-4``."""
    d = _degraded(cfg)
    p = d.pcsr
    steer = ops.Steering.from_pcsr(p, cuda_device, cap=cap)
    geo = dict(n_blocks=p.n_blocks, R=cfg.R, V=cfg.V, K=p.K,
               n_rows=p.n_rows)
    rng = np.random.default_rng(0)
    B = torch.as_tensor(_dyn_ints(rng, p.n_cols, 16), device=cuda_device)
    n0 = ops.launch_count()
    out = ops._call(steer, B, dblk=cfg.dblk, **geo)
    assert ops.launch_count() == n0 + 1
    assert torch.equal(out, ops.paramspmm_plain(steer, B, **geo))
    Q = torch.as_tensor(_dyn_ints(rng, p.n_rows, 16), device=cuda_device)
    raw = sddmm_ops._call(steer, Q, B, **geo)
    plain = sddmm_ops.sddmm_plain(steer, Q[None], B[None], V=cfg.V, R=cfg.R,
                                  K=p.K, n_rows=p.n_rows)[0]
    assert torch.equal(raw, plain)
    assert bool((raw[steer.vals == 0] == 0).all())
    x = [torch.as_tensor(rng.standard_normal((p.n_rows, 16)),
                         dtype=torch.float32) for _ in range(4)]
    res = {}
    for dev in ("cpu", cuda_device):
        ts = [t.to(dev, copy=True).requires_grad_() for t in x[:3]]
        y = engine.make_gat_message_fn(p)(*ts)
        y.backward(x[3].to(dev))
        res[str(dev)] = [y.detach().cpu()] + [t.grad.cpu() for t in ts]
    for a, b in zip(res["cpu"], res[str(cuda_device)]):
        torch.testing.assert_close(b, a, rtol=1e-5, atol=1e-4)
    assert bool((res["cpu"][0][:8] == 0).all())


@pytest.mark.cuda
def test_dynamic_graph_on_card_matches_fresh_pack(cuda_device):
    """``DynamicGraph`` on the card: its SpMM over every version of a
    churn stream bit-exact against a fresh pack on the card, one kernel
    launch a call, gradients through the version's transpose pack."""
    rng = np.random.default_rng(1)
    n = 256
    A = ((rng.random((n, n)) < 0.04)
         * rng.integers(1, 5, (n, n))).astype(np.float32)
    g = DynamicGraph(CSRMatrix.from_dense(A), 16, slack=1.05,
                     amortize_steps=5, device=cuda_device)
    B = torch.as_tensor(_dyn_ints(rng, n, 16), device=cuda_device)
    for _ in range(4):
        g.insert_edges(rng.integers(0, n, 200), rng.integers(0, n, 200),
                       rng.integers(1, 4, 200).astype(np.float32))
        rows, cols = _dyn_edges(g.dyn.to_csr())
        pick = rng.choice(rows.size, 150, replace=False)
        g.delete_edges(rows[pick], cols[pick])
        n0 = ops.launch_count()
        Bg = B.clone().requires_grad_()
        out = g.spmm(Bg)
        out.backward(B)
        assert ops.launch_count() == n0 + 2
        cur = g.dyn.to_csr()
        fresh = build_pcsr(cur.indptr, cur.indices, cur.data, n, n,
                           g.config)
        assert torch.equal(out, ops.paramspmm(fresh, B))
        t = cur.transpose()
        ft = build_pcsr(t.indptr, t.indices, t.data, n, n, g.config)
        assert torch.equal(Bg.grad, ops.paramspmm(ft, B))


DECODER_ARCHS = ["qwen2-72b", "chatglm3-6b", "gemma2-27b", "qwen1.5-110b",
                 "granite-moe-1b-a400m", "granite-moe-3b-a800m",
                 "llava-next-mistral-7b"]


@pytest.mark.cuda
@pytest.mark.parametrize("arch", DECODER_ARCHS)
def test_decoder_family_on_card_matches_cpu(cuda_device, arch):
    """A reduced decoder-only model (gemma2's window 8 < S; llava with its
    8 patches) on the card vs the port on the CPU, the same parameters:
    prefill logits and 12 decode steps within 5e-2 (bf16, the reference's
    backend tolerance); ``train_loss`` within ``rtol=1e-3`` and every
    gradient leaf within 5e-2 relative L2."""
    from repro_torch.configs import get_reduced
    from repro_torch.configs.base import ShapeCell
    from repro_torch.data.tokens import batch_for_step
    from repro_torch.models import lm
    from repro_torch.optim.adamw import tree_leaves, tree_map
    cfg = get_reduced(arch)
    cpu = lm.init_params(cfg, generator=torch.Generator().manual_seed(3),
                         device="cpu")
    card = _to(cpu, cuda_device)
    batch = {k: torch.as_tensor(v) for k, v in batch_for_step(
        cfg, 2, 32 - cfg.n_patches, 0, seed=1).items()}
    on = lambda dev: {k: v.to(dev) for k, v in batch.items()}
    got = lm.prefill(card, cfg, on(cuda_device), chunk=16)
    want = lm.prefill(cpu, cfg, batch, chunk=16)
    m = want > -1e30
    torch.testing.assert_close(got.cpu()[m], want[m], atol=5e-2, rtol=5e-2)
    out = {}
    for dev, params in (("cpu", cpu), ("card", card)):
        p = tree_map(lambda t: t.detach().requires_grad_(), params)
        loss = lm.train_loss(p, cfg, on(p["embed"].device), chunk=16)
        loss.backward()
        out[dev] = (float(loss.detach()), [t.grad for t in tree_leaves(p)])
    np.testing.assert_allclose(out["card"][0], out["cpu"][0], rtol=1e-3)
    for a, b in zip(out["card"][1], out["cpu"][1]):
        assert _rel_l2(a, b) <= 5e-2
    cache = {d: lm.init_cache(cfg, ShapeCell("d", 12, 2, "decode"),
                              device=d) for d in ("cpu", cuda_device)}
    tokens = batch["tokens"]
    for t in range(12):
        lc, cache["cpu"] = lm.decode_step(cpu, cfg, tokens[:, t:t + 1],
                                          cache["cpu"], t)
        lg, cache[cuda_device] = lm.decode_step(
            card, cfg, tokens[:, t:t + 1].to(cuda_device),
            cache[cuda_device], t)
        torch.testing.assert_close(lg.cpu()[m], lc[m], atol=5e-2,
                                   rtol=5e-2)


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["chatglm3-6b", "gemma2-27b",
                                  "granite-moe-3b-a800m"])
def test_captured_dense_decode_equals_eager(cuda_device, arch):
    """The dense cache path captured once and replayed: the eager step's
    logits and caches bit for bit over 12 positions (past gemma2's reduced
    window of 8), and ``generate`` the same tokens with and without
    graphs."""
    from repro_torch.configs import get_reduced
    from repro_torch.configs.base import ShapeCell
    from repro_torch.kernels.capture import capture
    from repro_torch.launch.serve import generate
    from repro_torch.models import lm
    cfg = get_reduced(arch)
    g = torch.Generator().manual_seed(2)
    params = _to(lm.init_params(cfg, generator=g, device="cpu"),
                 cuda_device)
    tokens = torch.randint(0, cfg.vocab, (2, 12), generator=g).to(
        cuda_device)
    caches = [lm.init_cache(cfg, ShapeCell("d", 12, 2, "decode"),
                            device=cuda_device) for _ in "ab"]
    static_tok = tokens[:, :1].clone()
    static_pos = torch.zeros((), dtype=torch.int64, device=cuda_device)
    step = lambda: lm.decode_step(params, cfg, static_tok, caches[1],
                                  static_pos)[0]
    captured = None
    with torch.no_grad():
        for t in range(12):
            want, _ = lm.decode_step(params, cfg, tokens[:, t:t + 1],
                                     caches[0], t)
            static_tok.copy_(tokens[:, t:t + 1])
            static_pos.fill_(t)
            if captured is None:
                got, captured = capture(step, cuda_device)
            else:
                got = captured.replay()
            assert torch.equal(got, want), f"step {t}"
    torch.cuda.synchronize()
    for name in caches[0]:
        assert torch.equal(caches[0][name], caches[1][name]), name
    prompt = tokens[:, :4].cpu().numpy()
    seqs = [generate(cfg, params, prompt, 12, 8, device=cuda_device,
                     graphs=graphs) for graphs in (True, False)]
    assert torch.equal(seqs[0], seqs[1])


@pytest.mark.cuda
def test_moe_dispatch_gives_the_same_bits_twice(cuda_device):
    """granite-moe-3b-a800m's layer widths (D 1536, 40 experts, top 8,
    expert d_ff 512) at a capacity that drops entries: two runs of the
    forward and of its gradients (x, the router and the three expert
    weights) give the same bits."""
    from repro_torch.models.transformer import moe_ffn
    g = torch.Generator(device=cuda_device).manual_seed(0)
    D, E, F = 1536, 40, 512
    r = lambda *s, std=0.02: (torch.randn(s, generator=g, device=cuda_device)
                              * std).to(torch.bfloat16)
    x = r(2, 256, D, std=1.0)
    w = [r(D, E), r(E, D, F), r(E, D, F), r(E, F, D)]
    runs = []
    for _ in range(2):
        xi = x.detach().requires_grad_()
        wi = [t.detach().requires_grad_() for t in w]
        out = moe_ffn(xi, *wi, top_k=8, act="silu", capacity_factor=0.5)
        out.float().square().sum().backward()
        runs.append([out.detach(), xi.grad] + [t.grad for t in wi])
    for a, b in zip(*runs):
        assert torch.equal(a, b)
    assert (runs[0][0].abs().sum(-1) == 0).any()      # entries dropped


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["rwkv6-1.6b", "whisper-tiny"])
def test_rwkv_and_whisper_on_card_match_cpu(cuda_device, arch):
    """The reduced RWKV6 and Whisper (its batch with 32 stub frames) on the
    card vs the port on the CPU, the same parameters: prefill logits and
    12 decode steps within 5e-2 (bf16, the reference's backend
    tolerance); ``train_loss`` within ``rtol=1e-3`` and every gradient
    leaf within 5e-2 relative L2; none of the port's kernels launched."""
    from repro_torch.configs import get_reduced
    from repro_torch.configs.base import ShapeCell
    from repro_torch.data.tokens import batch_for_step
    from repro_torch.kernels import selective_scan as scan
    from repro_torch.models import lm
    from repro_torch.optim.adamw import tree_leaves, tree_map
    cfg = get_reduced(arch)
    cpu = lm.init_params(cfg, generator=torch.Generator().manual_seed(3),
                         device="cpu")
    card = _to(cpu, cuda_device)
    batch = {k: torch.as_tensor(v) for k, v in batch_for_step(
        cfg, 2, 32, 0, seed=1).items()}
    on = lambda dev: {k: v.to(dev) for k, v in batch.items()}
    counts = lambda: (ops.launch_count(), sddmm_ops.launch_count(),
                      sddmm_ops.launch_count("sddmm"), scan.launch_count())
    before = counts()
    got = lm.prefill(card, cfg, on(cuda_device), chunk=16)
    want = lm.prefill(cpu, cfg, batch, chunk=16)
    m = want > -1e30
    torch.testing.assert_close(got.cpu()[m], want[m], atol=5e-2, rtol=5e-2)
    out = {}
    for dev, params in (("cpu", cpu), ("card", card)):
        p = tree_map(lambda t: t.detach().requires_grad_(), params)
        loss = lm.train_loss(p, cfg, on(p["embed"].device), chunk=16)
        loss.backward()
        out[dev] = (float(loss.detach()), [t.grad for t in tree_leaves(p)])
    np.testing.assert_allclose(out["card"][0], out["cpu"][0], rtol=1e-3)
    for a, b in zip(out["card"][1], out["cpu"][1]):
        assert _rel_l2(a, b) <= 5e-2
    cache = {d: lm.init_cache(cfg, ShapeCell("d", 12, 2, "decode"),
                              device=d) for d in ("cpu", cuda_device)}
    tokens = batch["tokens"]
    for t in range(12):
        lc, cache["cpu"] = lm.decode_step(cpu, cfg, tokens[:, t:t + 1],
                                          cache["cpu"], t)
        lg, cache[cuda_device] = lm.decode_step(
            card, cfg, tokens[:, t:t + 1].to(cuda_device),
            cache[cuda_device], t)
        torch.testing.assert_close(lg.cpu()[m], lc[m], atol=5e-2,
                                   rtol=5e-2)
    torch.cuda.synchronize()
    assert counts() == before


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["rwkv6-1.6b", "whisper-tiny"])
def test_captured_rwkv_and_whisper_decode_equals_eager(cuda_device, arch):
    """RWKV6's state step and Whisper's cached step captured once and
    replayed: the eager step's logits and caches bit for bit over 12
    positions, and ``generate`` the same tokens with and without
    graphs."""
    from repro_torch.configs import get_reduced
    from repro_torch.configs.base import ShapeCell
    from repro_torch.kernels.capture import capture
    from repro_torch.launch.serve import generate
    from repro_torch.models import lm
    cfg = get_reduced(arch)
    g = torch.Generator().manual_seed(2)
    params = _to(lm.init_params(cfg, generator=g, device="cpu"),
                 cuda_device)
    tokens = torch.randint(0, cfg.vocab, (2, 12), generator=g).to(
        cuda_device)
    caches = [lm.init_cache(cfg, ShapeCell("d", 12, 2, "decode"),
                            device=cuda_device) for _ in "ab"]
    if arch == "whisper-tiny":        # a live cross-attention cache
        for name in ("xk", "xv"):
            caches[0][name].normal_(generator=torch.Generator(
                device=cuda_device).manual_seed(5))
            caches[1][name].copy_(caches[0][name])
    static_tok = tokens[:, :1].clone()
    static_pos = torch.zeros((), dtype=torch.int64, device=cuda_device)
    step = lambda: lm.decode_step(params, cfg, static_tok, caches[1],
                                  static_pos)[0]
    captured = None
    with torch.no_grad():
        for t in range(12):
            want, _ = lm.decode_step(params, cfg, tokens[:, t:t + 1],
                                     caches[0], t)
            static_tok.copy_(tokens[:, t:t + 1])
            static_pos.fill_(t)
            if captured is None:
                got, captured = capture(step, cuda_device)
            else:
                got = captured.replay()
            assert torch.equal(got, want), f"step {t}"
    torch.cuda.synchronize()
    for name in caches[0]:
        assert torch.equal(caches[0][name], caches[1][name]), name
    prompt = tokens[:, :4].cpu().numpy()
    seqs = [generate(cfg, params, prompt, 12, 8, device=cuda_device,
                     graphs=graphs) for graphs in (True, False)]
    assert torch.equal(seqs[0], seqs[1])


@pytest.mark.cuda
@pytest.mark.parametrize("cfg", CONFIGS[::3], ids=lambda c: str(c.astuple()))
@pytest.mark.parametrize("H, dv", [(4, 256), (6, 121)])
def test_gat_kernels_at_the_published_gat_widths(cuda_device, cfg, H, dv):
    """The published GAT's widths (PPI: 4 heads of 256, 6 of 121, the
    last at vector width 1).  The SDDMM → softmax stats on the 2-wide
    operands [el, 1] and [1, er] at scale 1 gives LeakyReLU(el_i + er_j)
    bit for bit, as its plain version and a plain add do; the prologue
    SpMM and the raw SDDMM (dα) at ``dv`` against their plain versions
    (``rtol=1e-5``, ``atol=1e-4`` / ``1e-5``, as above); the slot pass at
    scale 1 bit for bit; dQ and dK at width 2 against the plain SpMM; and
    the whole message's gradients on the card against the CPU's."""
    p = _pack(cfg, False, explicit_zeros=True)
    p_t = transpose_pcsr(p)
    steer = ops.device_steering(p, cuda_device)
    t = engine.TransposeSide.build(p, p_t, cuda_device)
    g = torch.Generator(device=cuda_device).manual_seed(H)
    el, er = (torch.randn((H, 90), generator=g, device=cuda_device) * 4
              for _ in range(2))
    one = torch.ones_like(el)
    Q, K = torch.stack([el, one], -1), torch.stack([one, er], -1)
    Vf, dOut = (torch.randn((H, 90, dv), generator=g, device=cuda_device)
                for _ in range(2))
    geo = dict(n_blocks=p.n_blocks, R=cfg.R, V=cfg.V, K=p.K, n_rows=90)
    logits, rm, rs = sddmm_ops._stats_call(steer, Q, K, scale=1.0, **geo)
    w_logits, w_rm, w_rs = sddmm_ops.sddmm_softmax_plain(
        steer, Q, K, scale=1.0, slope=0.2, **geo)
    assert torch.equal(logits.view(torch.int32), w_logits.view(torch.int32))
    real = steer.vals != 0
    C = steer.trow.shape[0]
    row = (steer.trow.long()[:, None, None] * cfg.R
           + steer.lrow.long().reshape(C, 1, p.K) * cfg.V
           + torch.arange(cfg.V, device=cuda_device)[None, :, None])
    col = steer.colidx.long().reshape(C, 1, p.K).expand_as(row)
    e = el[:, row[real]] + er[:, col[real]]
    assert torch.equal(logits[:, real], torch.where(e >= 0, e, 0.2 * e))
    torch.testing.assert_close(rm, w_rm, rtol=1e-5, atol=1e-6)
    torch.testing.assert_close(rs, w_rs, rtol=1e-5, atol=1e-6)

    assert ops.vector_width(dv, Vf) == (4 if dv % 4 == 0 else 1)
    out = ops._call(steer, Vf, vals=logits, rowmax=rm, rowsum=rs,
                    dblk=cfg.dblk, **geo)
    want = ops.paramspmm_plain(steer, Vf, V=cfg.V, R=cfg.R, K=p.K,
                               n_blocks=p.n_blocks, n_rows=90, vals=logits,
                               rowmax=rm, rowsum=rs)
    torch.testing.assert_close(out, want, rtol=1e-5, atol=1e-4)
    dalpha = sddmm_ops._call(steer, dOut, Vf, **geo)
    torch.testing.assert_close(
        dalpha, sddmm_ops.sddmm_plain(steer, dOut, Vf, V=cfg.V, R=cfg.R,
                                      K=p.K, n_rows=90),
        rtol=1e-5, atol=1e-5)

    rowdot = engine._row_dot(dOut, out, p.n_blocks * cfg.R)
    kw = dict(R=cfg.R, V=cfg.V, K=p.K, t_shape=t.shape, scale=1.0,
              slope=0.2, rowdot=rowdot)
    want = sddmm_ops.gat_backward_plain(steer, t.src, logits, rm, rs,
                                        dalpha=dalpha, **kw)
    got = sddmm_ops.gat_backward(steer, t.src, logits, rm, rs,
                                 dalpha=dalpha.clone(), **kw)
    for a, b in zip(got, want):
        assert torch.equal(a.view(torch.int32), b.view(torch.int32))
    de, de_t = got[0], got[1]
    for s, B, vals, gm in ((steer, K, de, geo),
                           (t.steer, Q, de_t, t.geo)):
        dq = ops._call(s, B, vals=vals, **dict(gm, dblk=gm.get(
            "dblk", cfg.dblk)))
        torch.testing.assert_close(
            dq, ops.paramspmm_plain(s, B, V=gm["V"], R=gm["R"], K=gm["K"],
                                    n_blocks=gm["n_blocks"],
                                    n_rows=gm["n_rows"], vals=vals),
            rtol=1e-5, atol=1e-4)

    f = engine.make_gat_message_fn(p, p_t, scale=1.0)
    cpu = [x.cpu() for x in (Q, K, Vf)]
    want = _grads(lambda q, k, v: f(q, k, v), cpu, dOut.cpu())
    got = _grads(lambda q, k, v: f(q, k, v), [x.clone() for x in (Q, K, Vf)],
                 dOut)
    _assert_close(got, want, False)
