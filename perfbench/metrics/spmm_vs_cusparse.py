"""cuSPARSE's time over ParamSpMM's for a step's aggregations (over 1:
ParamSpMM is faster, the paper's claim).  ``torch.sparse.mm`` on Â as
CSR, on the original node order, at each of the step's SpMM widths, timed
with CUDA events after the window (Â is symmetric, so the backward's Âᵀ
products are the same products); over the profiler's device time a step
of the ``paramspmm`` family."""
import torch

from perfbench import work

REPS = 20


def _ms(fn, reps=REPS):
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    a.record()
    for _ in range(reps):
        fn()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / reps


def read(ctx):
    if ctx.prof is None or ctx.device.type != "cuda":
        return None
    dev = ctx.prof.seconds_by(work.kernel_family).get("paramspmm", 0.0)
    spmms = [o for o in ctx.ops if o.family == "paramspmm"]
    if dev <= 0 or not spmms or any(o.heads != 1 for o in spmms):
        return None
    gen = torch.Generator(device=ctx.device)
    gen.manual_seed(0)
    by_width = {}
    for w in sorted({o.width for o in spmms}):
        B = torch.randn((ctx.n, w), generator=gen, device=ctx.device)
        by_width[w] = _ms(lambda: torch.sparse.mm(ctx.adj.csr, B))
    cusparse_ms = sum(by_width[o.width] for o in spmms)
    return cusparse_ms / (dev / ctx.prof.steps * 1e3)
