"""Device ms a step in dense matmul kernels (cuBLAS and CUTLASS GEMMs and
their split-K reductions, by kernel name) over the profiled steps: the
additive GAT's ``H·W`` forward, dW and dX at 1,024 wide."""
import re

from perfbench import work

GEMM = re.compile(r"gemm|cutlass|splitKreduce", re.IGNORECASE)


def is_gemm(name: str) -> bool:
    return work.kernel_family(name) == "other" and bool(GEMM.search(name))


def read(ctx):
    if ctx.prof is None or not ctx.prof.ops:
        return None
    s = sum(d for name, _, d in ctx.prof.ops if is_gemm(name))
    return s / ctx.prof.steps * 1e3 if s > 0 else None
