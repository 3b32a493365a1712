// A steering's device arrays and sizes as the C entry points of
// paramspmm.cu, sddmm_softmax.cu and sddmm.cu take them: built once per
// pack on the host by kernels/paramspmm/ops.py::SteeringArgs (ctypes, the
// same fields in this order).  Each library exports
// repro_steering_args_size(), which the wrappers check against the ctypes
// struct when they load it.
#pragma once
#include <cuda_runtime.h>

struct SteeringArgs {
  const int* colidx;
  const int* lrow;
  const int* trow;
  const float* vals;    // the stored slot values
  const int4* units;    // begin, end, group, partial (−1: one-unit group)
  const int* splits;    // output block, first partial, end partial
  int n_blocks, n_chunks, n_units, n_splits, n_partials, most, span;
};
