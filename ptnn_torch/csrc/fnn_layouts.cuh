// The networks the repository bundles, with each FNN kernel's compile-time
// parameter for them, one line each: X(I, H, O, G, HPW).
//
// * G: the drift register kernel's lane-group size (drift_epoch.cu). A row
//   is bound by the instructions one lane issues, so the widest group that
//   leaves one or two hidden units a lane wins on the H100 (Sunspot: G = 16
//   over 8 and 4; Ionosphere: 32 over 16).
// * HPW: the hidden units an eval warp takes at a time (fnn_eval.cu); the
//   eval's launch plan gives a row group ceil(H / HPW) warps.
//
// Each kernel is instantiated for every line and takes its own column.
// ops/drift.py and ops/fnn_eval.py read this table from this file, and each
// library's query (`ptnn_drift_reg_layouts`, `ptnn_eval_layouts`) is checked
// against it when the library loads.
#pragma once

#define FNN_LAYOUTS(X)     \
  X(4, 10, 1, 16, 5)       \
  X(4, 12, 3, 16, 6)       \
  X(9, 12, 2, 16, 4)       \
  X(9, 25, 2, 32, 5)       \
  X(6, 25, 18, 32, 5)      \
  X(8, 30, 29, 32, 5)      \
  X(16, 30, 10, 32, 5)     \
  X(11, 50, 10, 32, 5)     \
  X(34, 50, 2, 32, 5)      \
  X(51, 50, 2, 32, 5)
