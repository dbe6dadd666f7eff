// breaking_points with every thread walking its 16 steps (no runs from the
// bit planes), for an A/B against the kernel:
//
//   python3 chip_smoke.py --ab breaking_points \
//       tools/ab/breaking_points_walk.cu
#define BP_RUNS_FROM_MASKS 0
#include "../../racon_tpu_torch/ops/kernels/breaking_points.cu"
