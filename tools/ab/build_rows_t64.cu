// build_rows, VARIANT 1 of tools/ab/build_rows_variants.cuh (its header says
// how to run it)
#define VARIANT 1
#include "build_rows_variants.cuh"
