// build_rows, VARIANT 3 of tools/ab/build_rows_variants.cuh (its header says
// how to run it)
#define VARIANT 3
#include "build_rows_variants.cuh"
