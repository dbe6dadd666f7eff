// build_rows, VARIANT 2 of tools/ab/build_rows_variants.cuh (its header says
// how to run it)
#define VARIANT 2
#include "build_rows_variants.cuh"
