"""Device compute on PyTorch: distance/top-k over resident matrices, the
int8 and int4 quantized rungs, and the wrappers of the bf16, int8 and int4
bucket-scores kernels and of the selection kernel (port of
:mod:`helix_tpu.ops`)."""
