"""Device compute on PyTorch: distance/top-k over resident matrices and
the fused bucket-scores kernel (port of :mod:`helix_tpu.ops`)."""
