"""Hand-written CUDA kernels for the (K, D) planes of the round (the two
sweeps, the host path's aircomp_sum, the cosine partials), their plain-torch
twins, the oracles, and the device dispatch (ops)."""
