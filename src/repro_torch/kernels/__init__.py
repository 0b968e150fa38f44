"""Hand-written CUDA kernels: the (K, D) planes of the round (the two
sweeps, the host path's aircomp_sum, the cosine partials), the compressed
cohort's gather_superpose, the Mamba2 SSD intra-chunk part and
sliding-window attention; their plain-torch twins, the oracles, and the
device dispatch (ops)."""
