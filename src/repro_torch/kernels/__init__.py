"""Hand-written CUDA kernels for the round's two delta-plane sweeps, their
plain-torch twins, the oracles, and the device dispatch (ops)."""
