"""Hand-written CUDA kernels of the port, each beside its plain torch
version: `bfc_step` (the simulator's per-tick switch decision)."""
