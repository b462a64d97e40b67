"""BFC switch decision: CUDA kernels (`bfc_step`), their plain torch
versions (`ref`) and the device dispatch (`ops`)."""
