"""RG-LRU linear recurrence: CUDA kernel (`rglru`), its plain torch version
(`ref`) and the device dispatch (`ops`)."""
