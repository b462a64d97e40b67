"""RWKV-6 WKV recurrence: CUDA kernel (`wkv`), its plain torch versions
(`ref`) and the device dispatch (`ops`)."""
