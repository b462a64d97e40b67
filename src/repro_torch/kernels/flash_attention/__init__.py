"""Flash attention forward: CUDA kernel (`flash_attention`), its plain
torch version (`ref`) and the device dispatch (`ops`)."""
