"""Model zoo: one decoder substrate for the assigned architectures (dense,
moe, audio, ssm, hybrid and vlm families)."""
