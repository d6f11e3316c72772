"""Model zoo: one decoder substrate for the assigned architectures. The port
runs the dense, moe and audio families; ssm, hybrid and vlm come later
(ROADMAP A15)."""
