"""Roofline analysis for the H100: the kernels' launch plans, their cost
models and the bounds of each kernel seam."""
