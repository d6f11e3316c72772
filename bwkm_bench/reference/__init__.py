"""The plain reference that decides ``correct``.

Plain PyTorch, in float64 where it sums or measures, on the tensors the
benchmark made itself. It imports nothing of the port and takes nothing the
port made except the outputs it judges (labels, distances, statistics,
centroids, a partition's memberships and boxes) and, where it follows the
port step by step, the port's state at the start of the step.
"""
