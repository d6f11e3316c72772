"""Launchers: the smoke mesh and the clustering system's drivers
(``cluster``: the paper's own workload; ``serve --task clusters``: the
long-lived service and the batched predictor)."""
