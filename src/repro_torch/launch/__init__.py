"""Launchers: the smoke mesh and the drivers (``cluster``: the paper's own
workload; ``serve``: the LM server and, with ``--task clusters``, the
long-lived service and the batched predictor; ``train``: LM training)."""
