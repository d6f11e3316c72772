"""Training substrate. So far only checkpointing (:mod:`repro_torch.train.checkpoint`)."""
