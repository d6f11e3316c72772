"""Training substrate: AdamW (:mod:`repro_torch.train.optimizer`), the train
step and its loss (:mod:`repro_torch.train.train_step`) and checkpointing
(:mod:`repro_torch.train.checkpoint`)."""
