"""Training: the loss, the train step with remat and microbatches,
evaluation and the fault-tolerant ``Trainer``."""
