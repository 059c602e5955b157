"""Checkpoints of training state, readable by the reference's reader."""
