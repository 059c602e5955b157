"""Fault tolerance for training fleets (``fault_tolerance``); the sharded
model path is still to port."""
