"""Optimiser of the port: ``adamw`` (AdamW with float32 moments, schedules,
global-norm clipping) and ``compress`` (int8 gradient quantisation)."""
