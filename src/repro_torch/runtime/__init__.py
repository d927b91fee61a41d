"""Runtimes of the port: ``serve.ServeEngine`` (continuous batching over
slots on one device), ``train.Trainer`` (the training loop: step, AdamW,
monitor, DFS commits, checkpoints) and ``fault`` (``FaultSupervisor`` for
the trainer; online fault detection for the closed-loop co-sim:
``SimFaultSupervisor``)."""
