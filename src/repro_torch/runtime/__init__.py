"""Runtimes of the port: ``serve.ServeEngine`` (continuous batching over
slots on one device) and ``fault`` (online fault detection for the
closed-loop co-sim: ``SimFaultSupervisor``)."""
