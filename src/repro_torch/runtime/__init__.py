"""Serving runtime of the port: ``serve.ServeEngine`` (continuous batching
over slots on one device)."""
