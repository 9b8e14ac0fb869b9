"""Serving runtime of the port: the continuous batcher."""
