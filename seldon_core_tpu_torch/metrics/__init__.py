"""Metrics of the port: the Prometheus series the component app exposes."""
