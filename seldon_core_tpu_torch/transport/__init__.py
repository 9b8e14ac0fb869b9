"""Transports of the port: the standard-library REST server and the CLI."""
