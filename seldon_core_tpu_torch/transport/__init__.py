"""Transports of the port: the standard-library REST server, the gRPC
component server and the CLI."""
