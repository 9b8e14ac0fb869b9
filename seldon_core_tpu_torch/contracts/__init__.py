"""Payload contract of the port (the subset the LLM REST surface uses)."""
