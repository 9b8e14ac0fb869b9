"""Prepackaged servers of the port."""
