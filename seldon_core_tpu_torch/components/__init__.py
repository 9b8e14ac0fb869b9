"""Component contract of the port."""
