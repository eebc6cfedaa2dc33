"""Utilities of the port (weight conversion)."""
