"""Training steps of the port (one device)."""
