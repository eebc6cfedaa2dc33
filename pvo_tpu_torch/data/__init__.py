"""Datasets of the port (its own copies of :mod:`pvo_tpu.data`)."""
