"""Projective geometry, solvers, BA blocks and frame distance (port of
:mod:`pvo_tpu.geom`)."""
