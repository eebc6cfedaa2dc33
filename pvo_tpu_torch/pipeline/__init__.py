"""VO<->VPS pipeline glue of the port: tracking, matching, PQ/VPQ
evaluation (the port's own copies of :mod:`pvo_tpu.pipeline`)."""
