"""Video panoptic segmentation of the port: Panoptic FPN with flow-guided
fusion (the port's own copy of :mod:`pvo_tpu.vps` inference)."""
