"""Measurement tools of the port: the bench scene, the z-buffer probe and
the colorize anatomy (counterparts of `pointcloudprocessor_tpu/tools/`)."""
