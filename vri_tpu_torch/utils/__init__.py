"""Host utilities of the port (copies of ``vri_tpu/utils``)."""
