"""Host-side data helpers of the port (counterparts of ``hmmc_tpu/data``)."""
