"""The port's model modules (counterparts of ``hmmc_tpu/models``)."""
