"""Data parallelism over ranks (counterpart of ``hmmc_tpu/parallel``):
:mod:`.distributed`."""
