"""Run utilities (counterpart of ``hmmc_tpu/utils``): :mod:`.preemption`."""
