"""hmmc_tpu_torch: the PyTorch + CUDA port of hmmc_tpu for NVIDIA Hopper.

It mirrors ``hmmc_tpu``'s module layout and names, imports ``torch`` and
numpy only, and keeps its own copy of what it needs from ``hmmc_tpu``.
Entry points (:func:`hmmc_tpu_torch.factory.build_model`,
:class:`hmmc_tpu_torch.evaluation.Evaluator`,
:func:`hmmc_tpu_torch.runner.run_finetune`) run on CUDA unless the caller
passes ``device="cpu"``.
"""

from hmmc_tpu_torch.config import ClipArch, CrossConfig, TaskConfig

__all__ = ["ClipArch", "CrossConfig", "TaskConfig"]
