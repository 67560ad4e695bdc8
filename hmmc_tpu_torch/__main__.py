"""``python -m hmmc_tpu_torch [flags]``: the port's fine-tune / eval /
extract / params CLI (flags as ``hmmc_tpu_torch.cli.get_args``); runs on
the current CUDA device."""

from hmmc_tpu_torch import cli, runner

if __name__ == "__main__":
    runner.main(cli.get_args())
