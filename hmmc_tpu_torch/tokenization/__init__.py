from hmmc_tpu_torch.tokenization.clip_bpe import ClipTokenizer

__all__ = ["ClipTokenizer"]
