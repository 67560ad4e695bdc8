"""Text-side sample processing: tokenize, add CLS/SEP, truncate, pad (a
copy of ``hmmc_tpu/data/text.py``).

Reproduces ``_get_text`` (dataloader_msrvtt_retrieval.py:263-288 /
dataloader_bird.py:143-166): ``[CLS] + tokens`` truncated to
``max_words - 1``, then ``[SEP]``, zero-padded to ``max_words``. English
specials are CLIP's ``<|startoftext|>/<|endoftext|>``; Chinese uses BERT's
``[CLS]/[SEP]``. Padding id is 0 in both schemes (which keeps CLIP's
argmax-EOT pooling valid — module_clip.py:482).
"""

from __future__ import annotations

from typing import Tuple

import numpy as np

EN_SPECIALS = {"cls": "<|startoftext|>", "sep": "<|endoftext|>"}
ZH_SPECIALS = {"cls": "[CLS]", "sep": "[SEP]"}


def encode_text(
    tokenizer,
    text: str,
    max_words: int,
    language: str = "english",
) -> Tuple[np.ndarray, np.ndarray]:
    """-> (input_ids [max_words] int32, mask [max_words] int32)."""
    specials = EN_SPECIALS if language == "english" else ZH_SPECIALS
    words = tokenizer.tokenize(text)
    words = [specials["cls"]] + words
    if len(words) > max_words - 1:
        words = words[:max_words - 1]
    words = words + [specials["sep"]]
    ids = tokenizer.convert_tokens_to_ids(words)
    mask = [1] * len(ids)
    while len(ids) < max_words:
        ids.append(0)
        mask.append(0)
    return (np.asarray(ids, np.int32), np.asarray(mask, np.int32))
