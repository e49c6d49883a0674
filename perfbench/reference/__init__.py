"""The plain fp32 reference the benchmark judges the program by: ViT and
BERT towers, the CLIP loss, AdamW, the text dropout's keep masks, a BERT
tokenizer over the vocabulary file and the eval image transform, in plain
PyTorch and NumPy. It imports nothing of the program and takes nothing
the program made: the benchmark hands it the seed's weights and inputs.

Every entry point calls :func:`precise` first: on the card an fp32
product may otherwise run in TF32.
"""

import torch


def precise() -> None:
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
