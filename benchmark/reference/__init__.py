"""The plain reference: the configurations' generators (an encoder piece
and a decoder piece each, found by name), the output codec and the
flagship's training step, in plain PyTorch.

It imports nothing of the program (``mipheivit_tpu_torch``) and neither
``jax`` nor the JAX package. It takes the seeded weights by the program's
tensor names (``weights.seeded_dict`` over ``models.param_shapes``), and
works out the LoRA merge, the casts and everything the program derives from
them again. Matrix products run in f32 with TF32 off (``strict_f32``).
"""

import torch


def strict_f32() -> None:
    """f32 products without TF32 on the card (a lower precision)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
