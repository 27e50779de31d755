"""Device resolution for the port's entry points.

Entry points take ``device="cuda"`` by default and never fall back to the
CPU on their own: without a card they raise, and they run on the CPU only
when the caller passes ``device="cpu"`` (the tests do).
"""

from __future__ import annotations

import torch


def resolve_device(device: str | torch.device = "cuda") -> torch.device:
    """Return ``torch.device(device)``, raising if CUDA is asked for but absent.

    Resolving a CUDA device also pins the float32 math of the card: TF32 is
    switched OFF for both cuDNN convolutions
    (``torch.backends.cudnn.allow_tf32``, PyTorch's default is on) and
    matmuls (``torch.backends.cuda.matmul.allow_tf32``). The backbone's
    speed comes from its bf16 autocast (``ModelConfig.compute_dtype``); the
    float32 parts (class head, projector, and a float32 config as a whole)
    then compute in full float32, as on the CPU and in the JAX reference.
    """
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "device='cuda' requested but torch.cuda.is_available() is "
                "False; pass device='cpu' to run on the CPU")
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {device!r}: use 'cuda' or 'cpu'")
    return dev
