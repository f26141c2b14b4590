"""Morpheus on PyTorch: the serving data plane ported to CUDA.

A port of the JAX package ``repro`` (which stays the reference) to
PyTorch on one NVIDIA H100.  Module paths mirror the reference's
(``repro_torch.core.specialize`` is ``repro.core.specialize``), and the
same numpy tables, params and batches give the same plans and, up to the
stated tolerances, the same outputs.

Entry points place their tensors on ``device="cuda"`` unless the caller
passes another device; asking for the card where there is none raises.

TF32 is switched off for the whole process on import: a one-hot matmul
lookup (``onehot`` / ``inline_const`` sites) must equal a gather bit for
bit, which TF32's 10-bit mantissa breaks.
"""
import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False


def resolve_device(device="cuda") -> torch.device:
    """``device`` as a :class:`torch.device`; raises when it names the
    card and there is none (nothing falls back to the CPU silently)."""
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                f"device {str(dev)!r} requested but CUDA is not available;"
                f" pass device='cpu' to run on the host")
        if dev.index is None:       # compare equal to tensors' devices
            dev = torch.device("cuda", torch.cuda.current_device())
    return dev
