"""PyTorch / CUDA port of the zero-stall serving stack for NVIDIA Hopper.

Mirrors the layout of the JAX package ``repro`` (configs, plan, kernels,
models, serve, launch) and runs its dense-decoder serving path on an
H100 through two hand-written CUDA kernels: the N-slot revolving-buffer
matmul (``kernels.zero_stall_matmul``) and masked flash attention
(``kernels.flash_attention``).  Importing this package imports neither
JAX nor anything of ``repro``.
"""

import torch

__all__ = ["resolve_device", "make_generator"]


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on.

    ``None`` means the card: it raises when no CUDA device is present
    instead of falling back to the CPU.  Pass ``device="cpu"`` to run the
    plain PyTorch versions of the kernels on the host.
    """
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "repro_torch entry points run on CUDA by default and no CUDA "
                "device is available; pass device='cpu' to run on the host")
        return torch.device("cuda")
    return torch.device(device)


def make_generator(device: torch.device, seed: int) -> torch.Generator:
    """A generator seeded with ``seed`` for drawing parameters on
    ``device``; the meta device (shapes only, as
    :func:`repro_torch.plan.trace_model` traces) takes a CPU generator,
    which its random ops accept and never advance."""
    g = torch.Generator(device="cpu" if device.type == "meta" else device)
    g.manual_seed(seed)
    return g
