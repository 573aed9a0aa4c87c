"""txr_torch: the txr ray tracer in PyTorch, with its kernels in CUDA for Hopper.

Module names mirror the JAX package ``txr`` so each module's counterpart is
easy to find.  Entry points (``render``, ``trace``, ``step_probe``) run on
``cuda`` unless the caller passes ``device="cpu"``; on the CPU the probe
kernel's plain PyTorch twin stands in for the kernel.
"""

import torch


def resolve_device(device=None):
    """The device an entry point runs on: ``cuda`` unless the caller names
    another.  Raises when CUDA is asked for (or implied) but absent — the
    port never carries on quietly on the CPU."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type != "cuda":
        return dev
    if not torch.cuda.is_available():
        raise RuntimeError(
            "txr_torch: CUDA is not available; pass device='cpu' to run the "
            "plain PyTorch path on the CPU")
    # "cuda" names the current card, so it compares equal to a tensor's device
    return dev if dev.index is not None else torch.device("cuda", torch.cuda.current_device())
