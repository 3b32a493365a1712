"""Where the port's entry points run."""
from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: CUDA unless the caller names
    another.  Raises when CUDA is asked for (or defaulted to) and not
    available — an entry point never carries on silently on the CPU."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available; pass device='cpu' to run on the CPU")
    return dev


# the JAX package's ``backend`` keyword: its kernels or its plain
# traversal; the port picks by device instead
BACKENDS = ("engine", "pallas")


def check_backend(backend, device=None) -> None:
    """Raise unless ``backend`` is ``None``, ``"pallas"`` (the CUDA kernels
    on the card, their plain versions on the CPU) or ``"engine"`` (the
    plain traversal: the CPU path, refused on a CUDA ``device``)."""
    if backend not in (None,) + BACKENDS:
        raise ValueError(f"backend must be one of {BACKENDS}, got "
                         f"{backend!r}")
    if (device is not None and torch.device(device).type == "cuda"
            and backend == "engine"):
        raise ValueError("backend='engine' is the plain CPU path; the "
                         "card runs the kernels (backend='pallas')")
