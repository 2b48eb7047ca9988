"""Where an entry point of the port runs.

Every entry point (``variational_optical_flow``, ``profile_solve_phases``,
``parallel.mesh.make_mesh``, ``parallel.batch.sharded_variational_solve``,
``parallel.distributed.distributed_variational_solve``) runs on the card
unless its caller passes ``device='cpu'``: ``device=None`` is
``torch.device('cuda')`` whatever its input is, an array or a tensor on
any device.  Without CUDA that raises; nothing falls back to the CPU.
"""

from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """``device`` as a ``torch.device``; ``None`` is the CUDA device, which
    must exist."""
    device = torch.device("cuda" if device is None else device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device: the port runs on the card unless asked for the CPU (device='cpu')")
    return device
