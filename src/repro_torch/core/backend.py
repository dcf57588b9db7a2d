"""Kernel targets of the port: the ``BackendTarget`` descriptor.

Two targets exist:

``cuda``
    Hand-written CUDA C++ kernels for Hopper (``sm_90a``), built with
    ``nvcc`` at first use and launched on PyTorch's current stream.

``cpu``
    The plain PyTorch version beside each kernel: the same decode, tile
    order and masks as tensor index math.  Taken only for tensors that
    lie on the CPU (the tests); a CUDA tensor never falls back to it.

The target follows the tensor: :func:`resolve` picks it from a tensor's
device.  Functions that create tensors themselves default to the card
(``resolve(None)`` is ``cuda``) and fail when there is none.
"""
from __future__ import annotations

import dataclasses

import torch


@dataclasses.dataclass(frozen=True)
class BackendTarget:
    """Capability descriptor for one kernel target.

    name:       "cuda" or "cpu", the ``torch.device`` type it serves.
    arch:       the compile target of the kernels (``sm_90a``), or None
                where no kernel is compiled.
    kernels:    entry points launch the hand-written kernels (True) or
                run their plain versions (False).
    """

    name: str
    arch: str | None
    kernels: bool


CUDA = BackendTarget("cuda", "sm_90a", True)
CPU = BackendTarget("cpu", None, False)

TARGETS = {t.name: t for t in (CUDA, CPU)}


def resolve(spec=None) -> BackendTarget:
    """Normalize a target spec to a :class:`BackendTarget`.

    spec: a target, a tensor (its device decides), a ``torch.device``,
    a device string ("cuda", "cuda:1", "cpu"), or None (the card).
    Any other device type raises: there is no kernel for it and no
    silent fallback.
    """
    if isinstance(spec, BackendTarget):
        return spec
    if isinstance(spec, torch.Tensor):
        spec = spec.device
    if spec is None:
        spec = "cuda"
    kind = torch.device(spec).type
    if kind not in TARGETS:
        raise ValueError(
            f"no kernel target for device type {kind!r}; expected one "
            f"of {tuple(TARGETS)}")
    return TARGETS[kind]


def default_device(device=None) -> torch.device:
    """The device a tensor-creating helper uses: the caller's choice,
    else the card.  Raises when the card is asked for and absent."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device available; pass device='cpu' to run the "
            "plain versions on the CPU")
    return dev
