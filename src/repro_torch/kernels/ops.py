"""Public entry points of the port's kernels.

Each follows its state's device: a CUDA tensor launches the hand-written
kernel, a CPU tensor runs the plain version beside it.  The kernels
live in their own modules with their oracles in ``ref.py``.
"""
from .flash_attention import flash_attention, paged_flash_attention
from .sierpinski_ca import ca_run, ca_step, launch_schedule
from .sierpinski_write import (sierpinski_sum, sierpinski_write,
                               sierpinski_write_)

__all__ = ["ca_run", "ca_step", "flash_attention", "launch_schedule",
           "paged_flash_attention", "sierpinski_sum", "sierpinski_write",
           "sierpinski_write_"]
