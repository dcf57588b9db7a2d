"""Public entry points of the port's kernels.

Each follows its state's device: a CUDA tensor launches the hand-written
kernel, a CPU tensor runs the plain version beside it.  The kernels
live in their own modules with their oracles in ``ref.py``.
"""
from .sierpinski_write import (sierpinski_sum, sierpinski_write,
                               sierpinski_write_)

__all__ = ["sierpinski_sum", "sierpinski_write", "sierpinski_write_"]
