# Hand-written CUDA kernels (csrc/) for the paper's compute hot-spots:
#   sierpinski_write -- the paper's SS IV microbenchmark (lambda vs BB grid):
#                       write and sum over the member cells
#   sierpinski_ca    -- temporally fused CA / diffusion stepping over the
#                       fractal (embedded or compact orthotope storage)
#   flash_attention  -- block-space flash attention (causal / local / full
#                       domains) and the paged single-token decode
# Each kernel module holds its plain PyTorch version and CUDA wrapper; the
# oracles are in ref.py and the public entry points are re-exported via
# ops.py.  Importing builds nothing: kernels are compiled at first launch.
from . import ref
from .ops import (ca_run, ca_step, flash_attention, launch_schedule,
                  paged_flash_attention, sierpinski_sum, sierpinski_write,
                  sierpinski_write_)
