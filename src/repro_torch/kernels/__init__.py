# Hand-written CUDA kernels (csrc/) for the paper's compute hot-spots:
#   sierpinski_write -- the paper's SS IV microbenchmark (lambda vs BB grid):
#                       write and sum over the member cells
#   sierpinski_ca    -- temporally fused CA / diffusion stepping over the
#                       fractal (embedded or compact orthotope storage)
# Each kernel module holds its plain PyTorch version and CUDA wrapper; the
# oracles are in ref.py and the public entry points are re-exported via
# ops.py.  Importing builds nothing: kernels are compiled at first launch.
from . import ref
from .ops import (ca_run, ca_step, launch_schedule, sierpinski_sum,
                  sierpinski_write, sierpinski_write_)
