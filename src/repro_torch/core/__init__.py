# The paper's primary contribution: the block-space fractal map lambda(w)
# and its generalization to block-structured sparse compute domains,
# plus the GridPlan that binds a domain to a closed-form, lookup-table or
# bounding-box launch, and the compact orthotope storage of Lemma 2.
from . import backend, compact, domain, fractal, memo, plan
from .backend import CPU, CUDA, BackendTarget
from .compact import (NEIGHBOR_OFFSETS, NEIGHBOR_OFFSETS8, CompactLayout,
                      SuperTiling, cell_neighbor_tables, compact_layout,
                      super_tiling)
from .domain import (BandDomain, BlockDomain, BoundingBoxDomain,
                     GeneralizedFractalDomain, SierpinskiDomain,
                     TriangularDomain, make_attention_domain,
                     make_fractal_domain)
from .fractal import (CARPET, FRACTALS, HAUSDORFF, SIERPINSKI, VICSEK,
                      FractalSpec, all_block_coords, deinterleave_linear,
                      gasket_volume, is_member, lambda_inverse, lambda_map,
                      lambda_map_linear, membership_grid, orthotope_shape,
                      pack_to_orthotope, scale_level, unpack_from_orthotope)
from .plan import (LOWERINGS, STORAGES, GridPlan, LaunchParams,
                   normalize_lowering, normalize_storage,
                   registered_domains)
