"""Host-side post-processing: spline refitting, ARAP, meshing, trimming, I/O.

Equivalent of the reference's eval-time optimization stack
(src/primitive_forward.py:105-344 optimize_{open,close}_spline[_kronecker],
src/fitting_utils.py:109-237 upsampling, :646-691 bit-mapping trim,
:276-303 tessellation, src/VisUtils.py mesh I/O). The reference leans on
geomdl + Open3D + lapsolver; here the numerical core is numpy + the native
C++ components (LAP, ARAP, outlier removal) in parsenet_tpu_torch.cpp, and
mesh I/O is a dependency-free PLY writer. Counterpart of
parsenet_tpu/postprocess/, of which it is a numpy copy.
"""
from .splines import optimize_spline_kronecker, up_sample_points_in_range
from .meshing import tessellate_grid, trim_mesh_by_distance, write_ply
