"""The hinge-SDCA local solve as a Hopper kernel (CUDA C++, sm_90a)."""
from repro_torch.kernels.sdca.ops import draw_coordinates, kernel_local_sdca
from repro_torch.kernels.sdca.ref import sdca_ref
from repro_torch.kernels.sdca.sdca import (COUNTS, reset_counts,
                                           sdca_local_solve)

__all__ = ["COUNTS", "draw_coordinates", "kernel_local_sdca",
           "reset_counts", "sdca_local_solve", "sdca_ref"]
