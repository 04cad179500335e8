from .ncurve import boundary_and_diffusion_reads, diffusion_single_pass

__all__ = [
    "boundary_and_diffusion_reads",
    "diffusion_single_pass",
]
