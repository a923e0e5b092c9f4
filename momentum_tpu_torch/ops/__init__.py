"""Hand-written CUDA kernels of the port and their plain PyTorch versions.

Each wrapper takes its plain version for a CPU tensor and launches its kernel
for a CUDA tensor (or raises); `launches` in each module counts the kernel
launches, so a run can show that it went through the kernel.

    fk.fk_global          K1 fk_global_kernel        csrc/fk.cu
    psd.damped_chol_solve K2+K3 damped_chol_solve_kernel  csrc/psd.cu
    raster.rasterize_planes  K4a raster_planes_kernel, K4b raster_planes_binned_kernel
                                                     csrc/raster.cu
"""
