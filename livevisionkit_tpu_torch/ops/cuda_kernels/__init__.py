"""Hand-written Hopper kernels: nvcc build, ctypes bindings and launch wrappers."""
