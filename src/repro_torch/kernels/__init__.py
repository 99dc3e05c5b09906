"""Hand-written Hopper kernels of the port, with their plain versions."""
