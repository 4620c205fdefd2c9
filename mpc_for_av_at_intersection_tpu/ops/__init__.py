"""Hand-written GPU kernels (Pallas through Triton); see ops/admm_triton.py."""
