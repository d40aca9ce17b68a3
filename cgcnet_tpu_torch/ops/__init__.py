"""Device ops: the BSR kernels (B1, B2), the fused assign head (B4) and its
training tail (B3 statistics, B5 backward), and the host-side NumPy graph
builders."""
