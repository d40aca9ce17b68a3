"""Device ops: the BSR kernels (B1, B2), the fused assign head (B4), and the
host-side NumPy graph builders."""
