"""The blocked dense matmul family (kernel B6)."""
