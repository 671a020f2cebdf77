"""The ELL SpMV family (kernels B7 and B8)."""
