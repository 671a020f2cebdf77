"""Core library of the port: the chip the tuner models (`hardware`), the
eq. 2 tiling law (`tiling`), the machine models and the flash kernel's
block-skip law (`cost_model`), the row-balancing law (`loadbalance`),
the design-space exploration (`dse`) and atomic writes (`ioutil`).
Counterpart of `repro.core`.
"""
