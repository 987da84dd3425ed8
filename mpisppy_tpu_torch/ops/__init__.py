# Solver kernels of the port: the BoxQP form, the restarted PDHG solver
# and its hand-written CUDA restart-window kernel.
