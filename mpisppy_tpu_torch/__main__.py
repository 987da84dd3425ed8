# `python -m mpisppy_tpu_torch ...` == the generic_cylinders driver
# (ref:mpisppy/generic_cylinders.py run as a script).
from mpisppy_tpu_torch.generic_cylinders import main

main()
