###############################################################################
# rho csv helpers (a copy of mpisppy_tpu/utils/rho_utils.py, numpy only;
# ref:mpisppy/utils/rho_utils.py:1-44): an "ID,rho" header, then rows of
# "slot,value" (the reference keys by variable name; here the nonant
# slot is the variable's identity).  Both packages read each other's
# files.
###############################################################################
from __future__ import annotations

import numpy as np


def rhos_to_csv(rho: np.ndarray, fname: str):
    with open(fname, "w") as f:
        f.write("ID,rho\n")
        for i, v in enumerate(np.asarray(rho)):
            f.write(f"{i},{float(v)!r}\n")


def rhos_from_csv(fname: str, num_nonants: int) -> np.ndarray:
    rho = np.ones(num_nonants)
    with open(fname) as f:
        header = f.readline()
        if "rho" not in header:
            raise ValueError(f"{fname}: missing 'ID,rho' header")
        for lineno, line in enumerate(f, start=2):
            line = line.strip()
            if not line:
                continue
            try:
                i_str, v_str = line.split(",")
                i, v = int(i_str), float(v_str)
            except ValueError as e:
                raise ValueError(
                    f"{fname}:{lineno}: expected 'ID,rho', got "
                    f"{line!r}") from e
            if not 0 <= i < num_nonants:
                raise ValueError(
                    f"{fname}:{lineno}: slot {i} out of range "
                    f"[0, {num_nonants})")
            rho[i] = v
    return rho
