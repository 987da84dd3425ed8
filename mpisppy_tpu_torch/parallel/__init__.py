# parallel subpackage of mpisppy_tpu_torch: the scenario mesh over a
# torch.distributed process group (mesh.py) and its elastic fault domain
# (elastic.py)
