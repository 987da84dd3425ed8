###############################################################################
# mmw_conf: the MMW confidence-interval CLI (port of
# mpisppy_tpu/confidence_intervals/mmw_conf.py;
# ref:mpisppy/confidence_intervals/mmw_conf.py:1-120).
#
#   python -m mpisppy_tpu_torch.confidence_intervals.mmw_conf \
#       --module-name mpisppy_tpu_torch.models.farmer --xhatpath xhat.npy \
#       --num-scens 3 --MMW-num-batches 5 --MMW-batch-size 10 \
#       [--device cpu]
#
# Loads a candidate x̂ from --xhatpath (written by ciutils.write_xhat or
# a solution writer), runs MMW batches of the gap estimator around it on
# --device (default cuda; without CUDA the run raises), and prints the
# gap CI as one JSON line.  As the JAX CLI, it adds no flag of the model.
###############################################################################
from __future__ import annotations

import importlib
import json
import sys

from mpisppy_tpu_torch.confidence_intervals import ciutils
from mpisppy_tpu_torch.confidence_intervals.confidence_config import (
    confidence_config,
)
from mpisppy_tpu_torch.confidence_intervals.mmw_ci import (
    MMWConfidenceIntervals,
)
from mpisppy_tpu_torch.utils.config import Config


def _parse_args(args=None):
    cfg = Config()
    cfg.add_to_config("module_name", "model module to import", str, None)
    cfg.num_scens_optional()
    confidence_config(cfg)
    cfg.add_to_config("MMW_num_batches", "number of MMW batches", int, 2)
    cfg.add_to_config("MMW_batch_size",
                      "scenarios per batch (default: num_scens)", int,
                      None)
    cfg.add_to_config("start_scen",
                      "first scenario index for sampling (default: after "
                      "the candidate's own scenarios)", int, None)
    cfg.device_args()
    cfg.parse_command_line("mpisppy_tpu_torch.confidence_intervals.mmw_conf",
                           args)
    return cfg


def main(args=None):
    argv = list(sys.argv[1:] if args is None else args)
    cfg = _parse_args(argv)
    if cfg.get("module_name") is None:
        raise SystemExit("--module-name is required")
    if cfg.get("xhatpath") is None:
        raise SystemExit("--xhatpath is required (an .npy candidate, "
                         "e.g. from ciutils.write_xhat)")
    if "." not in sys.path:
        sys.path.insert(0, ".")
    module = importlib.import_module(cfg["module_name"])
    xhat_one = ciutils.read_xhat(cfg["xhatpath"])
    start = cfg.get("start_scen")
    if start is None:
        # sample fresh scenarios beyond the ones the candidate saw
        # (ref:mmw_conf.py start = num_scens of the xhat run)
        start = int(cfg.get("num_scens") or 0)
        if start == 0:
            # evaluating on the candidate's own training scenarios
            # biases the gap estimate LOW and voids the CI coverage
            # guarantee (cf. seqsampling._candidate_seed_span)
            print(
                "WARNING: neither --start-scen nor --num-scens given; "
                "gap estimation starts at scenario 0, which likely "
                "REUSES the scenarios the candidate xhat was fit to "
                "— the resulting CI is optimistically biased",
                file=sys.stderr)
    batch_size = cfg.get("MMW_batch_size") or cfg.get("num_scens")
    if batch_size is None:
        raise SystemExit("--MMW-batch-size (or --num-scens) is required")
    mmw = MMWConfidenceIntervals(
        module, cfg, xhat_one,
        num_batches=cfg.get("MMW_num_batches", 2),
        batch_size=int(batch_size),
        start=start)
    res = mmw.run(confidence_level=cfg.get("confidence_level", 0.95))
    print(json.dumps(res), flush=True)
    return res


if __name__ == "__main__":
    main()
