###############################################################################
# scengen: seeded scenario synthesis on the device (port of
# mpisppy_tpu/scengen; dense constraint matrices).
#
# Public surface:
#   ScenarioProgram   declarative key -> scenario-data recipe
#   RowDraws          a sampler's Bernoulli-row rule as data (in-kernel)
#   scen_key          fold_in(base_key, scenario_index) — the counter scheme
#   program_for       model-module bridge (models/{farmer,sslp,uc,aircond})
#   program_from_cfg  the confidence-interval layer's cfg-gated resolver
#   virtual_batch     program -> VirtualBatch (O(n+m+S) resident)
#   materialize       program -> fully drawn ScenarioBatch (device)
#   window_inputs     VirtualBatch -> the window kernel's in-kernel draws
###############################################################################
from mpisppy_tpu_torch.scengen.program import (  # noqa: F401
    FIELDS, RowDraws, ScenarioProgram, estimate_materialized_bytes,
    has_program, program_for, program_from_cfg, sample_fields, scen_key,
)
from mpisppy_tpu_torch.scengen.virtual import (  # noqa: F401
    VirtualBatch, materialize, repartition, virtual_batch,
)
from mpisppy_tpu_torch.scengen.tiles import window_inputs  # noqa: F401

