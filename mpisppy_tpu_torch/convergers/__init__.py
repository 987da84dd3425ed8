# Convergers: hub-side intra-algorithm termination (port of
# mpisppy_tpu/convergers/; ref:mpisppy/convergers/).
from mpisppy_tpu_torch.convergers.converger import Converger  # noqa: F401
from mpisppy_tpu_torch.convergers.fracintsnotconv import (  # noqa: F401
    FractionalConverger,
)
from mpisppy_tpu_torch.convergers.norm_rho_converger import (  # noqa: F401
    NormRhoConverger,
)
from mpisppy_tpu_torch.convergers.primal_dual_converger import (  # noqa: F401
    PrimalDualConverger,
)
