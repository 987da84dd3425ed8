# Extension plane: hub plug-ins called at fixed PH callout points (port
# of mpisppy_tpu/extensions/; ref:mpisppy/extensions/).
from mpisppy_tpu_torch.extensions.extension import (  # noqa: F401
    Extension, MultiExtension,
)
from mpisppy_tpu_torch.extensions.avgminmaxer import MinMaxAvg  # noqa: F401
from mpisppy_tpu_torch.extensions.diagnoser import Diagnoser  # noqa: F401
from mpisppy_tpu_torch.extensions.xhatclosest import (  # noqa: F401
    XhatClosest,
)
