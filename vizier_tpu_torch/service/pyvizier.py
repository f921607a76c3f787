"""Service-side pyvizier facade.

A copy of the JAX package's ``service/pyvizier.py``: the service flavor of
the shared data model is the port's one facade, re-exported here.
"""

from vizier_tpu_torch.pyvizier import *  # noqa: F401,F403
from vizier_tpu_torch.pyvizier import __all__  # noqa: F401
