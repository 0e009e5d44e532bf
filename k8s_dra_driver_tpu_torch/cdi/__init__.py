"""CDI spec generation for TPU and GPU containers (the port's twin of
``k8s_dra_driver_tpu.cdi``; the runtime mapping is ``runtime.py``)."""

from .spec import (
    CDI_VERSION,
    CDIHandler,
    ContainerEdits,
    chip_visibility_env,
    tensorcore_visibility_env,
)

__all__ = [
    "CDI_VERSION",
    "CDIHandler",
    "ContainerEdits",
    "chip_visibility_env",
    "tensorcore_visibility_env",
]
