"""Reference applications authored through the declarative SDK (the port's
counterpart of ``repro.apps``)."""
from repro_torch.apps.log_processing import (
    build_log_processing,
    log_processing_app,
    register_log_services,
)

__all__ = [
    "build_log_processing",
    "log_processing_app",
    "register_log_services",
]
