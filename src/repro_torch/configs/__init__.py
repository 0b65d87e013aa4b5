"""Architecture configs of the port (copies of ``repro.configs``)."""
from repro_torch.configs.base import (  # noqa: F401
    ARCH_IDS,
    INPUT_SHAPES,
    PORTED_ARCHS,
    ArchConfig,
    ShapeConfig,
    check_ported,
    get_config,
)
