# One module per ported architecture; registration happens on import via
# repro_torch.configs.base.register_arch. Use get_arch("<id>") / all_archs().
from repro_torch.configs.base import (  # noqa: F401
    SHAPES,
    ArchConfig,
    AttnConfig,
    ShapeConfig,
    all_archs,
    applicable_shapes,
    get_arch,
    get_shape,
)
