# One module per ported architecture; registration happens on import via
# repro_torch.configs.base.register_arch. Use get_arch("<id>") / all_archs().
from repro_torch.configs.base import (  # noqa: F401
    ArchConfig,
    AttnConfig,
    all_archs,
    get_arch,
)
