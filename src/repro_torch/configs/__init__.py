"""Model configurations: the paper's GW models (``gw``) and the LM archs
(``base``, ``registry`` and one file per arch)."""

from repro_torch.configs.base import SHAPES, ArchConfig, InputShape, cell_supported  # noqa: F401
from repro_torch.configs.registry import ARCHS, all_cells, get_arch  # noqa: F401
