"""--arch registry: the 10 assigned architectures + the paper's GW models."""

from __future__ import annotations

from repro_torch.configs.base import SHAPES, ArchConfig, InputShape, cell_supported

from repro_torch.configs.llava_next_34b import CONFIG as _llava
from repro_torch.configs.yi_9b import CONFIG as _yi
from repro_torch.configs.qwen1_5_4b import CONFIG as _qwen_dense
from repro_torch.configs.granite_3_2b import CONFIG as _granite
from repro_torch.configs.smollm_360m import CONFIG as _smollm
from repro_torch.configs.mamba2_130m import CONFIG as _mamba2
from repro_torch.configs.hymba_1_5b import CONFIG as _hymba
from repro_torch.configs.dbrx_132b import CONFIG as _dbrx
from repro_torch.configs.qwen2_moe_a2_7b import CONFIG as _qwen_moe
from repro_torch.configs.seamless_m4t_large_v2 import CONFIG as _seamless

ARCHS: dict[str, ArchConfig] = {
    c.name: c
    for c in (
        _llava, _yi, _qwen_dense, _granite, _smollm,
        _mamba2, _hymba, _dbrx, _qwen_moe, _seamless,
    )
}

#: The paper's own models (LSTM autoencoders) are separate: they are not LM
#: archs and run through repro.core.autoencoder. See configs/gw.py.


def get_arch(name: str) -> ArchConfig:
    if name not in ARCHS:
        raise KeyError(f"unknown arch {name!r}; available: {sorted(ARCHS)}")
    return ARCHS[name]


def all_cells():
    """Yield every (arch, shape, supported, reason) cell of the 40-cell grid."""
    for arch in ARCHS.values():
        for shape in SHAPES.values():
            ok, reason = cell_supported(arch, shape)
            yield arch, shape, ok, reason
