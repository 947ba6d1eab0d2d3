"""Architecture registry: ``--arch <id>`` resolution for every launcher."""

from __future__ import annotations

from typing import Dict

from repro_torch.models.config import ArchConfig

from repro_torch.configs.qwen1_5_110b import CONFIG as _qwen
from repro_torch.configs.minicpm3_4b import CONFIG as _minicpm
from repro_torch.configs.llama3_405b import CONFIG as _llama
from repro_torch.configs.minitron_4b import CONFIG as _minitron
from repro_torch.configs.chameleon_34b import CONFIG as _chameleon
from repro_torch.configs.whisper_small import CONFIG as _whisper
from repro_torch.configs.granite_moe_1b import CONFIG as _granite
from repro_torch.configs.grok_1_314b import CONFIG as _grok
from repro_torch.configs.zamba2_2_7b import CONFIG as _zamba
from repro_torch.configs.falcon_mamba_7b import CONFIG as _falcon

ARCHS: Dict[str, ArchConfig] = {
    "qwen1.5-110b": _qwen,
    "minicpm3-4b": _minicpm,
    "llama3-405b": _llama,
    "minitron-4b": _minitron,
    "chameleon-34b": _chameleon,
    "whisper-small": _whisper,
    "granite-moe-1b-a400m": _granite,
    "grok-1-314b": _grok,
    "zamba2-2.7b": _zamba,
    "falcon-mamba-7b": _falcon,
}


def get_config(arch_id: str) -> ArchConfig:
    if arch_id not in ARCHS:
        raise KeyError(f"unknown arch {arch_id!r}; options: {sorted(ARCHS)}")
    return ARCHS[arch_id]
