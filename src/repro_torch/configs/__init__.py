"""Configurations of the port: the paper's FlyWire workload
(:mod:`.flywire`) and the LM architectures the port runs.

Counterpart of ``repro/configs/__init__.py``: ``get_config(name)`` returns
the full published config, ``get_config(name, smoke=True)`` the reduced
same-family variant the CPU tests use.  Of the reference's ten
architectures only the dense ones whose layers are ported have a module
here (``qwen2.5-14b``); the others raise ``NotImplementedError``.
"""

from __future__ import annotations

import importlib

ARCHS = [
    "grok1_314b",
    "llama4_scout_17b_a16e",
    "recurrentgemma_2b",
    "phi3_medium_14b",
    "qwen2_5_14b",
    "command_r_35b",
    "gemma3_12b",
    "whisper_medium",
    "rwkv6_7b",
    "llava_next_34b",
]

# canonical ids -> module names
ALIASES = {
    "grok-1-314b": "grok1_314b",
    "llama4-scout-17b-a16e": "llama4_scout_17b_a16e",
    "recurrentgemma-2b": "recurrentgemma_2b",
    "phi3-medium-14b": "phi3_medium_14b",
    "qwen2.5-14b": "qwen2_5_14b",
    "command-r-35b": "command_r_35b",
    "gemma3-12b": "gemma3_12b",
    "whisper-medium": "whisper_medium",
    "rwkv6-7b": "rwkv6_7b",
    "llava-next-34b": "llava_next_34b",
}

PORTED = ("qwen2_5_14b",)


def get_config(name: str, smoke: bool = False):
    mod_name = ALIASES.get(name, name.replace("-", "_").replace(".", "_"))
    if mod_name not in ARCHS:
        raise ValueError(f"unknown architecture {name!r}")
    if mod_name not in PORTED:
        raise NotImplementedError(
            f"{name}: not ported (ported: {', '.join(PORTED)})")
    mod = importlib.import_module(f"repro_torch.configs.{mod_name}")
    return mod.SMOKE if smoke else mod.CONFIG


def all_arch_names():
    return list(ALIASES.keys())


__all__ = ["ALIASES", "ARCHS", "PORTED", "all_arch_names", "get_config"]
