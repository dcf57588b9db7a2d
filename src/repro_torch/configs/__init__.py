"""Architecture registry of the port: the configurations whose stack is
ported so far.

Each ``<arch>.py`` exposes ``full()`` (the published config) and
``smoke()`` (a reduced same-family config for CPU tests), copied from
the JAX package's ``repro.configs``: quickstart, the dense GQA stacks
(gemma3-12b, qwen1.5-32b, qwen2.5-32b, phi3-mini-3.8b) and the MoE
stacks (deepseek-v2-236b with MLA, llama4-maverick-400b-a17b with GQA).
The JAX package's other architectures (SSM, hybrid and embedding-input
stacks) come with ROADMAP A11.
"""
from __future__ import annotations

import importlib
from typing import Optional

from repro_torch.models import ModelConfig

_MODULES = {"quickstart": "quickstart", "gemma3-12b": "gemma3_12b",
            "qwen1.5-32b": "qwen1_5_32b", "qwen2.5-32b": "qwen2_5_32b",
            "phi3-mini-3.8b": "phi3_mini_3_8b",
            "deepseek-v2-236b": "deepseek_v2_236b",
            "llama4-maverick-400b-a17b": "llama4_maverick_400b_a17b"}

#: the JAX package's other architectures, ported with ROADMAP A11
NOT_PORTED = ("falcon-mamba-7b", "musicgen-large", "zamba2-2.7b",
              "internvl2-26b")


def get_config(name: str, smoke: Optional[bool] = None) -> ModelConfig:
    if name in NOT_PORTED:
        raise KeyError(f"arch {name} is not ported yet (ROADMAP A11); "
                       f"ported: {sorted(_MODULES)}")
    if name not in _MODULES:
        raise KeyError(f"unknown arch {name}; known: {sorted(_MODULES)}")
    mod = importlib.import_module(f"repro_torch.configs.{_MODULES[name]}")
    return mod.smoke() if smoke else mod.full()
