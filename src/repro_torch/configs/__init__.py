"""Architecture registry of the port: every configuration of the JAX
package's ``repro.configs``.

Each ``<arch>.py`` exposes ``full()`` (the published config) and
``smoke()`` (a reduced same-family config for CPU tests), copied from
the JAX package: quickstart, the dense GQA stacks (gemma3-12b,
qwen1.5-32b, qwen2.5-32b, phi3-mini-3.8b), the MoE stacks
(deepseek-v2-236b with MLA, llama4-maverick-400b-a17b with GQA), the
SSM stack falcon-mamba-7b (Mamba-1), the hybrid zamba2-2.7b (Mamba-2
with a weight-shared attention block) and the embedding-input stacks
musicgen-large and internvl2-26b.
"""
from __future__ import annotations

import importlib
from typing import Optional

from repro_torch.models import ModelConfig

_MODULES = {"quickstart": "quickstart", "gemma3-12b": "gemma3_12b",
            "qwen1.5-32b": "qwen1_5_32b", "qwen2.5-32b": "qwen2_5_32b",
            "phi3-mini-3.8b": "phi3_mini_3_8b",
            "deepseek-v2-236b": "deepseek_v2_236b",
            "llama4-maverick-400b-a17b": "llama4_maverick_400b_a17b",
            "falcon-mamba-7b": "falcon_mamba_7b",
            "zamba2-2.7b": "zamba2_2_7b",
            "musicgen-large": "musicgen_large",
            "internvl2-26b": "internvl2_26b"}


def get_config(name: str, smoke: Optional[bool] = None) -> ModelConfig:
    if name not in _MODULES:
        raise KeyError(f"unknown arch {name}; known: {sorted(_MODULES)}")
    mod = importlib.import_module(f"repro_torch.configs.{_MODULES[name]}")
    return mod.smoke() if smoke else mod.full()
