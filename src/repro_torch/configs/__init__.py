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

``ARCHS``, ``SHAPES``, ``META`` and :func:`cells` are the JAX package's
dry-run registry, copied: the ten assigned architectures, the four input
shapes of the LM-family pool, each architecture's dry-run knobs (whether
it is sub-quadratic and so runs the ``long_500k`` cell, FSDP of the
expert/ffn weights, sequence-sharded activations, train-time gradient
accumulation, the moments' dtype) and the (architecture, shape) cells
(:mod:`repro_torch.launch.dryrun`).
"""
from __future__ import annotations

import importlib
from typing import Dict, Optional

from repro_torch.models import ModelConfig

ARCHS = [
    "falcon-mamba-7b",
    "gemma3-12b",
    "qwen1.5-32b",
    "qwen2.5-32b",
    "phi3-mini-3.8b",
    "deepseek-v2-236b",
    "llama4-maverick-400b-a17b",
    "musicgen-large",
    "zamba2-2.7b",
    "internvl2-26b",
]

_MODULES = {"quickstart": "quickstart", "gemma3-12b": "gemma3_12b",
            "qwen1.5-32b": "qwen1_5_32b", "qwen2.5-32b": "qwen2_5_32b",
            "phi3-mini-3.8b": "phi3_mini_3_8b",
            "deepseek-v2-236b": "deepseek_v2_236b",
            "llama4-maverick-400b-a17b": "llama4_maverick_400b_a17b",
            "falcon-mamba-7b": "falcon_mamba_7b",
            "zamba2-2.7b": "zamba2_2_7b",
            "musicgen-large": "musicgen_large",
            "internvl2-26b": "internvl2_26b"}


# input shapes assigned to the LM-family pool (seq_len x global_batch)
SHAPES = {
    "train_4k":    {"kind": "train",   "seq": 4096,   "batch": 256},
    "prefill_32k": {"kind": "prefill", "seq": 32768,  "batch": 32},
    "decode_32k":  {"kind": "decode",  "seq": 32768,  "batch": 128},
    "long_500k":   {"kind": "decode",  "seq": 524288, "batch": 1},
}

# per-arch dry-run metadata
META: Dict[str, Dict] = {
    "falcon-mamba-7b":          {"subquadratic": True,  "fsdp": False,
                                 "seq_shard": True, "grad_accum": 4},
    "gemma3-12b":               {"subquadratic": True,  "fsdp": False,
                                 "seq_shard": True, "grad_accum": 4},
    "qwen1.5-32b":              {"subquadratic": False, "fsdp": False,
                                 "seq_shard": True, "grad_accum": 4},
    "qwen2.5-32b":              {"subquadratic": False, "fsdp": False,
                                 "seq_shard": True, "grad_accum": 4},
    "phi3-mini-3.8b":           {"subquadratic": False, "fsdp": False,
                                 "seq_shard": True, "grad_accum": 1},
    "deepseek-v2-236b":         {"subquadratic": False, "fsdp": True,
                                 "seq_shard": True, "grad_accum": 16,
                                 "moments": "bfloat16"},
    "llama4-maverick-400b-a17b": {"subquadratic": False, "fsdp": True,
                                  "seq_shard": True, "grad_accum": 8,
                                  "moments": "bfloat16"},
    "musicgen-large":           {"subquadratic": False, "fsdp": False,
                                 "seq_shard": True, "grad_accum": 4},
    "zamba2-2.7b":              {"subquadratic": True,  "fsdp": False,
                                 "seq_shard": True, "grad_accum": 4},
    "internvl2-26b":            {"subquadratic": False, "fsdp": False,
                                 "seq_shard": True, "grad_accum": 4},
    "quickstart":               {"subquadratic": False, "fsdp": False,
                                 "seq_shard": False, "grad_accum": 1},
}


def get_config(name: str, smoke: Optional[bool] = None) -> ModelConfig:
    if name not in _MODULES:
        raise KeyError(f"unknown arch {name}; known: {sorted(_MODULES)}")
    mod = importlib.import_module(f"repro_torch.configs.{_MODULES[name]}")
    return mod.smoke() if smoke else mod.full()


def cells(include_skipped: bool = False):
    """All (arch, shape) dry-run cells, honoring the long_500k skip rule
    for pure full-attention archs (the JAX package's rule)."""
    out = []
    for a in ARCHS:
        for s in SHAPES:
            skipped = (s == "long_500k" and not META[a]["subquadratic"])
            if skipped and not include_skipped:
                continue
            out.append((a, s, skipped))
    return out
