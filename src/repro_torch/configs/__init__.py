"""Architecture configs of the port, copies of the reference's
(``repro.configs``).  ``get_config(name) -> ModelConfig``."""
import importlib

# CLI ids (as the reference's) -> module names
ALIASES = {
    "grok-1-314b": "grok_1_314b",
    "phi3.5-moe-42b-a6.6b": "phi35_moe_42b",
    "xlstm-125m": "xlstm_125m",
    "internlm2-1.8b": "internlm2_1_8b",
    "qwen3-4b": "qwen3_4b",
    "qwen1.5-110b": "qwen15_110b",
    "qwen3-1.7b": "qwen3_1_7b",
    "whisper-small": "whisper_small",
    "llama-3.2-vision-90b": "llama32_vision_90b",
    "hymba-1.5b": "hymba_1_5b",
}


def get_config(name: str):
    """The ``ModelConfig`` registered as ``name`` (a CLI id or module
    name)."""
    mod_name = ALIASES.get(name, name.replace("-", "_").replace(".", "_"))
    if mod_name not in ALIASES.values():
        raise ValueError(f"unknown arch {name!r}; have {sorted(ALIASES)}")
    mod = importlib.import_module(f"repro_torch.configs.{mod_name}")
    return mod.CONFIG
