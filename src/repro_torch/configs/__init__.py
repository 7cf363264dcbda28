"""Architecture configs of the port.  ``get_config(name) -> ModelConfig``.

Only the architectures whose family is ported are registered; the
reference's others (``repro.configs.ALIASES``) follow with their
families (ROADMAP.md queue 1 item 13).
"""
import importlib

# CLI ids (as the reference's) -> module names
ALIASES = {
    "qwen3-1.7b": "qwen3_1_7b",
    "phi3.5-moe-42b-a6.6b": "phi35_moe_42b",
}


def get_config(name: str):
    """The ``ModelConfig`` registered as ``name`` (a CLI id or module
    name)."""
    mod_name = ALIASES.get(name, name.replace("-", "_").replace(".", "_"))
    if mod_name not in ALIASES.values():
        raise ValueError(f"unknown or unported arch {name!r}; have "
                         f"{sorted(ALIASES)}")
    mod = importlib.import_module(f"repro_torch.configs.{mod_name}")
    return mod.CONFIG
