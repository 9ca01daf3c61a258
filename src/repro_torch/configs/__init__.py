"""Architecture registry: one module per assigned architecture."""
import importlib

ARCH_MODULES = {
    "zamba2-2.7b": "repro_torch.configs.zamba2_2p7b",
    "hubert-xlarge": "repro_torch.configs.hubert_xlarge",
    "moonshot-v1-16b-a3b": "repro_torch.configs.moonshot_v1_16b_a3b",
    "phi3.5-moe-42b-a6.6b": "repro_torch.configs.phi3p5_moe_42b_a6p6b",
    "phi3-medium-14b": "repro_torch.configs.phi3_medium_14b",
    "phi3-mini-3.8b": "repro_torch.configs.phi3_mini_3p8b",
    "command-r-plus-104b": "repro_torch.configs.command_r_plus_104b",
    "chatglm3-6b": "repro_torch.configs.chatglm3_6b",
    "pixtral-12b": "repro_torch.configs.pixtral_12b",
    "mamba2-1.3b": "repro_torch.configs.mamba2_1p3b",
}

ARCHS = list(ARCH_MODULES)


def get_config(name: str):
    """Full (paper-exact) config for an architecture id."""
    return importlib.import_module(ARCH_MODULES[name]).config()


def get_smoke_config(name: str):
    """Reduced same-family config for CPU smoke tests."""
    return importlib.import_module(ARCH_MODULES[name]).smoke_config()
