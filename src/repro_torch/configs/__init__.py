from repro_torch.configs.base import LayerSpec, MambaConfig, ModelConfig, MoEConfig  # noqa: F401
