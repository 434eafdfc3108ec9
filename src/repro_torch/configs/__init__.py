from repro_torch.configs.base import CNNConfig, ConvLayerSpec, DNNConfig, ModelConfig  # noqa: F401
from repro_torch.configs.registry import ARCHS, get_config, smoke_variant  # noqa: F401
