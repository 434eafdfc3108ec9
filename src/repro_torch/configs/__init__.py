from repro_torch.configs.base import (  # noqa: F401
    INPUT_SHAPES,
    CNNConfig,
    ConvLayerSpec,
    DNNConfig,
    InputShape,
    ModelConfig,
)
from repro_torch.configs.registry import (  # noqa: F401
    ALL_ARCHS,
    ARCHS,
    ASSIGNED_ARCHS,
    PAPER_ARCHS,
    get_config,
    get_input_shape,
    smoke_variant,
)
