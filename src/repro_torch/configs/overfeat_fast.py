"""OverFeat-FAST — the paper's second CNN workload
[Sermanet et al. 2013, arXiv:1312.6229]; paper §2.2 uses its C5 layer
(12x12 output, 3x3 kernel, 512 ifm, 1024 ofm) as the blocking case study.
"""
from repro_torch.configs.base import CNNConfig, ConvLayerSpec as L

CONFIG = CNNConfig(
    name="overfeat-fast",
    source="arXiv:1312.6229 (OverFeat, fast model); paper §2.2, §5",
    image_size=231,
    num_classes=1000,
    layers=(
        L("conv", ifm=3,    ofm=96,   kernel=11, stride=4, pad=0, out_hw=56),
        L("pool", out_hw=28),
        L("conv", ifm=96,   ofm=256,  kernel=5,  stride=1, pad=0, out_hw=24),
        L("pool", out_hw=12),
        L("conv", ifm=256,  ofm=512,  kernel=3,  stride=1, pad=1, out_hw=12),
        # paper's "C5": 512 ifm -> 1024 ofm, 3x3, 12x12 output
        L("conv", ifm=512,  ofm=1024, kernel=3,  stride=1, pad=1, out_hw=12),
        L("conv", ifm=1024, ofm=1024, kernel=3,  stride=1, pad=1, out_hw=12),
        L("pool", out_hw=6),
        L("fc", ifm=1024 * 6 * 6, ofm=3072, out_hw=1),
        L("fc", ifm=3072, ofm=4096, out_hw=1),
        L("fc", ifm=4096, ofm=1000, out_hw=1),
    ),
)
