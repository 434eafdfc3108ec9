"""VGG-A (configuration A, 11 weight layers) — the paper's main scaling
workload [Simonyan & Zisserman 2014, arXiv:1409.1556]; paper §5.2.

Spatial sizes follow the 224x224 ImageNet pipeline the paper used.
"""
from repro_torch.configs.base import CNNConfig, ConvLayerSpec as L

CONFIG = CNNConfig(
    name="vgg-a",
    source="arXiv:1409.1556 (VGG, config A); paper §5.2",
    image_size=224,
    num_classes=1000,
    layers=(
        L("conv", ifm=3,   ofm=64,  kernel=3, stride=1, pad=1, out_hw=224),
        L("pool", out_hw=112),
        L("conv", ifm=64,  ofm=128, kernel=3, stride=1, pad=1, out_hw=112),
        L("pool", out_hw=56),
        L("conv", ifm=128, ofm=256, kernel=3, stride=1, pad=1, out_hw=56),
        L("conv", ifm=256, ofm=256, kernel=3, stride=1, pad=1, out_hw=56),
        L("pool", out_hw=28),
        L("conv", ifm=256, ofm=512, kernel=3, stride=1, pad=1, out_hw=28),
        L("conv", ifm=512, ofm=512, kernel=3, stride=1, pad=1, out_hw=28),
        L("pool", out_hw=14),
        L("conv", ifm=512, ofm=512, kernel=3, stride=1, pad=1, out_hw=14),
        L("conv", ifm=512, ofm=512, kernel=3, stride=1, pad=1, out_hw=14),
        L("pool", out_hw=7),
        L("fc", ifm=512 * 7 * 7, ofm=4096, out_hw=1),
        L("fc", ifm=4096, ofm=4096, out_hw=1),
        L("fc", ifm=4096, ofm=1000, out_hw=1),
    ),
)
