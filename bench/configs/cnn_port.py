"""The program's form of a CNN configuration file: the port's
``CNNConfig`` with the file's layers, and the port's kernel entry for the
forward convolutions."""
from __future__ import annotations


def port_config(cfg: dict):
    from repro_torch.configs.base import CNNConfig, ConvLayerSpec
    return CNNConfig(
        name=cfg["name"], source=cfg["source"],
        image_size=cfg["image_size"], num_classes=cfg["num_classes"],
        layers=tuple(ConvLayerSpec(**lyr) for lyr in cfg["layers"]))
