"""The program's form of a fully-connected ASR configuration file: the
port's ``DNNConfig`` with the file's sizes."""
from __future__ import annotations


def port_config(cfg: dict):
    from repro_torch.configs.base import DNNConfig
    return DNNConfig(name=cfg["name"], source=cfg["source"],
                     input_dim=cfg["input_dim"], hidden_dim=cfg["hidden_dim"],
                     num_hidden=cfg["num_hidden"],
                     output_dim=cfg["output_dim"])
