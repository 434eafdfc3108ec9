"""CD-DNN — context-dependent DNN-HMM acoustic model, the paper's ASR
workload (§5.4) [Seide et al. 2011].  7 fully-connected hidden layers of
2048 neurons; 440-dim fbank context window input; 9304 tied-triphone
senone outputs.
"""
from repro_torch.configs.base import DNNConfig

CONFIG = DNNConfig(
    name="cd-dnn",
    source="Seide et al. 2011 (CD-DNN-HMM); paper §5.4",
    input_dim=440,
    hidden_dim=2048,
    num_hidden=7,
    output_dim=9304,
)
