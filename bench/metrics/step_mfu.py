"""step_mfu: model operations a step (three times the forward's products,
``flops.model_ops_per_step``, over the global batch) times the window's
steps, over the window's time, over the chips' dense TF32 peak; in %."""


def read(obs):
    f = obs["flops"]
    ops = f.model_ops_per_step(obs["cell"].family.products(obs["cell"].config),
                               obs["batch"])
    return (100.0 * ops * obs["steps"]
            / (obs["wall_s"] * obs["chips"] * f.PEAKS["tf32_flop_per_s"]))
