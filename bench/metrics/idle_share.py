"""idle_share: the share of the traced stretch in which no operation ran
on this rank's card; in %."""


def read(obs):
    t = obs["trace"]
    if t.busy_s <= 0:
        return None
    return 100.0 * (1.0 - t.busy_s / t.window_s)
