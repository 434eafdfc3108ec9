"""host_ms_per_step: the host's ms to issue one ``Run.step``, the mean of
the steps issued right after a device sync (``harness.BURSTS``), so that a
full launch queue does not make the host wait for the card."""
import statistics


def read(obs):
    host = obs.get("host_ms")
    return statistics.fmean(host) if host else None
