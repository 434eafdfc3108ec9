"""Structured telemetry of the port (``repro.telemetry``): ``events``
records spans and counts, ``sinks`` persists them (JSONL and a Chrome
trace), ``metrics`` aggregates them, and ``autotune`` fits the §3.2 comm
constants on the live mesh for ``comm="auto"``."""
from repro_torch.telemetry.autotune import (  # noqa: F401
    ENV_AUTOTUNE_CACHE,
    CommProbe,
    autotune_comm,
    choose_bucket_bytes,
    fit_comm_model,
    measured_hw,
)
from repro_torch.telemetry.events import (  # noqa: F401
    NULL_RECORDER,
    NullRecorder,
    Recorder,
    make_recorder,
)
from repro_torch.telemetry.metrics import (  # noqa: F401
    Counter,
    Gauge,
    Histogram,
    NullHistogram,
    metrics_summary,
)
from repro_torch.telemetry.sinks import (  # noqa: F401
    JsonlSink,
    merge_process_traces,
    read_jsonl,
    to_chrome_events,
    trace_path,
    write_chrome_trace,
)
