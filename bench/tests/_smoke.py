"""The benchmark's cells at a size the CPU tests hold: every file found by
name as in a run, the configuration shrunk (two convolutions and two FC
layers of VGG-A's kind; three hidden layers of CD-DNN's) and a batch of
8."""
from __future__ import annotations

import os
import time

from bench import harness

SMOKE = {
    "cnn": {"image_size": 32, "num_classes": 16, "layers": [
        {"kind": "conv", "ifm": 3, "ofm": 16, "kernel": 3, "stride": 1,
         "pad": 1, "out_hw": 32},
        {"kind": "pool", "out_hw": 16},
        {"kind": "conv", "ifm": 16, "ofm": 32, "kernel": 3, "stride": 1,
         "pad": 1, "out_hw": 16},
        {"kind": "pool", "out_hw": 8},
        {"kind": "fc", "ifm": 2048, "ofm": 64},
        {"kind": "fc", "ifm": 64, "ofm": 16}]},
    "dnn": {"input_dim": 40, "hidden_dim": 64, "num_hidden": 3,
            "output_dim": 32},
}
SEED = 2 ** 31 + 12345          # past 32 signed bits, as a run's seed may be
SECONDS = 0.3


def smoke_cell(name: str) -> harness.Cell:
    cell = harness.find_cell(name)
    cell.config = dict(cell.config, **SMOKE[cell.config["family"]])
    cell.traffic = dict(cell.traffic, batch=8)
    return cell


def run_smoke(name: str, trace: bool = False, fault=None):
    """One CPU run of the smoke cell in this process (one rank), with the
    fault ``fault`` (``_faults``) planted in the program."""
    from bench.tests import _faults
    with _faults.planted(fault):
        return harness.run_rank(smoke_cell(name), SEED, SECONDS, trace, "cpu",
                                time.time(), log=lambda *a, **k: None)


def rank_main(rank: int, world: int, init: str, name: str, trace: bool,
              fault, results):
    """One gloo rank of a multi-chip smoke cell on the CPU."""
    import torch.distributed as dist
    os.environ.update(REPRO_PROCESS_ID=str(rank),
                      REPRO_NUM_PROCESSES=str(world), REPRO_LOCAL_DEVICES="1")
    dist.init_process_group("gloo", init_method=init, rank=rank,
                            world_size=world)
    try:
        out = run_smoke(name, trace, fault)
        if rank == 0:
            results.put((out, harness.forbidden_modules()))
    except BaseException as e:          # reported to the test, then raised
        results.put(e)
        raise


def run_ranks(name: str, world: int, tmp_path, trace=False, fault=None,
              timeout=240):
    """The smoke cell over ``world`` gloo ranks on the CPU, each in a
    process of its own; rank 0's result."""
    import multiprocessing as mp
    ctx = mp.get_context("spawn")
    results = ctx.Queue()
    init = f"file://{tmp_path / 'init'}"
    procs = [ctx.Process(target=rank_main, args=(r, world, init, name, trace,
                                                 fault, results))
             for r in range(world)]
    for p in procs:
        p.start()
    try:
        got = results.get(timeout=timeout)
    finally:
        for p in procs:
            p.join(timeout=60)
            if p.is_alive():
                p.kill()
                p.join()
    if isinstance(got, BaseException):
        raise got
    assert all(p.exitcode == 0 for p in procs), [p.exitcode for p in procs]
    return got
