"""Shared fixture for the port's scenario, obs, reliability and launcher
tests: every process-wide piece of the port's state that these tests
touch is reset around each test — the knob defaults (backends, dedup,
obs mode, verbosity, fault plan), the obs registry (its metrics and
mirrors; the fault plan's collector is registered again), the span
tracer and the telemetry install point. Import ``port_state`` into a test
module to make it autouse there. ``world_of_one`` gives a test a 1 x 1
SPMD plan in its own process.
"""
import contextlib

import pytest

from repro_torch.embeddings import collection  # noqa: F401 (registers knob)
from repro_torch.kernels import dispatch  # noqa: F401 (registers knobs)
from repro_torch.obs import export as obs_export
from repro_torch.obs import log as obs_log  # noqa: F401 (registers knob)
from repro_torch.obs import metrics as obs_metrics
from repro_torch.obs import trace as obs_trace
from repro_torch.reliability import faults
from repro_torch.scenario import knobs


def reset_registry() -> None:
    obs_metrics.REGISTRY.reset()
    obs_metrics.register_stats("reliability.faults", faults._obs_snapshot)


@pytest.fixture(autouse=True)
def port_state():
    saved = {name: k.snapshot() for name, k in knobs.REGISTRY.items()}
    reset_registry()
    obs_trace.get_tracer().clear()
    yield
    prev = obs_export.install(None)
    if prev is not None:
        prev.close(final_source=None)
    for name, state in saved.items():
        knobs.REGISTRY[name].restore(state)
    obs_trace.get_tracer().clear()
    reset_registry()


@pytest.fixture
def one_thread():
    """One intra-op thread for a test that compares two CPU runs bit for
    bit: a multi-threaded CPU GEMM may split its work differently from one
    call to the next when the machine is loaded (roo-lsr's 640-wide DCNv2
    and LCE products show it), which moves the last bits of a loss. On
    the card the same runs are held bit for bit by chip_smoke.py."""
    import torch
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@contextlib.contextmanager
def world_of_one():
    """A 1 x 1 plan over a gloo world of one in this process; the world is
    destroyed on the way out (the launcher's ``--mesh 1x1`` on the CPU)."""
    import torch.distributed as dist

    from repro_torch.distributed.sharding import plan_for_mesh
    from repro_torch.launch.hostdevices import ensure_world
    from repro_torch.launch.mesh import make_mesh
    assert not dist.is_initialized()
    ensure_world("gloo")
    try:
        yield plan_for_mesh(make_mesh((1, 1), ("data", "model")))
    finally:
        dist.destroy_process_group()
