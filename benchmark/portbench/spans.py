"""What the program's own recorder (``plastic_unet_tpu_torch.utils.profiling``)
holds after a traced run, read for the per-layer metrics beside the device
trace: the kernel launches of the traced window by family, each with the
shapes its ``port.kernel.<family>`` span recorded, and the bytes the serving
entry staged (``port.serve.stage_in``, ``port.serve.to_host``).

The recorder stamps its records on the profiler's own clock, so a record
belongs to the window when it starts inside ``run.trace.window``. A
replayed CUDA graph runs no Python: its step is one ``port.train.step``
record whose ``graph`` names the capture, and the capture's launch records
stand for the replay's launches (:func:`launches`).

A program without the recorder has nothing to read: every reader here
returns None there and raises nothing.
"""

from __future__ import annotations

from portbench.spec import BENCH_DIR, load_file, load_json
from portbench.tracing import is_port_kernel

STEP = "port.train.step"
COPIES = ("port.serve.stage_in", "port.serve.to_host")


def families() -> dict:
    """{family: the port's kernel symbols its launches run} (data/kernel_families.json)."""
    return load_json(BENCH_DIR / "data" / "kernel_families.json")["families"]


def launch_work():
    """``flops/launches.py``: a launch's operations and bytes from its recorded shapes."""
    return load_file(BENCH_DIR / "flops" / "launches.py", "portbench_flops_launches")


def program_records():
    """(records, captures) of the program's recorder, or None where the program has no recorder."""
    try:
        from plastic_unet_tpu_torch.utils import profiling

        return profiling.records(), profiling.captures()
    except (ImportError, AttributeError):
        return None


def window_records(run):
    """(the records that start inside the traced window, the captures), or None."""
    got = program_records()
    if got is None or run.trace is None:
        return None
    records, caps = got
    a, b = run.trace.window
    return [r for r in records if a <= r["start_ns"] <= b], caps


def launches(run, family: str):
    """The recorded attributes of every launch of ``family`` in the traced
    window: its own ``port.kernel.<family>`` records, and for each replayed
    step the capture's; None where the program records nothing."""
    got = window_records(run)
    if got is None:
        return None
    records, caps = got
    name, out = "port.kernel." + family, []
    for r in records:
        if r["name"] == name:
            out.append(r["attrs"])
        elif r["name"] == STEP and r["attrs"].get("graph") is not None:
            out += [c["attrs"] for c in caps.get(r["attrs"]["graph"], ()) if c["name"] == name]
    return out


def family_kernels(run, family: str) -> list:
    """The traced window's kernels whose names hold one of ``family``'s symbols."""
    symbols = families()[family]
    return [o for o in run.trace.kernels() if is_port_kernel(o.name, symbols)] if run.trace else []


def roofline(run, family: str):
    """The recorded launches of ``family`` in the window at the roofline
    (each launch's operations over the float32 peak or its bytes over the
    HBM rate, the larger; ``flops/launches.py``), summed, over the device
    time of the window's kernels of that family. None where either is missing."""
    found = launches(run, family)
    ns = sum(o.end - o.start for o in family_kernels(run, family))
    if not found or not ns:
        return None
    w = launch_work()
    bound_s = 0.0
    for attrs in found:
        ops, nbytes = w.work(family, attrs)
        bound_s += max(ops / run.peaks["fp32_flops"], nbytes / run.peaks["bytes_per_s"])
    return 100.0 * bound_s / (ns / 1e9)


def conv3x3_roofline(run):
    """The conv3x3 kernel's launches (forward and input gradient) at the roofline."""
    return roofline(run, "conv3x3")


def wgrad_roofline(run):
    """The weight-gradient kernel's launches (with their chunks' reduction) at the roofline."""
    return roofline(run, "wgrad")


def tail_fwd_roofline(run):
    """The fused residual tail's launches at the roofline."""
    return roofline(run, "tail_fwd")


def tail_bwd_roofline(run):
    """The fused tail backward's launches (with its sample reduction) at the roofline."""
    return roofline(run, "tail_bwd")


def head_roofline(run):
    """The plastic head's launches at the roofline."""
    return roofline(run, "head")


def copy_gb_per_s(run):
    """GB/s of the serving entry's copies: the bytes its ``port.serve.stage_in``
    and ``port.serve.to_host`` spans moved in the window, over the device
    time of the window's copies between host and device."""
    got = window_records(run)
    if got is None:
        return None
    nbytes = sum(r["attrs"].get("bytes", 0) for r in got[0] if r["name"] in COPIES)
    ns = sum(o.end - o.start for o in run.trace.ops
             if o.kind == "gpu_memcpy" and ("HtoD" in o.name or "DtoH" in o.name))
    if not nbytes or not ns:
        return None
    return nbytes / (ns / 1e9) / 1e9
