"""Per-stage DEVICE-time attribution from the JAX profiler trace.

The reference's only observability is a leveled file log plus structure-stat
lines (``RayTraceDebug.cs:25-36``, ``RayTraceMaster.cs:331-335,734-735``).
Wall-clock around a jitted step gives the frame time but cannot split it into
kernels; the profiler's device timeline can: ``jax.profiler.start_trace``
writes a Chrome trace (``*.trace.json.gz``) whose device process rows
(``/device:GPU:0`` ...) carry per-kernel events with device-clock durations.

This module parses that trace into a per-stage millisecond breakdown:

* ``profile_stages(run)`` — trace one call of ``run()`` (synchronized with
  ``jax.block_until_ready``), parse, and return a :class:`DeviceProfile`.
* ``parse_device_trace(logdir)`` — the pure parser (unit-testable on a
  synthetic trace file).

Stage mapping is regex-over-event text (kernel/HLO name plus the event's
string arguments, which carry the op's scope path), with the Pallas trace
kernel reported per OCCURRENCE in timestamp order — occurrence k of the
kernel inside one frame is bounce k, which is exactly the breakdown needed to
steer traversal work.
"""

from __future__ import annotations

import dataclasses
import glob
import gzip
import json
import os
import re
import tempfile
from typing import Dict, List, Optional, Sequence, Tuple

# Default stage classification, first match wins. Device rows carry XLA
# kernel names: the Triton trace kernel keeps its pallas_call name
# ("gpu_trace_kernel"); everything else arrives as loop_*_fusion /
# input_*_fusion / custom-call names. The scope path (jax.named_scope
# "shade", "env_lookup") rides in the event's arguments only for ops run
# outside a CUDA command buffer; a jitted GPU step runs as one, so there
# shading, environment and RNG all land in "fusion".
DEFAULT_STAGES: Sequence[Tuple[str, str]] = (
    ("trace_kernel", r"gpu_trace_kernel"),
    ("env", r"env_lookup"),
    ("rng", r"threefry|random_bits|erf_inv"),
    ("shade", r"/shade"),
    ("sort", r"sort"),
    ("convolution_matmul", r"gemm|dot|conv"),
    ("fusion", r"fusion"),
    ("copy", r"copy|transpose|reshape|bitcast|^pad"),
    # jit_* umbrellas: after child subtraction their SELF time is the
    # dispatch/gap overhead between device ops.
    ("dispatch", r"^jit_"),
)

_DEVICE_NAME_RE = re.compile(r"^/device:")


@dataclasses.dataclass
class DeviceProfile:
    """Parsed device timeline for one traced region."""

    total_ms: float                      # sum of device event durations
    stages_ms: Dict[str, float]          # stage -> device ms (incl. "other")
    per_occurrence_ms: Dict[str, List[float]]  # stage -> durations, ts order
    top_ops: List[Tuple[str, float, int]]      # (name, ms, count), desc

    def report(self) -> str:
        lines = [f"device total {self.total_ms:9.3f} ms"]
        for name, ms in sorted(self.stages_ms.items(), key=lambda kv: -kv[1]):
            line = f"  {name:<20} {ms:9.3f} ms"
            occ = self.per_occurrence_ms.get(name)
            if occ and 1 < len(occ) <= 16:
                line += "  [" + ", ".join(f"{d:.2f}" for d in occ) + "]"
            lines.append(line)
        return "\n".join(lines)


def find_trace_file(logdir: str) -> Optional[str]:
    """Newest ``*.trace.json.gz`` under ``logdir`` (searched recursively)."""
    hits = glob.glob(os.path.join(logdir, "**", "*.trace.json.gz"),
                     recursive=True)
    return max(hits, key=os.path.getmtime) if hits else None


def _load_events(path: str) -> List[dict]:
    opener = gzip.open if path.endswith(".gz") else open
    with opener(path, "rt") as f:
        data = json.load(f)
    return data.get("traceEvents", data if isinstance(data, list) else [])


def _device_pids(events: Sequence[dict]) -> List[int]:
    """Process ids of the device rows: processes named ``/device:...``.

    The CPU backend runs XLA ops on host threads and has no device row; its
    trace then counts every process that recorded events.
    """
    names: Dict[int, str] = {}
    busy = set()
    for ev in events:
        pid = ev.get("pid")
        if pid is None:
            continue
        if ev.get("ph") == "M" and ev.get("name") == "process_name":
            names[pid] = str(ev.get("args", {}).get("name", ""))
        elif ev.get("ph") == "X":
            busy.add(pid)
    devices = [p for p, n in names.items() if _DEVICE_NAME_RE.search(n)
               and p in busy]
    return sorted(devices or busy)


def _event_text(ev: dict) -> str:
    """Kernel name plus the event's string arguments (scope path, HLO op)."""
    args = ev.get("args") or {}
    return " ".join([str(ev.get("name", ""))]
                    + [v for v in args.values() if isinstance(v, str)])


def parse_device_trace(logdir_or_file: str,
                       stages: Sequence[Tuple[str, str]] = DEFAULT_STAGES,
                       ) -> DeviceProfile:
    """Parse a profiler trace into a per-stage device-time breakdown.

    Args:
      logdir_or_file: a profiler log directory or a trace .json(.gz) path.
      stages: ordered (stage_name, regex) pairs; first match classifies an
        event, unmatched events land in "other".
    """
    path = logdir_or_file
    if os.path.isdir(path):
        found = find_trace_file(path)
        if found is None:
            raise FileNotFoundError(f"no *.trace.json.gz under {path}")
        path = found
    events = _load_events(path)
    pids = set(_device_pids(events))

    # SELF time per event: device rows nest (module > subcomputation >
    # kernel), so raw durations double-count parents. Walk each (pid, tid)
    # row in start order with an open-interval stack and subtract every
    # directly-nested child's span from its parent.
    rows: Dict[Tuple[int, int], List[dict]] = {}
    for ev in events:
        if ev.get("ph") != "X" or ev.get("pid") not in pids:
            continue
        rows.setdefault((ev.get("pid"), ev.get("tid", 0)), []).append(ev)

    compiled = [(name, re.compile(pat)) for name, pat in stages]
    stages_ms: Dict[str, float] = {}
    timeline: Dict[str, List[Tuple[float, float]]] = {}
    ops: Dict[str, Tuple[float, int]] = {}
    total = 0.0
    def emit(text: str, ts: float, self_us: float) -> None:
        nonlocal total
        dur_ms = max(self_us, 0.0) / 1000.0
        total += dur_ms
        name = text.split(" ", 1)[0]
        ms, cnt = ops.get(name, (0.0, 0))
        ops[name] = (ms + dur_ms, cnt + 1)
        stage = "other"
        for sname, creg in compiled:
            if creg.search(text):
                stage = sname
                break
        stages_ms[stage] = stages_ms.get(stage, 0.0) + dur_ms
        timeline.setdefault(stage, []).append((ts, dur_ms))

    for revents in rows.values():
        revents.sort(key=lambda e: (float(e.get("ts", 0.0)),
                                    -float(e.get("dur", 0.0))))
        stack: List[List] = []  # [end_ts, name, start_ts, self_dur_us]
        for ev in revents:
            ts = float(ev.get("ts", 0.0))
            dur = float(ev.get("dur", 0.0))
            # Only an event that ends inside the open one is its child:
            # back-to-back GPU kernels overlap by rounding (tens of ns).
            while stack and (stack[-1][0] <= ts + 1e-9
                             or ts + dur > stack[-1][0] + 1e-3):
                rec = stack.pop()
                emit(rec[1], rec[2], rec[3])
            if stack:
                stack[-1][3] -= dur  # child span leaves parent's self time
            stack.append([ts + dur, _event_text(ev), ts, dur])
        while stack:
            rec = stack.pop()
            emit(rec[1], rec[2], rec[3])

    per_occ = {s: [d for _, d in sorted(v)] for s, v in timeline.items()}
    top = sorted(((n, ms, c) for n, (ms, c) in ops.items()),
                 key=lambda x: -x[1])[:20]
    return DeviceProfile(total_ms=total, stages_ms=stages_ms,
                         per_occurrence_ms=per_occ, top_ops=top)


def profile_stages(run, logdir: Optional[str] = None,
                   stages: Sequence[Tuple[str, str]] = DEFAULT_STAGES,
                   ) -> DeviceProfile:
    """Trace ``run()`` with jax.profiler and return its device breakdown.

    ``run`` should execute the (already compiled) device work and return its
    outputs; the outputs are synchronized inside the traced region so the
    device timeline is complete.
    """
    import jax

    own = logdir is None
    logdir = logdir or tempfile.mkdtemp(prefix="urt_prof_")
    # The Python tracer's per-call events only bloat the trace; the device
    # rows are what the breakdown reads.
    opts = jax.profiler.ProfileOptions()
    opts.python_tracer_level = 0
    jax.profiler.start_trace(logdir, profiler_options=opts)
    try:
        jax.block_until_ready(run())
    finally:
        jax.profiler.stop_trace()
    prof = parse_device_trace(logdir, stages)
    if own:
        import shutil

        shutil.rmtree(logdir, ignore_errors=True)
    return prof
